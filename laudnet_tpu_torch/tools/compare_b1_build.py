"""The block kernels of this checkout against another build of
``csrc/`` (an earlier commit's, say): results and times, in one process on
one card.

    mkdir -p _smoke_checkout/parent
    git archive <commit> laudnet_tpu_torch/csrc | tar -x -C _smoke_checkout/parent
    python -m laudnet_tpu_torch.tools.compare_b1_build \\
        _smoke_checkout/parent/laudnet_tpu_torch/csrc

(``_smoke_checkout/`` is git-ignored.)
Builds every ``.cu`` of DIR into a library of its own (under
``csrc/_build/``, cached by the hash of DIR's sources) and runs the layers
through both libraries on the same inputs. This build runs its own launch
structure (the row passes in the products' epilogues where the widths
allow, `ops/vit_block.py::row_cluster`); the other runs the separate
launches that every build since the W8A8 layer has (``fuse=False``: LN2,
LN1 and the row quantisers as launches of their own), through the C
arguments they share (``lt_layernorm``, ``lt_gemm``, ``lt_attention``,
``lt_gemm_s8``, ``lt_layernorm_quant``, ``lt_rowquant``):

* B6, the W8A8 layer (`ops/vit_block.py::_layer_int8_cuda`), at DeiT-S
  L = 197 with a ragged key mask and a head gate, and at T2T-ViT-19's
  widths (D = 448, hidden 1344), launch by launch: each of this build's
  launches reads the other build's inputs for it, and its outputs are held
  to the other's bit for bit, where the arithmetic is unchanged; where it is
  not (`B6_CHANGED`: LN2's codes in the proj epilogue sum the row in
  another order; the attention routes long rows to another kernel), the
  share of values that differ is printed. Then the whole layer, with the
  share of outputs that differ;
* B1 and B2, the bf16 layer (`_layer_cuda`) with the exact and the
  fast-math body: DeiT-S at L = 197 (ragged, head gate), a segment layer at
  L = 98 with its token gate (B2's first launch) and T2T at L = 197, and
  B2's five-layer segment at L = 98 with a token policy in each later
  layer (`_segment_cuda`). A change of a summation order moves single bf16
  roundings, so each build is held to the plain version within ULPS bf16
  ulps of its largest output, as ``chip_smoke.py`` holds them, and the
  token masks must equal the plain ones; each build's distance to the
  plain version is printed, and whether the two builds agree bit for bit.

Then it times both builds in turns (other, this, this, other; chains of ten
calls between CUDA events, the median of each side) at DeiT-S bs128: each
of the four products (qkv, proj, fc1, fc2 with their epilogues) in bf16
and s8 at L = 197, the whole layer (bf16 exact and fast-math, W8A8) at
L = 197, and B2's five-layer segment at L = 98 (exact and fast-math).
Anything outside its bound raises.
"""

from __future__ import annotations

import hashlib
import json
import math
import statistics
import sys
from pathlib import Path

import torch

from laudnet_tpu_torch.ops import _build, vit_block
from laudnet_tpu_torch.tools.timing import chain_times

_ENTRY_POINTS = ("lt_layernorm", "lt_gemm", "lt_attention", "lt_gemm_s8",
                 "lt_layernorm_quant", "lt_rowquant")
ULPS = 4  # chip_smoke.py's bound of a kernel against its plain version


def other_library(src_dir: Path):
    """Every ``.cu`` of ``src_dir`` built into one library (cached by the
    hash of the directory's sources) and bound."""
    srcs = sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh"))
    if not any(s.name == "vit_block.cu" for s in srcs):
        raise FileNotFoundError(f"no vit_block.cu in {src_dir}")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = _build.BUILD_DIR / f"other_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.compile_library([s for s in srcs if s.suffix == ".cu"], out)
    return _build.load(out, _ENTRY_POINTS)


def ulp_tol(ref):
    top = ref.float().abs().max().item()
    return ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def _layer(g, d, hidden, dev, policy=False):
    def w(*shape, scale=0.05):
        return (torch.randn(*shape, generator=g) * scale).to(
            dev, torch.bfloat16)

    p = {"ln1": {"weight": 1 + w(d), "bias": w(d)},
         "ln2": {"weight": 1 + w(d), "bias": w(d)},
         "qkv": {"weight": w(3 * d, d), "bias": w(3 * d)},
         "proj": {"weight": w(d, d), "bias": w(d)},
         "fc1": {"weight": w(hidden, d), "bias": w(hidden)},
         "fc2": {"weight": w(d, hidden), "bias": w(d)}}
    if policy:  # keep iff feature 0 >= 0: no gate near a tie
        pw = torch.zeros(2, d)
        pw[0, 0], pw[1, 0] = 1.0, -1.0
        p["token_policy"] = {"weight": pw.to(dev, torch.bfloat16),
                             "bias": torch.zeros(2, dtype=torch.bfloat16,
                                                 device=dev)}
    return p


def cases(dev):
    """(name, x, key mask, params, heads, head gate, policy)."""
    g = torch.Generator().manual_seed(0)
    out = []
    for name, b, l, d, heads, hidden, gated, policy in (
            ("deit_s L=197 ragged, head gate", 128, 197, 384, 6, 1536,
             True, False),
            ("deit_s L=98 segment layer, token gate", 128, 98, 384, 6, 1536,
             False, True),
            ("t2t_vit_19 L=197", 64, 197, 448, 7, 1344, False, False)):
        x = torch.randn(b, l, d, generator=g)
        x[:, :, 0] = torch.where(torch.rand(b, l, generator=g) > 0.5, 8.0,
                                 -8.0)
        x = x.to(dev, torch.bfloat16)
        kmask = (torch.rand(b, l, generator=g) > 0.25).float().to(dev)
        kmask[:, 0] = 1.0
        gate = ((torch.rand(b, heads, generator=g) > 0.3).float().to(dev)
                if gated else None)
        p = _layer(g, d, hidden, dev, policy)
        out.append((name, x, kmask, p, heads, gate, p.get("token_policy")))
    return out


def _masks(kmask, policy):
    km = kmask.clone()
    # a token-gated layer updates one buffer as both masks (B2)
    return km, (km if policy is not None else kmask.clone())


def _share(a, b):
    """The share of entries of a and b that differ."""
    return (a != b).float().mean().item()


def check_int8(libs, dev):
    """B6 launch by launch: this build's launches on the other build's
    inputs for them. Returns {launch: share of outputs that differ}; raises
    where a launch whose arithmetic is unchanged is not bit-equal."""
    this, other = libs
    results = {}
    for name, x, kmask, p, heads, gate, policy in cases(dev):
        if policy is not None:
            continue
        qp = vit_block.quantize_block_params(p)
        b, l, d = x.shape
        m, hidden = b * l, qp["fc1"]["weight_q"].shape[0]
        stream = torch.cuda.current_stream().cuda_stream

        def codes(k):
            return (torch.empty(m, k, dtype=torch.int8, device=dev),
                    torch.empty(m, dtype=torch.float32, device=dev))

        def lnq(lib, inp, f32, w):
            q = codes(d)
            _build.check(lib, lib.lt_layernorm_quant(
                inp.data_ptr(), f32, q[0].data_ptr(), q[1].data_ptr(),
                w["weight"].data_ptr(), w["bias"].data_ptr(), m, d, 1e-6,
                stream), "layernorm-quantise")
            return q

        def rq(lib, inp, f32, k):
            q = codes(k)
            _build.check(lib, lib.lt_rowquant(
                inp.data_ptr(), f32, q[0].data_ptr(), q[1].data_ptr(), m, k,
                stream), "row-quantise")
            return q

        def att(lib, qkv):
            out = torch.empty(m, d, dtype=torch.bfloat16, device=dev)
            _build.check(lib, lib.lt_attention(
                qkv.data_ptr(), kmask.data_ptr(),
                None if gate is None else gate.data_ptr(), out.data_ptr(), b,
                l, heads, 0.125, 0, stream), "attention")
            return out

        def gemm(lib, a, w, n, k, epi, dtype, resid=None):
            out = torch.empty(m, n, dtype=dtype, device=dev)
            return vit_block._gemm_s8(lib, a, w, n, k, epi, out, resid, kmask)

        bf16, f32 = torch.bfloat16, torch.float32
        # the other build's chain: the nine launches
        q1 = lnq(other, x, 0, p["ln1"])
        qkv = gemm(other, q1, qp["qkv"], 3 * d, d, vit_block.EPI_QKV, bf16)
        attn = att(other, qkv)
        qa = rq(other, attn, 0, d)
        x2 = gemm(other, qa, qp["proj"], d, d, vit_block.EPI_PROJ, f32, x)
        q2 = lnq(other, x2, 1, p["ln2"])
        u = gemm(other, q2, qp["fc1"], hidden, d, vit_block.EPI_FC1, f32)
        qu = rq(other, u, 1, hidden)
        out = gemm(other, qu, qp["fc2"], d, hidden, vit_block.EPI_FC2, bf16,
                   x2)
        # this build's seven, each on the other's inputs
        mine_x2 = torch.empty_like(x2)
        mine_q2 = vit_block._gemm_s8_rows(
            this, qa, qp["proj"], d, d, vit_block.EPI_PROJ, codes(d), mine_x2,
            x, kmask, p["ln2"], 1e-6)
        mine_qu = vit_block._gemm_s8_rows(
            this, q2, qp["fc1"], hidden, d, vit_block.EPI_FC1, codes(hidden))
        launches = {
            "LN1 + quantise": (lnq(this, x, 0, p["ln1"]), q1),
            "s8 qkv": (gemm(this, q1, qp["qkv"], 3 * d, d, vit_block.EPI_QKV,
                            bf16), qkv),
            "attention": (att(this, qkv), attn),
            "row quantise of the attention output": (rq(this, attn, 0, d),
                                                     qa),
            "s8 proj: x2": (mine_x2, x2),
            "s8 proj: LN2's quantiser": (mine_q2, q2),
            "s8 fc1 + GELU + quantise": (mine_qu, qu),
            "s8 fc2": (gemm(this, qu, qp["fc2"], d, hidden,
                            vit_block.EPI_FC2, bf16, x2), out),
        }
        mine_out = vit_block._layer_int8_cuda(this, x, kmask, kmask.clone(),
                                              qp, heads, 1e-6, head_gate=gate)
        theirs = vit_block._layer_int8_cuda(other, x, kmask, kmask.clone(),
                                            qp, heads, 1e-6, head_gate=gate,
                                            fuse=False)
        torch.cuda.synchronize()
        for launch, (mine, ref) in launches.items():
            if isinstance(mine, tuple):  # s8 codes and their row scales
                results[f"B6 {name}: {launch}: codes"] = _share(mine[0],
                                                               ref[0])
                results[f"B6 {name}: {launch}: scales"] = _share(mine[1],
                                                                ref[1])
            else:
                results[f"B6 {name}: {launch}"] = _share(mine, ref)
        results[f"B6 {name}: the layer's output"] = _share(mine_out, theirs)
        for key in results:
            if key.startswith(f"B6 {name}"):
                print(f"{key}: this build vs the other "
                      + ("bit-equal" if results[key] == 0.0 else
                         f"{results[key]:.6g} of the values differ"),
                      flush=True)
        print(f"B6 {name}: largest difference of the layer's output "
              f"{(mine_out.float() - theirs.float()).abs().max().item():.6g}",
              flush=True)
    return results


# B6's launches whose arithmetic changed with the row epilogues, the rest
# bit-equal to the other build's: LN2's row sums in the proj epilogue
# (another order), the attention (from 129 keys on the exact form runs
# attention.cu's streaming kernel, csrc/vit_block.cu::ATT_ROUTE_EXACT), and
# so the output
B6_CHANGED = ("s8 proj: LN2's quantiser: codes",
              "s8 proj: LN2's quantiser: scales", "attention",
              "the layer's output")


def check_bf16(libs, dev):
    """B1 / B2 through both builds: each within ULPS of the plain layer,
    the token mask equal to the plain one."""
    results = {}
    for name, x, kmask, p, heads, gate, policy in cases(dev):
        for fast in (False, True):
            key = f"B1/B2 {name}, {'fast_math' if fast else 'exact'}"
            pmask = kmask.clone()
            if policy is not None:
                pmask = pmask * vit_block.token_gate(x, policy["weight"],
                                                     policy["bias"])
            ref = vit_block._layer_plain(x, pmask, pmask[..., None], p, heads,
                                         1e-6, fast, head_gate=gate)
            outs, line = [], []
            for who, lib in zip(("this", "other"), libs):
                km, rm = _masks(kmask, policy)
                y = vit_block._layer_cuda(lib, x, km, rm, p, heads, 1e-6,
                                          fast, policy=policy,
                                          head_gate=gate,
                                          fuse=who == "this")
                torch.cuda.synchronize()
                outs.append((y, km))
            record(results, key, outs, ref, pmask)
    g = torch.Generator().manual_seed(2)
    x, kmask, seg = segment_case(g, dev)
    for fast in (False, True):
        key = f"B2 5-layer segment L=98, {'fast_math' if fast else 'exact'}"
        ref, ref_mask = vit_block.fused_vit_segment_reference(
            x, kmask, seg, num_heads=6, fast_math=fast)
        outs = [vit_block._segment_cuda(lib, x, kmask, seg, 6, 1e-6, fast,
                                        fuse=who == "this")
                for who, lib in zip(("this", "other"), libs)]
        torch.cuda.synchronize()
        record(results, key, outs, ref, ref_mask)
    return results


def record(results, key, outs, ref, ref_mask):
    """Each build's (output, mask) against the plain ones; prints a line."""
    tol = ulp_tol(ref)
    line = []
    for who, (y, mask) in zip(("this", "other"), outs):
        err = (y.float() - ref.float()).abs().max().item()
        ok = err <= tol and torch.equal(mask, ref_mask)
        line.append(f"{who} build vs plain {err:.6g}"
                    f"{'' if ok else ' OUT OF BOUND'}")
        results[f"{key}, {who}"] = ok
    same = torch.equal(outs[0][0], outs[1][0])
    print(f"{key}: {'; '.join(line)} (tol {tol:.6g}); the builds "
          f"{'bit-equal' if same else 'differ'}", flush=True)


def segment_case(g, dev, b=128, l=98, layers=5):
    """B2 at DeiT-S widths: ``layers`` layers, each after the first with a
    token policy on feature 0 (no ties), an all-ones entry mask."""
    x = torch.randn(b, l, 384, generator=g)
    x[:, :, 0] = torch.where(torch.rand(b, l, generator=g) > 0.5, 8.0, -8.0)
    seg = [_layer(g, 384, 1536, dev, policy=i > 0) for i in range(layers)]
    return (x.to(dev, torch.bfloat16), torch.ones(b, l, device=dev), seg)


def in_turns(this, other, rounds=3, reps=10, chain=10):
    """Medians of ``this`` and ``other`` timed in rounds of other, this,
    this, other: chains of ``chain`` calls between CUDA events."""
    a, b = [], []
    for _ in range(rounds):
        for side, f in ((b, other), (a, this), (a, this), (b, other)):
            side.append(statistics.median(chain_times(f, chain, reps, 2)))
    return statistics.median(a), statistics.median(b)


def time_builds(libs, dev):
    """Each product and the whole layer at DeiT-S bs128, L = 197, through
    both builds in turns. Returns {what: (this ms, other ms)}."""
    g = torch.Generator().manual_seed(1)
    b, l, d, heads, hidden = 128, 197, 384, 6, 1536
    m = b * l
    p = _layer(g, d, hidden, dev)
    qp = vit_block.quantize_block_params(p)
    x = torch.randn(b, l, d, generator=g).to(dev, torch.bfloat16)
    ones = torch.ones(b, l, device=dev)
    rm = ones.reshape(-1)
    times = {}

    def record(what, fns):
        times[what] = in_turns(*fns)
        this_ms, other_ms = times[what]
        print(f"{what}: this build {this_ms:.4f} ms, the other "
              f"{other_ms:.4f} ms ({other_ms / this_ms:.3f}x)", flush=True)

    from laudnet_tpu_torch.ops.quant import quantize_rows

    shapes = {"qkv": (3 * d, d, None), "proj": (d, d, x.reshape(m, d)),
              "fc1": (hidden, d, None),
              "fc2": (d, hidden, torch.randn(m, d, generator=g).to(dev))}
    for name, (n, k, resid) in shapes.items():
        epi = vit_block.GEMM_EPILOGUES.index(name)
        a = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
        f32_out = name == "proj"
        out = torch.empty(m, n, device=dev,
                          dtype=torch.float32 if f32_out else torch.bfloat16)
        record(f"{name} bf16", [
            lambda lib=lib: vit_block._gemm(lib, a, p[name], n, k, epi, out,
                                            resid, rm) for lib in libs])
        q = quantize_rows(a)
        q = (q[0], q[1].reshape(-1).contiguous())
        out8 = torch.empty(m, n, device=dev, dtype=torch.float32 if (
            f32_out or name == "fc1") else torch.bfloat16)
        record(f"{name} s8", [
            lambda lib=lib: vit_block._gemm_s8(lib, q, qp[name], n, k, epi,
                                               out8, resid, rm)
            for lib in libs])
    fuse = (True, False)  # this build's launches, the other's
    for fast in (False, True):
        record(f"layer bf16 {'fast_math' if fast else 'exact'}", [
            lambda lib=lib, f=f: vit_block._layer_cuda(
                lib, x, ones, ones, p, heads, 1e-6, fast, fuse=f)
            for lib, f in zip(libs, fuse)])
    record("layer W8A8", [
        lambda lib=lib, f=f: vit_block._layer_int8_cuda(
            lib, x, ones, ones, qp, heads, 1e-6, fuse=f)
        for lib, f in zip(libs, fuse)])
    sx, smask, seg = segment_case(g, dev)
    for fast in (False, True):
        record(f"B2 5-layer segment L=98 {'fast_math' if fast else 'exact'}",
               [lambda lib=lib, f=f: vit_block._segment_cuda(
                   lib, sx, smask, seg, heads, 1e-6, fast, fuse=f)
                for lib, f in zip(libs, fuse)])
    return times


def run(src_dir, device="cuda"):
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the comparison runs the block kernels on a card")
    libs = (_build.library(), other_library(Path(src_dir)))
    differ = check_int8(libs, dev)
    bounded = check_bf16(libs, dev)
    times = time_builds(libs, dev)
    print(json.dumps({"b6_share_differing": differ,
                      "b1_b2_within_bound": bounded,
                      "ms_this_other": times}))
    kept = [k for k, v in differ.items()
            if v != 0.0 and not k.endswith(B6_CHANGED)]
    if kept:
        raise AssertionError(f"B6's launches differ from the other build's: "
                             f"{kept}")
    if not all(bounded.values()):
        raise AssertionError("a B1 / B2 launch is outside its bound")
    return differ, bounded, times


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: python -m laudnet_tpu_torch.tools."
                         "compare_b1_build DIR_WITH_vit_block.cu")
    run(sys.argv[1])
