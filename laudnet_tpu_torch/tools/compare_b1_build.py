"""The block kernels of this checkout against another build of
``csrc/`` (an earlier commit's, say): results and times, in one process on
one card.

    mkdir -p _smoke_checkout/parent
    git archive <commit> laudnet_tpu_torch/csrc | tar -x -C _smoke_checkout/parent
    python -m laudnet_tpu_torch.tools.compare_b1_build \\
        _smoke_checkout/parent/laudnet_tpu_torch/csrc

(``_smoke_checkout/`` is git-ignored.)
Builds every ``.cu`` of DIR into a library of its own (under
``csrc/_build/``, cached by the hash of DIR's sources) and runs the same
launches through both libraries on the same inputs:

* B6, the W8A8 layer (`ops/vit_block.py::_layer_int8_cuda`: exact integer
  sums and a fixed epilogue order), at DeiT-S L = 197 with a ragged key
  mask and a head gate, and at T2T-ViT-19's widths (D = 448, hidden
  1344): the two builds must agree bit for bit;
* B1 and B2, the bf16 layer (`_layer_cuda`) with the exact and the
  fast-math body: DeiT-S at L = 197 (ragged, head gate), a segment layer at
  L = 98 with its token gate fused into LN1 (B2's launch) and T2T at
  L = 197. A change of the GEMM core's summation order moves single bf16
  roundings, so each build is held to the plain version
  (`_layer_plain`) within ULPS bf16 ulps of its largest output, as
  ``chip_smoke.py`` holds them, and the token mask the gated layer writes
  must equal the plain one; each build's distance to the plain version is
  printed, and whether the two builds agree bit for bit.

Then it times both builds in turns (other, this, this, other; chains of ten
calls between CUDA events, the median of each side) at DeiT-S bs128, L =
197: each of the four products (qkv, proj, fc1, fc2 with their epilogues)
in bf16 and s8, and the whole layer, bf16 exact and fast-math and W8A8.
The other source must take the C arguments this one takes (``lt_layernorm``,
``lt_gemm``, ``lt_attention``, ``lt_gemm_s8``, ``lt_layernorm_quant``,
``lt_rowquant``), as every version since the W8A8 layer does. Anything
outside its bound raises.
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


def check_int8(libs, dev):
    """B6 through both builds: bit for bit."""
    results = {}
    for name, x, kmask, p, heads, gate, policy in cases(dev):
        if policy is not None:
            continue
        qp = vit_block.quantize_block_params(p)
        outs = [vit_block._layer_int8_cuda(lib, x, kmask, kmask.clone(), qp,
                                           heads, 1e-6, head_gate=gate)
                for lib in libs]
        torch.cuda.synchronize()
        same = torch.equal(outs[0], outs[1])
        key = f"B6 {name}"
        results[key] = same
        print(f"{key}: this build vs the other "
              f"{'bit-equal' if same else 'DIFFERENT'} (largest difference "
              f"{(outs[0].float() - outs[1].float()).abs().max().item():.6g})",
              flush=True)
    return results


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
            tol = ulp_tol(ref)
            outs, line = [], []
            for who, lib in zip(("this", "other"), libs):
                km, rm = _masks(kmask, policy)
                y = vit_block._layer_cuda(lib, x, km, rm, p, heads, 1e-6,
                                          fast, policy=policy, head_gate=gate)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                ok = err <= tol and torch.equal(km, pmask)
                outs.append(y)
                line.append(f"{who} build vs plain {err:.6g}"
                            f"{'' if ok else ' OUT OF BOUND'}")
                results[f"{key}, {who}"] = ok
            same = torch.equal(outs[0], outs[1])
            print(f"{key}: {'; '.join(line)} (tol {tol:.6g}); the builds "
                  f"{'bit-equal' if same else 'differ'}", flush=True)
    return results


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
    for fast in (False, True):
        record(f"layer bf16 {'fast_math' if fast else 'exact'}", [
            lambda lib=lib: vit_block._layer_cuda(lib, x, ones, ones, p,
                                                  heads, 1e-6, fast)
            for lib in libs])
    record("layer W8A8", [
        lambda lib=lib: vit_block._layer_int8_cuda(lib, x, ones, ones, qp,
                                                   heads, 1e-6)
        for lib in libs])
    return times


def run(src_dir, device="cuda"):
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the comparison runs the block kernels on a card")
    libs = (_build.library(), other_library(Path(src_dir)))
    exact = check_int8(libs, dev)
    bounded = check_bf16(libs, dev)
    times = time_builds(libs, dev)
    print(json.dumps({"b6_bit_equal": exact, "b1_b2_within_bound": bounded,
                      "ms_this_other": times}))
    if not all(exact.values()):
        raise AssertionError("B6's launches differ from the other build's")
    if not all(bounded.values()):
        raise AssertionError("a B1 / B2 launch is outside its bound")
    return exact, bounded, times


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: python -m laudnet_tpu_torch.tools."
                         "compare_b1_build DIR_WITH_vit_block.cu")
    run(sys.argv[1])
