"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's serving paths through
`laudnet_tpu_torch.infer.fused_vit.build_fused_vit` and `LAUDViT` on the
card at full model width (batch 128, 224x224, bf16, random weights from a
seeded torch.Generator). Phases, each raising on failure:

1. device: a CUDA card is required (there is no CPU path);
2. build: the kernels of `laudnet_tpu_torch/csrc/` with nvcc, into
   `laudnet_tpu_torch/csrc/_build/`;
3. kernels vs plain: B1 (`fused_vit_block`, also with a head gate), B2
   (`fused_vit_segment`), B6 (`fused_vit_block_int8`) and B4
   (`fused_vit_attention`) against their plain PyTorch versions at DeiT-S
   and T2T-ViT-19 shapes, with times, bounds and, for B4, the time of
   PyTorch's own fused attention call as a yardstick;
4. DeiT-S serving: LAUD-DeiT-S (12 layers, D=384, 6 heads of 64) four ways
   (nominal, snapped and flat-0.5 caps, and dense) through the kernels,
   with launch counts, token counts, agreement with the same engine on
   the plain versions, and img/s;
5. the rest of ViT serving: LAUD-T2T-ViT-19 (performer stem, 14 layers,
   D=448, 7 heads of 64, hidden 1344) dense and with selection; DeiT-S
   W8A8 (`int8=True`) dense and with selection; DeiT-S with head gates;
   and `LAUDViT(attn_impl='fused')` eval.

Prints a JSON line of the kernels, then as its last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.

``python3 chip_smoke.py kernels`` stops after phase 3 (a short run to check
a changed kernel), and ``python3 chip_smoke.py profile`` prints, instead of
the phases, where a forward's device time goes (`torch.profiler`, by
kernel) for the dense DeiT-S, W8A8 DeiT-S and T2T-ViT-19 engines. Neither
prints a result line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from laudnet_tpu_torch.infer.fused_vit import _patchify, build_fused_vit
from laudnet_tpu_torch.models import laud_deit_small, laud_t2t_vit_19
from laudnet_tpu_torch.ops import _build, vit_attention, vit_block

B, L_FULL, IMG = 128, 197, 224
DEIT = dict(d=384, heads=6, hidden=1536)
T2T = dict(d=448, heads=7, hidden=1344)
NOMINAL = (1.0,) * 3 + (0.7,) * 4 + (0.5,) * 5
CONFIGS = (  # name, engine options, token count of each layer
    ("nominal", dict(token_capacity=NOMINAL), [197] * 3 + [137] * 4 + [98] * 5),
    ("snapped", dict(token_capacity=NOMINAL, snap_capacities=True),
     [197] * 3 + [128] * 4 + [96] * 5),
    ("flat_0.5", dict(token_capacity=(0.5,) * 12), [98] * 12),
    ("dense", dict(), [197] * 12),
)
T2T_CAPS = (1.0,) * 3 + (0.7,) * 5 + (0.5,) * 6
T2T_CONFIGS = (
    ("t2t_nominal", dict(token_capacity=T2T_CAPS),
     [197] * 3 + [137] * 5 + [98] * 6),
    ("t2t_snapped", dict(token_capacity=T2T_CAPS, snap_capacities=True),
     [197] * 3 + [128] * 5 + [96] * 6),
    ("t2t_dense", dict(), [197] * 14),
)
# Kernel vs plain: both round to bf16 at the same points and differ only in
# f32 summation order, which flips single bf16 roundings. Tolerance: ULPS
# bf16 ulps (8 significant bits) of the largest output magnitude; a wrong
# epilogue, mask or softmax is off by far more. The W8A8 block (B6) holds
# the same bound: its integer sums are exact on both sides, so what differs
# is again f32 order (LayerNorm's row sums, the dequantising epilogue) and
# the bf16 roundings. An activation within an f32 ulp of a rounding tie can
# take the neighbouring s8 code on one side; that moves one term of a K-term
# product by one code, less than a thousandth of an output ulp, so it stays
# inside the bound and is not counted separately. B4 against its plain
# version (`reference_vit_attention`, which does not round p before P.V)
# differs by p's bf16 rounding, averaged over the keys: inside the bound.
ULPS = 4
# Engine through kernels vs through plain versions, 12-14 layers: rounding
# flips compound over depth and can move a token gate that sits at a bf16
# tie, which changes which tokens a few images keep. A logit error of 5%
# of the logits' norm and 97% top-1 agreement allow that and still fail
# any systematic kernel fault (those move features by O(1)). The class
# head is fitted to the backbone first (`fit_head`): a random head has
# top-2 gaps of a few hundredths of a logit, which bf16 rounding alone
# flips (H100: plain bf16 vs plain f32 top-1 agreement 0.89-0.98).
TOP1_MIN, REL_ERR_MAX = 0.97, 5e-2
# Two of the later paths are noisier than that by their arithmetic, not by
# their kernels. T2T-ViT-19 with selection: over 14 layers its gates flip
# more, and the plain bf16 engine itself is 0.076-0.078 from the plain f32
# engine there (0.040 dense), while the kernels are 0.056-0.059 from plain
# bf16 and 0.079 from plain f32. W8A8: a bf16 rounding flip upstream can
# move an s8 code by one unit, 1/127 of its row's largest value, so kernels
# vs plain is 0.039 dense and 0.053 with selection where bf16 has 0.016 and
# 0.032 (H100, this script). For these paths the bound is the arithmetic's
# own noise: the kernels may be no further from the plain bf16 engine than
# that is from the same plain engine in f32 (and never further than 2 *
# REL_ERR_MAX); where that noise is below REL_ERR_MAX, REL_ERR_MAX holds.
REL_ERR_CAP = 2 * REL_ERR_MAX
# W8A8 against the bf16 kernel engine is an inexact path: every product
# quantises both operands to 127 levels of their row's or channel's
# largest value. The JAX package bounds it at 5e-2 relative logit error
# over 2 layers (tests/test_quant_vit.py); independent per-layer noise over
# 12 layers grows that by about sqrt(6), so the gate is 0.15, with top-1
# agreement of at least 0.95 on the fitted head.
INT8_TOP1_MIN, INT8_REL_ERR_MAX = 0.95, 0.15
RIDGE = 0.1  # fit_head's ridge, relative to the mean feature variance
SRC = "laudnet_tpu_torch/csrc/vit_block.cu"
# Published dense peaks of the H100 SXM (NVIDIA data sheet) for the bounds.
PEAK_BF16, PEAK_S8, PEAK_HBM = 989e12, 1979e12, 3.35e12


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; the port's "
                 "smoke runs only on a CUDA card")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    nvcc = run([_build._nvcc(), "--version"]).splitlines()
    print("nvcc:", nvcc[-1] if nvcc else "?")
    return card


def phase_build():
    path, secs, log = _build.build()
    _build.library()
    print(f"build: {path.name} in {secs:.1f} s")
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ulp_tol(ref):
    top = ref.float().abs().max().item()
    return ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def block_bound(l, d, heads, hidden, layers=1, int8=False):
    """Least time (ms) the card could take for ``layers`` block layers on
    (B, l, d): the larger of operations over the tensor-core peak of their
    type (the four products in bf16, or s8 for the W8A8 block; attention in
    bf16) and bytes over the memory rate (x read and written once, masks,
    and each layer's weights read once)."""
    m = B * l
    gemm_ops = 2 * m * (3 * d * d + d * d + 2 * d * hidden)
    att_ops = 4 * B * heads * l * l * 64
    ops_s = layers * (gemm_ops / (PEAK_S8 if int8 else PEAK_BF16)
                      + att_ops / PEAK_BF16)
    weights = (4 * d * d + 2 * d * hidden) * (1 if int8 else 2)
    small = (4 * d + 5 * d + hidden) * 2  # LayerNorms and biases, bf16
    if int8:
        small += (5 * d + hidden) * 4     # per-channel f32 weight scales
    moved = 2 * m * d * 2 + 2 * m * 4 + layers * (weights + small)
    bytes_s = moved / PEAK_HBM
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def attention_bound(l, d, heads, gated):
    """As `block_bound`, for the attention forward alone: 4*B*H*l*l*64
    operations in bf16; qkv read once, the output written once, masks."""
    m = B * l
    ops_s = 4 * B * heads * l * l * 64 / PEAK_BF16
    bytes_s = (m * 3 * d * 2 + m * d * 2 + m * 4
               + (B * heads * 4 if gated else 0)) / PEAK_HBM
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def layer_params(g, dev, d, hidden, policy=False):
    """Random bf16 layer weights (lecun-normal scale). A token policy reads
    feature 0 (keep iff it is >= 0)."""
    def w(*shape):
        return (torch.randn(*shape, generator=g) / math.sqrt(shape[-1])).to(
            dev, torch.bfloat16)

    def vec(n, base=0.0):
        return (base + 0.02 * torch.randn(n, generator=g)).to(
            dev, torch.bfloat16)

    p = {"ln1": {"weight": vec(d, 1.0), "bias": vec(d)},
         "ln2": {"weight": vec(d, 1.0), "bias": vec(d)},
         "qkv": {"weight": w(3 * d, d), "bias": vec(3 * d)},
         "proj": {"weight": w(d, d), "bias": vec(d)},
         "fc1": {"weight": w(hidden, d), "bias": vec(hidden)},
         "fc2": {"weight": w(d, hidden), "bias": vec(d)}}
    if policy:
        pw = torch.zeros(2, d)
        pw[0, 0], pw[1, 0] = 1.0, -1.0
        p["token_policy"] = {"weight": pw.to(dev, torch.bfloat16),
                             "bias": torch.zeros(2, dtype=torch.bfloat16,
                                                 device=dev)}
    return p


def stream(g, l, d, dev):
    """(B, l, d) bf16 token stream; feature 0 is +-8 per token, so the
    segment's token gates never sit near a tie and the kernel's mask must
    equal the plain version's exactly."""
    x = torch.randn(B, l, d, generator=g)
    x[:, :, 0] = torch.where(torch.rand(B, l, generator=g) > 0.5, 8.0, -8.0)
    return x.to(dev, torch.bfloat16)


def key_mask(g, l, dev, ragged):
    """(B, l) 1/0 mask: all ones, or ragged with the class token kept."""
    if not ragged:
        return torch.ones(B, l, device=dev)
    mask = (torch.rand(B, l, generator=g) > 0.3).float().to(dev)
    mask[:, 0] = 1.0
    return mask


def head_gate(g, heads, dev):
    gate = (torch.rand(B, heads, generator=g) > 0.4).float()
    gate[0, 0], gate[1, 0] = 0.0, 1.0
    return gate.to(dev)


def compare(tag, fn, ref_fn, card, results, key, label, bound, library=None):
    """Runs kernel and plain once, checks the ULPS bound, times both (and
    the library yardstick), records a row."""
    out, ref = fn(), ref_fn()
    torch.cuda.synchronize()
    err, tol = (out.float() - ref.float()).abs().max().item(), ulp_tol(ref)
    ms, plain_ms = time_ms(fn), time_ms(ref_fn)
    lib_ms = None if library is None else time_ms(library)
    bound_ms, bound_by = bound
    print(f"{tag}: max_abs_err {err:.6g} (tol {tol:.6g}); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}"
          + ("" if lib_ms is None else f", library {lib_ms:.4f} ms")
          + f" [{card}]")
    if not err <= tol:
        raise AssertionError(f"{tag} disagrees with plain: {err} > {tol}")
    results[key].append(dict(label=label, err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms))


def phase_kernels(dev, card):
    g = torch.Generator().manual_seed(0)
    results = {"fused_vit_block": [], "fused_vit_segment": [],
               "fused_vit_block_int8": [], "fused_vit_attention": []}

    # --- B1, DeiT-S and T2T widths (448 and 1344 are not multiples of the
    # 128-wide GEMM tile: this guards its edge tiles) --------------------
    cases = ((DEIT, L_FULL, False, False, "serving"),
             (DEIT, 137, True, False, ""),
             (DEIT, L_FULL, False, True, "head gate"),
             (T2T, L_FULL, False, False, "t2t"), (T2T, 96, True, False, "t2t"))
    layers = {}
    for geom, l, ragged, gated, note in cases:
        d, heads, hidden = geom["d"], geom["heads"], geom["hidden"]
        if d not in layers:
            layers[d] = layer_params(g, dev, d, hidden)
        layer = layers[d]
        x = stream(g, l, d, dev)
        mask = key_mask(g, l, dev, ragged)
        gate = head_gate(g, heads, dev) if gated else None
        args = (x, mask.reshape(B, 1, l), mask.reshape(B, l, 1), layer)
        for fast in (False, True):
            kw = dict(num_heads=heads, fast_math=fast, head_gate=gate)
            compare(f"B1 fused_vit_block D={d} L={l} "
                    f"{'ragged' if ragged else 'full'} mask fast_math={fast}"
                    f"{' head gate' if gated else ''}",
                    lambda: vit_block.fused_vit_block(*args, **kw),
                    lambda: vit_block.fused_vit_block_reference(*args, **kw),
                    card, results, "fused_vit_block",
                    note if fast else "", block_bound(l, d, heads, hidden))

    # --- B2, five layers with interior gates ------------------------------
    for geom, l, note in ((DEIT, 98, "serving"), (T2T, 96, "t2t")):
        d, heads, hidden = geom["d"], geom["heads"], geom["hidden"]
        seg = [layer_params(g, dev, d, hidden, policy=i > 0) for i in range(5)]
        x = stream(g, l, d, dev)
        mask = torch.ones(B, l, device=dev)
        for fast in (False, True):
            kw = dict(num_heads=heads, fast_math=fast)
            _, out_mask = vit_block.fused_vit_segment(x, mask, seg, **kw)
            _, ref_mask = vit_block.fused_vit_segment_reference(x, mask, seg,
                                                                **kw)
            kept = ref_mask.mean().item()
            if not torch.equal(out_mask, ref_mask):
                raise AssertionError("B2 token_mask differs from plain")
            if not 0.0 < kept < 1.0:
                raise AssertionError(f"B2 gates did not bite: kept {kept}")
            compare(f"B2 fused_vit_segment 5 layers D={d} L={l} "
                    f"fast_math={fast} (token_mask equal, kept {kept:.4f})",
                    lambda: vit_block.fused_vit_segment(x, mask, seg, **kw)[0],
                    lambda: vit_block.fused_vit_segment_reference(
                        x, mask, seg, **kw)[0],
                    card, results, "fused_vit_segment",
                    note if fast else "",
                    block_bound(l, d, heads, hidden, layers=5))

    # --- B6, the W8A8 block -------------------------------------------------
    for geom, l, ragged, gated, note in (
            (DEIT, L_FULL, False, False, "serving"),
            (DEIT, 128, True, True, ""), (T2T, L_FULL, False, False, "t2t")):
        d, heads, hidden = geom["d"], geom["heads"], geom["hidden"]
        qlayer = vit_block.quantize_block_params(layers[d])
        x = stream(g, l, d, dev)
        mask = key_mask(g, l, dev, ragged)
        gate = head_gate(g, heads, dev) if gated else None
        args = (x, mask.reshape(B, 1, l), mask.reshape(B, l, 1), qlayer)
        kw = dict(num_heads=heads, head_gate=gate)
        compare(f"B6 fused_vit_block_int8 D={d} L={l} "
                f"{'ragged' if ragged else 'full'} mask"
                f"{' head gate' if gated else ''}",
                lambda: vit_block.fused_vit_block_int8(*args, **kw),
                lambda: vit_block.fused_vit_block_int8_reference(*args, **kw),
                card, results, "fused_vit_block_int8", note,
                block_bound(l, d, heads, hidden, int8=True))

    # --- B4, the attention forward; yardstick: PyTorch's fused attention
    # on the same qkv (strided per-head views, additive key mask), timed
    # here and used nowhere in the port -------------------------------------
    for geom, l, ragged, note in ((DEIT, L_FULL, False, "serving"),
                                  (T2T, L_FULL, False, "t2t"),
                                  (DEIT, 137, True, "")):
        d, heads = geom["d"], geom["heads"]
        qkv = torch.randn(B, l, 3 * d, generator=g).to(dev, torch.bfloat16)
        mask = key_mask(g, l, dev, ragged)
        q, k, v = qkv.reshape(B, l, 3, heads, 64).permute(2, 0, 3, 1, 4)
        neg = ((1.0 - mask) * -1e9).to(torch.bfloat16)[:, None, None, :]
        for gated in (False, True):
            gate = head_gate(g, heads, dev) if gated else None
            args = (qkv, mask, gate, heads, 0.125)
            compare(f"B4 fused_vit_attention D={d} L={l} "
                    f"{'ragged' if ragged else 'full'} key mask"
                    f"{' head mask' if gated else ''}",
                    lambda: vit_attention.fused_vit_attention(*args),
                    lambda: vit_attention.reference_vit_attention(*args),
                    card, results, "fused_vit_attention",
                    note if gated else "", attention_bound(l, d, heads, gated),
                    library=lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=neg, scale=0.125))
    return results


def img_per_s(fwd, images, iters=10):
    ms = time_ms(lambda: fwd(images), reps=iters, warmup=2)
    return B / (ms / 1e3)


@torch.no_grad()
def fit_head(model32, model, images, kw):
    """Fits the class head, in closed form, to the backbone's own f32
    features of ``images`` (ridge regression onto one class per image, 10
    logits apart), and copies it into the bf16 ``model``: the decisive
    classifier a trained head is, on random weights."""
    d = model32.dim
    head = model32.head
    head.weight.zero_()
    head.weight[:d].copy_(torch.eye(d))
    head.bias.zero_()
    feats = build_fused_vit(model32, plain=True, **kw)(images)[:, :d].double()
    mu = feats.mean(0)
    fc = feats - mu
    gram = fc.T @ fc
    gram += RIDGE * gram.diagonal().mean() * torch.eye(d, dtype=gram.dtype,
                                                       device=gram.device)
    target = torch.zeros(B, 1000, dtype=gram.dtype, device=gram.device)
    target[torch.arange(B), torch.arange(B) * 7] = 10.0
    w = torch.linalg.solve(gram, fc.T @ target).T
    head.weight.copy_(w)
    head.bias.copy_(-w @ mu)
    model.head.weight.copy_(head.weight)
    model.head.bias.copy_(head.bias)


def model_pair(build, dev, seed, **kw):
    """An f32 model with seeded random weights and its bf16 copy, both built
    on the card (the port's default device)."""
    model32 = build(generator=torch.Generator(dev).manual_seed(seed),
                    **kw).eval()
    model = build(**kw)
    model.load_state_dict(model32.state_dict())
    return model32, model.to(torch.bfloat16).eval()


def agreement(out, ref):
    top1 = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    return top1, rel


COUNTERS = {"fused_vit_block": vit_block.fused_vit_block,
            "fused_vit_segment": vit_block.fused_vit_segment,
            "fused_vit_block_int8": vit_block.fused_vit_block_int8,
            "fused_vit_attention": vit_attention.fused_vit_attention}
# Launches of each kernel on the main paths: every path is driven once with
# all counts set to 0 just before it and read just after (`counted`), and
# the readings add up here. Launches made to compare a kernel with its
# plain version, or to time anything, are not in it.
MAIN_PATH_LAUNCHES = dict.fromkeys(COUNTERS, 0)


def counted(drive):
    """Runs ``drive()`` from zeroed launch counts; returns its result and
    the counts it left, which are added to `MAIN_PATH_LAUNCHES`."""
    for fn in COUNTERS.values():
        fn.launches = 0
    out = drive()
    torch.cuda.synchronize()
    delta = {name: fn.launches for name, fn in COUNTERS.items()}
    for name, n in delta.items():
        MAIN_PATH_LAUNCHES[name] += n
    return out, delta


def serve_and_check(name, model32, model, images, kw, expect_tokens,
                    expect_launches, noise_floor=False):
    """One request through the kernels, held against the same engine on the
    plain versions (head fitted first, to the float plain engine's
    features). ``noise_floor`` raises the logit bound to the distance of
    plain bf16 from plain f32 (see REL_ERR_CAP). Returns the engine and the
    kernels' logits."""
    fit_head(model32, model, images,
             {k: v for k, v in kw.items() if k != "int8"})
    ref = build_fused_vit(model, plain=True, **kw)(images)
    rel_max = REL_ERR_MAX
    if noise_floor:
        _, noise = agreement(ref, build_fused_vit(model32, plain=True,
                                                  **kw)(images))
        rel_max = min(max(REL_ERR_MAX, noise), REL_ERR_CAP)
        print(f"{name}: plain bf16 vs plain f32 relative logit error "
              f"{noise:.6g}; bound for kernels vs plain {rel_max:.6g}")
    engine = build_fused_vit(model, **kw)
    out, delta = counted(lambda: engine(images))
    seen = engine.token_counts
    print(f"{name}: logits {tuple(out.shape)} {out.dtype}, launches {delta}, "
          f"tokens per layer {seen}")
    if out.shape != (B, 1000) or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: bad logits")
    if seen != expect_tokens:
        raise AssertionError(f"{name}: token counts {seen} != {expect_tokens}")
    for kernel, n in expect_launches.items():
        if n is None:
            if not delta[kernel] > 0:
                raise AssertionError(f"{name}: no {kernel} launch")
        elif delta[kernel] != n:
            raise AssertionError(f"{name}: expected {n} {kernel} launches, "
                                 f"got {delta[kernel]}")
    top1, rel = agreement(out, ref)
    print(f"{name}: kernels vs plain top-1 agreement {top1:.4f}, relative "
          f"logit error {rel:.6g}")
    if top1 < TOP1_MIN or not rel <= rel_max:
        raise AssertionError(f"{name}: kernels disagree with plain")
    return engine, out


def report_rates(names_kw, model, images, card, plain_iters=10):
    rates = {}
    for name, kw in names_kw:
        k_ips = img_per_s(build_fused_vit(model, **kw), images)
        p_ips = img_per_s(build_fused_vit(model, plain=True, **kw), images,
                          iters=plain_iters)
        rates[name] = k_ips
        print(f"{name}: {k_ips:.1f} img/s through kernels, {p_ips:.1f} img/s "
              f"plain (bs{B} bf16) [{card}]")
    return rates


def phase_slice(dev, card):
    model32, model = model_pair(laud_deit_small, dev, 0)
    images = torch.randn(B, IMG, IMG, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    for name, kw, tokens in CONFIGS:
        expect = ({"fused_vit_block": 12, "fused_vit_segment": 0}
                  if name == "dense" else {"fused_vit_segment": None})
        serve_and_check(name, model32, model, images, kw, tokens, expect)
    rates = report_rates([(n, kw) for n, kw, _ in CONFIGS], model, images,
                         card)
    for name in ("nominal", "snapped", "flat_0.5"):
        print(f"{name} / dense through kernels: "
              f"{rates[name] / rates['dense']:.4f}")
    return model32, model, images, rates


def phase_slice2(dev, card, deit32, deit, images, deit_rates):
    # --- T2T-ViT-19, full: performer stem + 14-layer trunk ----------------
    t32, t2t = model_pair(laud_t2t_vit_19, dev, 2)
    for name, kw, tokens in T2T_CONFIGS:
        expect = ({"fused_vit_block": 14, "fused_vit_segment": 0}
                  if name == "t2t_dense" else {"fused_vit_segment": None})
        serve_and_check(name, t32, t2t, images, kw, tokens, expect,
                        noise_floor=True)
    rates = report_rates([(n, kw) for n, kw, _ in T2T_CONFIGS], t2t, images,
                         card, plain_iters=5)
    for name in ("t2t_nominal", "t2t_snapped"):
        print(f"{name} / t2t_dense through kernels: "
              f"{rates[name] / rates['t2t_dense']:.4f}")
    print(f"t2t snapped / nominal through kernels: "
          f"{rates['t2t_snapped'] / rates['t2t_nominal']:.4f} (the TPU tile "
          f"formula of snap_capacity_to_tiles at T2T widths)")
    with torch.no_grad():
        stem_ms = time_ms(lambda: _patchify(t2t, images), reps=10)
    fwd_ms = B / rates["t2t_dense"] * 1e3
    print(f"t2t stem (dense, never gated): {stem_ms:.4f} ms of a "
          f"{fwd_ms:.4f} ms dense forward ({stem_ms / fwd_ms:.4f}), "
          f"{stem_ms / (B / rates['t2t_snapped'] * 1e3):.4f} of a snapped "
          f"one [{card}]")
    del t32, t2t

    # --- DeiT-S W8A8 -------------------------------------------------------
    snapped = dict(token_capacity=NOMINAL, snap_capacities=True)
    for name, kw, tokens in (("int8_dense", dict(int8=True), [197] * 12),
                             ("int8_snapped", dict(int8=True, **snapped),
                              [197] * 3 + [128] * 4 + [96] * 5)):
        _, out = serve_and_check(name, deit32, deit, images, kw, tokens,
                                 {"fused_vit_block_int8": 12,
                                  "fused_vit_block": 0,
                                  "fused_vit_segment": 0}, noise_floor=True)
        fkw = {k: v for k, v in kw.items() if k != "int8"}
        top1, rel = agreement(out, build_fused_vit(deit, **fkw)(images))
        print(f"{name}: vs the bf16 kernel engine top-1 agreement {top1:.4f}"
              f", relative logit error {rel:.6g}")
        if name == "int8_dense" and (top1 < INT8_TOP1_MIN
                                     or not rel <= INT8_REL_ERR_MAX):
            raise AssertionError("int8_dense: W8A8 is further from bf16 "
                                 "than its bound")
    rates = report_rates([("int8_dense", dict(int8=True)),
                          ("int8_snapped", dict(int8=True, **snapped))],
                         deit, images, card, plain_iters=5)
    for name, base in (("int8_dense", "dense"), ("int8_snapped", "snapped")):
        print(f"{name} / bf16 {base} through kernels: "
              f"{rates[name] / deit_rates[base]:.4f} "
              f"({rates[name]:.1f} vs {deit_rates[base]:.1f} img/s)")

    # --- DeiT-S with head gates: heads 1 and 4 closed in every layer, by
    # their policy biases (keep-logit -5, skip-logit +5) --------------------
    g32, gated = model_pair(laud_deit_small, dev, 3, layer_skip=False)
    with torch.no_grad():
        for m in (g32, gated):
            for blk in m.blocks:
                for head in (1, 4):
                    blk.head_policy.bias[head] = -5.0
                    blk.head_policy.bias[6 + head] = 5.0
    for name, kw, tokens in (
            ("head_gated_dense", dict(head_gating=True), [197] * 12),
            ("head_gated_snapped", dict(head_gating=True, **snapped),
             [197] * 3 + [128] * 4 + [96] * 5)):
        _, out = serve_and_check(name, g32, gated, images, kw, tokens,
                                 {"fused_vit_block": 12,
                                  "fused_vit_segment": 0})
        fkw = {k: v for k, v in kw.items() if k != "head_gating"}
        _, rel = agreement(out, build_fused_vit(gated, **fkw)(images))
        print(f"{name}: relative logit distance from the ungated engine "
              f"{rel:.6g}")
        if not rel > REL_ERR_MAX:
            raise AssertionError(f"{name}: the head gates did not bite")
    report_rates([("head_gated_dense", dict(head_gating=True))], gated,
                 images, card, plain_iters=5)

    # --- LAUDViT(attn_impl='fused') eval: the model's own forward, its
    # attention through B4 (token and head gates live) ----------------------
    fused = laud_deit_small(layer_skip=False, attn_impl="fused")
    fused.load_state_dict(gated.state_dict())
    fused = fused.to(torch.bfloat16).eval()
    xb = images.to(torch.bfloat16)
    with torch.no_grad():
        out, delta = counted(lambda: fused(xb))
        ref = gated(xb)
    n_b4 = delta["fused_vit_attention"]
    top1, rel = agreement(out.logits, ref.logits)
    print(f"LAUDViT attn_impl='fused' eval: B4 launches {n_b4}, head density "
          f"{out.head_density.mean().item():.4f}, vs attn_impl='reference' "
          f"top-1 agreement {top1:.4f}, relative logit error {rel:.6g}")
    if n_b4 != 12:
        raise AssertionError(f"expected 12 B4 launches, got {n_b4}")
    if not out.head_density.mean().item() < 1.0:
        raise AssertionError("fused eval: no head gate closed")
    # both forwards are bf16 and differ in the attention's rounding points
    # only (p rounded before P.V): the engine bounds apply
    if top1 < TOP1_MIN or not rel <= REL_ERR_MAX:
        raise AssertionError("attn_impl='fused' disagrees with 'reference'")
    with torch.no_grad():
        f_ips = img_per_s(lambda x: fused(x).logits, xb)
        r_ips = img_per_s(lambda x: gated(x).logits, xb)
    print(f"LAUDViT eval: {f_ips:.1f} img/s with attn_impl='fused', "
          f"{r_ips:.1f} img/s with 'reference' (bs{B} bf16) [{card}]")


def phase_profile(dev, card, forwards=5, rows=22):
    """Device time by kernel over ``forwards`` forwards of each engine."""
    from torch.profiler import ProfilerActivity, profile

    images = torch.randn(B, IMG, IMG, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    _, deit = model_pair(laud_deit_small, dev, 0)
    _, t2t = model_pair(laud_t2t_vit_19, dev, 2)
    snapped = dict(token_capacity=T2T_CAPS, snap_capacities=True)
    with torch.no_grad():
        runs = (("deit_dense", build_fused_vit(deit)),
                ("deit_int8_dense", build_fused_vit(deit, int8=True)),
                ("t2t_dense", build_fused_vit(t2t)),
                ("t2t_snapped", build_fused_vit(t2t, **snapped)),
                ("t2t_stem_only", lambda x: _patchify(t2t, x)))
        for name, fwd in runs:
            ms = time_ms(lambda: fwd(images), reps=10)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(forwards):
                    fwd(images)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type.name == "CUDA"]
            events.sort(key=lambda e: -e.device_time_total)
            total = sum(e.device_time_total for e in events) / forwards / 1e3
            print(f"--- {name}: {ms:.4f} ms per forward (CUDA events), "
                  f"{total:.4f} ms of kernels per forward, idle share "
                  f"{max(0.0, 1 - total / ms):.4f} [{card}]")
            for e in events[:rows]:
                print(f"  {e.device_time_total / forwards / 1e3:9.4f} ms "
                      f"x{e.count // forwards:<4d} {e.key[:110]}")


REPLACES = {
    "fused_vit_block": "laudnet_tpu/ops/pallas/vit_block.py:303",
    "fused_vit_segment": "laudnet_tpu/ops/pallas/vit_block.py:472",
    "fused_vit_block_int8": "laudnet_tpu/ops/pallas/vit_block.py:175",
    "fused_vit_attention": "laudnet_tpu/ops/pallas/vit_attention.py:194",
}


def main():
    card = phase_device()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build()
    if sys.argv[1:] == ["profile"]:
        phase_profile(dev, card)
        return
    results = phase_kernels(dev, card)
    if sys.argv[1:] == ["kernels"]:
        print(f"kernel phases passed in {time.perf_counter() - t0:.1f} s")
        return
    deit32, deit, images, deit_rates = phase_slice(dev, card)
    phase_slice2(dev, card, deit32, deit, images, deit_rates)
    launches = MAIN_PATH_LAUNCHES
    kernels = []
    for name, rows in results.items():
        # the numbers at the serving shape (DeiT-S, the longest L, fast_math
        # where the kernel has it)
        row = next(r for r in rows if r["label"] == "serving")
        kernels.append({"name": name, "route": "cuda", "source": SRC,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": max(r["err"] for r in rows),
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
