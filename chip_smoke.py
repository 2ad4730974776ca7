"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's serving paths through
`laudnet_tpu_torch.infer.fused_vit.build_fused_vit`, `LAUDViT` and the CNN
flagship of `laudnet_tpu_torch.entry`, and its training path through
`laudnet_tpu_torch.train.main.main`, on the card at full model width (batch
128, 224x224, bf16, random weights from a seeded torch.Generator). Phases,
each raising on failure:

1. device: a CUDA card is required (there is no CPU path);
2. build: the kernels of `laudnet_tpu_torch/csrc/` with nvcc, into
   `laudnet_tpu_torch/csrc/_build/`;
3. kernels vs plain: B1 (`fused_vit_block`, also with a head gate), B2
   (`fused_vit_segment`), B6 (`fused_vit_block_int8`), B4
   (`fused_vit_attention`) and B5 (its backward) against their plain
   PyTorch versions at DeiT-S and T2T-ViT-19 shapes, with times, bounds
   and, for B4 and B5, the time of PyTorch's own fused attention call
   (forward, backward) as a yardstick; B3 (`masked_bottleneck_tail`) at
   the shape of the JAX bench (B=16, 28x28, 1024 -> 2048, patch 7) and at
   the flagship's four stride-1 block shapes at batch 128, beside the dense
   tail through cuDNN and the gather -> cuDNN -> scatter tail;
4. DeiT-S serving: LAUD-DeiT-S (12 layers, D=384, 6 heads of 64) four ways
   (nominal, snapped and flat-0.5 caps, and dense) through the kernels,
   with launch counts, token counts, agreement with the same engine on
   the plain versions, and img/s;
5. the rest of ViT serving: LAUD-T2T-ViT-19 (performer stem, 14 layers,
   D=448, 7 heads of 64, hidden 1344) dense and with selection; DeiT-S
   W8A8 (`int8=True`) dense and with selection; DeiT-S with head gates;
   and `LAUDViT(attn_impl='fused')` eval;
6. DeiT-S training: ``train.main.main(--arch laud_deit_small --vit_attn
   fused --amp --batch_size 128)`` for 8 steps on synthetic data, with B4
   and B5 launch counts; then the same trainer on a repeated batch (the
   loss must fall), its first step held against the same step through the
   plain attention (metrics and the gradients that B5 feeds), and step
   time, img/s, peak memory and B4's and B5's share of a step.

Prints a JSON line of the kernels, then as its last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.

``python3 chip_smoke.py kernels`` stops after phase 3 (a short run to check
a changed kernel), ``python3 chip_smoke.py train`` runs phases 1-3 and 6,
``python3 chip_smoke.py cnn`` runs phases 1-2, B3's part of 3, 7 and 8,
and ``python3 chip_smoke.py profile`` prints, instead of
the phases, where a forward's device time goes (`torch.profiler`, by
kernel) for the dense DeiT-S, W8A8 DeiT-S and T2T-ViT-19 engines. Neither
prints a result line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

from laudnet_tpu_torch.entry import entry, flagship
from laudnet_tpu_torch.infer.fused_vit import _patchify, build_fused_vit
from laudnet_tpu_torch.models import (laud_deit_small, laud_t2t_vit_19,
                                      resnet50)
from laudnet_tpu_torch.models.laud_resnet import conv_nhwc
from laudnet_tpu_torch.ops import (_build, masked_block, sparse,
                                   vit_attention, vit_block)

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
# B3 against its plain version holds the same ULPS bound: both round the
# ReLU output, the second affine and the residual add to bf16 at the same
# points. B3 against a block's own sparse execution rounds at OTHER points
# (the model rounds each convolution's output to bf16 before BatchNorm, B3
# applies the folded BatchNorm to the f32 sums): one more rounding of h
# spreads through conv3 into less than an ulp of y, and y and the residual
# add then flip single roundings: REAL_ULPS bf16 ulps of the largest output.
REAL_ULPS = 8
# The flagship's sparse execution at capacity 1.0 against dense-masked, and
# W8A8 against bf16 (the CNN's bounds; the logits of a random head are O(1)
# and top-1 on them is reported, not gated). Sparse at full capacity
# computes the dense-masked graph on gathered patches: in f32 (TF32 off) it
# differs by summation order, SPARSE_F32_REL of the logits' norm; in bf16
# cuDNN picks other kernels for the patch batch, roundings flip and a gate
# at a tie moves a few cells: the engine bound REL_ERR_MAX. W8A8
# quantises both operands of 53 convolutions to 127 levels: the ViT
# engine's bound INT8_REL_ERR_MAX.
SPARSE_F32_REL = 1e-3
# The f32 model on the card against the same weights on the CPU: with TF32
# off the two differ in f32 summation order (1e-6 of a logit), and a cell
# whose logits tie that closely, or that sits downstream of one, may flip:
# at least MASK_AGREE_MIN of all mask cells must agree.
MASK_AGREE_MIN = 0.995
CNN_TRAIN_STEPS = 4
SRC = "laudnet_tpu_torch/csrc/vit_block.cu"
SRC_TAIL = "laudnet_tpu_torch/csrc/masked_block.cu"
SRC_BWD = "laudnet_tpu_torch/csrc/vit_attention_bwd.cu"
# B5 against its plain version: both round P, dS and the gated dO to bf16 at
# the same points, so dqkv holds the ULPS bound above; dhead is an f32 sum
# of L * 64 products per entry and is held to DHEAD_REL of its largest entry.
DHEAD_REL = 2e-3
# Training, first step through the kernels vs through the plain attention
# (same weights, same noise seed): every loss part within TRAIN_REL. Beyond
# bf16 rounding, a Gumbel gate at a tie can flip between the two runs, and
# the straight-through residue of a kept token reaches the key mask
# (tests/test_torch_laud_vit_train.py), so the two forwards are two samples
# of one noisy step: 0.7% apart on the H100 at batch 128. The backward is
# held apart from that: the same step with B4's forward and the PLAIN
# backward has the same activations, so its gradients differ from the
# kernels' only by B5's summation order. The gradients of the qkv products,
# which B5 feeds directly, must then agree over all layers: cosine
# similarity at least GRAD_COS_MIN, and a norm within GRAD_NORM_REL. A wrong
# dQ, dK or dV (a sign, a transpose, a missing scale) fails both by far.
TRAIN_REL, GRAD_COS_MIN, GRAD_NORM_REL = 2e-2, 0.999, 1e-2
TRAIN_STEPS = 8
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


def attention_bwd_bound(l, d, heads, gated):
    """As `attention_bound`, for the backward: five products of 2*l*l*64
    operations per image and head (dV, dP, dQ, dK and the recomputed S; a
    sixth, P.V, for the gate's gradient); qkv and dO read once, dqkv
    written once, masks."""
    m = B * l
    ops_s = (6 if gated else 5) * 2 * B * heads * l * l * 64 / PEAK_BF16
    bytes_s = (2 * m * 3 * d * 2 + m * d * 2 + m * 4
               + (2 * B * heads * 4 if gated else 0)) / PEAK_HBM
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


# B3's shapes: name, B, H = W, C, Co, patch, mask density, capacities
TAIL_SHAPES = (
    ("bench", 16, 28, 1024, 2048, 7, None, (8, 4)),
    ("stage1", 128, 56, 64, 256, 4, 0.5, (196, 98)),
    ("stage2", 128, 28, 128, 512, 4, 0.5, (49, 25)),
    ("stage3", 128, 14, 256, 1024, 2, 0.5, (49, 25)),
    ("stage4", 128, 7, 512, 2048, 1, 0.5, (49, 25)),
)


def tail_inputs(g, dev, b, hw, c, co, patch, density):
    """Random bf16 tensors of one bottleneck tail: post-ReLU x1, He-scaled
    weights, BatchNorm affines near identity, a 0/1 cell mask."""
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    bf = lambda t: t.to(dev, torch.bfloat16)
    hm = hw // patch
    return dict(
        x1=bf(rn(b, hw, hw, c).relu()), identity=bf(rn(b, hw, hw, co)),
        mask_cells=(torch.rand(b, hm, hm, generator=g) < density).float().to(
            dev),
        w2=bf(rn(3, 3, c, c, scale=math.sqrt(2.0 / (9 * c)))),
        a2=(1.0 + rn(c, scale=0.1)).to(dev), b2=rn(c, scale=0.1).to(dev),
        w3=bf(rn(c, co, scale=math.sqrt(2.0 / c))),
        a3=(1.0 + rn(co, scale=0.1)).to(dev), b3=rn(co, scale=0.1).to(dev))


def tail_selection(mask_cells, capacity):
    """(B, Hm, Wm) bool: the cells the tail computes, the first ``capacity``
    active ones of each image in raster order."""
    b = mask_cells.shape[0]
    active = mask_cells.reshape(b, -1) > 0.5
    return (active & (active.cumsum(1) <= capacity)).reshape(mask_cells.shape)


def tail_bound(t, patch, capacity):
    """Least time (ms) for THIS mask: two products on the selected pixels in
    bf16 against the bytes that must move: the x1 pixels within one pixel of
    a selected cell, identity and the output whole, both weights, the mask."""
    b, hw, _, c = t["x1"].shape
    co = t["identity"].shape[-1]
    chosen = tail_selection(t["mask_cells"], capacity)
    pix = chosen.repeat_interleave(patch, 1).repeat_interleave(patch, 2)
    rows = int(pix.sum())
    halo = F.max_pool2d(pix[:, None].float(), 3, 1, 1)
    ops_s = 2 * rows * (9 * c * c + c * co) / PEAK_BF16
    moved = (int(halo.sum()) * c * 2 + 2 * b * hw * hw * co * 2
             + (9 * c * c + c * co) * 2 + (c + co) * 8 + chosen.numel() * 4)
    bytes_s = moved / PEAK_HBM
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes"), rows


def dense_tail(t, patch):
    """The dense-masked tail through cuDNN (the JAX bench's ``dense_fn``
    plus the mask): bf16, channels-last. A yardstick; the port's B3 path
    never calls it."""
    x = t["x1"].permute(0, 3, 1, 2)
    w2 = t["w2"].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    w3 = t["w3"].t()[:, :, None, None].contiguous(
        memory_format=torch.channels_last)
    mask = t["mask_cells"].repeat_interleave(patch, 1).repeat_interleave(
        patch, 2)[..., None].to(torch.bfloat16)

    def fn():
        h = F.conv2d(x, w2, padding=1).permute(0, 2, 3, 1)
        h = torch.relu(h.float() * t["a2"] + t["b2"]).to(torch.bfloat16)
        y = F.conv2d(h.permute(0, 3, 1, 2), w3).permute(0, 2, 3, 1)
        y = (y.float() * t["a3"] + t["b3"]).to(torch.bfloat16)
        return torch.relu(t["identity"] + y * mask)

    return fn


def sparse_tail(t, patch, capacity):
    """The same function as the model's ``execution='sparse'`` computes it:
    `ops/sparse.py` gather -> cuDNN on the patches -> scatter-add."""
    w2 = t["w2"].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    w3 = t["w3"].t()[:, :, None, None].contiguous(
        memory_format=torch.channels_last)
    co = t["identity"].shape[-1]

    def fn():
        idx, valid = sparse.select_patches(t["mask_cells"], capacity)
        g = sparse.gather_patches(t["x1"], idx, patch, halo=1)
        b, k, ph, pw, c = g.shape
        h = F.conv2d(g.reshape(b * k, ph, pw, c).permute(0, 3, 1, 2), w2)
        h = torch.relu(h.permute(0, 2, 3, 1).float() * t["a2"] + t["b2"]).to(
            torch.bfloat16)
        y = F.conv2d(h.permute(0, 3, 1, 2), w3).permute(0, 2, 3, 1)
        y = (y.float() * t["a3"] + t["b3"]).to(torch.bfloat16)
        return torch.relu(sparse.scatter_patches_add(
            t["identity"], y.reshape(b, k, patch, patch, co), idx, valid,
            patch))

    return fn


def check_tail(tag, t, patch, capacity, card, rows_out=None, label="",
               timed=True):
    """B3 against its plain version on ``t``: the ULPS bound, and the cells
    it does not select equal to relu(identity) bit for bit. Timed beside
    the plain version and the two yardsticks unless ``timed`` is False."""
    kw = dict(patch=patch, capacity=capacity)
    kernel = lambda: masked_block.masked_bottleneck_tail(**t, **kw)
    plain = lambda: masked_block.reference_masked_bottleneck_tail(**t, **kw)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err, tol = (out.float() - ref.float()).abs().max().item(), ulp_tol(ref)
    chosen = tail_selection(t["mask_cells"], capacity)
    pix = chosen.repeat_interleave(patch, 1).repeat_interleave(patch, 2)
    rest_equal = torch.equal(out[~pix], torch.relu(t["identity"])[~pix])
    (bound_ms, bound_by), rows = tail_bound(t, patch, capacity)
    line = (f"{tag}: {int(chosen.sum())} of {chosen.numel()} cells selected "
            f"({rows} rows), max_abs_err {err:.6g} (tol {tol:.6g}), other "
            f"cells equal relu(identity): {rest_equal}")
    if timed:
        ms, plain_ms = time_ms(kernel), time_ms(plain, reps=5, warmup=1)
        lib_ms = time_ms(dense_tail(t, patch))
        sparse_ms = time_ms(sparse_tail(t, patch, capacity))
        line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                 f"{bound_ms:.4f} ms by {bound_by}, dense tail through cuDNN "
                 f"{lib_ms:.4f} ms, gather/cuDNN/scatter tail "
                 f"{sparse_ms:.4f} ms [{card}]")
        if rows_out is not None:
            rows_out.append(dict(label=label, err=err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=lib_ms))
    print(line)
    if not err <= tol or not rest_equal:
        raise AssertionError(f"{tag} disagrees with plain")


def phase_tail_kernel(dev, card, results):
    """B3 at the bench's shape and the flagship's four, each at two
    capacities; then an all-active mask, an all-zero mask and a capacity
    that binds."""
    g = torch.Generator().manual_seed(3)
    rows = results.setdefault("masked_bottleneck_tail", [])
    for name, b, hw, c, co, patch, density, caps in TAIL_SHAPES:
        n_cells = (hw // patch) ** 2
        for i, capacity in enumerate(caps):
            # the bench draws its mask at the density its capacity stands for
            dens = density if density else capacity / n_cells
            t = tail_inputs(g, dev, b, hw, c, co, patch, dens)
            check_tail(f"B3 masked_bottleneck_tail {name} B={b} {hw}x{hw} "
                       f"{c}->{co} patch {patch} density {dens:g} capacity "
                       f"{capacity}", t, patch, capacity, card, rows,
                       label="serving" if (name, i) == ("bench", 0) else name)
            del t
    t = tail_inputs(g, dev, 128, 28, 128, 512, 4, 0.6)
    for kind, mask, capacity in (
            ("all-active mask", torch.ones_like(t["mask_cells"]), 49),
            ("all-zero mask", torch.zeros_like(t["mask_cells"]), 49),
            ("binding capacity 5 of ~29 active", t["mask_cells"], 5)):
        check_tail(f"B3 masked_bottleneck_tail stage2 {kind}",
                   dict(t, mask_cells=mask), 4, capacity, card, timed=False)


def phase_kernels(dev, card):
    g = torch.Generator().manual_seed(0)
    results = {"fused_vit_block": [], "fused_vit_segment": [],
               "fused_vit_block_int8": [], "fused_vit_attention": [],
               "fused_vit_attention_bwd": []}
    phase_tail_kernel(dev, card, results)

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

    # --- B5, the attention backward; yardstick: the backward of PyTorch's
    # fused attention on the same shapes (its forward's graph is built once
    # and only the backward is timed) ---------------------------------------
    for geom, l, ragged, note in ((DEIT, L_FULL, False, "serving"),
                                  (T2T, L_FULL, False, "t2t"),
                                  (DEIT, 137, True, "")):
        d, heads = geom["d"], geom["heads"]
        qkv = torch.randn(B, l, 3 * d, generator=g).to(dev, torch.bfloat16)
        cot = torch.randn(B, l, d, generator=g).to(dev, torch.bfloat16)
        mask = key_mask(g, l, dev, ragged)
        q, k, v = (t.detach().requires_grad_() for t in
                   qkv.reshape(B, l, 3, heads, 64).permute(2, 0, 3, 1, 4))
        neg = ((1.0 - mask) * -1e9).to(torch.bfloat16)[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=neg,
                                                 scale=0.125)
        lib_cot = cot.reshape(B, l, heads, 64).permute(0, 2, 1, 3)
        for gated in (False, True):
            gate = head_gate(g, heads, dev) if gated else None
            args = (qkv, mask, gate, cot, heads, 0.125)
            tag = (f"B5 fused_vit_attention backward D={d} L={l} "
                   f"{'ragged' if ragged else 'full'} key mask"
                   f"{' head mask' if gated else ''}")
            compare(tag, lambda: vit_attention._launch_bwd(*args)[0],
                    lambda: vit_attention.reference_vit_attention_bwd(
                        *args)[0],
                    card, results, "fused_vit_attention_bwd",
                    note if gated else "",
                    attention_bwd_bound(l, d, heads, gated),
                    library=lambda: torch.autograd.grad(
                        lib_out, (q, k, v), lib_cot, retain_graph=True))
            if gated:
                dhead = vit_attention._launch_bwd(*args)[1]
                ref = vit_attention.reference_vit_attention_bwd(*args)[1]
                err = (dhead - ref).abs().max().item()
                tol = DHEAD_REL * ref.abs().max().item()
                closed = vit_attention._launch_bwd(*args)[0][0].reshape(
                    l, 3, heads, 64)[:, :, 0]
                print(f"{tag}: dhead max_abs_err {err:.6g} (tol {tol:.6g}); "
                      f"closed head dgate {dhead[0, 0].item():.6g}")
                if not err <= tol:
                    raise AssertionError(f"{tag}: dhead disagrees with plain")
                if closed.any() or dhead[0, 0].item() == 0.0:
                    raise AssertionError(f"{tag}: a closed head must have "
                                         "zero dqkv and a non-zero dgate")
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


COUNTERS = {  # kernel -> (the wrapper that holds its count, the count)
    "fused_vit_block": (vit_block.fused_vit_block, "launches"),
    "fused_vit_segment": (vit_block.fused_vit_segment, "launches"),
    "fused_vit_block_int8": (vit_block.fused_vit_block_int8, "launches"),
    "fused_vit_attention": (vit_attention.fused_vit_attention, "launches"),
    "fused_vit_attention_bwd": (vit_attention.fused_vit_attention,
                                "bwd_launches"),
    "masked_bottleneck_tail": (masked_block.masked_bottleneck_tail,
                               "launches")}
# Launches of each kernel on the main paths: every path is driven once with
# all counts set to 0 just before it and read just after (`counted`), and
# the readings add up here. Launches made to compare a kernel with its
# plain version, or to time anything, are not in it.
MAIN_PATH_LAUNCHES = dict.fromkeys(COUNTERS, 0)


def counted(drive, main_path=True):
    """Runs ``drive()`` from zeroed launch counts; returns its result and
    the counts it left. A main path's counts are added to
    `MAIN_PATH_LAUNCHES`; a run whose kernels this script has swapped for
    their plain versions is no main path (``main_path=False``): its counts
    are returned for the caller's assertions and added nowhere."""
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    out = drive()
    torch.cuda.synchronize()
    delta = {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}
    if main_path:
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


# --- training ---------------------------------------------------------------

TRAIN_ARGV = ["--arch", "laud_deit_small", "--vit_attn", "fused", "--amp",
              "--batch_size", str(B), "--input_size", str(IMG),
              "--epochs", "1", "--steps_per_epoch", str(TRAIN_STEPS),
              "--print_freq", "1"]
LOSS_PARTS = ("loss", "loss_cls", "loss_kd", "loss_flops")


class plain_attention:
    """Within the block the attention Function runs its plain forward and
    backward (or, ``forward=False``, its plain backward only) on CUDA
    tensors too: the yardstick of the kernels' step. Only this script swaps
    them; the port never does."""

    def __init__(self, forward=True):
        self.forward = forward

    def __enter__(self):
        self.saved = (vit_attention._launch_fwd, vit_attention._launch_bwd)
        if self.forward:
            vit_attention._launch_fwd = vit_attention.reference_vit_attention
        vit_attention._launch_bwd = vit_attention.reference_vit_attention_bwd

    def __exit__(self, *exc):
        vit_attention._launch_fwd, vit_attention._launch_bwd = self.saved


def qkv_grads(model):
    return torch.cat([blk.qkv.weight.grad.flatten() for blk in model.blocks])


def phase_train(dev, card):
    from torch.profiler import ProfilerActivity, profile

    from laudnet_tpu_torch.train import main as train_main

    # --- the entry point, end to end: 8 steps, validation, checkpoint -----
    with tempfile.TemporaryDirectory() as out_dir:
        best, delta = counted(lambda: train_main.main(
            TRAIN_ARGV + ["--train_url", out_dir]))
        with open(f"{out_dir}/log.txt") as f:
            header, row = (line.strip().split(",") for line in f.readlines())
        log = open(f"{out_dir}/train.log").read()
    n_b4, n_b5 = delta["fused_vit_attention"], delta["fused_vit_attention_bwd"]
    print(f"train.main: best top1 {best:.4f}; launches {delta}; log.txt "
          f"{dict(zip(header, row))}")
    # per step 12 teacher + 12 student forwards and 12 backwards; the two
    # validation batches add 12 forwards each
    if n_b4 != 24 * TRAIN_STEPS + 24 or n_b5 != 12 * TRAIN_STEPS:
        raise AssertionError(f"train.main: expected {24 * TRAIN_STEPS + 24} "
                             f"B4 and {12 * TRAIN_STEPS} B5 launches")
    if not all(math.isfinite(float(v)) for v in row) or "nan" in log:
        raise AssertionError("train.main: a metric is not finite")

    # --- the same trainer on one repeated batch ----------------------------
    args = train_main.parse_args(TRAIN_ARGV)
    quiet = lambda *a, **k: None
    images, labels = next(train_main.synthetic_batches(B, IMG, 1000, 1,
                                                       seed=0))

    def run(steps):
        tr = train_main.build_training(args, quiet)
        x, y = tr.to_device(images, labels)
        out = [tr.train_step(tr.state, x, y) for _ in range(steps)]
        return tr, x, y, [{k: float(v) for k, v in m.items()} for m in out]

    (tr, x, y, metrics), delta = counted(lambda: run(TRAIN_STEPS))
    for i, m in enumerate(metrics):
        print(f"train step {i}: " + ", ".join(
            f"{k} {m[k]:.6g}" for k in LOSS_PARTS + ("act_rate", "top1", "lr",
                                                     "temperature")))
        if not all(math.isfinite(m[k]) for k in LOSS_PARTS):
            raise AssertionError(f"train step {i}: a loss part is not finite")
    if (delta["fused_vit_attention"] != 24 * TRAIN_STEPS
            or delta["fused_vit_attention_bwd"] != 12 * TRAIN_STEPS):
        raise AssertionError(f"repeated batch: launches {delta}")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise AssertionError("the loss did not fall on a repeated batch: "
                             f"{metrics[0]['loss']} -> {metrics[-1]['loss']}")

    # --- first step: kernels vs the plain attention, same weights and seed -
    tr_k, _, _, first_k = run(1)
    grads_k = qkv_grads(tr_k.model).float()
    with plain_attention(forward=False):    # B4 forward, plain backward
        (tr_b, _, _, first_b), delta = counted(lambda: run(1),
                                               main_path=False)
    if delta["fused_vit_attention_bwd"] or not delta["fused_vit_attention"]:
        raise AssertionError(f"plain backward step: launches {delta}")
    grads_b = qkv_grads(tr_b.model).float()
    cos = F.cosine_similarity(grads_k, grads_b, dim=0).item()
    norm_rel = abs(grads_k.norm().item() / grads_b.norm().item() - 1.0)
    print(f"first step, B5 vs the plain backward behind the same forward: "
          f"cosine of the qkv weights' gradients {cos:.6f} (at least "
          f"{GRAD_COS_MIN}), norms differ by {norm_rel:.6g} (at most "
          f"{GRAD_NORM_REL}); loss {first_k[0]['loss']:.6g} / "
          f"{first_b[0]['loss']:.6g}")
    if (not cos >= GRAD_COS_MIN or not norm_rel <= GRAD_NORM_REL
            or first_k[0]["loss"] != first_b[0]["loss"]):
        raise AssertionError("B5's gradients disagree with the plain "
                             "backward's in the training step")
    with plain_attention():                 # plain forward and backward
        (tr_p, _, _, first_p), delta = counted(lambda: run(1),
                                               main_path=False)
    if any(delta.values()):
        raise AssertionError(f"the plain step launched a kernel: {delta}")
    worst = max(abs(first_k[0][k] - first_p[0][k]) / abs(first_p[0][k])
                for k in LOSS_PARTS)
    cos_p = F.cosine_similarity(grads_k, qkv_grads(tr_p.model).float(),
                                dim=0).item()
    print("first step through kernels vs plain attention: " + ", ".join(
        f"{k} {first_k[0][k]:.6g} / {first_p[0][k]:.6g}" for k in LOSS_PARTS)
        + f"; worst relative difference {worst:.6g} (bound {TRAIN_REL}); "
        f"cosine of the qkv weights' gradients {cos_p:.6f} (two samples of "
        f"a noisy step: not bounded)")
    if not worst <= TRAIN_REL:
        raise AssertionError("training through the kernels disagrees with "
                             "the plain attention")
    del tr_k, tr_b, tr_p

    # --- step time, memory, and where the step goes ------------------------
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: tr.train_step(tr.state, x, y), reps=6, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    with plain_attention():
        plain_ms = time_ms(lambda: tr.train_step(tr.state, x, y), reps=3,
                           warmup=1)
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tr.train_step(tr.state, x, y)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    events.sort(key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in events) / steps / 1e3

    def share(name):
        return sum(e.device_time_total for e in events
                   if name in e.key) / steps / 1e3

    b5_ms, b4_ms = share("attention_bwd_kernel"), share("attention_kernel")
    host = {e.key: e.count / steps for e in prof.key_averages()
            if e.key in ("cudaLaunchKernel", "cudaStreamSynchronize",
                         "cudaDeviceSynchronize", "aten::item",
                         "cudaMemcpyAsync")}
    if not (b5_ms > 0 and b4_ms > 0):
        raise AssertionError("the profile shows no attention kernel time")
    print(f"train step (DeiT-S, fused attention, bf16 compute, bs{B}): "
          f"{ms:.4f} ms, {B / (ms / 1e3):.1f} img/s (plain attention: "
          f"{plain_ms:.4f} ms); peak memory {peak / 2 ** 30:.4f} GiB; "
          f"{total:.4f} ms of kernels per step, idle share "
          f"{max(0.0, 1 - total / ms):.4f}; B5 {b5_ms:.4f} ms "
          f"({b5_ms / ms:.4f} of a step), B4 {b4_ms:.4f} ms "
          f"({b4_ms / ms:.4f}); host calls per step {host} [{card}]")
    for e in events[:14]:
        print(f"  {e.device_time_total / steps / 1e3:9.4f} ms "
              f"x{e.count // steps:<4d} {e.key[:100]}")


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


# --- the CNN flagship ---------------------------------------------------------

def mixed_gate_state(dev, x, seed=0):
    """The flagship's weights from ``seed`` with every spatial masker made
    to close about half of its cells on the images ``x`` (a fresh model's
    open bias of 5 keeps nearly all of them): the two logit kernels are
    +v and -v with v drawn at unit scale and summing to zero over the
    channels, so the common level of the post-ReLU features cancels and
    the cells differ by what they hold; then, block after block in one
    forward, the keep-bias is set so that the median cell of ``x`` sits at
    the tie. Returned as an f32 state dict that every variant loads."""
    model = flagship(dev, seed=seed).eval()
    g = torch.Generator(dev).manual_seed(seed + 1)

    def centre(masker, args):
        conv = masker.conv
        pooled = masker.mask_size
        m = F.adaptive_avg_pool2d(args[0].float().permute(0, 3, 1, 2), pooled)
        logits = F.conv2d(m, conv.weight, conv.bias)
        conv.bias[0] -= (logits[:, 0] - logits[:, 1]).median()

    hooks = []
    with torch.no_grad():
        for blocks in model.stages():
            for block in blocks:
                conv = block.masker_spatial.conv
                v = torch.randn(conv.weight.shape[1], device=dev, generator=g)
                v -= v.mean()
                conv.weight[0, :, 0, 0] = v
                conv.weight[1, :, 0, 0] = -v
                conv.bias.zero_()
                hooks.append(block.masker_spatial.register_forward_pre_hook(
                    centre))
        model(x, 0.1)
    for h in hooks:
        h.remove()
    return model.state_dict()


def variant(state, dev, **kw):
    model = flagship(dev, seed=None, **kw).eval()
    model.load_state_dict(state)
    return model


def recorded_masks(model, x, forward=None):
    """One eval forward (``forward``, or the model's own call); returns the
    output and every spatial masker's mask (taken by forward hooks), in
    block order."""
    masks, hooks = [], []
    for blocks in model.stages():
        for block in blocks:
            hooks.append(block.masker_spatial.register_forward_hook(
                lambda m, args, out: masks.append(out[0].detach())))
    with torch.no_grad():
        out = forward(x) if forward else model(x, 0.1)
    for h in hooks:
        h.remove()
    return out, masks


def device_busy_ms(fn, reps):
    """Kernel time per call of ``fn`` over ``reps`` calls (`torch.profiler`)
    and the host's launch count per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.device_time_total for e in events
               if e.device_type.name == "CUDA") / reps / 1e3
    launches = sum(e.count for e in events
                   if e.key == "cudaLaunchKernel") / reps
    return busy, launches


def phase_cnn_serving(dev, card):
    # --- the entry point as a user calls it: batch 8, f32, fresh weights ---
    forward, (model, x8, temperature) = entry()
    logits = forward(model, x8, temperature)
    with torch.no_grad():
        out = model(x8, temperature)
    fp, gflops = out.flops_perc.mean().item(), out.flops.item() / 1e9
    print(f"entry(): logits {tuple(logits.shape)} {logits.dtype}, flops_perc "
          f"{fp:.4f}, GFLOPs {gflops:.4f} (fresh weights: gates open)")
    if (logits.shape != (8, 1000) or not torch.isfinite(logits).all()
            or not 0.85 <= fp <= 1.0 or not 3.5 <= gflops <= 4.3):
        raise AssertionError("entry(): bad logits or FLOPs bookkeeping")
    del model, out

    images = torch.randn(B, IMG, IMG, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    state = mixed_gate_state(dev, images[:32])
    x8 = images[:8]

    # --- f32 on the card against f32 on the CPU: the masks -----------------
    f32 = variant(state, dev)
    out_gpu, masks_gpu = recorded_masks(f32, x8)
    cpu = variant({k: v.cpu() for k, v in state.items()}, "cpu")
    out_cpu, masks_cpu = recorded_masks(cpu, x8.cpu())
    cells = sum(m.numel() for m in masks_cpu)
    same = sum((a.cpu() == b).sum().item() for a, b in zip(masks_gpu,
                                                           masks_cpu))
    torch.backends.cudnn.allow_tf32 = True   # what PyTorch does by default
    _, masks_tf32 = recorded_masks(   # past the model's own switch
        f32, x8, lambda x: f32._forward(x, 0.1, False, None))
    same_tf32 = sum((a.cpu() == b).sum().item() for a, b in zip(masks_tf32,
                                                                masks_cpu))
    _, rel = agreement(out_gpu.logits.cpu(), out_cpu.logits)
    print(f"f32 flagship, card vs CPU, batch 8: {same} of {cells} mask cells "
          f"equal ({same / cells:.6f}; with cuDNN's TF32 left on: "
          f"{same_tf32 / cells:.6f}), relative logit error {rel:.6g}, mask "
          f"density {out_cpu.spatial_s3_img[0].mean().item():.4f} in stage 1")
    if same / cells < MASK_AGREE_MIN:
        raise AssertionError("the f32 model's masks on the card differ from "
                             "the CPU's")

    # --- sparse execution at full capacity is the dense-masked graph (f32) -
    with torch.no_grad():
        sp32 = variant(state, dev, execution="sparse")(x8, 0.1)
    _, rel = agreement(sp32.logits, out_gpu.logits)
    print(f"f32 sparse execution at capacity 1.0 vs dense-masked: relative "
          f"logit error {rel:.6g} (bound {SPARSE_F32_REL})")
    if not rel <= SPARSE_F32_REL:
        raise AssertionError("sparse execution disagrees with dense-masked")
    del f32, cpu, sp32

    # --- bf16 at batch 128: dense-masked, sparse, W8A8, and dense ResNet-50
    bf16 = torch.bfloat16
    dense_masked = variant(state, dev, compute_dtype=bf16)
    runs = {
        "dense-masked": dense_masked,
        "sparse capacity 1.0": variant(state, dev, compute_dtype=bf16,
                                       execution="sparse"),
        "sparse capacity 0.5": variant(state, dev, compute_dtype=bf16,
                                       execution="sparse",
                                       patch_capacity=(0.5,) * 4),
        "int8": variant(state, dev, compute_dtype=bf16, conv_impl="int8"),
    }
    outs = {}
    with torch.no_grad():
        for name, model in runs.items():
            outs[name] = model(images, 0.1)
            if (outs[name].logits.shape != (B, 1000)
                    or not torch.isfinite(outs[name].logits).all()):
                raise AssertionError(f"flagship {name}: bad logits")
    ref = outs["dense-masked"]
    print(f"flagship bf16 bs{B}, half-closed gates: flops_perc "
          f"{ref.flops_perc.mean().item():.4f}, GFLOPs "
          f"{ref.flops.item() / 1e9:.4f}, stage densities "
          + ", ".join(f"{s.mean().item():.4f}" for s in ref.spatial_s3))
    # W8A8 is bounded on the fresh weights, whose open gates (bias 5) no
    # quantisation noise flips: there the distance is the arithmetic's. On
    # the half-closed gates, which sit at the tie by construction, the same
    # noise also moves cells across it, and the distance is reported.
    fresh = flagship(dev).state_dict()
    with torch.no_grad():
        outs["int8, open gates"] = variant(
            fresh, dev, compute_dtype=bf16, conv_impl="int8")(images, 0.1)
        fresh_ref = variant(fresh, dev, compute_dtype=bf16)(images, 0.1)
    del fresh
    for name, against, bound in (
            ("sparse capacity 1.0", ref, REL_ERR_MAX),
            ("int8, open gates", fresh_ref, INT8_REL_ERR_MAX),
            ("int8", ref, None)):
        top1, rel = agreement(outs[name].logits, against.logits)
        dens = (outs[name].flops_perc - against.flops_perc).abs().max().item()
        print(f"flagship {name} vs dense-masked bf16: relative logit error "
              f"{rel:.6g} (bound {bound}), top-1 agreement {top1:.4f} on a "
              f"random head, largest flops_perc difference {dens:.6g}")
        if bound is not None and not rel <= bound:
            raise AssertionError(f"flagship {name} is further from "
                                 "dense-masked than its bound")
    del fresh_ref
    _, rel = agreement(outs["sparse capacity 0.5"].logits, ref.logits)
    print(f"flagship sparse capacity 0.5 vs dense-masked: relative logit "
          f"distance {rel:.6g} (cells beyond the capacity fall back to the "
          f"identity)")
    del outs

    teacher = resnet50(compute_dtype=bf16,
                       generator=torch.Generator(dev).manual_seed(2)).eval()
    runs["dense ResNet-50 (no gates)"] = teacher
    with torch.no_grad():
        for name, model in runs.items():
            call = ((lambda m=model: m(images)) if model is teacher
                    else (lambda m=model: m(images, 0.1)))
            ms = time_ms(call, reps=4 if name == "int8" else 10, warmup=2)
            busy, launches = device_busy_ms(call, 2)
            print(f"flagship {name}: {ms:.4f} ms, {B / (ms / 1e3):.1f} img/s "
                  f"(bs{B} bf16); {busy:.4f} ms of kernels, idle share "
                  f"{max(0.0, 1 - busy / ms):.4f}, {launches:.0f} launches "
                  f"[{card}]")
    del runs, teacher

    # --- B3's own path, as the JAX bench drives it (``bench.py --pallas``):
    # width 1024 -> 2048 at 28x28, patch 7, batch 16, densities 0.5 and 0.25
    g = torch.Generator().manual_seed(4)
    name, b, hw, c, co, patch, _, caps = TAIL_SHAPES[0]
    for capacity in caps:
        t = tail_inputs(g, dev, b, hw, c, co, patch, capacity / 16)
        out, delta = counted(lambda: masked_block.masked_bottleneck_tail(
            **t, patch=patch, capacity=capacity))
        kept = (out != torch.relu(t["identity"])).any(-1).float().mean().item()
        print(f"B3 path ({name} shape, capacity {capacity}): output "
              f"{tuple(out.shape)} {out.dtype}, launches "
              f"{delta['masked_bottleneck_tail']}, {kept:.4f} of the pixels "
              f"differ from relu(identity)")
        if (delta["masked_bottleneck_tail"] != 1
                or not torch.isfinite(out.float()).all()
                or not 0.0 < kept <= capacity / 16):
            raise AssertionError("B3 path: bad output or launch count")

    # --- B3 on the real tensors of one stride-1 block of each stage --------
    for stage, blocks in enumerate(dense_masked.stages(), start=1):
        block = blocks[1]
        seen = []
        hook = block.register_forward_pre_hook(
            lambda m, args: seen.append(args[0]))
        with torch.no_grad():
            dense_masked(images, 0.1)
        hook.remove()
        tail_on_block(stage, block, seen[0], card)


@torch.no_grad()
def tail_on_block(stage, block, x, card):
    """B3 fed what ``block`` feeds its own sparse tail (x1 after bn1 and
    ReLU, the identity, the masker's cells, conv2 and conv3 with their
    BatchNorms folded), held against the block's own sparse execution."""
    cd = block.compute_dtype
    patch = block.mask_spatial_granularity
    block.execution, block.patch_capacity = "sparse", 1.0
    want, stats = block(x, 0.1)
    block.execution = "dense"
    x1 = torch.relu(block.bn1(conv_nhwc(block.conv1, x, cd),
                              use_running_average=True, compute_dtype=cd))
    cells = block.masker_spatial(x, 0.1)[0][..., 0]
    folded = [masked_block.fold_bn(bn.weight, bn.bias, bn.running_mean,
                                   bn.running_var, bn.eps)
              for bn in (block.bn2, block.bn3)]
    t = dict(x1=x1.contiguous(), identity=x.contiguous(), mask_cells=cells,
             w2=block.conv2.weight.permute(2, 3, 1, 0).to(cd).contiguous(),
             a2=folded[0][0], b2=folded[0][1],
             w3=block.conv3.weight[:, :, 0, 0].t().to(cd).contiguous(),
             a3=folded[1][0], b3=folded[1][1])
    capacity = block.sparse_capacity()
    got, delta = counted(lambda: masked_block.masked_bottleneck_tail(
        **t, patch=patch, capacity=capacity))
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    tol = REAL_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    mean = (got.float() - want.float()).abs().mean().item()
    ms = time_ms(lambda: masked_block.masked_bottleneck_tail(
        **t, patch=patch, capacity=capacity))
    block.execution = "sparse"
    own_ms = time_ms(lambda: block(x, 0.1))
    block.execution = "dense"
    whole_ms = time_ms(lambda: block(x, 0.1))
    print(f"B3 on layer{stage}_1's tensors {tuple(x1.shape)} -> "
          f"{t['identity'].shape[-1]}, patch {patch}, mask density "
          f"{cells.mean().item():.4f}: launches "
          f"{delta['masked_bottleneck_tail']}, vs the block's sparse "
          f"execution max_abs_err {err:.6g} (tol {tol:.6g}, mean {mean:.6g}); "
          f"B3 {ms:.4f} ms; the whole block sparse {own_ms:.4f} ms, "
          f"dense-masked {whole_ms:.4f} ms (conv1, masker and bookkeeping "
          f"included) [{card}]")
    if delta["masked_bottleneck_tail"] != 1 or not err <= tol:
        raise AssertionError(f"B3 on layer{stage}_1 disagrees with the "
                             "block's sparse execution")


CNN_TRAIN_ARGV = ["--arch", "uni_resnet50", "--amp", "--batch_size", str(B),
                  "--input_size", str(IMG), "--epochs", "1", "--print_freq",
                  "1", "--steps_per_epoch"]
# The repeated batch trains from scratch, without warm-up, towards a teacher
# of random weights: at the published recipe's rate (0.04 at batch 512, for
# fine-tuning a trained network) the first step throws the cross-entropy
# from 7 to 66 and 8 steps do not bring it back. Recipe 23 is the same
# optimizer at a quarter of the rate.
CNN_REPEAT_ARGV = CNN_TRAIN_ARGV + [str(TRAIN_STEPS),
                                    "--hyperparams_set_index", "23"]


def phase_cnn_train(dev, card):
    from laudnet_tpu_torch.train import main as train_main
    from laudnet_tpu_torch.train import optim

    # --- the entry point: a few steps, validation, checkpoint --------------
    with tempfile.TemporaryDirectory() as out_dir:
        best = train_main.main(CNN_TRAIN_ARGV + [str(CNN_TRAIN_STEPS),
                                                 "--train_url", out_dir])
        with open(f"{out_dir}/log.txt") as f:
            header, row = (line.strip().split(",") for line in f.readlines())
        log = open(f"{out_dir}/train.log").read()
        wrote = sorted(os.listdir(f"{out_dir}/ckpt"))
    print(f"train.main uni_resnet50: best top1 {best:.4f}; log.txt "
          f"{dict(zip(header, row))}; checkpoint files {wrote}")
    if (not all(math.isfinite(float(v)) for v in row) or "nan" in log
            or f"step_{CNN_TRAIN_STEPS}.pt" not in wrote):
        raise AssertionError("train.main uni_resnet50: a metric is not "
                             "finite or no checkpoint was written")

    # --- the same trainer on one repeated batch ----------------------------
    args = train_main.parse_args(CNN_REPEAT_ARGV)
    tr = train_main.build_training(args, lambda *a, **k: None)
    images, labels = next(train_main.synthetic_batches(B, IMG, 1000, 1,
                                                       seed=0))
    x, y = tr.to_device(images, labels)
    metrics = [{k: float(v) for k, v in tr.train_step(tr.state, x, y).items()}
               for _ in range(TRAIN_STEPS)]
    for i, m in enumerate(metrics):
        print(f"CNN train step {i}: " + ", ".join(
            f"{k} {m[k]:.6g}" for k in LOSS_PARTS + ("act_rate", "top1", "lr",
                                                     "temperature")))
        if not all(math.isfinite(m[k]) for k in LOSS_PARTS):
            raise AssertionError(f"CNN train step {i}: a loss part is not "
                                 "finite")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise AssertionError("the CNN loss did not fall on a repeated batch: "
                             f"{metrics[0]['loss']} -> {metrics[-1]['loss']}")
    stats = tr.model.layer1_0.bn1
    if not stats.running_mean.abs().max().item() > 0:
        raise AssertionError("BatchNorm statistics did not move")

    torch.cuda.reset_peak_memory_stats()
    step = lambda: tr.train_step(tr.state, x, y)
    ms = time_ms(step, reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    busy, launches = device_busy_ms(step, 2)
    print(f"CNN train step (LAUD-ResNet-50 4-4-2-1 + dense ResNet-50 teacher, "
          f"bf16 compute, bs{B}): {ms:.4f} ms, {B / (ms / 1e3):.1f} img/s; "
          f"{busy:.4f} ms of kernels, idle share "
          f"{max(0.0, 1 - busy / ms):.4f}, {launches:.0f} launches a step; "
          f"peak memory {peak / 2 ** 30:.4f} GiB [{card}]")
    del tr

    # --- the dense ResNet-50's cross-entropy step, the same optimizer ------
    dense = resnet50(compute_dtype=torch.bfloat16,
                     generator=torch.Generator(dev).manual_seed(0))
    opt = optim.make_sgd(dense)
    optim.set_learning_rate(opt, 0.01)

    def dense_step():
        loss = F.cross_entropy(dense(x, training=True).float(), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss

    torch.cuda.reset_peak_memory_stats()
    dms = time_ms(dense_step, reps=5, warmup=1)
    dpeak = torch.cuda.max_memory_allocated()
    dbusy, dlaunches = device_busy_ms(dense_step, 2)
    print(f"dense ResNet-50 cross-entropy step (bf16 compute, bs{B}): "
          f"{dms:.4f} ms, {B / (dms / 1e3):.1f} img/s; {dbusy:.4f} ms of "
          f"kernels, idle share {max(0.0, 1 - dbusy / dms):.4f}, "
          f"{dlaunches:.0f} launches; peak memory {dpeak / 2 ** 30:.4f} GiB; "
          f"the LAUD step is {ms / dms:.4f}x as long [{card}]")


REPLACES = {
    "fused_vit_block": "laudnet_tpu/ops/pallas/vit_block.py:303",
    "fused_vit_segment": "laudnet_tpu/ops/pallas/vit_block.py:472",
    "fused_vit_block_int8": "laudnet_tpu/ops/pallas/vit_block.py:175",
    "fused_vit_attention": "laudnet_tpu/ops/pallas/vit_attention.py:194",
    "fused_vit_attention_bwd": "laudnet_tpu/ops/pallas/vit_attention.py:335",
    "masked_bottleneck_tail": "laudnet_tpu/ops/pallas/masked_block.py:176",
}
SOURCES = {"fused_vit_attention_bwd": SRC_BWD,
           "masked_bottleneck_tail": SRC_TAIL}


def main():
    card = phase_device()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build()
    if sys.argv[1:] == ["profile"]:
        phase_profile(dev, card)
        return
    if sys.argv[1:] == ["cnn"]:
        phase_tail_kernel(dev, card, {})
        phase_cnn_serving(dev, card)
        phase_cnn_train(dev, card)
        print(f"CNN phases passed in {time.perf_counter() - t0:.1f} s")
        return
    results = phase_kernels(dev, card)
    if sys.argv[1:] == ["kernels"]:
        print(f"kernel phases passed in {time.perf_counter() - t0:.1f} s")
        return
    if sys.argv[1:] == ["train"]:
        phase_train(dev, card)
        print(f"training phase passed in {time.perf_counter() - t0:.1f} s")
        return
    deit32, deit, images, deit_rates = phase_slice(dev, card)
    phase_slice2(dev, card, deit32, deit, images, deit_rates)
    del deit32, deit, images
    phase_train(dev, card)
    phase_cnn_serving(dev, card)
    phase_cnn_train(dev, card)
    launches = MAIN_PATH_LAUNCHES
    kernels = []
    for name, rows in results.items():
        # the numbers at the serving shape (DeiT-S, the longest L, fast_math
        # where the kernel has it)
        row = next(r for r in rows if r["label"] == "serving")
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES.get(name, SRC),
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
