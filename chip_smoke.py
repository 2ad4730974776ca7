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
3. kernels vs plain: the GEMM core (`csrc/gemm_sm90.cuh`) that B1, B2,
   B6, P1 and P2 run their products on, one product at a time at DeiT-S
   bs128 (qkv, proj, fc1, fc2 with their epilogues, bf16 and s8), each
   timed in turns with `F.linear` or `torch._int_mm` on the same operands,
   with its TFLOP/s or TOP/s and its bound, and each of its row epilogues
   (proj with LN2, bf16 and s8; fc2 with the next token gate and LN1; the
   s8 fc1 with its row quantiser: the core's cluster form) timed in turns
   with the two launches it replaces, with the clusters the card fits;
   `lt_attention`'s two forwards in turns at L = 98-197 (the split it
   routes by); B1 (`fused_vit_block`, also
   with a head gate), B2
   (`fused_vit_segment`), B6 (`fused_vit_block_int8`), B4
   (`fused_vit_attention`) and B5 (its backward) against their plain
   PyTorch versions at DeiT-S and T2T-ViT-19 shapes (B4 and B5 also at a
   ragged L = 137, at L = 257 and 577, DeiT-S at 256^2 and 384^2, and in
   f32), with times, bounds and, for B4 and B5, the time of PyTorch's own
   fused attention call (forward, backward) timed in turns with them, its
   backend named; B3
   (`masked_bottleneck_tail`) at
   the shape of the JAX bench (B=16, 28x28, 1024 -> 2048, patch 7) and at
   the flagship's four stride-1 block shapes at batch 128, with its
   kernels' device time and launches a call, beside the dense
   tail through cuDNN and the gather -> cuDNN -> scatter tail; its
   selection kernel bit for bit against `reference_select_cells`; B3 in
   f32, at ragged widths, C = 2560, patches 3 and 14 and capacity 1;
4. DeiT-S serving: LAUD-DeiT-S (12 layers, D=384, 6 heads of 64) four ways
   (nominal, snapped and flat-0.5 caps, and dense) through the kernels,
   with launch counts, token counts, agreement with the same engine on
   the plain versions, and img/s;
5. the rest of ViT serving: LAUD-T2T-ViT-19 (performer stem, 14 layers,
   D=448, 7 heads of 64, hidden 1344) dense and with selection; DeiT-S
   W8A8 (`int8=True`) dense and with selection; DeiT-S with head gates;
   `LAUDViT(attn_impl='fused')` eval, bf16 and f32; the DeiT-S block
   engine at 256^2 and 384^2 input (257 and 577 tokens), exact and
   fast_math;
6. DeiT-S training: ``train.main.main(--arch laud_deit_small --vit_attn
   fused --amp --batch_size 128)`` for 8 steps on synthetic data, with B4
   and B5 launch counts; then the same trainer on a repeated batch (the
   loss must fall), its first step held against the same step through the
   plain attention (metrics and the gradients that B5 feeds); 2 f32 steps
   (``--vit_attn fused`` without ``--amp``) through the CLI, the first
   held to the plain attention; and step time, img/s, peak memory and
   B4's and B5's share of a step;
7. CNN serving: the masked forwards (flagship f32 and bf16, channel and
   layer mode) under ``torch.cuda.set_sync_debug_mode("error")``; the
   flagship LAUD-ResNet-50 (`entry()`, then bs128 bf16
   dense-masked, sparse, W8A8, the f32 masks against the CPU's, B3 on one
   stride-1 block per stage);
8. CNN training: ``train.main.main(--arch uni_resnet50 --amp)``;
9. the probes, short: P1 (`tools/probe_block_budget.py`, the ``full`` and
   ``fast_tanh`` bodies) and P2 with every s8 rate
   (`tools/probe_int8.py --quick`); phase 3 also holds P1 (each carried
   body variant of B1 within ULPS of its plain version) and P2 (bit for
   bit the integer product, at n = 4096 and a ragged shape, timed in turns
   with `torch._int_mm`) against their plain versions;
10. the serving engine (`infer/engine.py::ServingEngine`): calibrate, plan
    and serve LAUD-DeiT-S with live token gates, the flagship, a
    channel-mode LAUD-ResNet-50 (static export behind its fidelity gate,
    int8 allowed) and batch-1 layer skip (`infer/layerskip.py`, a
    layer-mode LAUD-ResNet-50 and a layer-gated DeiT-S through B4; an
    f32 LAUD-DeiT-S served through B4); served
    logits against the directly built path, each timed CNN form against
    the dense-masked graph (and each configured copy against the model
    built with its options), and the latency model's
    predicted ms beside the measured ms of every ranked mode the port
    serves (an order the prediction reverses by more than ORDER_GAP
    fails);
11. LAUD-RegNetY-1.6GF (published widths, the repo's channel 2-2-2-2
    recipe, bs128 bf16): served through `ServingEngine` (the no-ranking
    dense-masked plan), timed with the gates open and with half the
    channel groups closed beside the static RegNetY-1.6GF, the bf16 and
    f32 forwards under ``torch.cuda.set_sync_debug_mode("error")``, the f32
    channel masks against the CPU's, and trained
    (``train.main.main(--arch lad_regnet_y_1_6gf --amp ... --lr_mult
    0.1)``: 4 steps through the CLI, 8 on a repeated batch with the loss
    falling, step ms, idle share, peak memory);
12. serving artifacts (`infer/aot.py`): the DeiT-S block engine dense and
    snapped, its int8 engine, `LAUDViT(attn_impl='fused')` and the RegNet
    exported, saved and served by one fresh process with no model code
    (`tools/serve_artifact.py`): logits bit for bit the live models', the
    port's kernels the same by name and count, another batch refused; and
    the registered op's host µs a call over its CUDA implementation
    called directly;
13. the GPU roofline simulator's CLI (`python -m
    laudnet_tpu_torch.sim.cli`), ResNet-50 on the V100 preset and a DeiT-S
    plan on the H100 model;
14. real input and reference checkpoints: what the host offers the image
    pipelines (PIL, g++, libjpeg's header and library, cores); an image
    folder of 10 classes (400 train, 130 val JPEGs of 160-500 px, some
    grayscale, one PNG) in a temporary directory; the PIL loader and,
    where it builds, the native C++ loader alone (img/s at bs128 224^2, the
    native one held to PIL within the JAX test's bounds); DeiT-S trained
    from the folder through ``train.main.main(... --data_url DIR)`` for one
    epoch (3 steps, validation with a padded last batch: B4 and B5 counted,
    the logged pipeline the one that builds), the step fed by the loader
    timed beside the same step on a batch already on the card (kernel
    time, idle share, peak memory); reference ``.pth.tar`` files of a dense
    ResNet-50 and the flagship written by the port's `save_pth_tar`, read
    back by ``--teacher_path`` and ``--finetune_from`` (f32 logits bit for
    bit the source models'), a fine-tuning run of the flagship on the
    folder, ``--evaluate_from`` on the flagship file (the source model's
    top-1) and on a timm-named DeiT-S file (the policy heads merged);
15. parallel (`laudnet_tpu_torch/parallel/`): ``train.main.main`` over a
    group of one NCCL rank (``--dist_*``), plain and ``--fsdp``, 3 steps
    each (B4 and B5 counted, losses finite), the first step of each held
    to the step without ``--dist_*`` at TRAIN_REL; the snapped DeiT-S
    engine over a one-rank mesh (logits bit for bit the engine without
    one); B4 and B5 on the local heads of tp = 2, 3 and 6 (DeiT-S bs128,
    L=197, a head gate) within ULPS of their plain versions, the ranks'
    outputs joined against the all-heads launch; then which collectives
    gloo takes on CUDA tensors in two processes on the card
    (`tools/probe_dist.py`), and the dry run's legs those allow
    (`entry.dryrun_multichip(2, device='cuda', backend='gloo',
    full_width=True)`: DeiT-S at full width on a dp1 x tp2 mesh, then its
    dp and fsdp legs again on a dp2 x tp1 mesh, so the data group's
    exchanges run across the two ranks (the fsdp one where the probe's
    whole FSDP2 step passes); each leg held to one process on the whole
    batch, PARALLEL_BOUNDS);
16. the CNN detectors (`laudnet_tpu_torch/detection/`, no port kernel on
    their path, which the phase asserts): an ImageNet-format LAUD-R101
    file and a COCO-format directory written first; (a) the CLI's
    ``train`` (``--amp``, 3 steps) then ``eval_info`` (2 batches) at
    800x1344 bs2 from that file, RetinaNet on synthetic data and Mask
    R-CNN on the directory (box and segm mAP); (b) full depth at 256x384,
    f32, card against CPU: raw outputs, gate masks, ``detect``,
    ``propose`` and ``roi_align`` bit for bit, the first training step on
    the same Gumbel draws; (c) JAX's reduced-depth convergence recipe; (d)
    RetinaNet, Faster and Mask R-CNN at 800x1344 bs2: eval forward bf16
    and f32, detect with its kernels and NMS ms, the ``--amp`` step, kernel
    ms, kernels, idle share, peak memory; the forwards and detects under
    ``torch.cuda.set_sync_debug_mode("error")``;
17. the DETR family (`detection/detr.py`, no port kernel on its path,
    which the phase asserts), f32 as DETR runs: ImageNet-format LAUD-R101
    files (channel and layer mode) and the COCO directory of phase 16's
    helpers; (a) the CLI's ``train`` (3 steps) then ``eval_info`` (2
    batches), DDQ-DETR channel 2-2-2-2 at 800x1344 bs2 on synthetic data
    and Mask2Former layer at 1024x1024 bs2 on the directory; (b) full depth
    at 256x384 / 256x256, card against CPU: raw outputs and the first
    step's loss parts on the same draws within DETR_F32_REL,
    ``detr_detect``, ``nms_keep_mask`` and the Hungarian assignment bit
    for bit; (c) both forms at depth 1-1-1-1 on one repeated batch, the
    loss falling below DETR_CONVERGE x its first; (d) both at full size:
    eval forward, detect, the DDQ initialisation's NMS, a keep mask, the
    Hungarian host copy, the train step, kernel ms, kernels, idle share,
    peak memory, the kernels with the most device time; the forwards and
    detects under ``torch.cuda.set_sync_debug_mode("error")``.

Prints a JSON line of the kernels, then as its last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX. Nothing runs at
a cut depth but the convergence runs of phases 16 and 17 (depth 1-1-1-1).

``python3 chip_smoke.py kernels`` stops after phase 3 (a short run to check
a changed kernel), ``python3 chip_smoke.py train`` runs phases 1-3 and 6,
``python3 chip_smoke.py cnn`` runs phases 1-2, B3's part of 3, 7 and 8,
``python3 chip_smoke.py probes`` runs phases 1-2 and both probes in full
(every mode set, the stage breakdown, the launch costs of
`tools/probe_host.py`), ``python3 chip_smoke.py engine`` runs phases 1-2
and 10, ``python3 chip_smoke.py regnet`` phases 1-2 and 11-13,
``python3 chip_smoke.py data`` phases 1-2 and 14, ``python3 chip_smoke.py
parallel`` phases 1-2 and 15, ``python3 chip_smoke.py detection`` phases
1-2 and 16, ``python3 chip_smoke.py detr`` phases 1-2 and 17, and
``python3 chip_smoke.py profile`` prints, instead of
the phases, where a forward's device time goes (`torch.profiler`, by
kernel) for the dense and snapped DeiT-S, W8A8 DeiT-S and T2T-ViT-19
engines. None of
these prints a result line.
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

import numpy as np
import torch
import torch.nn.functional as F

from laudnet_tpu_torch.entry import entry, flagship
from laudnet_tpu_torch.infer.engine import ServingEngine, configured
from laudnet_tpu_torch.infer.fused_vit import _patchify, build_fused_vit
from laudnet_tpu_torch.models import (lad_regnet_y_1_6gf, laud_deit_small,
                                      laud_t2t_vit_19, regnet_static,
                                      resnet50, uni_resnet50)
from laudnet_tpu_torch.models.laud_resnet import conv_nhwc
from laudnet_tpu_torch.ops import (_build, masked_block, s8_gemm, sparse,
                                   vit_attention, vit_block)
from laudnet_tpu_torch.tools import (probe_block_budget, probe_host,
                                     probe_int8, serve_artifact)
# B3's five shapes (name, B, H = W, C, Co, patch, mask density, capacities),
# their inputs and its kernels' device time, as the build comparison has them
from laudnet_tpu_torch.tools.compare_b3_build import SHAPES as TAIL_SHAPES
from laudnet_tpu_torch.tools.compare_b3_build import device as b3_device
from laudnet_tpu_torch.tools.compare_b3_build import inputs as tail_inputs
from laudnet_tpu_torch.tools.timing import chain_times

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
# csrc/vit_block.cu::ATT_ROUTE_EXACT / ATT_ROUTE_DEFERRED: lt_attention's
# exact (0) and deferred (1) forms run attention.cu's streaming forward
# from this many keys on
ROUTE_L = {0: 129, 1: 145}
SRC_S8 = "laudnet_tpu_torch/csrc/probe_int8.cu"
SRC_TAIL = "laudnet_tpu_torch/csrc/masked_block.cu"
SRC_ATT = "laudnet_tpu_torch/csrc/attention.cu"
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
F32_TRAIN_STEPS = 2
# An f32 LAUDViT through B4 against the same model through the reference
# attention: both f32, apart by the attention's summation order (~1e-6 of
# an activation); a token gate at an f32 tie could flip one token, which
# moves an image's logits by far less than this bound over the batch.
F32_MODEL_REL = 1e-3
# B4 and B5 in f32 against their f32 plain versions: full f32 sums on both
# sides in other orders, so at most F32_REL of the largest output entry;
# TF32 products (10 mantissa bits) would be off by ~1e-3 of it and fail.
F32_REL = 1e-4
# Published dense peaks of the H100 SXM (NVIDIA data sheet) for the bounds;
# f32 outside the tensor cores for the f32 attention.
PEAK_BF16, PEAK_S8, PEAK_HBM, PEAK_F32 = 989e12, 1979e12, 3.35e12, 67e12


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
    """Builds the kernels and prints, per compiled kernel, what ptxas said:
    registers, spills, and any warning (a setmaxnreg it ignored)."""
    path, secs, log = _build.build()
    _build.library()
    print(f"build: {path.name} in {secs:.1f} s")
    name, facts = None, []
    for line in log.splitlines() + ["ptxas info    : Compiling entry function"]:
        line = line.strip()
        if "Compiling entry function" in line:
            if name is not None:
                print(f"  ptxas: {name[:110]}: {'; '.join(facts)}")
            name, facts = line.split("'")[1] if "'" in line else None, []
        elif "spill" in line or "Used" in line or "warning" in line:
            facts.append(line.replace("ptxas info    : ", ""))


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of fn(), after warm-up."""
    return statistics.median(chain_times(fn, 1, reps, warmup))


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


def attention_bound(l, d, heads, gated, b=B, f32=False):
    """As `block_bound`, for the attention forward alone: 4*b*H*l*l*64
    operations in bf16 (f32: on the CUDA cores); qkv read once, the output
    written once, masks."""
    m, size = b * l, 4 if f32 else 2
    ops_s = 4 * b * heads * l * l * 64 / (PEAK_F32 if f32 else PEAK_BF16)
    bytes_s = (m * 3 * d * size + m * d * size + m * 4
               + (b * heads * 4 if gated else 0)) / PEAK_HBM
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def attention_bwd_bound(l, d, heads, gated, b=B, f32=False):
    """As `attention_bound`, for the backward: five products of 2*l*l*64
    operations per image and head (dV, dP, dQ, dK and S, whose statistics
    the forward hands over; a sixth, P.V, for the gate's gradient); qkv,
    dO and the forward's row statistics read once, dqkv written once,
    masks."""
    m, size = b * l, 4 if f32 else 2
    ops_s = ((6 if gated else 5) * 2 * b * heads * l * l * 64
             / (PEAK_F32 if f32 else PEAK_BF16))
    bytes_s = (2 * m * 3 * d * size + m * d * size + m * 4
               + b * heads * l * 8
               + (2 * b * heads * 4 if gated else 0)) / PEAK_HBM
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


def in_turns(fn, library, rounds=3, reps=10, chain=10):
    """Kernel and yardstick timed in rounds of kernel, library, library,
    kernel: the medians of each side's readings. A reading is a chain of
    ``chain`` back-to-back calls between two CUDA events, so that each
    call's host work (a Python wrapper, PyTorch's dispatch) hides under
    the previous call's device time and the two sides compare as
    kernels."""
    k, lib = [], []
    for _ in range(rounds):
        for side, f in ((k, fn), (lib, library), (lib, library), (k, fn)):
            side.append(statistics.median(chain_times(f, chain, reps, 2)))
    return statistics.median(k), statistics.median(lib)


def compare(tag, fn, ref_fn, card, results, key, label, bound, library=None,
            f32=False, plain_reps=20):
    """Runs kernel and plain once, checks the bound (ULPS bf16 ulps, or
    F32_REL of the largest entry for ``f32``), times both (the kernel in
    turns with the library yardstick where there is one), records a
    row."""
    out, ref = fn(), ref_fn()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (F32_REL * ref.float().abs().max().item() if f32
           else ulp_tol(ref))
    if library is None:
        ms, lib_ms = time_ms(fn), None
    else:
        ms, lib_ms = in_turns(fn, library)
    plain_ms = time_ms(ref_fn, reps=plain_reps, warmup=1)
    bound_ms, bound_by = bound
    print(f"{tag}: max_abs_err {err:.6g} (tol {tol:.6g}); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}"
          + ("" if lib_ms is None else f", library {lib_ms:.4f} ms (in "
             f"turns)") + f" [{card}]")
    if not err <= tol:
        raise AssertionError(f"{tag} disagrees with plain: {err} > {tol}")
    results[key].append(dict(label=label, err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms))


def sdpa_backend(fn):
    """The device kernels one call of ``fn`` launches (`torch.profiler`):
    which of PyTorch's attention backends served it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type.name == "CUDA"})
    return "; ".join(n[:80] for n in names)


def tail_selection(mask_cells, capacity):
    """(B, Hm, Wm) bool: the cells the tail computes, the first ``capacity``
    active ones of each image in raster order."""
    b = mask_cells.shape[0]
    active = mask_cells.reshape(b, -1) > 0.5
    return (active & (active.cumsum(1) <= capacity)).reshape(mask_cells.shape)


def tail_bound(t, patch, capacity):
    """Least time (ms) for THIS mask: two products on the selected pixels
    (bf16 on the tensor cores, f32 at the CUDA cores' rate) against the
    bytes that must move: the x1 pixels within one pixel of a selected
    cell, identity and the output whole, both weights, the mask."""
    b, hw, _, c = t["x1"].shape
    co = t["identity"].shape[-1]
    size = t["x1"].element_size()
    chosen = tail_selection(t["mask_cells"], capacity)
    pix = chosen.repeat_interleave(patch, 1).repeat_interleave(patch, 2)
    rows = int(pix.sum())
    halo = F.max_pool2d(pix[:, None].float(), 3, 1, 1)
    peak = PEAK_F32 if size == 4 else PEAK_BF16
    ops_s = 2 * rows * (9 * c * c + c * co) / peak
    moved = (int(halo.sum()) * c * size + 2 * b * hw * hw * co * size
             + (9 * c * c + c * co) * size + (c + co) * 8
             + chosen.numel() * 4)
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
    """B3 against its plain version on ``t``: the ULPS bound (F32_REL of
    the largest entry in f32), the cells it does not select equal to
    relu(identity) bit for bit, and the selection kernel bit for bit its
    plain version. Timed unless ``timed`` is False: single calls through
    the wrapper, its kernels' device time and launches per call, beside
    the plain version and the two yardsticks. Returns the row."""
    kw = dict(patch=patch, capacity=capacity)
    kernel = lambda: masked_block.masked_bottleneck_tail(**t, **kw)
    plain = lambda: masked_block.reference_masked_bottleneck_tail(**t, **kw)
    out, ref = kernel(), plain()
    sel = masked_block.select_cells(t["mask_cells"], capacity)
    sel_ref = masked_block.reference_select_cells(t["mask_cells"], capacity)
    torch.cuda.synchronize()
    f32 = out.dtype == torch.float32
    err = (out.float() - ref.float()).abs().max().item()
    tol = F32_REL * ref.float().abs().max().item() if f32 else ulp_tol(ref)
    chosen = tail_selection(t["mask_cells"], capacity)
    pix = chosen.repeat_interleave(patch, 1).repeat_interleave(patch, 2)
    rest_equal = torch.equal(out[~pix], torch.relu(t["identity"])[~pix])
    sel_equal = all(torch.equal(a, b) for a, b in zip(sel, sel_ref))
    (bound_ms, bound_by), rows = tail_bound(t, patch, capacity)
    line = (f"{tag}: {int(chosen.sum())} of {chosen.numel()} cells selected "
            f"({rows} rows), max_abs_err {err:.6g} (tol {tol:.6g}), other "
            f"cells equal relu(identity): {rest_equal}, selection kernel "
            f"equal to its plain version: {sel_equal}")
    row = None
    if timed:
        ms, plain_ms = time_ms(kernel), time_ms(plain, reps=5, warmup=1)
        dev_ms, per_call, by_kernel = b3_device(kernel)
        lib_ms = sparse_ms = None
        line += (f"; kernel {ms:.4f} ms (device "
                 + ("not measured: the profiler dropped its events"
                    if dev_ms is None else
                    f"{dev_ms:.4f} ms, {per_call} launches a call: "
                    + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()))
                 + f"), plain {plain_ms:.4f} ms, "
                 f"bound {bound_ms:.4f} ms by {bound_by}")
        if not f32:
            lib_ms = time_ms(dense_tail(t, patch))
            sparse_ms = time_ms(sparse_tail(t, patch, capacity))
            line += (f", dense tail through cuDNN {lib_ms:.4f} ms, "
                     f"gather/cuDNN/scatter tail {sparse_ms:.4f} ms")
        line += f" [{card}]"
        row = dict(label=label, err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                   device_ms=dev_ms)
        if rows_out is not None:
            rows_out.append(row)
        if per_call is not None and per_call > 2:
            raise AssertionError(f"{tag}: {per_call} kernels a call, not 2")
    print(line)
    if not err <= tol or not rest_equal or not sel_equal:
        raise AssertionError(f"{tag} disagrees with plain")
    return row


# B3 beyond the five shapes, each against its plain version once: f32 (the
# FFMA kernel), ragged widths (padded to 8 by the wrapper), a width above
# 2048 and patches outside {1, 2, 4, 7}: name, B, H = W, C, Co, patch,
# dtype
TAIL_EXTRA = (
    ("f32 stage1", 8, 56, 64, 256, 4, torch.float32),
    ("f32 stage4", 32, 7, 512, 2048, 1, torch.float32),
    ("ragged 200->88", 8, 28, 200, 88, 4, torch.bfloat16),
    ("ragged 24->20", 8, 8, 24, 20, 2, torch.bfloat16),
    ("ragged 24->20 f32", 8, 8, 24, 20, 2, torch.float32),
    ("C=2560", 4, 7, 2560, 512, 1, torch.bfloat16),
    ("patch 3", 8, 24, 64, 256, 3, torch.bfloat16),
    ("patch 14", 8, 28, 128, 512, 14, torch.bfloat16),
)


def phase_tail_kernel(dev, card, results):
    """B3 at the bench's shape and the flagship's four, each at two
    capacities (timed); the bench shape in f32 (timed); f32, ragged widths,
    C = 2560 and patches 3 and 14; then an all-active mask, an all-zero
    mask, a capacity that binds and capacity 1."""
    g = torch.Generator().manual_seed(3)
    rows = results.setdefault("masked_bottleneck_tail", [])
    bench = []
    for name, b, hw, c, co, patch, density, caps in TAIL_SHAPES:
        n_cells = (hw // patch) ** 2
        for i, capacity in enumerate(caps):
            # the bench draws its mask at the density its capacity stands for
            dens = density if density else capacity / n_cells
            t = tail_inputs(g, dev, b, hw, c, co, patch, dens)
            row = check_tail(
                f"B3 masked_bottleneck_tail {name} B={b} {hw}x{hw} {c}->{co} "
                f"patch {patch} density {dens:g} capacity {capacity}", t,
                patch, capacity, card, rows,
                label="serving" if (name, i) == ("bench", 0) else name)
            if name == "bench":
                bench.append((dens, row))
                if i == 0:
                    t32 = {k: (v.float() if v.dtype == torch.bfloat16 else v)
                           for k, v in t.items()}
                    check_tail(f"B3 masked_bottleneck_tail {name} f32 "
                               f"capacity {capacity}", t32, patch, capacity,
                               card)
                    del t32
            del t
    print("JAX bench ratio, dense tail through cuDNN / B3: " + ", ".join(
        f"{r['library_ms'] / r['ms']:.4f} (wrapper), "
        + ("device not measured" if r["device_ms"] is None else
           f"{r['library_ms'] / r['device_ms']:.4f} (device)")
        + f" at density {d:g}" for d, r in bench) + f" [{card}]")
    for name, b, hw, c, co, patch, dtype in TAIL_EXTRA:
        t = tail_inputs(g, dev, b, hw, c, co, patch, 0.5)
        t = {k: (v.to(dtype) if v.dtype == torch.bfloat16 else v)
             for k, v in t.items()}
        n_cells = (hw // patch) ** 2
        for capacity in (max(1, n_cells // 3), n_cells):
            check_tail(f"B3 masked_bottleneck_tail {name} B={b} {hw}x{hw} "
                       f"{c}->{co} patch {patch} capacity {capacity}", t,
                       patch, capacity, card, timed=False)
        del t
    t = tail_inputs(g, dev, 128, 28, 128, 512, 4, 0.6)
    for kind, mask, capacity in (
            ("all-active mask", torch.ones_like(t["mask_cells"]), 49),
            ("all-zero mask", torch.zeros_like(t["mask_cells"]), 49),
            ("binding capacity 5 of ~29 active", t["mask_cells"], 5),
            ("capacity 1", t["mask_cells"], 1)):
        check_tail(f"B3 masked_bottleneck_tail stage2 {kind}",
                   dict(t, mask_cells=mask), 4, capacity, card, timed=False)


def phase_probe_kernels(dev, card, results):
    """P2 (the s8 GEMM) bit for bit against its plain version at n = 4096
    and a ragged shape, timed in turns with `torch._int_mm`; P1 (B1's body
    variants) at
    the JAX probe's shape (B=128, L=197, D=384): each carried mode within
    ULPS of its plain version. (That the production bodies are the
    parent commit's B1 bit for bit is shown by
    `tools/compare_b1_build.py`, which needs the other source.)"""
    g = torch.Generator().manual_seed(5)
    for m, k, n, label in ((4096, 4096, 4096, "serving"),
                           (1000, 1040, 776, "")):
        a = torch.randint(-127, 128, (m, k), generator=g,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (n, k), generator=g,
                          dtype=torch.int8).to(dev)
        out = s8_gemm.s8_gemm(a, w.t())
        ref = s8_gemm.s8_gemm_reference(a, w.t())
        if not torch.equal(out, ref):
            raise AssertionError(f"P2 s8_gemm {m}x{k}x{n} differs from the "
                                 "integer product")
        kernel = lambda: s8_gemm.s8_gemm(a, w.t())
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            ms, lib_ms = in_turns(kernel, lambda: torch._int_mm(a, w.t()))
        else:
            ms, lib_ms = time_ms(kernel), None
        plain_ms = time_ms(lambda: s8_gemm.s8_gemm_reference(a, w.t()),
                           reps=5)
        ops_s = 2.0 * m * n * k / PEAK_S8
        bytes_s = (m * k + n * k + 4 * m * n) / PEAK_HBM
        bound, by = (max(ops_s, bytes_s) * 1e3,
                     "operations" if ops_s >= bytes_s else "bytes")
        print(f"P2 s8_gemm {m}x{k} @ {k}x{n}: bit-equal to the integer "
              f"product; kernel {ms:.4f} ms ({2.0 * m * n * k / ms / 1e9:.1f} "
              f"TOP/s), plain {plain_ms:.4f} ms, bound {bound:.4f} ms by "
              f"{by}" + ("" if lib_ms is None else
                         f", torch._int_mm {lib_ms:.4f} ms "
                         f"({2.0 * m * n * k / lib_ms / 1e9:.1f} TOP/s; in "
                         f"turns)") + f" [{card}]")
        results["s8_gemm"].append(dict(
            label=label, err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=lib_ms))

    params, x = probe_block_budget.probe_params(dev)
    bb, l, d, heads = x.shape[0], x.shape[1], x.shape[2], probe_block_budget.H
    hidden = params["fc1"]["weight"].shape[0]
    ones = torch.ones(bb, l, device=dev)
    args = (x, ones.reshape(bb, 1, l), ones.reshape(bb, l, 1), params)
    for mode, v in probe_block_budget.MODES.items():
        def kernel(v=v):
            return vit_block.fused_vit_block(*args, num_heads=heads,
                                             variant=v)

        def plain(v=v):
            return vit_block.fused_vit_block_reference(
                x, ones, ones, params, num_heads=heads, variant=v)

        compare(f"P1 fused_vit_block variant {mode} D={d} L={l}"
                + (" (B1's production body)"
                   if v in (vit_block.EXACT, vit_block.FAST) else ""),
                kernel, plain, card, results, "block_variant",
                "serving" if mode == "full" else "",
                block_bound(l, d, heads, hidden))


PRODUCTS = ("qkv", "proj", "fc1", "fc2")


def product_bound(name, m, d, hidden, s8):
    """Least time (ms) of one of a layer's four products with its epilogue
    on (m, d) rows: operations over the tensor-core peak of the operand
    type; bytes over the memory rate: A and W read once (s8: with their f32
    scales), the bias, the output written once (qkv and fc2 bf16, proj f32,
    fc1 bf16 or, s8, f32), the residual (proj bf16 x, fc2 f32 x2) and the
    row mask read once. The row epilogues (`vit_block.ROW_EPILOGUES`): the
    LayerNorm's weights read and its output written (proj_ln: h2 bf16 or,
    s8, codes and f32 scales; fc2_ln: h1 bf16, the gate's weights, the mask
    written), fc1_q's codes and scales in place of its f32 output."""
    base = vit_block.ROW_PRODUCT.get(name, name)
    n, k = {"qkv": (3 * d, d), "proj": (d, d), "fc1": (hidden, d),
            "fc2": (d, hidden)}[base]
    size = 1 if s8 else 2
    out = 4 if base == "proj" or (s8 and base == "fc1") else 2
    if name == "fc1_q":
        out = 1
    moved = (m * k + n * k) * size + n * 2 + m * n * out
    if name in ("proj_ln", "fc2_ln"):
        moved += 2 * n * 2 + m * n * (1 if s8 else 2)
    if name == "fc2_ln":
        moved += 2 * n * 2 + m * 4
    if name in ("fc1_q", "proj_ln") and s8:
        moved += m * 4
    name = base
    if s8:
        moved += (m + n) * 4
    if name in ("proj", "fc2"):
        moved += m * n * (2 if name == "proj" else 4) + m * 4
    ops_s = 2.0 * m * n * k / (PEAK_S8 if s8 else PEAK_BF16)
    bytes_s = moved / PEAK_HBM
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def phase_products(dev, card):
    """The GEMM core (`csrc/gemm_sm90.cuh`) one product at a time at
    DeiT-S bs128 (M = 25,216): qkv, proj, fc1 and fc2 with their epilogues
    (`vit_block.block_gemm`), bf16 and s8, each within ULPS of its plain
    version and timed in turns with one library call on the same operands:
    `F.linear` (cuBLAS, bf16 out, no epilogue beyond the bias) and
    `torch._int_mm` (s32 out, no epilogue). Returns the rows."""
    from laudnet_tpu_torch.ops.quant import quantize_rows, quantize_weight

    g = torch.Generator().manual_seed(9)
    m, d, hidden = B * L_FULL, DEIT["d"], DEIT["hidden"]
    lib = _build.library()
    rows = []
    for name in PRODUCTS:
        n, k = {"qkv": (3 * d, d), "proj": (d, d), "fc1": (hidden, d),
                "fc2": (d, hidden)}[name]
        w = {"weight": (torch.randn(n, k, generator=g) * k ** -0.5).to(
            dev, torch.bfloat16),
             "bias": (0.1 * torch.randn(n, generator=g)).to(dev,
                                                            torch.bfloat16)}
        a = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
        kw = {}
        if name in ("proj", "fc2"):
            kw["row_mask"] = torch.ones(m, device=dev)
            kw["resid"] = torch.randn(m, n, generator=g).to(
                dev, torch.bfloat16 if name == "proj" else torch.float32)
        wq, ws = quantize_weight(w["weight"])
        q, qs = quantize_rows(a)
        wq8 = {"weight_q": wq, "scale": ws, "bias": w["bias"]}
        kw8 = dict(kw, a_scale=qs.reshape(-1).contiguous())
        for s8 in (False, True):
            args = (q, wq8, name) if s8 else (a, w, name)
            kws = kw8 if s8 else kw
            out = vit_block.block_gemm(*args, **kws)
            ref = vit_block.block_gemm_reference(*args, **kws)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = ulp_tol(ref)
            if not err <= tol:
                raise AssertionError(f"GEMM core {name} s8={s8} disagrees "
                                     f"with plain: {err} > {tol}")
            library = ((lambda: torch._int_mm(q, wq.t())) if s8 else
                       (lambda: F.linear(a, w["weight"], w["bias"])))
            # timed through the bare launch into a kept output: the
            # wrapper's checks are host time, not the kernel's
            epi = PRODUCTS.index(name)
            rm, res = kw.get("row_mask"), kw.get("resid")
            if s8:
                kernel = lambda: vit_block._gemm_s8(
                    lib, (q, kw8["a_scale"]), wq8, n, k, epi, out, res, rm)
            else:
                kernel = lambda: vit_block._gemm(lib, a, w, n, k, epi, out,
                                                 res, rm)
            ms, lib_ms = in_turns(kernel, library)
            bound, by = product_bound(name, m, d, hidden, s8)
            unit = "TOP/s" if s8 else "TFLOP/s"
            rate = 2.0 * m * n * k / 1e9
            print(f"GEMM core {name} {'s8' if s8 else 'bf16'} M={m} N={n} "
                  f"K={k}: max_abs_err {err:.6g} (tol {tol:.6g}); kernel "
                  f"{ms:.4f} ms ({rate / ms:.1f} {unit}), "
                  f"{'torch._int_mm' if s8 else 'F.linear'} {lib_ms:.4f} ms "
                  f"({rate / lib_ms:.1f} {unit}; in turns), bound "
                  f"{bound:.4f} ms by {by} [{card}]")
            rows.append(dict(product=name, s8=s8, ms=ms, library_ms=lib_ms,
                             bound_ms=bound, bound_by=by, err=err))
    for s8 in (False, True):
        mine = [r for r in rows if r["s8"] == s8]
        print(f"GEMM core, the four {'s8' if s8 else 'bf16'} products of a "
              f"DeiT-S layer at bs128: kernel "
              f"{sum(r['ms'] for r in mine):.4f} ms, library "
              f"{sum(r['library_ms'] for r in mine):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in mine):.4f} ms [{card}]")
    return rows + phase_row_products(dev, card, g)


ROW_PRODUCTS = (("proj_ln", False), ("proj_ln", True), ("fc2_ln", False),
                ("fc1_q", True))


def close_codes(tag, q, qs, ref_q, ref_qs):
    """s8 codes against the plain version's: the f32 row they quantise
    differs by a summation order (LN2's statistics) or by libdevice's erf
    against PyTorch's, so scales within 1e-5 relative, codes within 1 and
    at most one in a thousand moved. Returns the share moved."""
    rel = ((qs - ref_qs).abs() / ref_qs.abs()).max().item()
    moved = (q.int() - ref_q.int()).abs()
    share = moved.float().mean().item()
    if not (rel <= 1e-5 and moved.max().item() <= 1 and share <= 1e-3):
        raise AssertionError(f"{tag}: codes disagree with plain (scales "
                             f"{rel:.3g} relative, {share:.3g} of the codes "
                             f"moved, by up to {moved.max().item()})")
    return share


def phase_row_products(dev, card, g):
    """The row epilogues (the GEMM core's cluster form) at DeiT-S bs128:
    proj with LN2 (bf16, s8 with LN2's quantiser), fc2 with the next
    layer's token gate and LN1, the s8 fc1 with its row quantiser, each
    against its plain version and timed in turns with the two launches it
    replaces (the product, then the row pass: `lt_layernorm`,
    `lt_layernorm_quant`, `lt_rowquant`). Returns the rows."""
    from laudnet_tpu_torch.ops.quant import quantize_rows, quantize_weight

    m, d, hidden = B * L_FULL, DEIT["d"], DEIT["hidden"]
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, s8 in ROW_PRODUCTS:
        base = vit_block.ROW_PRODUCT[name]
        epi = PRODUCTS.index(base)
        n, k = {"proj": (d, d), "fc2": (d, hidden), "fc1": (hidden, d)}[base]
        w = {"weight": (torch.randn(n, k, generator=g) * k ** -0.5).to(
            dev, torch.bfloat16),
             "bias": (0.1 * torch.randn(n, generator=g)).to(dev,
                                                            torch.bfloat16)}
        a = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
        kw = {}
        if base in ("proj", "fc2"):
            kw["row_mask"] = torch.ones(m, device=dev)
            kw["resid"] = torch.randn(m, n, generator=g).to(
                dev, torch.bfloat16 if base == "proj" else torch.float32)
            kw["ln"] = {"weight": (1 + 0.05 * torch.randn(n, generator=g)).to(
                dev, torch.bfloat16), "bias": (0.05 * torch.randn(
                    n, generator=g)).to(dev, torch.bfloat16)}
        if name == "fc2_ln":
            pw = torch.zeros(2, n)
            pw[0, 0], pw[1, 0] = 1.0, -1.0
            kw["policy"] = {"weight": pw.to(dev, torch.bfloat16),
                            "bias": torch.zeros(2, dtype=torch.bfloat16,
                                                device=dev)}
            kw["seq_len"] = L_FULL
        if s8:
            wq, ws = quantize_weight(w["weight"])
            a, qs = quantize_rows(a)
            w = {"weight_q": wq, "scale": ws, "bias": w["bias"]}
            kw["a_scale"] = qs.reshape(-1).contiguous()
        out = vit_block.block_gemm(a, w, name, **kw)
        ref = vit_block.block_gemm_reference(a, w, name, **kw)
        torch.cuda.synchronize()
        tag = f"GEMM core {name} {'s8' if s8 else 'bf16'} M={m} N={n} K={k}"
        if name == "fc1_q":
            err = close_codes(tag, *out, *ref)
        else:
            err = (out[0].float() - ref[0].float()).abs().max().item()
            if not err <= ulp_tol(ref[0]):
                raise AssertionError(f"{tag}: disagrees with plain: {err}")
            if s8:
                close_codes(tag, *out[1:], *ref[1:])
            elif not ((out[1].float() - ref[1].float()).abs().max().item()
                      <= ulp_tol(ref[1])):
                raise AssertionError(f"{tag}: LayerNorm disagrees with plain")
            if name == "fc2_ln" and not torch.equal(out[2], ref[2]):
                raise AssertionError(f"{tag}: the token mask differs")
        # timed through the bare launches into kept outputs
        res, rm, ln = kw.get("resid"), kw.get("row_mask"), kw.get("ln")
        y = torch.empty(m, n, device=dev, dtype=torch.float32 if (
            base == "proj" or s8 and base == "fc1") else torch.bfloat16)
        h = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
        codes = (torch.empty(m, n, device=dev, dtype=torch.int8),
                 torch.empty(m, device=dev))
        mask = torch.ones(m, device=dev)
        if s8:
            qa = (a, kw["a_scale"])
            fused = lambda: vit_block._gemm_s8_rows(
                lib, qa, w, n, k, epi, codes, y if base == "proj" else None,
                res, rm, ln)

            def unfused():
                vit_block._gemm_s8(lib, qa, w, n, k, epi, y, res, rm)
                if base == "proj":
                    _build.check(lib, lib.lt_layernorm_quant(
                        y.data_ptr(), 1, codes[0].data_ptr(),
                        codes[1].data_ptr(), ln["weight"].data_ptr(),
                        ln["bias"].data_ptr(), m, n, 1e-6, stream), "lnq")
                else:
                    _build.check(lib, lib.lt_rowquant(
                        y.data_ptr(), 1, codes[0].data_ptr(),
                        codes[1].data_ptr(), m, n, stream), "rowquant")
        else:
            tp = kw.get("policy") or {}
            fused = lambda: vit_block._gemm_rows(
                lib, a, w, n, k, epi, y, h, res,
                rm if base == "proj" else mask, ln, 1e-6, 0, 0,
                kw.get("policy"), mask, L_FULL)

            def unfused():
                vit_block._gemm(lib, a, w, n, k, epi, y, res,
                                rm if base == "proj" else mask)
                _build.check(lib, lib.lt_layernorm(
                    y.data_ptr(), int(base == "proj"), h.data_ptr(),
                    ln["weight"].data_ptr(), ln["bias"].data_ptr(), m, n,
                    1e-6, 0, tp["weight"].data_ptr() if tp else None,
                    tp["bias"].data_ptr() if tp else None,
                    mask.data_ptr() if tp else None, L_FULL, stream),
                    "layernorm")
        ms, old_ms = in_turns(fused, unfused)
        bound, by = product_bound(name, m, d, hidden, s8)
        print(f"{tag}: max_abs_err {err:.6g}; fused {ms:.4f} ms, the "
              f"product and its row pass as two launches {old_ms:.4f} ms "
              f"(in turns), bound {bound:.4f} ms by {by} [{card}]")
        rows.append(dict(product=name, s8=s8, ms=ms, unfused_ms=old_ms,
                         bound_ms=bound, bound_by=by, err=err))
    # the persistent grids (csrc/vit_block.cu::lt_gemm_clusters' kinds)
    for label, kind, n, cn in (
            ("proj_ln / fc2_ln bf16", 0, d, 2), ("proj_ln s8", 2, d, 2),
            ("fc1_q s8", 3, hidden, 8), ("proj_ln bf16 T2T", 0, T2T["d"], 2),
            ("fc1_q s8 T2T", 3, T2T["hidden"], 7)):
        print(f"GEMM core {label} N={n}: cudaOccupancyMaxActiveClusters "
              f"gives {lib.lt_gemm_clusters(kind, n)} clusters of {cn} "
              f"[{card}]")
    return rows


def phase_kernels(dev, card):
    g = torch.Generator().manual_seed(0)
    results = {"fused_vit_block": [], "fused_vit_segment": [],
               "fused_vit_block_int8": [], "fused_vit_attention": [],
               "fused_vit_attention_bwd": [], "block_variant": [],
               "s8_gemm": []}
    phase_products(dev, card)
    phase_tail_kernel(dev, card, results)
    phase_probe_kernels(dev, card, results)

    # --- B1, DeiT-S and T2T widths (the GEMM core takes T2T's 448 and 1344
    # in tiles 224 wide, DeiT-S's in tiles of 192) ----------------------
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

    # --- B4 and B5, the attention forward and backward (csrc/attention.cu);
    # yardsticks: PyTorch's fused attention on the same qkv (strided per-
    # head views, additive key mask) and its backward (the forward's graph
    # built once, only the backward timed), timed in turns with the
    # kernels, here only, used nowhere in the port ----------------------------
    att_cases = (  # geometry, L, ragged mask, dtype, plain repetitions, note
        (DEIT, L_FULL, False, torch.bfloat16, 20, "serving"),
        (T2T, L_FULL, False, torch.bfloat16, 20, "t2t"),
        (DEIT, 137, True, torch.bfloat16, 20, ""),
        (DEIT, 257, True, torch.bfloat16, 5, "256^2"),
        (DEIT, 577, True, torch.bfloat16, 2, "384^2"),
        (DEIT, L_FULL, True, torch.float32, 5, "f32"),
        (DEIT, 257, False, torch.float32, 3, "f32 256^2"))
    for geom, l, ragged, dtype, plain_reps, note in att_cases:
        d, heads = geom["d"], geom["heads"]
        f32 = dtype == torch.float32
        qkv = torch.randn(B, l, 3 * d, generator=g).to(dev, dtype)
        cot = torch.randn(B, l, d, generator=g).to(dev, dtype)
        mask = key_mask(g, l, dev, ragged)
        q, k, v = qkv.reshape(B, l, 3, heads, 64).permute(2, 0, 3, 1, 4)
        neg = ((1.0 - mask) * -1e9).to(dtype)[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=neg,
                                                      scale=0.125)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=neg,
                                                 scale=0.125)
        lib_cot = cot.reshape(B, l, heads, 64).permute(0, 2, 1, 3)
        sdpa_bwd = lambda: torch.autograd.grad(lib_out, (qg, kg, vg), lib_cot,
                                               retain_graph=True)
        print(f"scaled_dot_product_attention at L={l} {dtype}: forward "
              f"kernels [{sdpa_backend(sdpa)}], backward kernels "
              f"[{sdpa_backend(sdpa_bwd)}]")
        for gated in (False, True):
            gate = head_gate(g, heads, dev) if gated else None
            args = (qkv, mask, gate, heads, 0.125)
            where = (f"D={d} L={l} {'ragged' if ragged else 'full'} key mask"
                     f"{' head mask' if gated else ''} {dtype}")
            label = note if gated and note in ("serving", "t2t") else ""
            compare(f"B4 fused_vit_attention {where}",
                    lambda: vit_attention.fused_vit_attention(*args),
                    lambda: vit_attention.reference_vit_attention(*args),
                    card, results, "fused_vit_attention", label,
                    attention_bound(l, d, heads, gated, f32=f32),
                    library=sdpa, f32=f32, plain_reps=plain_reps)
            _, stats = vit_attention._launch_fwd(*args, return_stats=True)
            bargs = (qkv, mask, gate, cot, heads, 0.125, stats)
            tag = f"B5 fused_vit_attention backward {where}"
            compare(tag, lambda: vit_attention._launch_bwd(*bargs)[0],
                    lambda: vit_attention.reference_vit_attention_bwd(
                        *bargs[:-1])[0],
                    card, results, "fused_vit_attention_bwd", label,
                    attention_bwd_bound(l, d, heads, gated, f32=f32),
                    library=sdpa_bwd, f32=f32, plain_reps=plain_reps)
            if gated:
                dhead = vit_attention._launch_bwd(*bargs)[1]
                ref = vit_attention.reference_vit_attention_bwd(
                    *bargs[:-1])[1]
                err = (dhead - ref).abs().max().item()
                tol = DHEAD_REL * ref.abs().max().item()
                closed = vit_attention._launch_bwd(*bargs)[0][0].reshape(
                    l, 3, heads, 64)[:, :, 0]
                print(f"{tag}: dhead max_abs_err {err:.6g} (tol {tol:.6g}); "
                      f"closed head dgate {dhead[0, 0].item():.6g}")
                if not err <= tol:
                    raise AssertionError(f"{tag}: dhead disagrees with plain")
                if closed.any() or dhead[0, 0].item() == 0.0:
                    raise AssertionError(f"{tag}: a closed head must have "
                                         "zero dqkv and a non-zero dgate")
        del qkv, cot, lib_out, qg, kg, vg

    # --- the layer's attention launch (`lt_attention`): attention.cu's
    # streaming forward (attn_fwd_bf16, B4's kernel) against vit_block.cu's
    # register-resident attention_kernel, in turns, at B2's L = 98, the
    # snapped 128, the ragged 137 and B1's 197, exact and deferred, with
    # and without the head gate; both held to the plain attention. The
    # split lt_attention routes by (ATT_ROUTE_EXACT, ATT_ROUTE_DEFERRED) is
    # read from these lines.
    d, heads = DEIT["d"], DEIT["heads"]
    lib = _build.library()
    stream_ptr = torch.cuda.current_stream().cuda_stream
    for l in (98, 128, 137, 197):
        qkv = torch.randn(B, l, 3 * d, generator=g).to(dev, torch.bfloat16)
        mask = key_mask(g, l, dev, l == 137)
        neg = (1.0 - mask) * vit_block.NEG
        for gated in (False, True):
            gate = head_gate(g, heads, dev) if gated else None
            gptr = None if gate is None else gate.data_ptr()
            for deferred in (0, 1):
                outs = [torch.empty(B, l, d, device=dev, dtype=torch.bfloat16)
                        for _ in range(2)]

                def streaming():
                    _build.check(lib, lib.lt_attn_fwd(
                        qkv.data_ptr(), mask.data_ptr(), gptr,
                        outs[0].data_ptr(), None, B, l, heads, 0.125,
                        deferred, 0, stream_ptr), "attn_fwd_bf16")

                def resident():
                    _build.check(lib, lib.lt_attention_resident(
                        qkv.data_ptr(), mask.data_ptr(), gptr,
                        outs[1].data_ptr(), B, l, heads, 0.125, deferred,
                        stream_ptr), "attention_kernel")

                streaming(), resident()
                ref = vit_block.attention(qkv, neg, heads, 0.125,
                                          fast=bool(deferred), head_gate=gate)
                torch.cuda.synchronize()
                tag = (f"lt_attention's two kernels D=384 L={l}"
                       f"{' ragged' if l == 137 else ''}"
                       f"{' head gate' if gated else ''} "
                       f"{'deferred' if deferred else 'exact'}")
                errs = [(o.float() - ref.float()).abs().max().item()
                        for o in outs]
                if not max(errs) <= ulp_tol(ref):
                    raise AssertionError(f"{tag}: disagrees with plain "
                                         f"{errs}")
                s_ms, r_ms = in_turns(streaming, resident)
                print(f"{tag}: attn_fwd_bf16 {s_ms:.4f} ms, attention_kernel "
                      f"{r_ms:.4f} ms (in turns; max_abs_err {errs[0]:.6g}, "
                      f"{errs[1]:.6g}); lt_attention routes to "
                      f"{'attn_fwd_bf16' if l >= ROUTE_L[deferred] else 'attention_kernel'}"
                      f" [{card}]")
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
                               "launches"),
    "block_variant": (vit_block.fused_vit_block, "variant_launches"),
    "s8_gemm": (s8_gemm.s8_gemm, "launches")}
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

    # --- the same in f32: B4's f32 form against the reference attention,
    # both f32 (full f32 products, TF32 off), so apart by summation order
    fused32 = laud_deit_small(layer_skip=False, attn_impl="fused")
    fused32.load_state_dict(g32.state_dict())
    fused32.eval()
    with torch.no_grad():
        out, delta = counted(lambda: fused32(images))
        ref = g32(images)
    n_b4 = delta["fused_vit_attention"]
    top1, rel = agreement(out.logits, ref.logits)
    print(f"LAUDViT attn_impl='fused' eval, f32: B4 launches {n_b4}, vs "
          f"attn_impl='reference' top-1 agreement {top1:.4f}, relative "
          f"logit error {rel:.6g} (bound {F32_MODEL_REL})")
    if n_b4 != 12 or top1 < TOP1_MIN or not rel <= F32_MODEL_REL:
        raise AssertionError("f32 attn_impl='fused' disagrees with "
                             "'reference' or did not launch B4 12 times")
    with torch.no_grad():
        f_ips = img_per_s(lambda x: fused32(x).logits, images)
        r_ips = img_per_s(lambda x: g32(x).logits, images)
    print(f"LAUDViT eval f32: {f_ips:.1f} img/s with attn_impl='fused', "
          f"{r_ips:.1f} img/s with 'reference' (bs{B}) [{card}]")
    del fused32, g32, gated, fused

    # --- the block engine past 256 tokens: DeiT-S at 256^2 (257 tokens)
    # and 384^2 (577), dense, exact and fast_math; B1's attention launches
    # go to the streaming forward of csrc/attention.cu ----------------------
    for size in (256, 384):
        l = (size // 16) ** 2 + 1
        m32, m = model_pair(laud_deit_small, dev, 8, img_size=size)
        imgs = torch.randn(B, size, size, 3, device=dev,
                           generator=torch.Generator(dev).manual_seed(9))
        names = []
        for fast in (False, True):
            name = f"deit_s_{size}px{'_fast' if fast else ''}"
            serve_and_check(name, m32, m, imgs, dict(fast_math=fast),
                            [l] * 12, {"fused_vit_block": 12})
            names.append((name, dict(fast_math=fast)))
        report_rates(names, m, imgs, card, plain_iters=3)
        del m32, m, imgs


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

    def run(steps, args=args):
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

    # --- f32: --vit_attn fused without --amp, through the CLI, then its
    # first step held to the same step through the plain attention --------
    argv32 = [a for a in TRAIN_ARGV if a != "--amp"]
    argv32[argv32.index("--steps_per_epoch") + 1] = str(F32_TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as out_dir:
        best, delta = counted(lambda: train_main.main(
            argv32 + ["--train_url", out_dir]))
        with open(f"{out_dir}/log.txt") as f:
            header, row = (line.strip().split(",") for line in f.readlines())
    n_b4, n_b5 = delta["fused_vit_attention"], delta["fused_vit_attention_bwd"]
    print(f"train.main without --amp (f32): best top1 {best:.4f}; B4 "
          f"launches {n_b4}, B5 launches {n_b5}; log.txt "
          f"{dict(zip(header, row))}")
    if (n_b4 != 24 * F32_TRAIN_STEPS + 24 or n_b5 != 12 * F32_TRAIN_STEPS
            or not all(math.isfinite(float(v)) for v in row)):
        raise AssertionError("f32 train.main: launches or a metric wrong")
    # The first f32 step against the same step through the plain attention,
    # at the f32 bound, with the token gates off: a kept token's
    # straight-through residue (1 +- 2^-24) reaches the additive key mask as
    # a score offset of tens that turns with the last bit of the gate's soft
    # value (ROADMAP queue 3), so with token gates on two f32 steps that
    # differ by summation order are two samples, as in bf16. Head and layer
    # gates multiply outputs, which carries no such jump.
    args32 = train_main.parse_args(argv32 + ["--vit_skip", "head,layer"])
    tr_k, _, _, first_k = run(1, args32)
    with plain_attention():
        (tr_p, _, _, first_p), delta = counted(lambda: run(1, args32),
                                               main_path=False)
    if any(delta.values()):
        raise AssertionError(f"the plain f32 step launched a kernel: {delta}")
    worst = max(abs(first_k[0][k] - first_p[0][k]) / abs(first_p[0][k])
                for k in LOSS_PARTS)
    gk, gp = qkv_grads(tr_k.model), qkv_grads(tr_p.model)
    grad_rel = ((gk - gp).norm() / gp.norm()).item()
    print("first f32 step (head and layer gates) through kernels vs plain "
          "attention: " + ", ".join(
              f"{k} {first_k[0][k]:.8g} / {first_p[0][k]:.8g}"
              for k in LOSS_PARTS)
          + f"; worst relative difference {worst:.6g}, qkv weights' "
          f"gradients {grad_rel:.6g} of their norm apart (bound {F32_REL})")
    if not all(math.isfinite(first_k[0][k]) for k in LOSS_PARTS):
        raise AssertionError("f32 step: a loss part is not finite")
    if not (worst <= F32_REL and grad_rel <= F32_REL):
        raise AssertionError("the f32 step through the kernels disagrees "
                             "with the plain attention")
    del tr_k, tr_p

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

    b5_ms, b4_ms = share("attn_bwd_"), share("attn_fwd_")
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
                ("deit_snapped", build_fused_vit(
                    deit, token_capacity=NOMINAL, snap_capacities=True)),
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
                      f"x{e.count // forwards:<4d} {e.key[:140]}")


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

    # --- no host sync in a masked forward: the flagship's dense-masked
    # forward (f32 and bf16), a channel-mode and a layer-mode model run
    # under torch.cuda.set_sync_debug_mode("error"), which raises at any
    # synchronisation of the host with the card ---------------------------
    for name, model in (
            ("flagship f32", variant(state, dev)),
            ("flagship bf16", variant(state, dev,
                                      compute_dtype=torch.bfloat16)),
            ("channel-mode bf16", channel_resnet(dev)),
            ("layer-mode f32", layer_resnet(dev))):
        with torch.no_grad():
            model(x8, 0.1)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = model(x8, 0.1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        print(f"{name} dense-masked forward under sync debug mode 'error': "
              f"no host sync; logits {tuple(out.logits.shape)}, flops on "
              f"{out.flops.device}")
        del model

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
    dev_ms, per_call, _ = b3_device(
        lambda: masked_block.masked_bottleneck_tail(**t, patch=patch,
                                                    capacity=capacity))
    block.execution = "sparse"
    own_ms = time_ms(lambda: block(x, 0.1))
    block.execution = "dense"
    whole_ms = time_ms(lambda: block(x, 0.1))
    print(f"B3 on layer{stage}_1's tensors {tuple(x1.shape)} -> "
          f"{t['identity'].shape[-1]}, patch {patch}, mask density "
          f"{cells.mean().item():.4f}: launches "
          f"{delta['masked_bottleneck_tail']}, vs the block's sparse "
          f"execution max_abs_err {err:.6g} (tol {tol:.6g}, mean {mean:.6g}); "
          f"B3 {ms:.4f} ms (device "
          + ("not measured" if dev_ms is None else
             f"{dev_ms:.4f} ms, {per_call} launches a call")
          + f"); the whole block sparse {own_ms:.4f} ms, "
          f"dense-masked {whole_ms:.4f} ms (conv1, masker and bookkeeping "
          f"included) [{card}]")
    if (delta["masked_bottleneck_tail"] != 1
            or (per_call is not None and per_call > 2) or not err <= tol):
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


# --- the probes (P1, P2) and the serving engine --------------------------------

def phase_probes(card, full=False):
    """The two probes through their entry points: a short form on the main
    path (P1's full and fast_tanh bodies, a short chain of every s8 rate),
    or, with ``full``, every mode set, the stage breakdown and the launch
    costs (``python3 chip_smoke.py probes``)."""
    if not full:
        probe_block_budget.run(["full", "fast_tanh"], chain=2, repeats=1)
        probe_int8.run(quick=True)
        return
    for flag in ("default", "--fast", "--post", "--combos"):
        print(f"--- probe_block_budget {flag} [{card}]")
        probe_block_budget.run(probe_block_budget.SETS[flag])
    print(f"--- probe_block_budget --stages [{card}]")
    print(json.dumps(probe_block_budget.stages()))
    print(f"--- probe_int8 [{card}]")
    probe_int8.main([])
    print(f"--- probe_host [{card}]")
    probe_host.run()


# A mode's predicted and measured times disagree in order only where both
# the prediction reverses two modes AND they are more than ORDER_GAP apart
# measured: rates spread 5-25% between calls (PERF.md), so nearer pairs are
# printed, not judged.
ORDER_GAP = 0.25
BATCH1_ROUNDS = 21
CNN_ROUNDS = 5


def interleaved_ms(fns, rounds=3, reps=3, label=None, card=""):
    """Median ms of each of ``fns`` (name -> callable), timed round by
    round, every callable once a round (`time_ms`): a slow spell of the
    shared host then falls on all of them alike instead of on whichever
    form was being timed when it came. With ``label``, prints each form's
    spread across the rounds: (largest - smallest round) / median, and the
    spread of the median itself, estimated as that over sqrt(rounds)."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, reps=reps, warmup=1))
    medians = {name: statistics.median(t) for name, t in times.items()}
    if label is not None:
        for name, t in times.items():
            spread = (max(t) - min(t)) / medians[name]
            print(f"{label} {name}: {rounds} rounds of {reps} calls, median "
                  f"{medians[name]:.4f} ms, spread across rounds "
                  f"{spread:.4f}, of the median {spread / rounds ** 0.5:.4f} "
                  f"(rounds {', '.join(f'{v:.3f}' for v in t)}) [{card}]")
    return medians


def predicted_vs_measured(name, plan, measured, card):
    """Prints each ranked mode's predicted and measured ms (modes the port
    cannot serve for this model, such as another paradigm's, or the
    rank-only B3 form, are printed as predicted only); returns
    the pairs whose order the prediction reverses beyond ORDER_GAP."""
    print(f"{name}: plan mode {plan.mode} (served {plan.served}, exact "
          f"{plan.exact}, predicted speedup {plan.predicted_speedup:.4f})"
          + (f"; {plan.notes}" if plan.notes else ""))
    for mode, sec in sorted(plan.ranking.items(), key=lambda kv: kv[1]):
        got = measured.get(mode)
        print(f"  {mode:>20}: predicted {sec * 1e3:9.4f} ms, measured "
              + ("not served for this model" if got is None
                 else f"{got:9.4f} ms")
              + f" [{card}]")
    bad = []
    for a in measured:
        for b in measured:
            if (plan.ranking[a] < plan.ranking[b]
                    and measured[a] > (1 + ORDER_GAP) * measured[b]):
                bad.append(f"{name}: predicted {a} < {b}, measured "
                           f"{measured[a]:.4f} > {measured[b]:.4f} ms")
    for line in bad:
        print("  ORDER REVERSED:", line)
    return bad


def token_gated_deit(dev, seed=3):
    """bf16 LAUD-DeiT-S, token gates only (the block engine's), with the
    gates of layers 3 and 7 centred: each compares a random direction of
    the token's features with its opposite, unbiased, so about half of
    the tokens close there and the keeps drop as the nominal schedule's;
    every other layer's gate is held open by its bias."""
    _, model = model_pair(laud_deit_small, dev, seed, head_skip=False,
                          layer_skip=False, device=dev)
    g = torch.Generator(dev).manual_seed(seed + 1)
    with torch.no_grad():
        for i, blk in enumerate(model.blocks):
            tp = blk.token_policy
            if i in (3, 7):
                v = torch.randn(tp.weight.shape[1], device=dev, generator=g)
                tp.weight[0], tp.weight[1] = v, -v
                tp.bias.zero_()
            else:
                tp.bias.copy_(torch.tensor([5.0, -5.0]))
    return model


def channel_resnet(dev, seed=4):
    """bf16 LAUD-ResNet-50 in channel mode (groups of 2 channels, one-layer
    MLP maskers) whose policy keeps a fixed ~60% of the groups with a
    margin (masker biases +-2) that the input moves a little: the static
    export's fidelity gate passes."""
    model = uni_resnet50(dyn_mode=("channel",) * 4,
                         channel_dyn_granularity=(2, 2, 2, 2),
                         channel_masker=("MLP",) * 4,
                         channel_masker_layers=(1, 1, 1, 1),
                         compute_dtype=torch.bfloat16, device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blocks in model.stages():
            for block in blocks:
                fc = block.masker_channel.fc
                keep = (torch.rand(fc.bias.shape[0] // 2, generator=g)
                        < 0.6).float().to(dev)
                fc.bias.copy_(torch.cat([4 * keep - 2, 2 - 4 * keep]))
    return model.eval()


def layer_resnet(dev, seed=5):
    """f32 LAUD-ResNet-50 in layer mode with every odd block's gate shut
    (masker bias -5 / +5): eight of sixteen blocks run."""
    model = uni_resnet50(dyn_mode=("layer",) * 4,
                         channel_masker=("MLP",) * 4,
                         channel_masker_layers=(1, 1, 1, 1), device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
    with torch.no_grad():
        for i, block in enumerate(b for bs in model.stages() for b in bs):
            if i % 2:
                block.masker_spatial.conv.bias.copy_(
                    torch.tensor([-5.0, 5.0]))
    return model.eval()


def layer_deit(dev, seed=6):
    """bf16 LAUD-DeiT-S with layer gates only; the attention branches of
    blocks 2, 5 and 8 and the MLP branches of blocks 4 and 9 shut."""
    _, model = model_pair(laud_deit_small, dev, seed, token_skip=False,
                          head_skip=False, device=dev)
    with torch.no_grad():
        for i, blk in enumerate(model.blocks):
            # layer_policy bias: attn_on, mlp_on, attn_off, mlp_off
            if i in (2, 5, 8):
                blk.layer_policy.bias[0] = -5.0
            if i in (4, 9):
                blk.layer_policy.bias[1] = -5.0
    return model


def phase_engine(dev, card):
    """`ServingEngine` on four configurations: calibrate, plan, serve;
    ``served == mode``; the served logits against the directly built path;
    predicted against measured ms for every ranked mode the port serves."""
    images = torch.randn(B, IMG, IMG, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(7))
    calib = [torch.randn(B, IMG, IMG, 3, device=dev, generator=torch.Generator(
        dev).manual_seed(8 + i)) for i in range(2)]
    reversed_pairs = []

    def served(engine, name):
        out, delta = counted(lambda: engine(images))
        torch.cuda.synchronize()
        if out.shape != (B, 1000) or not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name}: bad served logits")
        if engine.plan.served != engine.plan.mode:
            raise AssertionError(f"{name}: served {engine.plan.served} != "
                                 f"mode {engine.plan.mode}")
        return out, {k: v for k, v in delta.items() if v}

    # --- 1. LAUD-DeiT-S with live token gates ------------------------------
    deit = token_gated_deit(dev)
    engine = ServingEngine(deit, snap_capacities=True)
    plan = engine.calibrate(calib)
    out, delta = served(engine, "deit")
    caps = plan.token_capacity
    direct = build_fused_vit(deit, token_capacity=caps or (1.0,) * 12,
                             snap_capacities=True,
                             int8=plan.mode.endswith("-int8"))
    if not torch.equal(out, direct(images)):
        raise AssertionError("deit: served logits differ from "
                             "build_fused_vit with the plan's capacities")
    print(f"deit engine: capacities {caps}, tokens per layer "
          f"{direct.token_counts}, launches {delta}; served logits equal "
          f"build_fused_vit's")
    # the calibrated capacities before snapping: the same engine unsnapped
    nominal = ServingEngine(deit).calibrate(calib).token_capacity
    full = (1.0,) * 12
    nominal = nominal or full
    forms = {"dense": dict(),
             "mask": dict(token_capacity=full),
             "token": dict(token_capacity=nominal),
             "token-snapped": dict(token_capacity=nominal,
                                   snap_capacities=True),
             "dense-int8": dict(token_capacity=full, int8=True),
             "token-int8": dict(token_capacity=nominal, int8=True),
             "token-snapped-int8": dict(token_capacity=nominal,
                                        snap_capacities=True, int8=True)}
    measured = interleaved_ms({
        mode: (lambda fwd=build_fused_vit(deit, **kw): fwd(images))
        for mode, kw in forms.items() if mode in plan.ranking})
    reversed_pairs += predicted_vs_measured("deit", plan, measured, card)
    del deit, engine, direct

    # --- 2. the flagship: the spatial plan ----------------------------------
    state = mixed_gate_state(dev, images[:32])
    bf16 = torch.bfloat16
    fl = variant(state, dev, compute_dtype=bf16)
    engine = ServingEngine(fl)
    plan = engine.calibrate(calib)
    out, delta = served(engine, "flagship")
    if plan.mode != "dense-masked":
        raise AssertionError(f"flagship: plan chose {plan.mode}, the latency "
                             "model orders dense-masked first")
    with torch.no_grad():
        masked = fl(images, 0.1).logits
    if not torch.equal(out, masked):
        raise AssertionError("flagship: served logits differ from the "
                             "dense-masked graph")
    from laudnet_tpu_torch.infer.calibrate import calibrate_patch_capacity

    with torch.no_grad():
        caps = plan.token_capacity or calibrate_patch_capacity(
            lambda x: fl(x, 0.1), calib)
    print(f"flagship engine: launches {delta}; patch capacities {caps}")
    forms = {"dense-masked": fl,
             "dense-masked-int8": configured(fl, conv_impl="int8"),
             "spatial-capacity": configured(fl, execution="sparse",
                                            patch_capacity=caps),
             "dense": resnet50(compute_dtype=bf16, device=dev,
                               generator=torch.Generator(dev).manual_seed(2)
                               ).eval()}
    # each configured copy against the model built with the same options
    # and weights (bit for bit), and against the dense-masked graph: sparse
    # execution on a calibration batch, whose cells the capacities cover,
    # at the bf16 engine bound; W8A8 on these half-closed gates is reported
    # (phase 7 bounds it on open gates: the gates here sit at the tie and
    # quantisation noise moves cells across it)
    with torch.no_grad():
        for mode, kw in (("dense-masked-int8", dict(conv_impl="int8")),
                         ("spatial-capacity", dict(execution="sparse",
                                                   patch_capacity=caps))):
            got = forms[mode](images, 0.1).logits
            built = variant(state, dev, compute_dtype=bf16, **kw)
            if not torch.equal(got, built(images, 0.1).logits):
                raise AssertionError(f"flagship {mode}: the configured copy "
                                     "differs from the model built so")
            del built
        _, rel_int8 = agreement(forms["dense-masked-int8"](images, 0.1).logits,
                                masked)
        _, rel_sparse = agreement(
            forms["spatial-capacity"](calib[0], 0.1).logits,
            fl(calib[0], 0.1).logits)
    print(f"flagship: configured copies equal the models built so; "
          f"spatial-capacity vs dense-masked on a calibration batch: "
          f"relative logit error {rel_sparse:.6g} (bound {REL_ERR_MAX}); "
          f"W8A8 vs dense-masked {rel_int8:.6g} (gates at the tie: "
          f"reported)")
    if not rel_sparse <= REL_ERR_MAX:
        raise AssertionError("flagship spatial-capacity disagrees with "
                             "dense-masked")
    # the masked CNN forms are host-bound like the batch-1 ones (dense-
    # masked against spatial capacity read 0.74-1.21x apart across calls,
    # PERF.md section 7): more rounds than the ViT forms
    with torch.no_grad():
        measured = interleaved_ms({
            m: (lambda f=f: f(images)) if m == "dense" else
            (lambda f=f: f(images, 0.1)) for m, f in forms.items()},
            rounds=CNN_ROUNDS, label="flagship", card=card)
    reversed_pairs += predicted_vs_measured("flagship", plan, measured, card)
    dense_ms = measured["dense"]  # the ungated ResNet-50 of every CNN plan
    del fl, forms, engine

    # --- 3. channel-mode LAUD-ResNet-50: static export and int8 -------------
    ch = channel_resnet(dev)
    engine = ServingEngine(ch)
    plan = engine.calibrate(calib, allow_static_export=True, allow_int8=True)
    out, delta = served(engine, "channel")
    fidelity = plan.fidelity["mean_agreement"]
    print(f"channel engine: fidelity mean agreement {fidelity:.4f}, mean "
          f"coverage {plan.fidelity['mean_coverage']:.4f} (gate 0.85)")
    if plan.mode != "static-export" or fidelity < 0.85:
        raise AssertionError(f"channel: plan chose {plan.mode} at fidelity "
                             f"{fidelity:.4f}; the maskers' margins make the "
                             "policy static and the model orders the float "
                             "export first")
    from laudnet_tpu_torch.infer import calibrate as cal
    from laudnet_tpu_torch.infer.export_pruned import (
        calibrate_export_act_scales, export_pruned_resnet)

    mask_fn = cal.make_channel_mask_fn(ch, 0.1)
    masks = cal.calibrate_channel_masks(mask_fn, calib)
    export = export_pruned_resnet(ch, masks)
    if not torch.equal(out, export(images)):
        raise AssertionError("channel: served logits differ from "
                             "export_pruned_resnet's")
    scales = calibrate_export_act_scales(ch, masks, calib, quantile=1.0,
                                         margin=0.05)
    forms = {"dense-masked": lambda: ch(images, 0.1).logits,
             "dense-masked-int8": lambda q=configured(ch, conv_impl="int8"):
             q(images, 0.1).logits,
             "static-export": lambda: export(images),
             "static-export-int8": lambda e=export_pruned_resnet(
                 ch, masks, int8=True, act_scales=scales): e(images)}
    # every form against the dense-masked graph: the float export at this
    # fidelity computes the same network (bf16 noise: REL_ERR_MAX), the
    # int8 forms quantise 53 convolutions (INT8_REL_ERR_MAX)
    with torch.no_grad():
        ref = forms["dense-masked"]()
        for mode, bound in (("static-export", REL_ERR_MAX),
                            ("dense-masked-int8", INT8_REL_ERR_MAX),
                            ("static-export-int8", INT8_REL_ERR_MAX)):
            _, rel = agreement(forms[mode](), ref)
            print(f"channel {mode} vs dense-masked: relative logit error "
                  f"{rel:.6g} (bound {bound})")
            if not rel <= bound:
                raise AssertionError(f"channel {mode} is further from "
                                     "dense-masked than its bound")
        measured = interleaved_ms(forms, rounds=CNN_ROUNDS, label="channel",
                                  card=card)
    measured["dense"] = dense_ms
    reversed_pairs += predicted_vs_measured("channel", plan, measured, card)
    del ch, forms, engine, export

    # --- 4. batch-1 layer skip ------------------------------------------------
    from laudnet_tpu_torch.infer.layerskip import (build_layer_skip_resnet,
                                                   build_layer_skip_vit)

    x1 = images[:1]
    lr = layer_resnet(dev)
    engine = ServingEngine(lr, batch_size=1)
    plan = engine.calibrate([x1, images[1:2]])
    if plan.served != plan.mode:
        raise AssertionError("layer ResNet: served != mode")
    ls = build_layer_skip_resnet(lr)
    (got, n_run), delta = counted(lambda: ls(x1))
    with torch.no_grad():
        ref = lr(x1, 0.1)
    _, rel = agreement(got, ref.logits)
    ran = int(sum(s.sum().item() for s in ref.spatial_s3))
    print(f"layer-skip ResNet-50 (f32, batch 1): {n_run} of 16 blocks run "
          f"(model: {ran}), relative logit error vs the model's eval "
          f"{rel:.6g}")
    if n_run != ran or not 0 < n_run < 16 or not rel <= SPARSE_F32_REL:
        raise AssertionError("layer-skip ResNet disagrees with the model")
    dense1 = resnet50(device=dev, generator=torch.Generator(dev).manual_seed(
        2)).eval()
    # batch 1 is host-bound: its forms' times spread by up to a third from
    # round to round (PERF.md section 7), so they are timed over
    # BATCH1_ROUNDS rounds, which brings the spread of each median well
    # below ORDER_GAP
    with torch.no_grad():
        measured = interleaved_ms({
            "layerskip": lambda: ls(x1),
            "dense-masked": lambda: lr(x1, 0.1),
            "dense-masked-int8": lambda q=configured(lr, conv_impl="int8"):
            q(x1, 0.1),
            "dense": lambda: dense1(x1)}, rounds=BATCH1_ROUNDS, reps=5,
            label="layer ResNet-50 batch 1", card=card)
    reversed_pairs += predicted_vs_measured("layer ResNet-50 batch 1", plan,
                                            measured, card)
    del lr, engine, dense1

    # --- an f32 ViT served through B4, as the JAX engine serves every ViT
    # through its fused attention (the block engine takes bf16 only) -------
    f32_vit, _ = model_pair(laud_deit_small, dev, 10, token_skip=False,
                            layer_skip=False, device=dev)
    engine = ServingEngine(f32_vit)
    plan = engine.calibrate(calib)
    out, delta = served(engine, "f32 deit")
    with torch.no_grad():
        ref = f32_vit(images, engine.temperature, training=False).logits
    _, rel = agreement(out, ref)
    print(f"f32 LAUD-DeiT-S engine: plan {plan.mode} (served {plan.served}), "
          f"launches {delta}; vs the model's own forward (reference "
          f"attention) relative logit error {rel:.6g} (bound "
          f"{F32_MODEL_REL})")
    if not delta.get("fused_vit_attention") or not rel <= F32_MODEL_REL:
        raise AssertionError("f32 deit: not served through B4, or its "
                             "logits disagree with the model's")
    del f32_vit, engine

    lv = layer_deit(dev)
    lsv = build_layer_skip_vit(lv)
    x1 = x1.to(torch.bfloat16)
    (got, n_run), delta = counted(lambda: lsv(x1))
    fused = configured(lv, attn_impl="fused")
    with torch.no_grad():
        ref = fused(x1, 0.1).logits
    print(f"layer-skip DeiT-S (bf16, batch 1): {n_run} of 24 branches run, "
          f"launches {delta}, logits equal the model's eval "
          f"(attn_impl='fused'): {torch.equal(got, ref)}")
    if not delta["fused_vit_attention"] > 0 or not torch.equal(got, ref):
        raise AssertionError("layer-skip DeiT-S: no B4 launch, or logits "
                             "differ from the model's eval")
    with torch.no_grad():
        ms = interleaved_ms({"skip": lambda: lsv(x1),
                             "masked": lambda: fused(x1, 0.1)},
                            rounds=BATCH1_ROUNDS, reps=5,
                            label="layer-skip DeiT-S batch 1", card=card)
    ms_skip, ms_masked = ms["skip"], ms["masked"]
    print(f"layer-skip DeiT-S batch 1: {ms_skip:.4f} ms, the dense-masked "
          f"graph {ms_masked:.4f} ms [{card}]")
    if reversed_pairs:
        raise AssertionError("the latency model reverses measured orders: "
                             + "; ".join(reversed_pairs))


# --- LAUD-RegNet, the serving artifacts and the simulator ----------------------

# The repo's RegNet recipe (`train_scripts.sh`, 4): LAUD-RegNetY-1.6GF in
# channel mode, channel groups of 2 in every stage, the backbone at a tenth
# of the learning rate.
REGNET_KEY = "y_1_6gf"
REGNET_KW = dict(dyn_mode=("channel",) * 4, channel_dyn_granularity=(2,) * 4)
REGNET_TRAIN_ARGV = [
    "--arch", f"lad_regnet_{REGNET_KEY}", "--amp", "--batch_size", str(B),
    "--input_size", str(IMG), "--dyn_mode", "channel-channel-channel-channel",
    "--channel_dyn_granularity", "2-2-2-2", "--t0", "5.0", "--t_last", "0.1",
    "--temp_scheduler", "exp", "--target_rate", "0.5", "--lambda_act", "10.0",
    "--T_kd", "4.0", "--alpha_kd", "0.5", "--lr_mult", "0.1", "--epochs", "1",
    "--print_freq", "1", "--steps_per_epoch"]
REGNET_TRAIN_STEPS = 4
REGNET_MASK_IMAGES = 16  # the f32 card-vs-CPU mask comparison's batch


def regnet(dev, seed=7, **kw):
    return lad_regnet_y_1_6gf(**REGNET_KW, **kw,
                              generator=torch.Generator(dev).manual_seed(seed))


def channel_maskers(model):
    return [blk.masker_channel for st in model.stages() for blk in st]


@torch.no_grad()
def close_half_the_groups(model):
    """Every channel masker's keep bias at -10 for the even groups (the
    skip bias is -2): those groups close for every image, about half."""
    for mk in channel_maskers(model):
        mk.fc.bias[:mk.group:2] = -10.0


def recorded_channel_masks(model, x):
    masks = []
    hooks = [mk.register_forward_hook(lambda m, a, out: masks.append(out[0]))
             for mk in channel_maskers(model)]
    with torch.no_grad():
        model(x, 0.1)
    for h in hooks:
        h.remove()
    return torch.cat([m.float().cpu().reshape(-1) for m in masks])


def phase_regnet(dev, card):
    bf16 = torch.bfloat16
    images = torch.randn(B, IMG, IMG, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(8))

    # --- the serving engine: no analytic geometry, the honest plan --------
    model = regnet(dev, compute_dtype=bf16).eval()
    engine = ServingEngine(model)
    plan = engine.calibrate([images[:64], images[64:]])
    print(f"RegNetY-1.6GF serving plan: mode {plan.mode}, served "
          f"{plan.served}, ranking {plan.ranking}, exact {plan.exact}")
    if (plan.mode != "dense-masked" or plan.served != plan.mode
            or plan.ranking != {}):
        raise AssertionError("RegNet: not the no-ranking dense-masked plan")
    logits, _ = counted(lambda: engine(images))
    if logits.shape != (B, 1000) or not torch.isfinite(logits.float()).all():
        raise AssertionError("RegNet: bad served logits")

    # --- no host sync in the forward, bf16 and f32 -------------------------
    model32 = regnet(dev).eval()
    for name, m in (("bf16", model), ("f32", model32)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                m(images[:8], 0.1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"RegNetY-1.6GF {name} forward: no host synchronisation")

    # --- throughput: gates open (fresh), half the groups closed, static ---
    half = regnet(dev, compute_dtype=bf16).eval()
    close_half_the_groups(half)
    static = regnet_static(REGNET_KEY, compute_dtype=bf16,
                           generator=torch.Generator(dev).manual_seed(9)
                           ).eval()
    with torch.no_grad():
        for name, m in (("gates open", model), ("half the groups closed",
                                                half),
                        ("static RegNetY-1.6GF", static)):
            out = m(images, 0.1)
            call = lambda m=m: m(images, 0.1)
            ms = time_ms(call, reps=10, warmup=2)
            busy, launches = device_busy_ms(call, 2)
            print(f"RegNetY-1.6GF {name}: {ms:.4f} ms, "
                  f"{B / (ms / 1e3):.1f} img/s (bs{B} bf16, dense-masked), "
                  f"channel density {torch.cat(out.channel_s).mean().item():.4f}"
                  f", GFLOPs {out.flops.item() / 1e9:.4f}; {busy:.4f} ms of "
                  f"kernels, idle share {max(0.0, 1 - busy / ms):.4f}, "
                  f"{launches:.0f} launches [{card}]")
    del half, static, engine

    # --- f32 channel masks, card against CPU --------------------------------
    x = images[:REGNET_MASK_IMAGES].float()
    with torch.no_grad():
        for mk in channel_maskers(model32):
            mk.fc.bias.zero_()  # decisions near one half
    cpu = lad_regnet_y_1_6gf(**REGNET_KW, device="cpu").eval()
    cpu.load_state_dict(model32.state_dict())
    on_card = recorded_channel_masks(model32, x)
    on_cpu = recorded_channel_masks(cpu, x.cpu())
    agree = (on_card == on_cpu).float().mean().item()
    print(f"RegNetY-1.6GF f32 channel masks, card vs CPU: {agree:.6f} of "
          f"{on_card.numel()} decisions agree (bound {MASK_AGREE_MIN}); "
          f"density {on_card.mean().item():.4f}")
    if agree < MASK_AGREE_MIN:
        raise AssertionError("RegNet f32 masks disagree with the CPU's")
    del model32, cpu, model
    regnet_train(dev, card)


def regnet_train(dev, card):
    from laudnet_tpu_torch.train import main as train_main

    with tempfile.TemporaryDirectory() as out_dir:
        best = train_main.main(REGNET_TRAIN_ARGV + [str(REGNET_TRAIN_STEPS),
                                                    "--train_url", out_dir])
        with open(f"{out_dir}/log.txt") as f:
            header, row = (line.strip().split(",") for line in f.readlines())
        log = open(f"{out_dir}/train.log").read()
        density = open(f"{out_dir}/all_density_latest.txt").read().split(
            "\n")
        wrote = sorted(os.listdir(f"{out_dir}/ckpt"))
    full = [ln for ln in log.splitlines() if "full_flops" in ln]
    print(f"train.main lad_regnet_y_1_6gf: best top1 {best:.4f}; "
          f"{full[0] if full else ''}; log.txt {dict(zip(header, row))}; "
          f"density rows {len([d for d in density if d.strip()])}; "
          f"checkpoint files {wrote}")
    if (not all(math.isfinite(float(v)) for v in row) or "nan" in log
            or f"step_{REGNET_TRAIN_STEPS}.pt" not in wrote):
        raise AssertionError("train.main lad_regnet_y_1_6gf: a metric is not "
                             "finite or no checkpoint was written")

    args = train_main.parse_args(REGNET_TRAIN_ARGV + [str(TRAIN_STEPS)])
    tr = train_main.build_training(args, lambda *a, **k: None)
    images, labels = next(train_main.synthetic_batches(B, IMG, 1000, 1,
                                                       seed=0))
    x, y = tr.to_device(images, labels)
    metrics = [{k: float(v) for k, v in tr.train_step(tr.state, x, y).items()}
               for _ in range(TRAIN_STEPS)]
    for i, m in enumerate(metrics):
        print(f"RegNet train step {i}: " + ", ".join(
            f"{k} {m[k]:.6g}" for k in LOSS_PARTS + ("act_rate", "top1", "lr",
                                                     "temperature")))
        if not all(math.isfinite(m[k]) for k in LOSS_PARTS):
            raise AssertionError(f"RegNet train step {i}: a loss part is not "
                                 "finite")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise AssertionError("the RegNet loss did not fall on a repeated "
                             f"batch: {metrics[0]['loss']} -> "
                             f"{metrics[-1]['loss']}")
    torch.cuda.reset_peak_memory_stats()
    step = lambda: tr.train_step(tr.state, x, y)
    ms = time_ms(step, reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    busy, launches = device_busy_ms(step, 2)
    print(f"RegNet train step (LAUD-RegNetY-1.6GF channel 2-2-2-2 + static "
          f"RegNetY-1.6GF teacher, bf16 compute, lr_mult 0.1, bs{B}): "
          f"{ms:.4f} ms, {B / (ms / 1e3):.1f} img/s; {busy:.4f} ms of "
          f"kernels, idle share {max(0.0, 1 - busy / ms):.4f}, "
          f"{launches:.0f} launches a step; peak memory "
          f"{peak / 2 ** 30:.4f} GiB [{card}]")


def port_kernel(name):
    """A profiler kernel name of the port's own (`csrc/`): every kernel
    there is defined in a top-level anonymous namespace, PyTorch's and the
    libraries' are not (``at::native::(anonymous namespace)::...``)."""
    return name.removeprefix("void ").startswith("(anonymous namespace)::")


def phase_aot(dev, card):
    """Exports, saves and loads the served models through `infer/aot.py`,
    then serves every artifact in one fresh process that has no model code
    (`tools/serve_artifact.py`), and holds its logits and the port's
    kernels it launches (`port_kernel`) to the live models'; PyTorch's own
    kernels are counted beside them. Expected: bit for bit the same logits
    (the same kernels on the same inputs and weights, in another
    process)."""
    from laudnet_tpu_torch.infer import aot

    bf16 = torch.bfloat16
    images = torch.randn(B, IMG, IMG, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(10))
    _, deit = model_pair(laud_deit_small, dev, 0)
    fused = laud_deit_small(layer_skip=False, attn_impl="fused",
                            generator=torch.Generator(dev).manual_seed(11))
    fused = fused.to(bf16).eval()
    reg = regnet(dev, compute_dtype=bf16).eval()
    close_half_the_groups(reg)
    # name, live forward (a model is saved with `save_serving_artifact`),
    # the kernel it must launch
    forms = (
        ("deit_block_dense", build_fused_vit(deit), "fused_vit_block"),
        ("deit_block_snapped", build_fused_vit(
            deit, token_capacity=NOMINAL, snap_capacities=True),
         "fused_vit_segment"),
        ("deit_block_int8", build_fused_vit(deit, int8=True),
         "fused_vit_block_int8"),
        ("laudvit_fused", lambda x: fused(x.to(bf16), 0.1).logits,
         "fused_vit_attention"),
        ("regnet_y_1_6gf", reg, None),
    )
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        torch.save(images, f"{tmp}/images.pt")
        live, paths = {}, []
        for name, fwd, kernel in forms:
            t0 = time.perf_counter()
            if isinstance(fwd, torch.nn.Module):
                path = aot.save_serving_artifact(f"{tmp}/{name}", fwd,
                                                 tuple(images.shape))
            else:
                path = f"{tmp}/{name}.pt2"
                with open(path, "wb") as f:
                    f.write(aot.export_serving_fn(fwd, tuple(images.shape),
                                                  device=dev))
            secs = time.perf_counter() - t0
            call = ((lambda m=fwd: m(images, 0.1).logits)
                    if isinstance(fwd, torch.nn.Module) else
                    (lambda f=fwd: f(images)))
            with torch.no_grad():
                logits, delta = counted(call)
                live[name] = (logits.float().cpu(),
                              serve_artifact.kernel_counts(call), delta)
            if kernel is not None and not delta[kernel] > 0:
                raise AssertionError(f"AOT {name}: the live model ran no "
                                     f"{kernel}")
            paths.append(path)
            print(f"AOT {name}: exported and saved in {secs:.2f} s, "
                  f"{os.path.getsize(path) / 2 ** 20:.1f} MiB")
        # one fresh process serves them all, after the exports: two
        # processes tracing the card at once lose profiler events
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "laudnet_tpu_torch.tools.serve_artifact",
             f"{tmp}/images.pt", f"{tmp}/out"] + paths,
            capture_output=True, text=True)
        if proc.returncode:
            raise AssertionError(f"serve_artifact failed:\n{proc.stderr}")
        print(f"AOT: the fresh process served {len(paths)} artifacts in "
              f"{time.perf_counter() - t0:.1f} s")
        lines = proc.stdout.strip().splitlines()
        for row in map(json.loads, lines):
            name = row["name"]
            want, want_kernels, _ = live[name]
            got = torch.load(f"{tmp}/out/{name}.pt", weights_only=True)
            diff = (got.float() - want).abs().max().item()
            ours = {k: n for k, n in row["kernels"].items() if port_kernel(k)}
            want_ours = {k: n for k, n in want_kernels.items()
                         if port_kernel(k)}
            model_code = [m for m in row["port_modules"]
                          if m.startswith("laudnet_tpu_torch.models")]
            print(f"AOT {name}: loaded program vs live model, largest logit "
                  f"difference {diff:.6g} (bound 0: bit for bit); the port's "
                  f"kernels {sum(ours.values())} a call, live "
                  f"{sum(want_ours.values())}, the same by name and count "
                  f"{ours == want_ours}; all kernels "
                  f"{sum(row['kernels'].values())}, live "
                  f"{sum(want_kernels.values())}; another batch refused "
                  f"{row['refused_other_batch']}; model modules imported "
                  f"{model_code}")
            if row["kernels"] != want_kernels:
                names = set(row["kernels"]) | set(want_kernels)
                print("  kernels that differ (loaded, live): " + "; ".join(
                    f"{k[:90]} {row['kernels'].get(k)} {want_kernels.get(k)}"
                    for k in sorted(names)
                    if row["kernels"].get(k) != want_kernels.get(k)))
            if (diff != 0 or ours != want_ours or model_code
                    or not row["refused_other_batch"]):
                raise AssertionError(f"AOT {name}: the loaded program is not "
                                     "the live model's")
    del deit, fused, reg

    # --- the host cost of the registered op ---------------------------------
    call, launch, dispatch = probe_host.wrapper_host_s(dev)
    print(f"fused_vit_block host cost (DeiT-S bs{B}): {call * 1e6:.2f} us a "
          f"call, {launch * 1e6:.2f} us a launch; the registered op adds "
          f"{dispatch * 1e6:.2f} us a call over its CUDA implementation "
          f"called directly (the ctypes call of earlier builds) [{card}]")


def phase_simulator():
    """The GPU roofline simulator's CLI, as a user runs it, in processes
    that import no JAX: two at once."""
    argvs = (["resnet50", "--hardware", "v100"],
             ["deit_small", "--plan", ",".join(map(str, NOMINAL))])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "laudnet_tpu_torch.sim.cli", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv in argvs]
    for argv, proc in zip(argvs, procs):
        out, err = proc.communicate()
        print(f"sim.cli {' '.join(argv)} (rc {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s):")
        print("  " + out.strip().replace("\n", "\n  "))
        if proc.returncode or ("ms/batch" not in out
                               and "mode     :" not in out):
            raise AssertionError(f"sim.cli printed no prediction:\n{err}")


# --- real input and reference checkpoints (phase 14) ------------------------

DATA_CLASSES, DATA_TRAIN, DATA_VAL = 10, 40, 13   # 400 train, 130 val images
DATA_SIDES = (160, 500)
DATA_STEPS = DATA_CLASSES * DATA_TRAIN // B        # 3 steps of 128
DATA_VAL_BATCHES = -(-DATA_CLASSES * DATA_VAL // B)  # 128 + 2 padded rows
DATA_TRAIN_ARGV = ["--arch", "laud_deit_small", "--vit_attn", "fused",
                   "--amp", "--batch_size", str(B), "--input_size", str(IMG),
                   "--num_classes", str(DATA_CLASSES), "--epochs", "1",
                   "--print_freq", "1"]
# 400 // 192 = 2 steps of the flagship, its val set one batch of 130 + 62
DATA_CNN_ARGV = ["--arch", "uni_resnet50", "--batch_size", "192",
                 "--input_size", str(IMG), "--num_classes",
                 str(DATA_CLASSES), "--epochs", "1", "--print_freq", "1"]
# the native loader against the PIL path, eval transform unnormalised, per
# pixel and in the mean (tests/test_native_loader.py:56-57)
NATIVE_PIXEL, NATIVE_MEAN = 6.0 / 255.0, 1.0 / 255.0


def image_host_facts():
    """What the image pipelines need on this host: PIL, g++, libjpeg's
    header and library; and the cores the loaders' threads share."""
    facts = {}
    try:
        import PIL
        facts["PIL"] = PIL.__version__
    except ImportError:
        facts["PIL"] = None
    try:
        facts["g++"] = run(["g++", "--version"]).splitlines()[0]
        header = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                                input="#include <cstdio>\n#include <jpeglib.h>\n",
                                capture_output=True, text=True)
        facts["jpeglib.h"] = header.returncode == 0
    except (OSError, subprocess.CalledProcessError):
        facts["g++"], facts["jpeglib.h"] = None, False
    try:
        libs = subprocess.run(["ldconfig", "-p"], capture_output=True,
                              text=True).stdout
        facts["libjpeg"] = [line.strip().split(" ")[0] for line in
                            libs.splitlines() if "jpeg" in line.lower()]
    except OSError:
        facts["libjpeg"] = None
    facts["nproc"] = os.cpu_count()
    print(f"host probe: {facts}")
    return facts


def write_image_folder(root):
    """root/{train,val}/<class>/<image>: DATA_CLASSES classes of DATA_TRAIN
    and DATA_VAL JPEGs of 160-500 px a side (smooth noise fields), every
    17th grayscale, one PNG; written by a thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(0)
    jobs = []
    for split, n in (("train", DATA_TRAIN), ("val", DATA_VAL)):
        for c in range(DATA_CLASSES):
            os.makedirs(f"{root}/{split}/n{c:02d}")
            for i in range(n):
                w, h = (int(v) for v in rng.integers(*DATA_SIDES, 2))
                k = len(jobs)
                ext = "png" if k == 5 else "jpg"
                jobs.append((f"{root}/{split}/n{c:02d}/{i}.{ext}", w, h,
                             "L" if k % 17 == 3 else "RGB",
                             int(rng.integers(2 ** 31))))

    def write(job):
        path, w, h, mode, seed = job
        g = np.random.default_rng(seed)
        shape = (9, 12, 3) if mode == "RGB" else (9, 12)
        Image.fromarray(g.integers(0, 255, shape, np.uint8), mode).resize(
            (w, h), Image.BICUBIC).save(path, quality=90)

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(write, jobs))
    return len(jobs)


def loader_rate(loader, epochs=2):
    """img/s of ``loader`` alone over its last epoch (the first warms the
    page cache and the threads); the batches are dropped."""
    for e in range(epochs):
        t = time.perf_counter()
        n = sum(len(y) for _, y in loader.epoch(e))
        secs = time.perf_counter() - t
    return n / secs, secs


def pil_breakdown(paths):
    """Single-thread ms an image of the PIL train transform's parts, in
    its own order (`data/transforms.py::train_transform`)."""
    import random

    from PIL import Image

    from laudnet_tpu_torch.data import transforms as tf

    parts = dict.fromkeys(("open + decode", "crop + resize + flip",
                           "to f32 + normalise"), 0.0)
    for seed, path in enumerate(paths):
        t0 = time.perf_counter()
        with Image.open(path) as img:
            img = img.convert("RGB")
        t1 = time.perf_counter()
        rng = random.Random(seed)
        img = tf.random_resized_crop(img, IMG, rng)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        t2 = time.perf_counter()
        tf._to_array(img, normalize=True)
        t3 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k] += dt * 1e3 / len(paths)
    return parts


def timm_deit_state(model):
    """``model``'s weights under timm's DeiT names: the reference ViT
    checkpoints' layout, without policy heads."""
    from laudnet_tpu_torch.convert import to_flax_tree

    tree = to_flax_tree(model)
    state = {"patch_embed.proj.weight":
             tree["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
             "patch_embed.proj.bias": tree["patch_embed"]["bias"],
             "cls_token": tree["cls_token"], "pos_embed": tree["pos_embed"],
             "norm.weight": tree["norm"]["scale"],
             "norm.bias": tree["norm"]["bias"],
             "head.weight": tree["head"]["kernel"].T,
             "head.bias": tree["head"]["bias"]}
    timm = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
            "fc2": "mlp.fc2", "norm1": "norm1", "norm2": "norm2"}
    for i in range(len(model.blocks)):
        for mod, name in timm.items():
            for leaf, v in tree[f"block_{i}"][mod].items():
                state[f"blocks.{i}.{name}." + ("bias" if leaf == "bias"
                                               else "weight")] = (
                    v.T if leaf == "kernel" else v)
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


def fed_and_synthetic_steps(tr, card):
    """The DeiT-S step fed by the loader (host batch, pinned copy, step;
    one epoch of DATA_STEPS, timed after one warm epoch) beside the same
    step on one batch already on the card, each with its kernels' time and
    idle share, and the fed epoch's peak memory."""
    def epoch(e):
        out = []
        for images, labels in tr.train_loader.epoch(e):
            out.append(tr.train_step(tr.state, *tr.to_device(images, labels)))
        torch.cuda.synchronize()
        return out

    epoch(0)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    metrics = epoch(1)
    fed_ms = (time.perf_counter() - t) * 1e3 / len(metrics)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"the fed DeiT-S steps: loss {losses}")
    fed_busy, fed_launches = device_busy_ms(lambda: epoch(2), 1)
    fed_busy /= DATA_STEPS
    images, labels = next(iter(tr.train_loader.epoch(3)))
    x, y = tr.to_device(images, labels)
    step = lambda: tr.train_step(tr.state, x, y)
    syn_ms = time_ms(step, reps=6, warmup=2)
    syn_busy, _ = device_busy_ms(step, 3)
    print(f"DeiT-S train step fed by the loader: {fed_ms:.4f} ms "
          f"({B / (fed_ms / 1e3):.1f} img/s), {fed_busy:.4f} ms of kernels, "
          f"idle share {max(0.0, 1 - fed_busy / fed_ms):.4f}, peak memory "
          f"{peak / 2 ** 30:.4f} GiB, losses {losses}; on a batch already on "
          f"the card: {syn_ms:.4f} ms, {syn_busy:.4f} ms of kernels, idle "
          f"share {max(0.0, 1 - syn_busy / syn_ms):.4f}; fed / synthetic "
          f"{fed_ms / syn_ms:.4f} [{card}]")


def phase_data(dev, card):
    """Real input and reference checkpoints: the host probe, an image
    folder, the loaders alone, DeiT-S trained from the folder through the
    CLI (B4 and B5 counted), and reference `.pth.tar` files written by the
    port's converter and read back by ``--teacher_path``,
    ``--finetune_from`` and ``--evaluate_from``."""
    from laudnet_tpu_torch.convert import (load_flax_variables, save_pth_tar,
                                           to_flax_variables)
    from laudnet_tpu_torch.data import (DataLoader, ImageFolderDataset,
                                        eval_transform, native_loader,
                                        train_transform)
    from laudnet_tpu_torch.train import main as train_main

    facts = image_host_facts()
    native = native_loader.native_available()
    print(f"native C++ loader: {'builds' if native else 'does not build: '}"
          f"{'' if native else (native_loader.build_error() or '').strip()[:300]}")
    if native and not facts["jpeglib.h"]:
        raise AssertionError("the native loader built without jpeglib.h")
    quiet = lambda *a, **k: None

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/images"
        if facts["PIL"] is None:
            print("image part of phase 14 not run: this host has no PIL, so "
                  "no image can be written here, and "
                  + ("libjpeg's header is there" if facts["jpeglib.h"]
                     else "no libjpeg header either, so no pipeline of the "
                          "port can decode one"))
        else:
            t = time.perf_counter()
            n = write_image_folder(root)
            print(f"image folder: {n} images of {DATA_SIDES[0]}-"
                  f"{DATA_SIDES[1]} px, {DATA_CLASSES} classes, in "
                  f"{time.perf_counter() - t:.1f} s")

            # --- the loaders alone ---------------------------------------
            train_dir = f"{root}/train"
            pil = DataLoader(ImageFolderDataset(train_dir,
                                                train_transform(IMG)), B)
            rates = {"PIL": loader_rate(pil)}
            one = DataLoader(ImageFolderDataset(train_dir,
                                                train_transform(IMG)), B,
                             num_workers=1)
            rates["PIL, 1 thread"] = loader_rate(one, epochs=1)
            parts = pil_breakdown([p for p, _ in one.dataset.samples[:64]])
            print("PIL train transform, one thread, ms an image: " + ", ".join(
                f"{k} {v:.3f}" for k, v in parts.items())
                + f" (sum {sum(parts.values()):.3f})")
            if native:
                fast = native_loader.NativeDataLoader(
                    ImageFolderDataset(train_dir, None), B, size=IMG)
                rates["native"] = loader_rate(fast)
                paths = [p for p, _ in fast.dataset.samples[::50]]
                ours = native_loader.NativeBatchTransform(
                    IMG, train=False, normalize=False).load(
                        paths, [0] * len(paths))
                from PIL import Image
                ref = []
                for p in paths:
                    with Image.open(p) as img:
                        ref.append(eval_transform(IMG, normalize=False)(img))
                diff = abs(ours - np.stack(ref))
                print(f"native vs PIL eval transform on {len(paths)} "
                      f"images: max {diff.max():.6f}, mean "
                      f"{diff.mean():.6f}")
                if diff.max() > NATIVE_PIXEL or diff.mean() > NATIVE_MEAN:
                    raise AssertionError("native loader disagrees with PIL")
            for name, (rate, secs) in rates.items():
                print(f"loader alone, {name}: {rate:.1f} img/s (bs{B} "
                      f"{IMG}^2 train transform, {secs:.3f} s an epoch of "
                      f"{DATA_STEPS * B} images, {facts['nproc']} cores)")
            if native:
                print(f"native / PIL: {rates['native'][0] / rates['PIL'][0]:.4f}")

            # --- DeiT-S trained from the folder through the CLI ----------
            argv = DATA_TRAIN_ARGV + ["--data_url", root]
            with tempfile.TemporaryDirectory() as out:
                best, delta = counted(lambda: train_main.main(
                    argv + ["--train_url", out]))
                log = open(f"{out}/train.log").read()
                with open(f"{out}/log.txt") as f:
                    header, row = (line.strip().split(",")
                                   for line in f.readlines())
            n_b4 = delta["fused_vit_attention"]
            n_b5 = delta["fused_vit_attention_bwd"]
            want = ("input pipeline: native C++ loader" if native
                    else "input pipeline: PIL")
            pipeline = next(line for line in log.splitlines()
                            if "input pipeline" in line)
            print(f"train.main --data_url: best top1 {best:.4f}; B4 "
                  f"{n_b4}, B5 {n_b5} launches; '{pipeline.strip()}'; "
                  f"log.txt {dict(zip(header, row))}")
            if (n_b4 != 24 * DATA_STEPS + 12 * DATA_VAL_BATCHES
                    or n_b5 != 12 * DATA_STEPS):
                raise AssertionError(
                    f"train.main --data_url: expected "
                    f"{24 * DATA_STEPS + 12 * DATA_VAL_BATCHES} B4 and "
                    f"{12 * DATA_STEPS} B5 launches")
            if want not in pipeline or f"[{DATA_STEPS - 1}/{DATA_STEPS}]" \
                    not in log or "nan" in log:
                raise AssertionError("train.main --data_url: wrong pipeline, "
                                     "step count or a metric not finite")
            if not all(math.isfinite(float(v)) for v in row):
                raise AssertionError("train.main --data_url: a metric is "
                                     "not finite")
            # timing runs: their launches are not the main path's
            tr = train_main.build_training(train_main.parse_args(argv), quiet)
            fed_and_synthetic_steps(tr, card)
            del tr

        # --- reference checkpoints on the card ---------------------------
        cnn_args = train_main.parse_args(DATA_CNN_ARGV + ["--seed", "21"])
        src = train_main.build_training(cnn_args, quiet)
        g = torch.Generator(dev).manual_seed(22)
        for model in (src.model, src.teacher):
            for name, buf in model.named_buffers():
                if name.endswith("running_mean"):
                    buf.copy_(torch.randn(buf.shape, generator=g,
                                          device=dev) * 0.1)
        flagship_path = f"{tmp}/laud_resnet50.pth.tar"
        dense_path = f"{tmp}/resnet50.pth.tar"
        save_pth_tar(to_flax_variables(src.model), flagship_path, epoch=0)
        save_pth_tar(to_flax_variables(src.teacher), dense_path, epoch=0)
        ckpt = ["--teacher_path", dense_path, "--finetune_from", flagship_path]
        loaded = train_main.build_training(
            train_main.parse_args(DATA_CNN_ARGV + ckpt), quiet)
        x = torch.randn(16, IMG, IMG, 3, device=dev,
                        generator=torch.Generator(dev).manual_seed(23))
        with torch.no_grad():
            same_teacher = torch.equal(loaded.teacher(x, training=False),
                                       src.teacher(x, training=False))
            same_student = torch.equal(
                loaded.model(x, 0.1, training=False).logits,
                src.model(x, 0.1, training=False).logits)
        print(f"reference checkpoints read back on the card: the teacher's "
              f"f32 logits bit for bit {same_teacher}, the fine-tuned "
              f"flagship's {same_student}")
        if not (same_teacher and same_student):
            raise AssertionError("a checkpoint read back on the card gives "
                                 "other logits than its source model")
        del loaded
        if facts["PIL"] is not None:
            data = ["--data_url", root, "--amp"]
            with tempfile.TemporaryDirectory() as out:
                best, _ = counted(lambda: train_main.main(
                    DATA_CNN_ARGV + data + ckpt + ["--train_url", out]))
                log = open(f"{out}/train.log").read()
            print(f"train.main uni_resnet50 --teacher_path --finetune_from "
                  f"--data_url: best top1 {best:.4f}")
            if ("loaded teacher from" not in log or "[1/2]" not in log
                    or "nan" in log or "disabling KD" in log):
                raise AssertionError("the flagship's fine-tuning run")
            with tempfile.TemporaryDirectory() as out:
                top1 = train_main.main(DATA_CNN_ARGV + data + [
                    "--evaluate_from", flagship_path, "--train_url", out])
            ref = train_main.build_training(
                train_main.parse_args(DATA_CNN_ARGV + data), quiet)
            load_flax_variables(ref.model, to_flax_variables(src.model))
            want = train_main._validate(ref)[0]
            print(f"--evaluate_from the flagship file: top1 {top1!r}; its "
                  f"source model on the same val set: {want!r}")
            if top1 != want:
                raise AssertionError("--evaluate_from disagrees with the "
                                     "file's source model")
            del ref

            # a timm DeiT-S file: the policy heads stay as initialised
            vit_args = train_main.parse_args(DATA_TRAIN_ARGV + [
                "--data_url", root, "--seed", "24"])
            vit = train_main.build_training(vit_args, quiet)
            with torch.no_grad():
                for name, p in vit.model.named_parameters():
                    if "_policy" not in name:
                        p.mul_(1.01)
            deit_path = f"{tmp}/deit_small.pth"
            torch.save({"model": timm_deit_state(vit.model)}, deit_path)
            want = train_main._validate(vit)[0]
            del vit
            with tempfile.TemporaryDirectory() as out:
                top1, delta = counted(lambda: train_main.main(
                    DATA_TRAIN_ARGV + ["--data_url", root, "--seed", "24",
                                       "--evaluate_from", deit_path,
                                       "--train_url", out]))
            print(f"--evaluate_from a timm DeiT-S file: top1 {top1!r} "
                  f"(its source with the same policy heads: {want!r}); B4 "
                  f"{delta['fused_vit_attention']} launches")
            if top1 != want or not delta["fused_vit_attention"]:
                raise AssertionError("--evaluate_from the DeiT-S file")


# --- phase 15: parallel/ ---------------------------------------------------

PARALLEL_STEPS = 3
# Two processes on the one card, LAUD-DeiT-S at full width in bf16, each
# leg against one process on the whole batch (`entry.dryrun_multichip`,
# distances relative to the one-process result's norm): the dp step's
# loss parts at TRAIN_REL (the two runs' products see other batch shapes
# and round in bf16 otherwise); the tp and pp logits, the sp stream and the
# fsdp gradient at REL_ERR_MAX (bf16 sums split over two ranks).
PARALLEL_BOUNDS = {"dp": TRAIN_REL, "tp": REL_ERR_MAX, "sp": REL_ERR_MAX,
                   "fsdp": REL_ERR_MAX, "pp": REL_ERR_MAX}
# The collectives each two-process leg runs (`parallel/`): the step-0 probe
# (`tools/probe_dist.py`) says which gloo takes on CUDA tensors; a leg that
# needs one it refuses is not run and waits for a machine with two cards.
LEG_COLLECTIVES = {
    "dp": ("all_reduce", "all_gather", "broadcast"),
    "tp": ("all_reduce", "all_gather", "broadcast"),
    "sp": ("all_reduce", "all_gather", "broadcast"),
    "fsdp": ("all_reduce", "all_gather", "broadcast",
             "all_gather_into_tensor", "reduce_scatter_tensor"),
    "pp": ("all_reduce", "all_gather", "broadcast", "send_recv"),
}


def phase_parallel(dev, card):
    """Phase 15 (module docstring): world size 1 over NCCL through the CLI,
    plain and --fsdp; the one-rank ServingEngine(mesh=); B4/B5 on the
    local heads of tp = 2, 3, 6; two processes on the card over gloo."""
    import torch.distributed as dist

    from laudnet_tpu_torch.entry import dryrun_multichip
    from laudnet_tpu_torch.ops.vit_attention import (
        fused_vit_attention, reference_vit_attention,
        reference_vit_attention_bwd)
    from laudnet_tpu_torch.parallel import make_mesh
    from laudnet_tpu_torch.parallel.mesh import free_port
    from laudnet_tpu_torch.parallel.tp import (ModelParallel, local_shard,
                                               tp_fused_vit_attention)
    from laudnet_tpu_torch.tools.probe_dist import (COLLECTIVES, FSDP_TRIALS,
                                                    trials)
    from laudnet_tpu_torch.train import main as train_main

    t0 = time.perf_counter()
    # --- (a) one process, world size 1 over NCCL ---------------------------
    dist_argv = ["--dist_coordinator", f"127.0.0.1:{free_port()}",
                 "--dist_num_processes", "1", "--dist_process_id", "0"]
    argv = [a for a in TRAIN_ARGV]
    argv[argv.index("--steps_per_epoch") + 1] = str(PARALLEL_STEPS)
    for extra in ([], ["--fsdp"]):
        with tempfile.TemporaryDirectory() as out_dir:
            t = time.perf_counter()
            best, delta = counted(lambda: train_main.main(
                argv + dist_argv + extra + ["--train_url", out_dir]))
            secs = time.perf_counter() - t
            with open(f"{out_dir}/log.txt") as f:
                header, row = (ln.strip().split(",") for ln in f.readlines())
            log = open(f"{out_dir}/train.log").read()
        n_b4 = delta["fused_vit_attention"]
        n_b5 = delta["fused_vit_attention_bwd"]
        print(f"parallel: train.main world size 1 over NCCL "
              f"{' '.join(extra) or '(data parallel)'}: {PARALLEL_STEPS} "
              f"steps and validation in {secs:.1f} s, B4 {n_b4}, B5 {n_b5}, "
              f"log.txt {dict(zip(header, row))}")
        if (n_b4 != 24 * PARALLEL_STEPS + 24 or n_b5 != 12 * PARALLEL_STEPS
                or not all(math.isfinite(float(v)) for v in row)
                or "nan" in log or ("FSDP" in log) != bool(extra)):
            raise AssertionError("parallel: the world-size-1 run is wrong")
    if (dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo")
            or dist.get_world_size() != 1):
        raise AssertionError("parallel: the CLI did not join NCCL alone")

    # the first step through the group (plain and FSDP) against the CLI's
    # step without --dist_*, same seed and batch
    images, labels = next(train_main.synthetic_batches(B, IMG, 1000, 1,
                                                       seed=0))
    quiet = lambda *a, **k: None

    from torch.profiler import ProfilerActivity, profile

    def first_step(extra):
        """The training of ``argv + extra``, its first step's metrics, and
        the qkv weight of block 0 before and after that step (gathered from
        FSDP's shards)."""
        tr = train_main.build_training(train_main.parse_args(argv + extra),
                                       quiet)
        full = lambda p: (p.full_tensor() if hasattr(p, "full_tensor")
                          else p).detach().float().clone()
        before = full(tr.model.blocks[0].qkv.weight)
        tr.batch = tr.to_device(images, labels)
        m = tr.train_step(tr.state, *tr.batch)
        if hasattr(tr.model, "reshard"):
            tr.model.reshard()
        return tr, {k: float(v) for k, v in m.items()}, before, full(
            tr.model.blocks[0].qkv.weight)

    trainings = {}
    trainings["no group"], plain, before, after = first_step([])
    for label, extra in (("dp", dist_argv),
                         ("--fsdp", dist_argv + ["--fsdp"])):
        trainings[label], got, _, moved = first_step(extra)
        worst = max(abs(got[k] - plain[k]) / abs(plain[k])
                    for k in LOSS_PARTS)
        step_rel = ((moved - after).norm() / (after - before).norm()).item()
        print(f"parallel: first step {label} over the group vs without: "
              + ", ".join(f"{k} {got[k]:.6g} / {plain[k]:.6g}"
                          for k in LOSS_PARTS)
              + f"; worst relative difference {worst:.3g} (bound "
              f"{TRAIN_REL}); block 0's qkv update {step_rel:.3g} of its "
              f"norm apart (bound {TRAIN_REL})")
        if not (worst <= TRAIN_REL and step_rel <= TRAIN_REL):
            raise AssertionError("parallel: the step over the group "
                                 "disagrees with the step without it")
    # the three steps timed in turns (a b c c b a, twice), then each
    # profiled for 2 steps: kernel ms, idle share, NCCL kernels, host calls
    readings = {k: [] for k in trainings}
    for order in (list(trainings), list(trainings)[::-1]) * 2:
        for k in order:
            tr = trainings[k]
            readings[k].append(time_ms(lambda: tr.train_step(
                tr.state, *tr.batch), reps=3, warmup=1))
    for k, tr in trainings.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                tr.train_step(tr.state, *tr.batch)
            torch.cuda.synchronize()
        averages = prof.key_averages()
        kernels = [e for e in averages if e.device_type.name == "CUDA"]
        busy = sum(e.device_time_total for e in kernels) / 2 / 1e3
        nccl = sum(e.device_time_total for e in kernels
                   if "nccl" in e.key.lower()) / 2 / 1e3
        host = {e.key: e.count // 2 for e in averages if e.key in (
            "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
            "cudaStreamSynchronize", "aten::item")}
        ms = statistics.median(readings[k])
        print(f"parallel: train step ({k}): {ms:.4f} ms (readings "
              f"{', '.join(f'{v:.2f}' for v in readings[k])}), {busy:.4f} "
              f"ms of kernels in {len(kernels)} kernels, idle share "
              f"{max(0.0, 1 - busy / ms):.4f}, NCCL kernels {nccl:.4f} ms, "
              f"host calls a step {host} [{card}]")
    del trainings

    # the one-rank ServingEngine(mesh=): DeiT-S snapped through the block
    # engine, logits equal to the engine without a mesh
    gen = torch.Generator(dev).manual_seed(21)
    deit = laud_deit_small(token_skip=True, head_skip=False,
                           layer_skip=False, token_capacity=NOMINAL,
                           device=dev, generator=gen
                           ).to(torch.bfloat16).eval()
    x = torch.randn(B, IMG, IMG, 3, generator=gen, device=dev)
    alone = ServingEngine(deit, snap_capacities=True)(x)
    engine = ServingEngine(deit, snap_capacities=True,
                           mesh=make_mesh(device=dev))
    served, delta = counted(lambda: engine(x))
    equal = torch.equal(served, alone)
    print(f"parallel: ServingEngine(mesh=1-rank) on DeiT-S snapped: logits "
          f"{'bit for bit' if equal else 'DIFFER from'} the engine without "
          f"a mesh; launches {delta}")
    if not equal or not (delta["fused_vit_block"]
                         or delta["fused_vit_segment"]):
        raise AssertionError("parallel: the mesh engine serves otherwise")

    # --- (b) B4 / B5 on local heads, DeiT-S bs128 L=197 with a head mask --
    g = torch.Generator().manual_seed(22)
    d, heads = DEIT["d"], DEIT["heads"]
    qkv = torch.randn(B, L_FULL, 3 * d, generator=g).to(dev, torch.bfloat16)
    km = key_mask(g, L_FULL, dev, ragged=True)
    hm = head_gate(g, heads, dev)
    gout = torch.randn(B, L_FULL, d, generator=g).to(dev, torch.bfloat16)
    scale = (d // heads) ** -0.5
    whole = fused_vit_attention(qkv, km, hm, heads, scale)
    for tp in (2, 3, 6):
        h_loc = heads // tp
        outs = []
        for r in range(tp):
            q_loc = local_shard(qkv, 2, r, tp, sections=3)
            hm_loc = hm[:, r * h_loc:(r + 1) * h_loc].contiguous()
            out = tp_fused_vit_attention(q_loc, km, hm, heads, scale,
                                         ModelParallel(None, r, tp))
            ref, stats = reference_vit_attention(q_loc, km, hm_loc, h_loc,
                                                 scale, return_stats=True)
            err = (out.float() - ref.float()).abs().max().item()
            q_g = q_loc.detach().requires_grad_()
            o_g = fused_vit_attention(q_g, km, hm_loc, h_loc, scale)
            g_loc = local_shard(gout, 2, r, tp)
            o_g.backward(g_loc)
            ref_dq, _ = reference_vit_attention_bwd(
                q_loc, km, hm_loc, g_loc, h_loc, scale, stats=stats)
            err_b = (q_g.grad.float() - ref_dq.float()).abs().max().item()
            if not (err <= ulp_tol(ref) and err_b <= ulp_tol(ref_dq)):
                raise AssertionError(
                    f"parallel: B4/B5 on {h_loc} local heads (tp={tp}, "
                    f"rank {r}) off their plain versions: {err:.3g} / "
                    f"{err_b:.3g}")
            outs.append(out)
        joined = torch.cat(outs, -1)
        diff = (joined.float() - whole.float()).abs().max().item()
        print(f"parallel: tp={tp}: B4 and B5 on {h_loc} local head(s) within "
              f"{ULPS} ulps of their plain versions on every rank; the "
              f"ranks' outputs joined are "
              + ("bit for bit the all-heads launch" if diff == 0 else
                 f"{diff:.3g} from the all-heads launch") + f" [{card}]")

    # --- (c) two processes on the card over gloo --------------------------
    probe = trials("gloo", COLLECTIVES + FSDP_TRIALS)
    print(f"parallel: gloo on CUDA tensors: {probe}")
    legs = tuple(leg for leg, needs in LEG_COLLECTIVES.items()
                 if all(probe[n] == "ok" for n in needs))
    waiting = [leg for leg in LEG_COLLECTIVES if leg not in legs]
    if waiting:
        print(f"parallel: legs that wait for a machine with two cards (a "
              f"collective gloo refuses on CUDA tensors): {waiting}")
    # dp1 x tp2 for every leg the probe allows, then dp2 x tp1 for the
    # data-parallel legs (their data group has two ranks only there, so
    # FSDP2's whole step over the two ranks must pass the probe)
    dp2_legs = tuple(leg for leg in legs if leg == "dp" or (
        leg == "fsdp" and probe["fsdp2_step"] == "ok"))
    if "fsdp" in legs and "fsdp" not in dp2_legs:
        print(f"parallel: the dp2 x tp1 fsdp leg waits for a machine with "
              f"two cards: FSDP2's step over gloo on CUDA tensors "
              f"{probe['fsdp2_step']}")
    for model_par, which in ((2, legs), (1, dp2_legs)):
        if not which:
            continue
        t = time.perf_counter()
        dist_ = dryrun_multichip(2, device=dev.type, backend="gloo",
                                 full_width=True, legs=which,
                                 model_parallel=model_par)
        print(f"parallel: two processes on the card, LAUD-DeiT-S full width, "
              f"dp{2 // model_par} x tp{model_par}: {dist_} (bounds "
              f"{PARALLEL_BOUNDS}) in {time.perf_counter() - t:.1f} s")
        for leg, v in dist_.items():
            if not v <= PARALLEL_BOUNDS[leg]:
                raise AssertionError(f"parallel: leg {leg} (dp"
                                     f"{2 // model_par} x tp{model_par}) is "
                                     f"{v} from one process")
    dist.destroy_process_group()
    print(f"parallel: phase 15 in {time.perf_counter() - t0:.1f} s [{card}]")


# --- the CNN detectors (phase 16) ------------------------------------------------

DET_CONFIGS = {
    "retinanet": "configs/detection/retinanet_laud_r101_channel_2222_0x6.py",
    "faster_rcnn": "configs/detection/faster_rcnn_laud_r101_channel_2222_0x8.py",
    "mask_rcnn": "configs/detection/mask_rcnn_laud_r101_channel_2222_0x8.py",
}
DET_SIZE, DET_BATCH = (800, 1344), 2    # COCO's rectangular size, mmdet's bs
DET_SMALL = (256, 384)                  # the card-against-CPU geometry
# Card against CPU, f32 with TF32 off on both: the raw outputs of 100+
# convolutions summed in other orders (cuDNN against oneDNN) differ by
# ~1e-6 of their norm a layer; a gate that flips at an f32 tie changes its
# block's output, which the MASK_AGREE_MIN bound lets through for 0.5 % of
# the decisions. DET_F32_REL bounds ||card - cpu|| / ||cpu|| per output.
DET_F32_REL = 1e-3
# The first training step's loss parts, card against CPU on the same
# weights and Gumbel draws: the RPN, sparsity and RetinaNet parts within
# DET_F32_REL; the second-stage parts (RoI classification and box, mask)
# sum over a proposal set that an objectness near-tie at the top-1000 or
# NMS boundary may change by a box, so within DET_ROI_REL.
DET_ROI_REL = 1e-2
DET_CONVERGE = 0.7   # the reduced-depth run's last loss below this x first
DET_CONVERGE_CFG = dict(num_classes=3, base_lr=0.005, lr_mult=0.5, epochs=1,
                        steps_per_epoch=40, warmup_steps=10,
                        lambda_sparse=0.1)


def det_model_cfg(kind):
    from laudnet_tpu_torch.utils.config import Config

    return dict(Config.fromfile(DET_CONFIGS[kind])["model"])


def write_imagenet_checkpoint(path, dev, seed=0, residual_scale=0.1,
                              dyn_mode="channel"):
    """The ImageNet-format LAUD-ResNet-101 file the CLI's ``--init_from``
    reads (the configs' own files are not in the repository): the port's
    ``uni_resnet101`` in the configs' channel 2-2-2-2 mode (or ``dyn_mode``
    in every stage), each block's
    last BatchNorm scale at ``residual_scale`` (a trained ResNet keeps its
    residual branches small, torchvision's ``zero_init_residual`` starts
    them at 0; at 1 the residual stream of 33 random blocks grows to 5-10x
    the stem's scale and the first RetinaNet loss reads ~870), its
    BatchNorm running statistics the mean of three training-mode forwards'
    batch statistics on synthetic detection images, written by
    `convert/torch_export.py::save_pth_tar`."""
    from laudnet_tpu_torch.convert import save_pth_tar, to_flax_variables
    from laudnet_tpu_torch.detection.runner import synthetic_coco_batches
    from laudnet_tpu_torch.models import uni_resnet101
    from laudnet_tpu_torch.ops.gating import GumbelNoise
    from laudnet_tpu_torch.ops.norm import BatchNorm

    model = uni_resnet101(dyn_mode=(dyn_mode,) * 4,
                          channel_dyn_granularity=(2,) * 4,
                          channel_masker=("MLP",) * 4,
                          channel_masker_layers=(2,) * 4, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
    with torch.no_grad():
        for s, blocks in enumerate(model.stages()):
            for block in blocks:
                block.bn3.weight.fill_(residual_scale)
                if dyn_mode != "channel":  # its gate grid follows the input
                    block.set_output_size(tuple(-(-n // 2 ** (s + 2))
                                                for n in DET_SIZE))
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    noise = GumbelNoise.seeded(seed, dev)
    with torch.no_grad():
        for k, batch in enumerate(synthetic_coco_batches(
                DET_BATCH, DET_SIZE, 3, 3, seed=seed)):
            for m in norms:  # running statistics = the mean of the batches'
                m.momentum = k / (k + 1)
            model(torch.from_numpy(batch[0]).to(dev), 0.1, training=True,
                  noise=noise)
    for m in norms:
        m.momentum = 0.9
    save_pth_tar(to_flax_variables(model), path)
    return path


def write_coco_dir(root, n=8, seed=0):
    """A flat-layout COCO directory: ``n`` JPEGs of 400-640 px with 1-4
    objects of 3 categories, half with polygon and half with RLE masks,
    under ``images/``, the same annotations as ``train.json`` and
    ``val.json``."""
    from PIL import Image

    def rle(mask):
        counts, run, val = [], 0, 0
        for v in mask.T.reshape(-1):
            if v == val:
                run += 1
            else:
                counts.append(run)
                run, val = 1, 1 - val
        counts.append(run)
        return counts

    os.makedirs(os.path.join(root, "images"))
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(n):
        h, w = int(rng.integers(400, 520)), int(rng.integers(500, 640))
        img = (rng.random((h, w, 3)) * 90).astype(np.uint8)
        for m in range(1 + i % 4):
            bw, bh = int(rng.integers(60, w // 2)), int(rng.integers(60, h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y0:y0 + bh, x0:x0 + bw, m % 3] = 220
            mask = np.zeros((h, w), np.uint8)
            mask[y0:y0 + bh, x0:x0 + bw] = 1
            seg = ([[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]]
                   if (i + m) % 2 else dict(size=[h, w], counts=rle(mask)))
            anns.append(dict(id=len(anns) + 1, image_id=i,
                             category_id=(1, 2, 3)[m % 3],
                             bbox=[x0, y0, bw, bh], area=bw * bh, iscrowd=0,
                             segmentation=seg))
        Image.fromarray(img).save(os.path.join(root, "images", f"{i}.jpg"),
                                  quality=90)
        images.append(dict(id=i, file_name=f"{i}.jpg", height=h, width=w))
    ann = dict(images=images, annotations=anns,
               categories=[dict(id=c, name=f"c{c}") for c in (1, 2, 3)])
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}.json"), "w") as f:
            json.dump(ann, f)
    return root


def det_cli_runs(tmp, ckpt, coco, card):
    """(a) ``train`` then ``eval_info`` through the CLI at full width."""
    from laudnet_tpu_torch.detection import cli

    size = ["--image_size", f"{DET_SIZE[0]},{DET_SIZE[1]}", "--batch_size",
            str(DET_BATCH)]
    for kind, data in (("retinanet", []), ("mask_rcnn", ["--data_dir", coco])):
        work = os.path.join(tmp, kind)
        t = time.perf_counter()
        history = cli.main(["train", DET_CONFIGS[kind], "--work_dir", work,
                            "--amp", "--init_from", ckpt, "--epochs", "1",
                            "--steps_per_epoch", "3"] + size + data)
        train_s = time.perf_counter() - t
        bad = [(i, k) for i, m in enumerate(history) for k, v in m.items()
               if k.startswith("loss") and not math.isfinite(v)]
        if len(history) != 2 or bad:
            raise AssertionError(f"detection CLI {kind}: {len(history)} "
                                 f"logged steps, losses not finite: {bad}")
        t = time.perf_counter()
        res = cli.main(["eval_info", DET_CONFIGS[kind], "--work_dir", work,
                        "--eval_steps", "2"] + size + data)
        eval_s = time.perf_counter() - t
        keys = ("mAP",) + (("segm_mAP",) if kind == "mask_rcnn" else ())
        if not (all(0.0 <= res[k] <= 1.0 for k in keys)
                and 0.0 < res["mean_flops_rate"] <= 1.0
                and res["n_images"] == 2 * DET_BATCH):
            raise AssertionError(f"detection CLI eval_info {kind}: {res}")
        print(f"detection CLI {kind} (LAUD-R101 channel 2-2-2-2, "
              f"{DET_SIZE[0]}x{DET_SIZE[1]} bs{DET_BATCH}): train --amp 3 "
              f"steps in {train_s:.1f} s, losses "
              + ", ".join(f"{k} {v:.4f}" for k, v in history[-1].items()
                          if k.startswith("loss"))
              + f"; eval_info 2 batches in {eval_s:.1f} s: "
              + ", ".join(f"{k} {res[k]:.4f}" for k in keys
                          + ("mean_flops_rate",))
              + f", mean GFLOPs {res['mean_flops'] / 1e9:.2f} [{card}]")


class RecordingNoise:
    """`GumbelNoise` that keeps every draw (as numpy) for a replay."""

    def __init__(self, seed):
        from laudnet_tpu_torch.ops.gating import GumbelNoise

        self.noise, self.arrays = GumbelNoise.seeded(seed), []

    def gumbel(self, shape, dtype=torch.float32, device=None):
        g = self.noise.gumbel(shape, dtype)
        self.arrays.append(g.numpy().copy())
        return g if device is None else g.to(device)


def gate_masks(model, run):
    """``run()``'s output and every gating head's mask, in call order."""
    from laudnet_tpu_torch.models.maskers import (ChannelMaskerConvLinear,
                                                  ChannelMaskerMLP,
                                                  SpatialMasker)

    masks, hooks = [], []
    for m in model.modules():
        if isinstance(m, (ChannelMaskerMLP, ChannelMaskerConvLinear,
                          SpatialMasker)):
            hooks.append(m.register_forward_hook(
                lambda mod, args, out: masks.append(out[0].detach().cpu())))
    try:
        return run(), masks
    finally:
        for h in hooks:
            h.remove()


def det_rel(got, ref):
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def det_same(tag, got, ref):
    """Bit-for-bit equality of two dicts (or tuples) of tensors."""
    items = got.items() if isinstance(got, dict) else enumerate(got)
    for k, v in items:
        if not torch.equal(v.cpu(), ref[k].cpu()):
            raise AssertionError(f"detection card vs CPU: {tag} {k} differs")


def det_card_vs_cpu(dev, ckpt, card):
    """(b) Full depth at DET_SMALL, f32, the same weights on both."""
    from laudnet_tpu_torch.detection.runner import (
        DetTrainConfig, batch_to_device, build_detector,
        load_backbone_checkpoint, make_detection_sgd,
        make_detector_train_step, synthetic_coco_batches)
    from laudnet_tpu_torch.detection.two_stage import (TWO_STAGE_STRIDES,
                                                       roi_align)
    from laudnet_tpu_torch.device import full_f32_convolutions
    from laudnet_tpu_torch.ops.gating import ReplayNoise
    from laudnet_tpu_torch.train.trainer import TrainState

    batch = next(synthetic_coco_batches(DET_BATCH, DET_SMALL, 3, 1, seed=7,
                                        max_gt=8, with_masks=True))
    for kind in ("retinanet", "mask_rcnn"):
        cpu, _ = build_detector(det_model_cfg(kind), device="cpu",
                                generator=torch.Generator().manual_seed(3))
        load_backbone_checkpoint(cpu, ckpt)
        gpu, _ = build_detector(det_model_cfg(kind), device=dev)
        gpu.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(batch[0])
        with torch.no_grad():
            ref, ref_masks = gate_masks(cpu, lambda: cpu(x))
            out, masks = gate_masks(gpu, lambda: gpu(x.to(dev)))
        agree = (torch.cat([a.flatten() for a in masks])
                 == torch.cat([b.flatten() for b in ref_masks])).float()
        errs = {}
        if kind == "retinanet":
            for k in ("cls_logits", "box_deltas"):
                errs[k] = det_rel(out[k], ref[k])
            det = type(cpu).detect(ref, DET_SMALL)
            det_same("RetinaNet.detect", type(gpu).detect(
                {k: (v.to(dev) if torch.is_tensor(v) else v)
                 for k, v in ref.items()}, DET_SMALL), det)
        else:
            for k in ("rpn_obj", "rpn_reg"):
                errs[k] = det_rel(out[k], ref[k])
            # the second stage on the CPU's proposals, TF32 off as in the
            # model's forward
            with torch.no_grad(), full_f32_convolutions():
                feats, _, _ = gpu.backbone(x.to(dev))
                pyramid = gpu.neck(feats)
                second = gpu.roi_heads(pyramid, ref["proposals"].to(dev),
                                       *DET_SMALL)
                for k, v in zip(("cls_logits", "box_deltas", "mask_logits"),
                                second):
                    errs[k] = det_rel(v, ref[k])
                anchors = ref["anchors"]
                det_same("FasterRCNN.propose", gpu.propose(
                    ref["rpn_obj"].to(dev), ref["rpn_reg"].to(dev),
                    anchors.to(dev), *DET_SMALL), cpu.propose(
                    ref["rpn_obj"], ref["rpn_reg"], anchors, *DET_SMALL))
                cpu_pyr = [p.cpu() for p in pyramid[:4]]
                for size in (7, 14):
                    det_same(f"roi_align {size}", [roi_align(
                        pyramid[:4], ref["proposals"].to(dev),
                        TWO_STAGE_STRIDES[:4], size)], [roi_align(
                            cpu_pyr, ref["proposals"], TWO_STAGE_STRIDES[:4],
                            size)])
            det = type(cpu).detect(ref)
            det_same("FasterRCNN.detect", type(gpu).detect(
                {k: (v.to(dev) if torch.is_tensor(v) else v)
                 for k, v in ref.items()}), det)
        worst = max(errs.values())
        print(f"detection card vs CPU {kind} (R101 {DET_SMALL[0]}x"
              f"{DET_SMALL[1]} f32): gate masks {agree.mean().item():.6f} "
              f"equal ({agree.numel()}); rel err "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; detect, propose and roi_align bit for bit [{card}]")
        if agree.mean().item() < MASK_AGREE_MIN or worst > DET_F32_REL:
            raise AssertionError(f"detection card vs CPU {kind}: masks "
                                 f"{agree.mean().item()}, errors {errs}")

        # the first f32 training step, the same Gumbel draws
        cfg = DetTrainConfig(num_classes=80, epochs=1, steps_per_epoch=2,
                             warmup_steps=1, with_masks=kind == "mask_rcnn")
        parts = []
        recording = RecordingNoise(5)
        data = batch if cfg.with_masks else batch[:4]
        for model, device, noise in ((cpu, "cpu", recording),
                                     (gpu, dev, None)):
            opt = make_detection_sgd(model)
            step = make_detector_train_step(
                model, opt, cfg,
                "retinanet" if kind == "retinanet" else "faster_rcnn",
                noise=noise or ReplayNoise(recording.arrays))
            m = step(TrainState(step=0, model=model, optimizer=opt),
                     *batch_to_device(data, device))
            parts.append({k: float(v) for k, v in m.items()})
        errs = {k: abs(parts[1][k] - parts[0][k]) / max(abs(parts[0][k]),
                                                        1e-12)
                for k in parts[0] if k.startswith("loss")}
        print(f"detection card vs CPU {kind}: first f32 train step, loss "
              "parts rel err " + ", ".join(f"{k} {v:.3g}"
                                           for k, v in errs.items())
              + f" (card loss {parts[1]['loss']:.6f}) [{card}]")
        for k, v in errs.items():
            bound = (DET_ROI_REL if k in ("loss_cls", "loss_box", "loss_mask")
                     and kind != "retinanet" else DET_F32_REL)
            if not v <= bound:
                raise AssertionError(f"detection train step card vs CPU "
                                     f"{kind}: {k} {v} > {bound}")


def det_converge(dev, card):
    """(c) JAX's synthetic-COCO convergence recipe on the card: Faster
    R-CNN at backbone depth (1, 1, 1, 1), 64 px, 40 steps."""
    from laudnet_tpu_torch.detection import FasterRCNN
    from laudnet_tpu_torch.detection.runner import (DetTrainConfig,
                                                    train_detector)

    model = FasterRCNN(num_classes=3, backbone_layers=(1, 1, 1, 1),
                       dyn_mode=("channel",) * 4, num_proposals=16,
                       sparsity_target=0.5, device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    t = time.perf_counter()
    _, history = train_detector(model, DetTrainConfig(**DET_CONVERGE_CFG),
                                kind="faster_rcnn", image_size=64,
                                batch_size=2, log=lambda *a: None)
    losses = [h["loss"] for h in history]
    print(f"detection convergence (Faster R-CNN, depth 1-1-1-1, 64 px, 40 "
          f"steps): logged losses {[round(v, 4) for v in losses]} in "
          f"{time.perf_counter() - t:.1f} s [{card}]")
    if not (math.isfinite(losses[-1]) and losses[-1] < DET_CONVERGE
            * losses[0]):
        raise AssertionError(f"detection convergence: {losses[0]} -> "
                             f"{losses[-1]}, not below {DET_CONVERGE}x")


def kernel_profile(fn, reps=2):
    """Per call of ``fn``: kernel ms, kernels run, and wall ms (host clock
    over the profiled calls, synchronised)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / reps / 1e3
    kernels = sum(e.count for e in events) / reps
    return busy, kernels, wall


def det_numbers(dev, ckpt, card):
    """(d) At DET_SIZE and DET_BATCH, per detector: the eval forward in bf16
    and f32, detect with its kernels and the NMS share, the --amp train
    step, kernel time, kernel count and idle share, peak memory. The
    forwards and detects run once more under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from laudnet_tpu_torch.detection.retinanet import nms
    from laudnet_tpu_torch.detection.runner import (
        DetTrainConfig, batch_to_device, build_detector,
        load_backbone_checkpoint, make_detection_sgd,
        make_detector_train_step, synthetic_coco_batches)
    from laudnet_tpu_torch.train.trainer import TrainState

    batch = next(synthetic_coco_batches(DET_BATCH, DET_SIZE, 80, 1, seed=9,
                                        max_gt=32, with_masks=True))
    for kind in ("retinanet", "faster_rcnn", "mask_rcnn"):
        cfg = det_model_cfg(kind)
        f32, key = build_detector(cfg, device=dev,
                                  generator=torch.Generator(dev).manual_seed(4))
        load_backbone_checkpoint(f32, ckpt)
        bf16, _ = build_detector(dict(cfg, amp=True), device=dev)
        bf16.load_state_dict(f32.state_dict())
        data = batch_to_device(batch if kind == "mask_rcnn" else batch[:4],
                               dev)
        x = data[0]
        if key == "retinanet":
            detect = lambda out: type(f32).detect(out, DET_SIZE)
        else:
            detect = lambda out: type(f32).detect(out)
        row = {}
        with torch.no_grad():
            for name, model in (("bf16", bf16), ("f32", f32)):
                fwd = lambda: model(x)
                row[f"eval_{name}_ms"] = time_ms(fwd, reps=5, warmup=2)
                out = fwd()
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    detect(fwd())
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            busy, row["eval_bf16_kernels"], wall = kernel_profile(
                lambda: bf16(x))
            row["eval_bf16_kernel_ms"] = busy
            row["eval_bf16_idle"] = max(0.0, 1 - busy / wall)
            row["detect_ms"] = time_ms(lambda: detect(out), reps=5, warmup=1)
            _, row["detect_kernels"], _ = kernel_profile(lambda: detect(out))
            # the detect's NMS alone, on inputs of its shape
            if key == "retinanet":
                n, thr, keep = 1000, 0.5, 100
            else:
                n, thr, keep = out["proposals"].shape[1], 0.5, 100
            g = torch.Generator(dev).manual_seed(1)
            xy = torch.rand(DET_BATCH, n, 2, device=dev, generator=g) * 700
            boxes = torch.cat([xy, xy + torch.rand(
                DET_BATCH, n, 2, device=dev, generator=g) * 200 + 8], -1)
            scores = torch.rand(DET_BATCH, n, device=dev, generator=g)
            row["nms_ms"] = time_ms(lambda: nms(boxes, scores, thr, keep),
                                    reps=5, warmup=1)
            if key != "retinanet":  # the proposals' NMS inside the forward
                row["propose_nms_ms"] = time_ms(
                    lambda: nms(torch.cat([boxes] * 4, 1)[:, :1000],
                                torch.cat([scores] * 4, 1)[:, :1000], 0.7,
                                256), reps=5, warmup=1)

        opt = make_detection_sgd(bf16)
        step = make_detector_train_step(
            # learning rate 0: the step (gradients, update and all) runs
            # eight times on one batch and computes the same values each
            # time; at a live rate random heads drift to NaN on a repeated
            # batch within eight steps
            bf16, opt, DetTrainConfig(num_classes=80, base_lr=0.0, epochs=1,
                                      steps_per_epoch=100, warmup_steps=1,
                                      with_masks=kind == "mask_rcnn"),
            key, seed=1)
        state = TrainState(step=0, model=bf16, optimizer=opt)
        train = lambda: step(state, *data)
        for _ in range(2):
            m = train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(4):
            t = time.perf_counter()
            m = train()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        row["train_ms"] = statistics.median(times)
        row["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        busy, row["train_kernels"], wall = kernel_profile(train)
        row["train_kernel_ms"] = busy
        row["train_idle"] = max(0.0, 1 - busy / wall)
        if not all(math.isfinite(float(v)) for k, v in m.items()
                   if k.startswith("loss")):
            raise AssertionError(f"detection {kind} --amp step: {m}")
        print(f"detection numbers {kind} (LAUD-R101 channel 2-2-2-2, "
              f"{DET_SIZE[0]}x{DET_SIZE[1]} bs{DET_BATCH}): "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in row.items())
              + f" [{card}]")
        del f32, bf16, opt, state, step
        torch.cuda.empty_cache()


def phase_detection(dev, card):
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_imagenet_checkpoint(os.path.join(tmp, "laud_r101.pth.tar"),
                                         dev)
        coco = write_coco_dir(os.path.join(tmp, "coco"))
        print(f"detection set-up: ImageNet LAUD-R101 file and COCO directory "
              f"in {time.perf_counter() - t0:.1f} s")
        # the main path launches none of the port's kernels (none is on it)
        _, launched = counted(lambda: det_cli_runs(tmp, ckpt, coco, card))
        if any(launched.values()):
            raise AssertionError(f"detection launched port kernels: "
                                 f"{launched}; name them in the kernel table")
        det_card_vs_cpu(dev, ckpt, card)
        det_converge(dev, card)
        det_numbers(dev, ckpt, card)
    print(f"detection: phase 16 in {time.perf_counter() - t0:.1f} s [{card}]")


# --- the DETR family (phase 17) --------------------------------------------------

DETR_CONFIGS = {
    "ddq": "configs/detection/ddq_detr_laud_r101_channel_2222_0x5.py",
    "mask2former": "configs/detection/mask2former_laud_r101_layer_0x5.py",
}
# COCO's 800x1344 for DDQ-DETR; Mask2Former's LSJ crop of 1024x1024; mmdet's
# 2 images a card for both
DETR_SIZE = {"ddq": (800, 1344), "mask2former": (1024, 1024)}
DETR_BATCH = 2
DETR_MODE = {"ddq": "channel", "mask2former": "layer"}
# the card-against-CPU geometry: DDQ needs num_queries (300) encoder tokens,
# 256x384 gives 2,016; Mask2Former's four levels give 5,440 at 256x256
DETR_SMALL = {"ddq": (256, 384), "mask2former": (256, 256)}
# Card against CPU, f32 with TF32 off on both: the raw outputs after the
# 101-layer backbone, three encoder and three decoder layers, ||card - cpu||
# / ||cpu|| per output (the CNN detectors' DET_F32_REL); the first training
# step's loss parts alike, on the same Gumbel, denoising and point draws
DETR_F32_REL = 1e-3
# (c): the reduced-depth run on one repeated batch, the mean of its last 3
# losses below DETR_CONVERGE x its first. Mask2Former's loss is noisy (its
# points are drawn anew each step): over six seeds on the CPU it read
# 0.55-0.66 after 20 steps and 0.42-0.51 after 30 (DDQ 0.47 after 20)
DETR_CONVERGE = 0.8
DETR_CONVERGE_STEPS, DETR_CONVERGE_LR = 30, 3e-5


def detr_model_cfg(form, **over):
    from laudnet_tpu_torch.utils.config import Config

    cfg = Config.fromfile(DETR_CONFIGS[form])
    return dict(cfg["model"], **over), dict(cfg.get("train_cfg", {}))


def detr_cli_runs(tmp, ckpts, coco, card):
    """(a) ``train`` (3 steps, f32 as DETR runs) then ``eval_info`` (2
    batches) through the CLI at full width: DDQ-DETR on synthetic data,
    Mask2Former on the COCO directory (box and segm mAP)."""
    from laudnet_tpu_torch.detection import cli

    for form, data in (("ddq", []), ("mask2former", ["--data_dir", coco])):
        h, w = DETR_SIZE[form]
        size = ["--image_size", f"{h},{w}", "--batch_size", str(DETR_BATCH)]
        work = os.path.join(tmp, form)
        t = time.perf_counter()
        history = cli.main(["train", DETR_CONFIGS[form], "--work_dir", work,
                            "--init_from", ckpts[form], "--epochs", "1",
                            "--steps_per_epoch", "3"] + size + data)
        train_s = time.perf_counter() - t
        bad = [(i, k) for i, m in enumerate(history) for k, v in m.items()
               if k.startswith("loss") and not math.isfinite(v)]
        want = ("loss_dn", "loss_dec_aux", "loss_enc_aux") if form == "ddq" \
            else ("loss_mask", "loss_mask_aux")
        if len(history) != 2 or bad or not all(k in history[-1]
                                               for k in want):
            raise AssertionError(f"DETR CLI {form}: {len(history)} logged "
                                 f"steps, losses not finite: {bad}, "
                                 f"{sorted(history[-1])}")
        t = time.perf_counter()
        res = cli.main(["eval_info", DETR_CONFIGS[form], "--work_dir", work,
                        "--eval_steps", "2"] + size + data)
        eval_s = time.perf_counter() - t
        keys = ("mAP",) + (("segm_mAP",) if form == "mask2former" else ())
        if not (all(0.0 <= res[k] <= 1.0 for k in keys)
                and 0.0 < res["mean_flops_rate"] <= 1.0
                and res["n_images"] == 2 * DETR_BATCH):
            raise AssertionError(f"DETR CLI eval_info {form}: {res}")
        print(f"DETR CLI {form} (LAUD-R101 {DETR_MODE[form]}, {h}x{w} "
              f"bs{DETR_BATCH}, f32): train 3 steps in {train_s:.1f} s, "
              + ", ".join(f"{k} {v:.4f}" for k, v in history[-1].items()
                          if k.startswith("loss"))
              + f"; eval_info 2 batches in {eval_s:.1f} s: "
              + ", ".join(f"{k} {res[k]:.4f}" for k in keys
                          + ("mean_flops_rate",))
              + f", mean GFLOPs {res['mean_flops'] / 1e9:.2f} [{card}]")


class RecordingDraws:
    """`UniformDraws` on the CPU that keeps every draw for a replay."""

    def __init__(self, seed):
        from laudnet_tpu_torch.detection.detr import UniformDraws

        self.draws, self.arrays = UniformDraws.seeded(seed), []

    def uniform(self, shape, device=None):
        u = self.draws.uniform(shape)
        self.arrays.append(u.numpy().copy())
        return u if device is None else u.to(device)

    def randint(self, shape, low, high, device=None):
        r = self.draws.randint(shape, low, high)
        self.arrays.append(r.numpy().copy())
        return r if device is None else r.to(device)


def detr_rel_errs(out, ref):
    """||card - cpu|| / ||cpu|| of every float output, aux ones included."""
    errs = {}
    for k, v in ref.items():
        if torch.is_tensor(v) and v.is_floating_point():
            errs[k] = det_rel(out[k], v)
        elif isinstance(v, tuple):
            for i, aux in enumerate(v):
                for kk, vv in aux.items():
                    errs[f"{k}{i}.{kk}"] = det_rel(out[k][i][kk], vv)
    return errs


def detr_card_vs_cpu(dev, ckpts, card):
    """(b) Full depth at DETR_SMALL, f32, the same weights on both: raw
    outputs and the first step's loss parts within DETR_F32_REL; from the
    CPU's outputs, ``detr_detect``, ``nms_keep_mask`` and the Hungarian
    assignments bit for bit."""
    from laudnet_tpu_torch.detection.detr import (_set_prediction_cost,
                                                  cxcywh_to_xyxy, detr_detect,
                                                  hungarian_match_many,
                                                  nms_keep_mask, ReplayDraws)
    from laudnet_tpu_torch.detection.runner import (
        DetTrainConfig, batch_to_device, build_detector,
        load_backbone_checkpoint, make_detection_sgd,
        make_detector_train_step, synthetic_coco_batches)
    from laudnet_tpu_torch.ops.gating import ReplayNoise
    from laudnet_tpu_torch.train.trainer import TrainState

    for form in ("ddq", "mask2former"):
        size = DETR_SMALL[form]
        cfg, train_cfg = detr_model_cfg(form)
        masks = form == "mask2former"
        batch = next(synthetic_coco_batches(DETR_BATCH, size, 80, 1, seed=7,
                                            max_gt=8, with_masks=masks))
        cpu, _ = build_detector(cfg, device="cpu", image_size=size,
                                generator=torch.Generator().manual_seed(3))
        load_backbone_checkpoint(cpu, ckpts[form])
        gpu, _ = build_detector(cfg, device=dev, image_size=size)
        gpu.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(batch[0])
        with torch.no_grad():
            ref = cpu(x)
            out = gpu(x.to(dev))
        errs = detr_rel_errs(out, ref)
        # bit for bit on the CPU's outputs
        to_dev = lambda t: t.to(dev)
        det = detr_detect(ref, size)
        det_same("detr_detect", detr_detect(
            {k: to_dev(ref[k]) for k in ("cls_logits", "boxes_cxcywh")},
            size), det)
        scores = 1.0 - torch.softmax(ref["cls_logits"], -1)[..., -1]
        boxes = cxcywh_to_xyxy(ref["boxes_cxcywh"])
        eligible = torch.rand(scores.shape,
                              generator=torch.Generator().manual_seed(2)) \
            < 0.7
        det_same("nms_keep_mask", [nms_keep_mask(
            to_dev(boxes), to_dev(scores), 0.8, to_dev(eligible))],
            [nms_keep_mask(boxes, scores, 0.8, eligible)])
        gt = batch_to_device(batch[1:4], "cpu")
        gt_norm = gt[0] / torch.tensor([size[1], size[0]] * 2,
                                       dtype=torch.float32)
        gt_cxcywh = torch.cat([(gt_norm[..., :2] + gt_norm[..., 2:]) / 2,
                               (gt_norm[..., 2:] - gt_norm[..., :2])
                               .clamp_min(1e-6)], -1)
        kw = dict(cls_weight=1.0, l1_weight=5.0, giou_weight=2.0)
        cost_cpu = _set_prediction_cost(ref["cls_logits"],
                                        ref["boxes_cxcywh"], gt_cxcywh,
                                        gt[1], gt[2], **kw)
        cost_gpu = _set_prediction_cost(
            to_dev(ref["cls_logits"]), to_dev(ref["boxes_cxcywh"]),
            to_dev(gt_cxcywh), to_dev(gt[1]), to_dev(gt[2]), **kw)
        det_same("hungarian_match", [hungarian_match_many(cost_gpu[None])],
                 [hungarian_match_many(cost_cpu[None])])
        print(f"DETR card vs CPU {form} (R101 {size[0]}x{size[1]} f32): rel "
              "err " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + "; detr_detect, nms_keep_mask and the Hungarian assignment "
              f"bit for bit [{card}]")
        if max(errs.values()) > DETR_F32_REL:
            raise AssertionError(f"DETR card vs CPU {form}: {errs}")

        # the first f32 training step on the same draws
        dcfg = DetTrainConfig(num_classes=80, epochs=1, steps_per_epoch=2,
                              warmup_steps=1, with_masks=masks,
                              mask_points=train_cfg.get("mask_points"))
        parts = []
        noise, draws = RecordingNoise(5), RecordingDraws(6)
        data = batch if masks else batch[:4]
        for model, device in ((cpu, "cpu"), (gpu, dev)):
            opt = make_detection_sgd(model)
            if device == "cpu":
                gumbel, uniform = noise, draws
            else:  # one replay for both streams: they were drawn in turn
                gumbel, uniform = (ReplayNoise(noise.arrays),
                                   ReplayDraws(draws.arrays))
            step = make_detector_train_step(model, opt, dcfg, "detr",
                                            noise=gumbel, dn_draws=uniform,
                                            mask_draws=uniform)
            m = step(TrainState(step=0, model=model, optimizer=opt),
                     *batch_to_device(data, device))
            parts.append({k: float(v) for k, v in m.items()})
        errs = {k: abs(parts[1][k] - parts[0][k]) / max(abs(parts[0][k]),
                                                        1e-12)
                for k in parts[0] if k.startswith("loss")}
        print(f"DETR card vs CPU {form}: first f32 train step, loss parts "
              "rel err " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f" (card loss {parts[1]['loss']:.6f}) [{card}]")
        if not all(v <= DETR_F32_REL for v in errs.values()):
            raise AssertionError(f"DETR train step card vs CPU {form}: "
                                 f"{errs}")
        del cpu, gpu


def detr_converge(dev, card):
    """(c) Each form at backbone depth 1-1-1-1 (the configs' widths,
    queries and levels otherwise), 3 classes, trained on the card on one
    repeated batch: finite losses (DDQ's ``loss_dn`` and ``loss_dec_aux``
    among them, JAX's ``test_ddq_trains_end_to_end``), the mean of the last
    3 below DETR_CONVERGE x the first."""
    from laudnet_tpu_torch.detection.runner import (
        DetTrainConfig, batch_to_device, build_detector, make_detection_sgd,
        make_detector_train_step, synthetic_coco_batches)
    from laudnet_tpu_torch.train.trainer import TrainState

    for form, size in (("ddq", 128), ("mask2former", 64)):
        cfg, train_cfg = detr_model_cfg(form, backbone_layers=(1, 1, 1, 1),
                                        num_classes=3)
        masks = form == "mask2former"
        model, _ = build_detector(cfg, device=dev, image_size=size,
                                  generator=torch.Generator(dev)
                                  .manual_seed(0))
        batch = next(synthetic_coco_batches(2, size, 3, 1, seed=3,
                                            with_masks=masks))
        dcfg = DetTrainConfig(
            num_classes=3, base_lr=DETR_CONVERGE_LR, lr_mult=1.0, epochs=1,
            steps_per_epoch=DETR_CONVERGE_STEPS, warmup_steps=1,
            lambda_sparse=0.1, with_masks=masks,
            mask_points=1024 if masks else None)
        opt = make_detection_sgd(model, lr_mult=1.0)
        step = make_detector_train_step(model, opt, dcfg, "detr", seed=0)
        state = TrainState(step=0, model=model, optimizer=opt)
        data = batch_to_device(batch if masks else batch[:4], dev)
        t = time.perf_counter()
        history = [step(state, *data) for _ in range(DETR_CONVERGE_STEPS)]
        losses = [float(m["loss"]) for m in history]
        ratio = statistics.mean(losses[-3:]) / losses[0]
        print(f"DETR convergence {form} (depth 1-1-1-1, {size} px, "
              f"{DETR_CONVERGE_STEPS} steps on one batch, lr "
              f"{DETR_CONVERGE_LR}): losses {[round(v, 3) for v in losses]}"
              f", last-3 mean / first {ratio:.3f} in "
              f"{time.perf_counter() - t:.1f} s [{card}]")
        finite = all(math.isfinite(float(v)) for m in history
                     for k, v in m.items() if k.startswith("loss"))
        need = ("loss_dn", "loss_dec_aux") if form == "ddq" else (
            "loss_mask", "loss_mask_aux")
        if not (finite and all(k in history[-1] for k in need)
                and ratio < DETR_CONVERGE):
            raise AssertionError(f"DETR convergence {form}: {losses}, "
                                 f"{sorted(history[-1])}")


def top_kernels(fn, rows=6):
    """The ``rows`` kernels of one ``fn()`` call with the most device time:
    ``name[:48] ms`` each, ms per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type.name == "CUDA"),
                    key=lambda e: -e.self_device_time_total)
    return "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} "
                     f"x{e.count}" for e in events[:rows])


def detr_numbers(dev, ckpts, card):
    """(d) Per form at DETR_SIZE and DETR_BATCH, f32: the eval forward,
    ``detr_detect``, the DDQ query initialisation's NMS and one decoder
    layer's keep mask on inputs of their shapes, the Hungarian host copy
    and matching of one step's cost stack, the train step (learning rate
    0, so eight steps on one batch compute the same values), kernel ms,
    kernels, idle share, peak memory, and the kernels with the most device
    time. The forwards and detects run once more under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from laudnet_tpu_torch.detection.detr import (detr_detect,
                                                  hungarian_match_many,
                                                  nms_keep_mask)
    from laudnet_tpu_torch.detection.retinanet import nms
    from laudnet_tpu_torch.detection.runner import (
        DetTrainConfig, batch_to_device, build_detector,
        load_backbone_checkpoint, make_detection_sgd,
        make_detector_train_step, synthetic_coco_batches)
    from laudnet_tpu_torch.train.trainer import TrainState

    for form in ("ddq", "mask2former"):
        size = DETR_SIZE[form]
        cfg, train_cfg = detr_model_cfg(form)
        masks = form == "mask2former"
        batch = next(synthetic_coco_batches(DETR_BATCH, size, 80, 1, seed=9,
                                            max_gt=32, with_masks=masks))
        model, _ = build_detector(cfg, device=dev, image_size=size,
                                  generator=torch.Generator(dev)
                                  .manual_seed(4))
        load_backbone_checkpoint(model, ckpts[form])
        data = batch_to_device(batch if masks else batch[:4], dev)
        x = data[0]
        row = {}
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fwd = lambda: model(x)
            detect = lambda o: detr_detect(o, size)
            row["eval_ms"] = time_ms(fwd, reps=5, warmup=2)
            out = fwd()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                detect(fwd())
            finally:
                torch.cuda.set_sync_debug_mode(0)
            busy, row["eval_kernels"], wall = kernel_profile(fwd)
            row["eval_kernel_ms"] = busy
            row["eval_idle"] = max(0.0, 1 - busy / wall)
            row["eval_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            eval_top = top_kernels(fwd)
            row["detect_ms"] = time_ms(lambda: detect(out), reps=5, warmup=1)
            _, row["detect_kernels"], _ = kernel_profile(lambda: detect(out))
            q = model.num_queries
            g = torch.Generator(dev).manual_seed(1)
            xy = torch.rand(DETR_BATCH, 4 * q, 2, device=dev, generator=g)
            boxes = torch.cat([xy, xy + torch.rand(
                DETR_BATCH, 4 * q, 2, device=dev, generator=g) * 0.2], -1)
            scores = torch.rand(DETR_BATCH, 4 * q, device=dev, generator=g)
            if form == "ddq":
                row["ddq_init_nms_ms"] = time_ms(
                    lambda: nms(boxes, scores, model.ddq_nms_iou, q),
                    reps=5, warmup=1)
                row["keep_mask_ms"] = time_ms(
                    lambda: nms_keep_mask(boxes[:, :q], scores[:, :q],
                                          model.ddq_nms_iou),
                    reps=5, warmup=1)
            # a step's stack: the final layer's cost and one a decoder
            # layer (DDQ: the encoder proposals and 2 auxiliary layers;
            # Mask2Former: 3 mask auxiliaries), 32 GT slots
            costs = torch.rand(1 + model.dec_layers, DETR_BATCH, q, 32,
                               device=dev, generator=g)
            row["hungarian_ms"] = time_ms(lambda: hungarian_match_many(costs),
                                          reps=5, warmup=1)

        opt = make_detection_sgd(model)
        step = make_detector_train_step(
            model, opt, DetTrainConfig(
                num_classes=80, base_lr=0.0, epochs=1, steps_per_epoch=100,
                warmup_steps=1, with_masks=masks,
                mask_points=train_cfg.get("mask_points")), "detr", seed=1)
        state = TrainState(step=0, model=model, optimizer=opt)
        train = lambda: step(state, *data)
        for _ in range(2):
            m = train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(4):
            t = time.perf_counter()
            m = train()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        row["train_ms"] = statistics.median(times)
        row["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        busy, row["train_kernels"], wall = kernel_profile(train)
        row["train_kernel_ms"] = busy
        row["train_idle"] = max(0.0, 1 - busy / wall)
        if not all(math.isfinite(float(v)) for k, v in m.items()
                   if k.startswith("loss")):
            raise AssertionError(f"DETR {form} train step: {m}")
        print(f"DETR {form} eval forward, kernels by device ms: {eval_top}")
        print(f"DETR {form} train step, kernels by device ms: "
              f"{top_kernels(train)}")
        print(f"DETR numbers {form} (LAUD-R101 {DETR_MODE[form]}, "
              f"{size[0]}x{size[1]} bs{DETR_BATCH}, f32): "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in row.items())
              + f" [{card}]")
        del model, opt, state, step
        torch.cuda.empty_cache()


def phase_detr(dev, card):
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {form: write_imagenet_checkpoint(
            os.path.join(tmp, f"laud_r101_{mode}.pth.tar"), dev,
            dyn_mode=mode) for form, mode in DETR_MODE.items()}
        coco = write_coco_dir(os.path.join(tmp, "coco"))
        print(f"DETR set-up: ImageNet LAUD-R101 files and COCO directory in "
              f"{time.perf_counter() - t0:.1f} s")
        # the main path launches none of the port's kernels (none is on it)
        _, launched = counted(lambda: detr_cli_runs(tmp, ckpts, coco, card))
        if any(launched.values()):
            raise AssertionError(f"DETR launched port kernels: {launched}; "
                                 f"name them in the kernel table")
        detr_card_vs_cpu(dev, ckpts, card)
        detr_converge(dev, card)
        _, launched = counted(lambda: detr_numbers(dev, ckpts, card))
        if any(launched.values()):
            raise AssertionError(f"DETR launched port kernels: {launched}")
    print(f"DETR: phase 17 in {time.perf_counter() - t0:.1f} s [{card}]")


REPLACES = {
    "fused_vit_block": "laudnet_tpu/ops/pallas/vit_block.py:303",
    "fused_vit_segment": "laudnet_tpu/ops/pallas/vit_block.py:472",
    "fused_vit_block_int8": "laudnet_tpu/ops/pallas/vit_block.py:175",
    "fused_vit_attention": "laudnet_tpu/ops/pallas/vit_attention.py:194",
    "fused_vit_attention_bwd": "laudnet_tpu/ops/pallas/vit_attention.py:335",
    "masked_bottleneck_tail": "laudnet_tpu/ops/pallas/masked_block.py:176",
    "block_variant": "tools/probe_block_budget.py:190",
    "s8_gemm": "tools/probe_int8.py:61",
}
SOURCES = {"fused_vit_attention": SRC_ATT, "fused_vit_attention_bwd": SRC_ATT,
           "masked_bottleneck_tail": SRC_TAIL, "s8_gemm": SRC_S8}


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
    if sys.argv[1:] == ["probes"]:
        phase_probes(card, full=True)
        print(f"probes passed in {time.perf_counter() - t0:.1f} s [{card}]")
        return
    if sys.argv[1:] == ["regnet"]:
        phase_regnet(dev, card)
        phase_aot(dev, card)
        phase_simulator()
        print(f"RegNet, AOT and simulator phases passed in "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        return
    if sys.argv[1:] == ["data"]:
        phase_data(dev, card)
        print(f"data phase passed in {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        return
    if sys.argv[1:] == ["parallel"]:
        phase_parallel(dev, card)
        print(f"parallel phase passed in {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        return
    if sys.argv[1:] == ["detection"]:
        phase_detection(dev, card)
        print(f"detection phase passed in {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        return
    if sys.argv[1:] == ["detr"]:
        phase_detr(dev, card)
        print(f"DETR phase passed in {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        return
    if sys.argv[1:] == ["engine"]:
        phase_engine(dev, card)
        print(f"engine phase passed in {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        return
    results = phase_kernels(dev, card)
    if sys.argv[1:] == ["kernels"]:
        print(f"kernel phases passed in {time.perf_counter() - t0:.1f} s")
        return
    if sys.argv[1:] == ["train"]:
        phase_train(dev, card)
        print(f"training phase passed in {time.perf_counter() - t0:.1f} s")
        return
    lap = [t0]

    def timed(name):
        now = time.perf_counter()
        print(f"--- {name}: {now - lap[0]:.1f} s")
        lap[0] = now

    timed("build and kernel checks")
    deit32, deit, images, deit_rates = phase_slice(dev, card)
    phase_slice2(dev, card, deit32, deit, images, deit_rates)
    del deit32, deit, images
    timed("ViT serving")
    phase_train(dev, card)
    timed("ViT training")
    phase_cnn_serving(dev, card)
    timed("CNN serving")
    phase_cnn_train(dev, card)
    timed("CNN training")
    counted(lambda: phase_probes(card))
    timed("probes")
    phase_engine(dev, card)
    timed("serving engine")
    phase_regnet(dev, card)
    timed("RegNet")
    phase_aot(dev, card)
    timed("AOT artifacts")
    phase_simulator()
    timed("simulator")
    phase_data(dev, card)
    timed("real input and reference checkpoints")
    phase_parallel(dev, card)
    timed("parallel")
    phase_detection(dev, card)
    timed("detection")
    phase_detr(dev, card)
    timed("DETR")
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
                        "library_ms": row["library_ms"],
                        **({"device_ms": row["device_ms"]}
                           if "device_ms" in row else {})})
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
