"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main path, LAUD-DeiT-S token-select serving through
`laudnet_tpu_torch.infer.fused_vit.build_fused_vit`, on the card at full
DeiT-S width (12 layers, D=384, 6 heads of 64, batch 128, 224x224, bf16,
random weights from a seeded torch.Generator). Phases, each raising on
failure:

1. device: a CUDA card is required (there is no CPU path);
2. build: the kernels of `laudnet_tpu_torch/csrc/` with nvcc, into
   `laudnet_tpu_torch/csrc/_build/`;
3. kernels vs plain: B1 (`fused_vit_block`) and B2 (`fused_vit_segment`)
   against their plain PyTorch versions at DeiT-S shapes, with times;
4. the slice: the engine four ways (nominal, snapped and flat-0.5 caps,
   and dense) through the kernels, with launch counts, token counts, and
   agreement with the same engine on the plain versions, and img/s.

Prints a JSON line of the kernels, then as its last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

from laudnet_tpu_torch.infer.fused_vit import build_fused_vit
from laudnet_tpu_torch.models import laud_deit_small
from laudnet_tpu_torch.ops import _build, vit_block

B, L_FULL, D, HEADS, HIDDEN, IMG = 128, 197, 384, 6, 1536, 224
NOMINAL = (1.0,) * 3 + (0.7,) * 4 + (0.5,) * 5
CONFIGS = (  # name, engine options, token count of each layer
    ("nominal", dict(token_capacity=NOMINAL), [197] * 3 + [137] * 4 + [98] * 5),
    ("snapped", dict(token_capacity=NOMINAL, snap_capacities=True),
     [197] * 3 + [128] * 4 + [96] * 5),
    ("flat_0.5", dict(token_capacity=(0.5,) * 12), [98] * 12),
    ("dense", dict(), [197] * 12),
)
# Kernel vs plain: both round to bf16 at the same points and differ only in
# f32 summation order, which flips single bf16 roundings. Tolerance: ULPS
# bf16 ulps (8 significant bits) of the largest output magnitude; a wrong
# epilogue, mask or softmax is off by far more.
ULPS = 4
# Engine through kernels vs through plain versions, 12 layers: rounding
# flips compound over depth and can move a token gate that sits at a bf16
# tie, which changes which tokens a few images keep. A logit error of 5%
# of the logits' norm and 97% top-1 agreement allow that and still fail
# any systematic kernel fault (those move features by O(1)). The class
# head is fitted to the backbone first (`fit_head`): a random head has
# top-2 gaps of a few hundredths of a logit, which bf16 rounding alone
# flips (H100: plain bf16 vs plain f32 top-1 agreement 0.89-0.98).
TOP1_MIN, REL_ERR_MAX = 0.97, 5e-2
RIDGE = 0.1  # fit_head's ridge, relative to the mean feature variance
SRC = "laudnet_tpu_torch/csrc/vit_block.cu"


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


def layer_params(g, dev, policy=False):
    """Random bf16 DeiT-S layer weights (lecun-normal scale). A token
    policy reads feature 0 (keep iff it is >= 0)."""
    def w(*shape):
        return (torch.randn(*shape, generator=g) / math.sqrt(shape[-1])).to(
            dev, torch.bfloat16)

    def vec(n, base=0.0):
        return (base + 0.02 * torch.randn(n, generator=g)).to(
            dev, torch.bfloat16)

    p = {"ln1": {"weight": vec(D, 1.0), "bias": vec(D)},
         "ln2": {"weight": vec(D, 1.0), "bias": vec(D)},
         "qkv": {"weight": w(3 * D, D), "bias": vec(3 * D)},
         "proj": {"weight": w(D, D), "bias": vec(D)},
         "fc1": {"weight": w(HIDDEN, D), "bias": vec(HIDDEN)},
         "fc2": {"weight": w(D, HIDDEN), "bias": vec(D)}}
    if policy:
        pw = torch.zeros(2, D)
        pw[0, 0], pw[1, 0] = 1.0, -1.0
        p["token_policy"] = {"weight": pw.to(dev, torch.bfloat16),
                             "bias": torch.zeros(2, dtype=torch.bfloat16,
                                                 device=dev)}
    return p


def stream(g, l, dev):
    """(B, l, D) bf16 token stream; feature 0 is +-8 per token, so the
    segment's token gates never sit near a tie and the kernel's mask must
    equal the plain version's exactly."""
    x = torch.randn(B, l, D, generator=g)
    x[:, :, 0] = torch.where(torch.rand(B, l, generator=g) > 0.5, 8.0, -8.0)
    return x.to(dev, torch.bfloat16)


def phase_kernels(dev, card):
    g = torch.Generator().manual_seed(0)
    layer = layer_params(g, dev)
    results = {"fused_vit_block": [], "fused_vit_segment": []}
    for l, ragged in ((L_FULL, False), (137, True)):
        x = stream(g, l, dev)
        mask = torch.ones(B, l, device=dev)
        if ragged:
            mask = (torch.rand(B, l, generator=g) > 0.3).float().to(dev)
            mask[:, 0] = 1.0
        args = (x, mask.reshape(B, 1, l), mask.reshape(B, l, 1), layer)
        for fast in (False, True):
            kw = dict(num_heads=HEADS, fast_math=fast)
            out = vit_block.fused_vit_block(*args, **kw)
            ref = vit_block.fused_vit_block_reference(*args, **kw)
            torch.cuda.synchronize()
            err, tol = (out.float() - ref.float()).abs().max().item(), ulp_tol(ref)
            ms = time_ms(lambda: vit_block.fused_vit_block(*args, **kw))
            plain_ms = time_ms(
                lambda: vit_block.fused_vit_block_reference(*args, **kw))
            print(f"B1 fused_vit_block L={l} {'ragged' if ragged else 'full'} "
                  f"mask fast_math={fast}: max_abs_err {err:.6g} (tol {tol:.6g})"
                  f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
            if not err <= tol:
                raise AssertionError(f"B1 disagrees with plain: {err} > {tol}")
            results["fused_vit_block"].append((err, ms, plain_ms, l, fast))

    layers = [layer_params(g, dev, policy=i > 0) for i in range(5)]
    x = stream(g, 98, dev)
    mask = torch.ones(B, 98, device=dev)
    for fast in (False, True):
        kw = dict(num_heads=HEADS, fast_math=fast)
        out, out_mask = vit_block.fused_vit_segment(x, mask, layers, **kw)
        ref, ref_mask = vit_block.fused_vit_segment_reference(x, mask, layers,
                                                              **kw)
        torch.cuda.synchronize()
        err, tol = (out.float() - ref.float()).abs().max().item(), ulp_tol(ref)
        kept = ref_mask.mean().item()
        ms = time_ms(lambda: vit_block.fused_vit_segment(x, mask, layers, **kw))
        plain_ms = time_ms(
            lambda: vit_block.fused_vit_segment_reference(x, mask, layers, **kw))
        print(f"B2 fused_vit_segment 5 layers L=98 fast_math={fast}: "
              f"max_abs_err {err:.6g} (tol {tol:.6g}), token_mask equal "
              f"{torch.equal(out_mask, ref_mask)} (kept {kept:.4f}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
        if not torch.equal(out_mask, ref_mask):
            raise AssertionError("B2 token_mask differs from plain")
        if not 0.0 < kept < 1.0:
            raise AssertionError(f"B2 gates did not bite: kept {kept}")
        if not err <= tol:
            raise AssertionError(f"B2 disagrees with plain: {err} > {tol}")
        results["fused_vit_segment"].append((err, ms, plain_ms, 98, fast))
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
    head = model32.head
    head.weight.zero_()
    head.weight[:D].copy_(torch.eye(D))
    head.bias.zero_()
    feats = build_fused_vit(model32, plain=True, **kw)(images)[:, :D].double()
    mu = feats.mean(0)
    fc = feats - mu
    gram = fc.T @ fc
    gram += RIDGE * gram.diagonal().mean() * torch.eye(D, dtype=gram.dtype,
                                                       device=gram.device)
    target = torch.zeros(B, 1000, dtype=gram.dtype, device=gram.device)
    target[torch.arange(B), torch.arange(B) * 7] = 10.0
    w = torch.linalg.solve(gram, fc.T @ target).T
    head.weight.copy_(w)
    head.bias.copy_(-w @ mu)
    model.head.weight.copy_(head.weight)
    model.head.bias.copy_(head.bias)


def phase_slice(dev, card):
    model32 = laud_deit_small(generator=torch.Generator().manual_seed(0))
    model32 = model32.to(dev).eval()
    model = laud_deit_small()
    model.load_state_dict(model32.state_dict())
    model = model.to(dev, torch.bfloat16).eval()
    images = torch.randn(B, IMG, IMG, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    engines = {name: build_fused_vit(model, **kw) for name, kw, _ in CONFIGS}

    # the main path's run: every counter from 0, one request per config
    vit_block.fused_vit_block.launches = 0
    vit_block.fused_vit_segment.launches = 0
    for name, kw, counts in CONFIGS:
        fit_head(model32, model, images, kw)
        ref = build_fused_vit(model, plain=True, **kw)(images)
        b1, b2 = (vit_block.fused_vit_block.launches,
                  vit_block.fused_vit_segment.launches)
        out = engines[name](images)
        torch.cuda.synchronize()
        d1 = vit_block.fused_vit_block.launches - b1
        d2 = vit_block.fused_vit_segment.launches - b2
        seen = engines[name].token_counts
        print(f"{name}: logits {tuple(out.shape)} {out.dtype}, B1 launches "
              f"{d1}, B2 launches {d2}, tokens per layer {seen}")
        if out.shape != (B, 1000) or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: bad logits")
        if seen != counts:
            raise AssertionError(f"{name}: token counts {seen} != {counts}")
        if name == "dense" and (d1, d2) != (12, 0):
            raise AssertionError(f"dense: expected 12 B1 launches, got {d1}")
        if name != "dense" and not d2 > 0:
            raise AssertionError(f"{name}: no B2 launch")
        top1 = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        print(f"{name}: kernels vs plain top-1 agreement {top1:.4f}, relative "
              f"logit error {rel:.6g}")
        if top1 < TOP1_MIN or not rel <= REL_ERR_MAX:
            raise AssertionError(f"{name}: kernels disagree with plain")
    launches = {"fused_vit_block": vit_block.fused_vit_block.launches,
                "fused_vit_segment": vit_block.fused_vit_segment.launches}

    rates = {}
    for name, kw, _ in CONFIGS:
        k_ips = img_per_s(engines[name], images)
        p_ips = img_per_s(build_fused_vit(model, plain=True, **kw), images)
        rates[name] = (k_ips, p_ips)
        print(f"{name}: {k_ips:.1f} img/s through kernels, {p_ips:.1f} img/s "
              f"plain (bs{B} bf16) [{card}]")
    dense = rates["dense"][0]
    for name in ("nominal", "snapped", "flat_0.5"):
        print(f"{name} / dense through kernels: {rates[name][0] / dense:.4f}")
    return launches


def main():
    card = phase_device()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build()
    results = phase_kernels(dev, card)
    launches = phase_slice(dev, card)
    replaces = {"fused_vit_block": "laudnet_tpu/ops/pallas/vit_block.py:303",
                "fused_vit_segment": "laudnet_tpu/ops/pallas/vit_block.py:472"}
    kernels = []
    for name, rows in results.items():
        # time at the serving shape: fast_math, the longest L checked
        _, ms, plain_ms, _, _ = max(rows, key=lambda r: (r[4], r[3]))
        kernels.append({"name": name, "route": "cuda", "source": SRC,
                        "replaces": replaces[name],
                        "launches": launches[name],
                        "max_abs_err": max(r[0] for r in rows),
                        "ms": ms, "plain_ms": plain_ms})
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
