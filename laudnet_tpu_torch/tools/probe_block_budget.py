"""The fused ViT block's time by stage (counterpart of
`tools/probe_block_budget.py`; kernel P1).

    python -m laudnet_tpu_torch.tools.probe_block_budget [--fast|--post|--combos]

Times B1 (`ops/vit_block.py::fused_vit_block`'s kernels) with one stage of
the body ablated or replaced (`ops/vit_block.py::fused_vit_block` with a
``variant``: template instantiations of ``csrc/vit_block.cu``) at the JAX probe's shape: DeiT-S,
B = 128, L = 197, D = 384, 6 heads of 64, hidden 1536, all-ones masks, the
probe's seeded weights. Each mode is timed with CUDA events over a chain of
layers after warm-up (`tools/timing.py`) and printed as microseconds per
image and layer with its delta from ``full``; the sets are those of the JAX
probe:

* default: full, nogelu, silu_gelu, nosoftmax, unnorm, noln, ln_onepass
  (each one change to the exact body);
* ``--fast``: full, fast_exact, fast_tanh, fast_silu (the fast-math body
  with each GELU);
* ``--post``: full, fast_tanh, then each surviving stage ablated on top of
  the shipped fast-math body;
* ``--combos``: full, tanh_gelu;
* ``--stages``: where B1's (fast_math) and B6's layer time goes, by kernel
  (`torch.profiler`), with each product's achieved rate (a product with a
  row pass in its epilogue counted as its product): the terms
  `sim/hardware.py::HopperSpec` pins for the latency model.

Modes of the JAX probe that are lane tricks of the TPU's 128-wide vector
unit have no counterpart here and are printed with the reason
(`LEFT_BEHIND`). Every failure raises.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from laudnet_tpu_torch.ops.vit_block import (FAST, BlockVariant,
                                             fused_vit_block)
from laudnet_tpu_torch.tools.timing import chain_ms

BATCH, L, D, H = 128, 197, 384, 6
HIDDEN = 4 * D

MODES = {
    "full": BlockVariant(),
    "nogelu": BlockVariant(act="none"),
    "silu_gelu": BlockVariant(act="silu"),
    "tanh_gelu": BlockVariant(act="tanh"),
    "nosoftmax": BlockVariant(softmax="linear"),
    "unnorm": BlockVariant(softmax="deferred"),
    "noln": BlockVariant(ln="scale"),
    "ln_onepass": BlockVariant(ln="onepass"),
    "fast_exact": BlockVariant(ln="onepass", softmax="deferred", act="erf"),
    "fast_tanh": FAST,
    "fast_silu": BlockVariant(ln="onepass", softmax="deferred", act="silu"),
    "post_noexp": BlockVariant(ln="onepass", act="tanh", softmax="linear"),
    "post_nosub": BlockVariant(ln="onepass", act="tanh", softmax="nomax"),
    "post_noln": BlockVariant(ln="scale", act="tanh", softmax="deferred"),
    "post_nogelu": BlockVariant(ln="onepass", act="none",
                                softmax="deferred"),
    "post_norowmask": BlockVariant(ln="onepass", act="tanh",
                                   softmax="deferred", row_mask=False),
    "post_bf16res": BlockVariant(ln="onepass", act="tanh",
                                 softmax="deferred", bf16_residual=True),
}

_LANES = ("a TPU lane trick: the TPU kernel runs two heads of 64 in one "
          "128-lane tile and masks half of it; the H100 kernel runs one "
          "head of 64 per mma tile and masks nothing")
LEFT_BEHIND = {
    "nomask": _LANES + " (the lane-mask multiplies this mode drops)",
    "post_nomask": _LANES + " (the lane-mask multiplies this mode drops)",
    "stackq": _LANES + " (two heads' queries stacked into one score "
                       "product)",
    "stackq_unnorm": _LANES + " (stacked queries, deferred normalisation)",
    "premask": _LANES + " (masks folded into zeroed weight columns)",
    "post_premask": _LANES + " (masks folded into zeroed weight columns)",
    "vselect": _LANES + " (a lane select in place of masking V)",
    "post_vselect": _LANES + " (a lane select in place of masking V)",
    "combo_exact": _LANES + " (stacked queries with each GELU)",
    "combo_tanh": _LANES + " (stacked queries with each GELU)",
    "combo_silu": _LANES + " (stacked queries with each GELU)",
    "f32attn": ("the H100's tensor cores take f32 operands only as TF32 (10 "
                "mantissa bits, fewer than bf16 keeps after its rounding is "
                "undone), so an f32-operand attention would measure another "
                "precision's kernel, not the cost the TPU probe asks about "
                "(f32 operands on the MXU)"),
}

SETS = {
    "default": ["full", "nogelu", "silu_gelu", "nosoftmax", "unnorm", "noln",
                "ln_onepass", "nomask", "stackq", "f32attn"],
    "--fast": ["full", "fast_exact", "fast_tanh", "fast_silu"],
    "--post": ["full", "fast_tanh", "post_vselect", "post_premask",
               "post_noexp", "post_nosub", "post_nomask", "post_noln",
               "post_nogelu", "post_norowmask", "post_bf16res"],
    "--combos": ["full", "tanh_gelu", "stackq_unnorm", "combo_exact",
                 "combo_tanh", "combo_silu"],
}


def probe_params(device, d=D, hidden=HIDDEN, seed=0):
    """The JAX probe's layer: unit LayerNorms, zero biases, weights normal
    * 0.05 from ``np.random.default_rng(seed)``, in torch.nn.Linear layout
    (the transposes of its (in, out) kernels, drawn in its order), bf16.
    Returns ``(params, x)`` with x (BATCH, L, d) normal * 0.5."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32
                               ).to(device, torch.bfloat16)

    def lin(k_in_out):
        return {"weight": t(k_in_out.T),
                "bias": t(np.zeros(k_in_out.shape[1], np.float32))}

    ones, zeros = np.ones(d, np.float32), np.zeros(d, np.float32)
    wqkv = rng.standard_normal((d, 3 * d)) * 0.05
    wproj = rng.standard_normal((d, d)) * 0.05
    w1 = rng.standard_normal((d, hidden)) * 0.05
    w2 = rng.standard_normal((hidden, d)) * 0.05
    params = {"ln1": {"weight": t(ones), "bias": t(zeros)},
              "ln2": {"weight": t(ones), "bias": t(zeros)},
              "qkv": lin(wqkv), "proj": lin(wproj), "fc1": lin(w1),
              "fc2": lin(w2)}
    x = t(rng.standard_normal((BATCH, L, d)) * 0.5)
    return params, x


def run(modes, device="cuda", chain=20, repeats=3):
    """Times each carried mode of ``modes`` (others are reported with the
    reason they stay behind). Returns ``{mode: us per image and layer}``
    plus ``<mode>_maxerr`` (largest difference from ``full``) for the
    modes whose output should stay close to it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the probe measures a CUDA card")
    params, x = probe_params(dev)
    ones = torch.ones(BATCH, L, device=dev)
    kmask, rmask = ones.reshape(BATCH, 1, L), ones.reshape(BATCH, L, 1)
    results, base, ref = {}, None, None
    for mode in modes:
        if mode in LEFT_BEHIND:
            print(f"{mode:>15}: left behind: {LEFT_BEHIND[mode]}")
            continue
        v = MODES[mode]

        def layer(v=v):
            return fused_vit_block(x, kmask, rmask, params, num_heads=H,
                                   variant=v)

        us = chain_ms(layer, chain, repeats) * 1e3 / BATCH
        results[mode] = us
        if mode == "full":
            base, ref = us, layer()
        elif mode in ("unnorm", "ln_onepass", "tanh_gelu", "fast_exact",
                      "fast_tanh", "fast_silu") and ref is not None:
            results[mode + "_maxerr"] = (layer().float() - ref.float()
                                         ).abs().max().item()
        delta = "" if base is None else f" (delta {base - us:+.3f})"
        print(f"{mode:>15}: {us:8.3f} us/img/layer{delta}", flush=True)
    return results


# the product each GEMM epilogue computes (csrc/vit_block.cu: EPI_*), as
# (K, N) at DeiT-S, and each row epilogue's (RowKind: proj with LN2, fc2
# with the next layer's LN1, the s8 proj with LN2's quantiser, the s8 fc1
# with its row quantiser)
_GEMMS = {0: ("qkv", D, 3 * D), 1: ("proj", D, D), 2: ("fc1", D, HIDDEN),
          3: ("fc2", HIDDEN, D)}
_ROW_GEMMS = {0: _GEMMS[1], 1: _GEMMS[3], 2: _GEMMS[1], 3: _GEMMS[2]}


def stages(device="cuda", layers=10):
    """Device time by kernel of ``layers`` B1 layers (fast_math) and B6
    layers at the probe's shape, per layer, with the products' achieved
    rates (T(FL)OP/s), the attention kernel's and LayerNorm's bytes rate.
    Returns the dict it prints."""
    from torch.profiler import ProfilerActivity, profile

    from laudnet_tpu_torch.ops.vit_block import (fused_vit_block,
                                                 fused_vit_block_int8,
                                                 quantize_block_params)

    dev = torch.device(device)
    params, x = probe_params(dev)
    qparams = quantize_block_params(params)
    ones = torch.ones(BATCH, L, device=dev)
    kmask, rmask = ones.reshape(BATCH, 1, L), ones.reshape(BATCH, L, 1)
    rows = BATCH * L
    out = {}
    for name, layer in (
            ("b1", lambda: fused_vit_block(x, kmask, rmask, params,
                                           num_heads=H, fast_math=True)),
            ("b6", lambda: fused_vit_block_int8(x, kmask, rmask, qparams,
                                                num_heads=H))):
        for _ in range(3):
            layer()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(layers):
                layer()
            torch.cuda.synchronize()
        gemm_flops = gemm_ms = 0.0
        for e in prof.key_averages():
            if e.device_type.name != "CUDA" or e.device_time_total <= 0:
                continue
            ms = e.device_time_total / layers / 1e3
            key = e.key
            kinds = (("BlockEpilogue<", _GEMMS), ("RowEpilogue<", _ROW_GEMMS))
            tag = next((t for t in kinds if t[0] in key), None)
            if tag is not None:  # csrc/gemm_sm90.cuh's kernel
                epi = int(key.split(tag[0])[1].split(",")[0].split(">")[0])
                what, k, n = tag[1][epi]
                flops = 2.0 * rows * k * n
                gemm_flops += flops
                gemm_ms += ms
                out[f"{name}_{what}_ms"] = ms
                out[f"{name}_{what}_tflops"] = flops / ms / 1e9
            elif "attention_kernel<" in key or "attn_fwd_bf16<" in key:
                # lt_attention's launch, either kernel (by L and form)
                out[f"{name}_attention_ms"] = ms
                lq, lk = -(-L // 64) * 64, -(-L // 16) * 16
                out[f"{name}_attention_tflops"] = (
                    4.0 * BATCH * H * lq * lk * 64 / ms / 1e9)
            elif "layernorm" in key or "rowquant" in key:
                tag = "layernorm" if "layernorm" in key else "rowquant"
                out[f"{name}_{tag}_ms"] = out.get(f"{name}_{tag}_ms", 0) + ms
        out[f"{name}_gemm_tflops"] = gemm_flops / gemm_ms / 1e9
        out[f"{name}_layer_ms"] = chain_ms(layer, 20)
    # B1's LayerNorm launch (LN1: LN2 runs in proj's epilogue) moves x
    # (bf16) in and bf16 out
    out["b1_layernorm_gbps"] = rows * D * (2 + 2) / (
        out["b1_layernorm_ms"] * 1e-3) / 1e9
    for k, v in out.items():
        print(f"{k:>24}: {v:.4f}")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--stages" in argv:
        results = stages()
    else:
        flags = [a for a in argv if a in SETS]
        results = run(SETS[flags[0] if flags else "default"])
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
