"""Exact static export of channel-gated LAUD-ResNets (counterpart of
`laudnet_tpu/infer/export_pruned.py`).

LAUDNet's channel masks in practice converge to nearly input-independent
patterns; deploying them as a *static* slim model turns the 0/1 multiplies
into real FLOP reductions (conv2 shrinks quadratically). The subtlety that
makes naive weight slicing WRONG: the reference gates conv outputs *before*
BatchNorm (`laud_resnet.py:115-124`), so a masked-off channel is not dead —
after eval-BN it carries the constant ``relu(bias - mean * scale/std)``
into the next conv. This exporter folds those constants exactly:

* conv1: slice output channels to the kept set; bn1 sliced.
* conv2: slice in/out channels; the masked *inputs*' constant contribution
  is precomputed as a spatial bias map (one conv over a constant map at
  export time — exact including zero-padding borders) and fused after bn2.
* conv3: slice input channels; the masked inputs are spatially uniform, so
  their contribution folds into a plain per-channel bias (1x1 conv).

For a fixed mask pattern the exported model reproduces the dynamic model's
eval outputs bit-near (test-verified). For input-dependent masks this is an
approximation whose accuracy must be re-validated on data — the standard
dynamic-to-static deployment tradeoff.

The export reads the port's `LAUDResNet` (its f32 master weights and
BatchNorm statistics) and computes in ``dtype`` (the model's compute dtype,
else f32), NHWC. Each block's kept channels are zero-padded up to a
multiple of 8 (zero weights and a zero affine, so a padded channel carries
exact zeros and adds nothing to any sum): that is the alignment cuDNN's
bf16 tensor-core convolutions take. Unpadded, an export keeping ~60% of
the channels in groups of 2 (38 of 64, ...) ran slower on an H100 than the
full dense ResNet-50 (15.95 against 10.66 ms at bs128). The int8 form's
convolutions go through
`ops/quant.py::int_conv2d` (stock PyTorch, as the JAX package leaves them
to XLA).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from laudnet_tpu_torch.device import full_f32_convolutions
from laudnet_tpu_torch.ops.quant import int8_linear, int_conv2d, quantize_weight


def _pad(t, dim, n):
    """``t`` zero-padded along ``dim`` to length ``n``."""
    shape = list(t.shape)
    shape[dim] = n - shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _bn_affine(bn):
    """Eval BatchNorm as ``x * a + b`` (f32)."""
    a = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return a, bn.bias.float() - bn.running_mean.float() * a


def _conv(x, k, stride=1, padding=0):
    """NHWC ``x`` by an OIHW kernel."""
    return F.conv2d(x.permute(0, 3, 1, 2), k, stride=stride,
                    padding=padding).permute(0, 2, 3, 1)


def _quant_kernel(k):
    """Per-output-channel symmetric int8 for an OIHW kernel
    (`ops/quant.py::quantize_weight` over the flattened filter). Returns
    (int8 kernel, f32 per-cout scale)."""
    q, s = quantize_weight(k.flatten(1))
    return q.reshape(k.shape), s


def _qconv(x, kq, stride=1, padding=0, absmax=None):
    """W8A8 conv: per-tensor activation scale (dynamic abs-max, or a
    calibrated static ``absmax`` that skips the runtime reduce pass and
    saturates outliers), the exact convolution of the codes, dequant by
    the activation scale only (the per-cout weight scale is folded into the
    following BN affine). Returns x.dtype."""
    xf = x.float()
    amax = (xf.abs().amax() if absmax is None
            else torch.tensor(absmax, dtype=torch.float32, device=x.device))
    xs = torch.clamp_min(amax, 1e-6) * (1.0 / 127.0)
    xq = torch.round(xf / xs).clamp(-127, 127)
    acc = int_conv2d(xq.permute(0, 3, 1, 2), kq, (stride, stride),
                     (padding, padding), (1, 1), 1).permute(0, 2, 3, 1)
    return (acc * xs).to(x.dtype)


def export_pruned_resnet(model, block_masks: Sequence[np.ndarray], *,
                         int8: bool = False,
                         act_scales: Sequence[float] = None,
                         record_act_scales: bool = False, dtype=None):
    """Build ``forward(x) -> logits`` from a channel-mode `LAUDResNet`.

    ``block_masks``: one 0/1 group-mask per block (raster order), each of
    length ``width // granularity``; at least one group must be kept per
    block. The model's geometry (stage depths, channel granularity, the
    resolution of each block) is read from the model; its weights are
    sliced and folded here, once.

    ``int8`` additionally quantizes every conv W8A8 (`ops/quant.py`
    scheme: per-output-channel weight scales — folded into the BN affine
    so the runtime dequant is the activation scale only — and per-tensor
    dynamic activation scales). A second approximation on top of the
    frozen policy: re-validate accuracy.

    Dynamic activation scales cost one abs-max reduce pass per conv.
    ``act_scales`` bakes calibrated per-site abs-max values instead
    (static quantization — the reduce disappears, outliers saturate):
    build once with ``record_act_scales=True`` — the forward then
    returns ``(logits, per_site_absmax)`` — feed calibration batches
    through it, and pass the (quantile of the) recorded scales back as
    ``act_scales`` (`calibrate_export_act_scales` does exactly this).
    Sites are ordered as the forward visits them: stem, then per block
    [downsample?, conv1, conv2, conv3].
    """
    if record_act_scales:
        int8 = False  # scales are recorded on the float path
    dtype = dtype or model.compute_dtype or torch.float32
    blocks = [getattr(model, n) for names in model.block_names for n in names]
    assert len(block_masks) == len(blocks)

    pruned = []
    with torch.no_grad(), full_f32_convolutions():
        for blk, mask in zip(blocks, block_masks):
            w = blk.width
            gran = w // blk.masker_channel.group
            if len(mask) * gran != w:
                # an undersized mask would silently slice trailing channels
                # out of conv1..conv3 while also excluding them from the
                # const1/const2 bias folding — wrong logits, no error
                raise ValueError(
                    f"mask has {len(mask)} groups x granularity {gran} = "
                    f"{len(mask) * gran} channels, conv width is {w} — "
                    "calibrate with the model's channel_dyn_granularity")
            ch_mask = np.repeat(np.asarray(mask).astype(bool), gran)
            kept = torch.as_tensor(np.where(ch_mask)[0])
            dropped = torch.as_tensor(np.where(~ch_mask)[0])
            assert kept.numel() > 0, "empty mask"

            a1, b1 = _bn_affine(blk.bn1)
            a2, b2 = _bn_affine(blk.bn2)
            a3, b3 = _bn_affine(blk.bn3)
            # constant value of masked channels after bn1+relu (conv1 out = 0)
            const1 = torch.clamp_min(b1, 0.0)  # (W,)
            w2 = blk.conv2.weight.float()  # (W, W, 3, 3)
            # exact bias map: conv2 over a constant map carrying const1 on
            # the dropped inputs only (captures zero-padding border effects)
            in_hw = blk.out_h * blk.stride
            const_map = torch.zeros((1, in_hw, in_hw, w), device=w2.device)
            const_map[..., dropped] = const1[dropped]
            bias_map2 = _conv(const_map, w2[kept], stride=blk.stride,
                              padding=1)[0]  # (out_hw, out_hw, k)
            # masked conv2 outputs after bn2+relu are spatially uniform == 0
            # (they were gated to zero before bn2), value relu(b2):
            const2 = torch.clamp_min(b2, 0.0)  # (W,)
            w3 = blk.conv3.weight.float()[:, :, 0, 0].t()  # (W, Co)
            bias3 = const2[dropped] @ w3[dropped]  # (Co,)
            ds = None
            if blk.downsample_conv is not None:
                ds = {"w": blk.downsample_conv.weight.float(),
                      "ab": _bn_affine(blk.downsample_bn)}
            kp = -(-kept.numel() // 8) * 8  # kept channels, padded
            pruned.append({
                "w1": _pad(blk.conv1.weight.float()[kept], 0, kp),
                "a1": _pad(a1[kept], 0, kp), "b1": _pad(b1[kept], 0, kp),
                "w2": _pad(_pad(w2[kept][:, kept], 0, kp), 1, kp),
                "a2": _pad(a2[kept], 0, kp), "b2": _pad(b2[kept], 0, kp),
                # pre-bn2-scaled
                "bias_map2": _pad(bias_map2 * a2[kept], 2, kp),
                # (Co, kp, 1, 1)
                "w3": _pad(w3[kept].t()[:, :, None, None], 1, kp),
                "a3": a3, "b3": b3 + bias3 * a3,
                "ds": ds, "stride": blk.stride,
            })

        a_stem, b_stem = _bn_affine(model.bn1)
        stem_k = model.conv1.weight.float()
        fc_w, fc_b = model.fc.weight.float(), model.fc.bias.float()

        if int8:
            # quantize every kernel; fold the per-cout weight scale into the
            # multiplier that already follows each conv (BN affine / fc)
            for blk in pruned:
                blk["w1"], s1 = _quant_kernel(blk["w1"])
                blk["a1"] = blk["a1"] * s1
                blk["w2"], s2 = _quant_kernel(blk["w2"])
                blk["a2"] = blk["a2"] * s2
                # bias_map2 is added AFTER the a2 multiply: no rescale
                blk["w3"], s3 = _quant_kernel(blk["w3"])
                blk["a3"] = blk["a3"] * s3
                if blk["ds"] is not None:
                    blk["ds"]["w"], sd = _quant_kernel(blk["ds"]["w"])
                    da, db = blk["ds"]["ab"]
                    blk["ds"]["ab"] = (da * sd, db)
            stem_k, ss = _quant_kernel(stem_k)
            a_stem = a_stem * ss
            fc_q, fc_s = quantize_weight(fc_w)
        # everything else computes in ``dtype`` (int8 kernels stay codes)
        floats = ("a1", "b1", "a2", "b2", "bias_map2", "a3", "b3") + (
            () if int8 else ("w1", "w2", "w3"))
        for blk in pruned:
            for k in floats:
                blk[k] = blk[k].to(dtype)
            if blk["ds"] is not None:
                blk["ds"]["ab"] = tuple(t.to(dtype) for t in blk["ds"]["ab"])
                if not int8:
                    blk["ds"]["w"] = blk["ds"]["w"].to(dtype)
        a_stem, b_stem, fc_w, fc_b = (t.to(dtype) for t in
                                      (a_stem, b_stem, fc_w, fc_b))
        if not int8:
            stem_k = stem_k.to(dtype)

    @torch.no_grad()
    def forward(x):
        obs = []  # record mode: per-site activation abs-max, visit order
        site = [0]

        def conv(h, k, stride=1, padding=0):
            if record_act_scales:
                obs.append(h.float().abs().amax())
                return _conv(h, k, stride, padding)
            if int8:
                amax = (None if act_scales is None
                        else act_scales[site[0]])
                site[0] += 1
                return _qconv(h, k, stride, padding, absmax=amax)
            return _conv(h, k, stride, padding)

        h = x.to(dtype)
        h = conv(h, stem_k, stride=2, padding=3) * a_stem + b_stem
        h = torch.clamp_min(h, 0.0)
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for blk in pruned:
            identity = h
            if blk["ds"] is not None:
                da, db = blk["ds"]["ab"]
                identity = conv(h, blk["ds"]["w"],
                                stride=blk["stride"]) * da + db
            y = torch.clamp_min(conv(h, blk["w1"]) * blk["a1"] + blk["b1"],
                                0.0)
            y = conv(y, blk["w2"], stride=blk["stride"], padding=1)
            y = torch.clamp_min(y * blk["a2"] + blk["b2"] + blk["bias_map2"],
                                0.0)
            y = conv(y, blk["w3"]) * blk["a3"] + blk["b3"]
            h = torch.clamp_min(y + identity, 0.0)
        pooled = h.mean(dim=(1, 2))
        if int8:
            out = int8_linear(pooled, fc_q, fc_s, fc_b).to(pooled.dtype)
        else:
            out = pooled @ fc_w.t() + fc_b
        if record_act_scales:
            return out, torch.stack(obs)
        return out

    def run(x):
        with full_f32_convolutions():
            return forward(x)

    return run


def calibrate_export_act_scales(model, block_masks, batches, *,
                                quantile: float = 1.0, margin: float = 0.0):
    """Record per-conv-site activation abs-max over calibration batches
    for the static-scale int8 export. Returns a list ordered like the
    export's conv sites; pass it as ``act_scales`` (typically with a
    small ``margin``; values above the baked scale saturate at eval)."""
    fwd = export_pruned_resnet(model, block_masks, record_act_scales=True)
    per_batch = [fwd(b)[1].cpu().numpy() for b in batches]
    arr = np.stack(per_batch)  # (n_batches, n_sites)
    q = np.quantile(arr, quantile, axis=0) * (1.0 + margin)
    return [float(v) for v in q]
