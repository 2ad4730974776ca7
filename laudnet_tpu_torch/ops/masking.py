"""Mask algebra: application, receptive-field expansion, resizing, pooling
(counterpart of `laudnet_tpu/ops/masking.py`).

Everything is NHWC. A group mask covers contiguous channel blocks: channel
``i`` belongs to group ``i // (C // G)``. Masks stay dense 0/1 tensors, so
the training graph is a plain differentiable program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _spread_groups(mask: torch.Tensor, c: int) -> torch.Tensor:
    g = mask.shape[-1]
    if g > 1 and g != c:
        mask = mask.repeat_interleave(c // g, dim=-1)
    return mask


def apply_channel_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multiplies NHWC activations by a per-sample channel-group mask.
    ``x``: (B, H, W, C); ``mask``: (B, G) with G dividing C (or G == 1 for a
    whole-layer gate)."""
    mask = _spread_groups(mask, x.shape[-1])
    return x * mask[:, None, None, :].to(x.dtype)


def apply_spatial_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multiplies NHWC activations by a spatial, possibly group-wise, mask.
    ``x``: (B, H, W, C); ``mask``: (B, H, W, G)."""
    return x * _spread_groups(mask, x.shape[-1]).to(x.dtype)


def _pair(size):
    return (size, size) if isinstance(size, int) else tuple(size)


def upsample_mask_nearest(mask: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC mask to ``size`` (int, or
    ``(h, w)``). Where the mask resolution divides the target this is an
    exact pixel repeat; otherwise it gathers with the index rule
    ``src = floor(dst * in / out)``."""
    out_h, out_w = _pair(size)
    h, w = mask.shape[1], mask.shape[2]
    if h == out_h and w == out_w:
        return mask
    if out_h % h == 0 and out_w % w == 0:
        mask = mask.repeat_interleave(out_h // h, dim=1)
        return mask.repeat_interleave(out_w // w, dim=2)
    ih = np.floor(np.arange(out_h) * h / out_h).astype(np.int64)
    iw = np.floor(np.arange(out_w) * w / out_w).astype(np.int64)
    ih = torch.from_numpy(ih).to(mask.device)
    iw = torch.from_numpy(iw).to(mask.device)
    return mask[:, ih][:, :, iw]


def expand_mask(mask: torch.Tensor, stride: int = 1,
                padding: int = 1) -> torch.Tensor:
    """Dilates an output-side spatial mask to the input side of a conv: OR
    over the mask groups; for stride > 1 zero-upsampling (the value at the
    top left of each stride x stride cell); a max-pool with window
    ``2 * padding + 1``; broadcast back to all groups.

    ``mask``: (B, H, W, G) float or bool. Returns bool
    (B, H * stride, W * stride, G)."""
    g = mask.shape[-1]
    m = (mask > 0.5).any(dim=-1, keepdim=True)
    if stride > 1:
        b, h, w, _ = m.shape
        up = torch.zeros((b, h * stride, w * stride, 1), dtype=torch.bool,
                         device=m.device)
        up[:, ::stride, ::stride] = m
        m = up
    if padding > 0:
        k = 2 * padding + 1
        pooled = F.max_pool2d(m.permute(0, 3, 1, 2).float(), k, stride=1,
                              padding=padding)
        m = pooled.permute(0, 2, 3, 1) > 0.5
    return m.expand(*m.shape[:-1], g)


def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) averaging matrix: output cell i averages rows
    [floor(i * in / out), ceil((i + 1) * in / out))."""
    p = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -(-(i + 1) * in_size // out_size)
        p[i, lo:hi] = 1.0 / (hi - lo)
    return p


def adaptive_avg_pool(x: torch.Tensor, out_size) -> torch.Tensor:
    """Average-pools NHWC ``x`` to ``out_size`` spatially (int or (h, w)),
    as ``F.adaptive_avg_pool2d`` does, accumulating in f32. Divisible sizes
    are a window sum times ``1 / (kh * kw)``; the general case contracts
    with per-dimension window-averaging matrices."""
    out_h, out_w = _pair(out_size)
    b, h, w, c = x.shape
    if h == out_h and w == out_w:
        return x
    xf = x.float()
    if h % out_h == 0 and w % out_w == 0:
        kh, kw = h // out_h, w // out_w
        s = xf.reshape(b, out_h, kh, out_w, kw, c).sum(dim=(2, 4))
        return (s * (1.0 / (kh * kw))).to(x.dtype)
    ph = torch.from_numpy(_adaptive_pool_matrix(h, out_h)).to(x.device)
    pw = torch.from_numpy(_adaptive_pool_matrix(w, out_w)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", ph, xf)
    y = torch.einsum("pw,bowc->bopc", pw, y)
    return y.to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average over the spatial dims of NHWC ``x`` -> (B, C)."""
    return x.mean(dim=(1, 2))
