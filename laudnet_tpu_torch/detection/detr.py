"""DETR family on a LAUD backbone: DDQ-DETR and Mask2Former (counterpart of
`laudnet_tpu/detection/detr.py`).

The JAX module's pieces, formula for formula:

* `TransformerLayer`: pre-norm attention and a tanh-GELU MLP; the
  attention is flax's ``MultiHeadDotProductAttention`` (q/k/v kernels
  (D, H, dh), the out kernel (H, dh, D), q divided by sqrt(dh), masked
  logits set to ``finfo(f32).min``, so a row with every cell masked
  averages its values uniformly);
* `MSDeformAttention` and `DeformableEncoderLayer`: multi-scale deformable
  attention as plain bilinear gathers, the heads folded into the batch;
* the pixel decoder (nearest upsampling with JAX's half-pixel centres),
  the DDQ query initialisation (class-agnostic NMS over the dense encoder
  proposals), the learned-query decoder with Mask2Former's masked
  cross-attention (antialiased linear downsampling of the mask logits with
  JAX's triangle weights), and the DDQ decoder (refinement in
  inverse-sigmoid space, a distinct-query keep mask after every layer but
  the last, denoising groups);
* the set loss: costs on the device, every cost matrix of a step copied to
  the host at once, scipy's ``linear_sum_assignment`` there, the matches
  copied back at once, then the losses.

The bilinear sampler is a `torch.autograd.Function` that saves the value,
the four flat indices and the two fractional offsets, and scatter-adds in
backward: eager autograd of the formula would keep about seven
(B*heads, N*points, dh) tensors a level, tens of GB at Mask2Former's 1024 x
1024 input. Its gradient is JAX's, ties included (a weight clipped at
exactly 0 or 1 passes half, as ``jnp.clip``'s gradient does).

Random draws (the denoising noise, the mask loss's points) come from a
`UniformDraws` source over an explicit ``torch.Generator``; tests hand in a
`ReplayDraws` with JAX's recorded draws. DETR runs in f32 only; its
convolutions run with cuDNN's TF32 off (`device.full_f32_convolutions`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.detection.backbone import LAUDDetBackbone
from laudnet_tpu_torch.detection.fpn import Conv, lecun_normal_
from laudnet_tpu_torch.detection.losses import loss_sparse
from laudnet_tpu_torch.detection.retinanet import (gather_rows, nms,
                                                   topk_stable)
from laudnet_tpu_torch.detection.two_stage import Dense
from laudnet_tpu_torch.device import full_f32_convolutions, resolve_device

LN_EPS = 1e-6  # flax's LayerNorm default


# --- random draws ------------------------------------------------------------

class UniformDraws:
    """Uniform [0, 1) and integer draws from an explicit
    ``torch.Generator``, made on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device=None) -> "UniformDraws":
        gen = torch.Generator(device if device is not None else "cpu")
        return cls(gen.manual_seed(seed))

    def reseed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    def uniform(self, shape, device=None) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator,
                       device=self.generator.device)
        return u if device is None else u.to(device)

    def randint(self, shape, low: int, high: int,
                device=None) -> torch.Tensor:
        r = torch.randint(low, high, tuple(shape), generator=self.generator,
                          device=self.generator.device)
        return r if device is None else r.to(device)


class ReplayDraws:
    """Hands back recorded arrays in order, checking each shape: both
    frameworks then draw the same numbers."""

    def __init__(self, arrays):
        self.arrays = list(arrays)
        self.used = 0

    def _next(self, shape):
        a = torch.from_numpy(np.array(self.arrays[self.used]))
        self.used += 1
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"recorded draw {self.used - 1} has shape "
                             f"{tuple(a.shape)}, asked for {tuple(shape)}")
        return a

    def uniform(self, shape, device=None) -> torch.Tensor:
        return self._next(shape).to(device=device, dtype=torch.float32)

    def randint(self, shape, low: int, high: int,
                device=None) -> torch.Tensor:
        return self._next(shape).to(device=device, dtype=torch.int64)


# --- layers ------------------------------------------------------------------

class HeadsIn(nn.Module):
    """flax ``DenseGeneral(features=(H, dh))``: (..., D) -> (..., H, dh);
    the kernel keeps flax's (D, H, dh) layout (`convert/from_jax.py`)."""
    FLAX_LAYOUT = True

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        dh = dim // heads
        self.weight = nn.Parameter(torch.empty(dim, heads, dh,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(heads, dh, device=device))

    def init_weights(self, generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[0], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        d, h, dh = self.weight.shape
        y = x @ self.weight.reshape(d, h * dh)
        return y.reshape(x.shape[:-1] + (h, dh)) + self.bias


class HeadsOut(nn.Module):
    """flax ``DenseGeneral(features=D, axis=(-2, -1))``: (..., H, dh) ->
    (..., D); the kernel keeps flax's (H, dh, D) layout."""
    FLAX_LAYOUT = True

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        dh = dim // heads
        self.weight = nn.Parameter(torch.empty(heads, dh, dim,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def init_weights(self, generator) -> None:
        h, dh, _ = self.weight.shape
        lecun_normal_(self.weight, h * dh, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        h, dh, d = self.weight.shape
        return (x.reshape(x.shape[:-2] + (h * dh,))
                @ self.weight.reshape(h * dh, d)) + self.bias


class Embed(nn.Module):
    """flax ``nn.Embed``: an ``embedding`` table (num, D)."""

    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim, device=device))

    def init_weights(self, generator) -> None:
        # flax's default: variance_scaling(1, 'fan_in', 'normal',
        # out_axis=0), fan_in = dim for a (num, dim) table
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(
                self.embedding.shape[1]), generator=generator)

    def forward(self, index):
        return self.embedding[index]


def _layer_norm(dim, device):
    return nn.LayerNorm(dim, eps=LN_EPS, device=device)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (no dropout)."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.query = HeadsIn(dim, heads, device)
        self.key = HeadsIn(dim, heads, device)
        self.value = HeadsIn(dim, heads, device)
        self.out = HeadsOut(dim, heads, device)

    def forward(self, q_in, kv_in, mask=None):
        """``mask``: boolean, broadcast to (B, H, Q, K); attend where
        True."""
        q, k, v = self.query(q_in), self.key(kv_in), self.value(kv_in)
        depth = q.shape[-1]
        q = q / torch.full((), math.sqrt(depth), dtype=q.dtype,
                           device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v))


class TransformerLayer(nn.Module):
    """Pre-norm attention (self-attention when ``kv`` is None) and a
    tanh-GELU MLP, each with a residual."""

    def __init__(self, dim: int = 256, heads: int = 8, mlp_dim: int = 1024,
                 device=None):
        super().__init__()
        self.norm1 = _layer_norm(dim, device)
        self.attn = Attention(dim, heads, device)
        self.norm2 = _layer_norm(dim, device)
        self.fc1 = Dense(dim, mlp_dim, device=device)
        self.fc2 = Dense(mlp_dim, dim, device=device)

    def forward(self, q, kv=None, attn_mask=None):
        """``attn_mask``: optional boolean (B, Q, KV), broadcast over the
        heads."""
        y = self.norm1(q)
        mask = None if attn_mask is None else attn_mask[:, None]
        q = q + self.attn(y, y if kv is None else kv, mask)
        y = self.fc2(F.gelu(self.fc1(self.norm2(q)), approximate="tanh"))
        return q + y


# --- bilinear sampling -------------------------------------------------------

def _clip_grad_factor(r: torch.Tensor) -> torch.Tensor:
    """The gradient of ``jnp.clip(r, 0, 1)``: 1 inside, 1/2 on either
    bound (JAX splits a tie of ``max``/``min`` evenly), 0 outside."""
    inside = ((r > 0) & (r < 1)).to(r.dtype)
    tie = ((r == 0) | (r == 1)).to(r.dtype)
    return inside + 0.5 * tie


def _corners(value, locs):
    """The four flat indices and the unclipped fractional offsets of
    JAX's sampler."""
    b, h, w, c = value.shape
    x = locs[..., 0] * w - 0.5
    y = locs[..., 1] * h - 0.5
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    # a NaN location reads pixel 0, as XLA converts NaN to the integer 0
    idx = tuple(torch.nan_to_num(yy * w + xx, nan=0.0).long()
                for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))
    return idx, x - x0, y - y0


def _take(flat, idx):
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1,
                                                       flat.shape[-1]))


def _blend(flat, idx, wx, wy):
    """``top * (1 - wy) + bot * wy`` with ``top = v00 * (1 - wx) + v01 *
    wx`` (and ``bot`` alike), each product rounded once, as JAX's formula
    is evaluated; the gathered corners are freed as soon as they are
    used."""
    top = _take(flat, idx[0]).mul_(1 - wx).add_(_take(flat, idx[1]).mul_(wx))
    bot = _take(flat, idx[2]).mul_(1 - wx).add_(_take(flat, idx[3]).mul_(wx))
    return top.mul_(1 - wy).add_(bot.mul_(wy))


class _BilinearSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, locs):
        b, h, w, c = value.shape
        idx, rx, ry = _corners(value, locs)
        out = _blend(value.reshape(b, h * w, c), idx,
                     rx.clamp(0, 1)[..., None], ry.clamp(0, 1)[..., None])
        ctx.save_for_backward(value, rx, ry, *idx)
        return out

    @staticmethod
    def backward(ctx, g):
        value, rx, ry, *idx = ctx.saved_tensors
        b, h, w, c = value.shape
        flat = value.reshape(b, h * w, c)
        wx, wy = rx.clamp(0, 1)[..., None], ry.clamp(0, 1)[..., None]
        grad_value = grad_locs = None
        if ctx.needs_input_grad[0]:
            gv = torch.zeros_like(flat)
            corner_weights = ((1 - wx) * (1 - wy), wx * (1 - wy),
                              (1 - wx) * wy, wx * wy)
            for i, cw in zip(idx, corner_weights):
                gv.scatter_add_(1, i[..., None].expand(-1, -1, c), g * cw)
            grad_value = gv.reshape(value.shape)
        if ctx.needs_input_grad[1]:
            # d out / d wx = (v01 - v00)(1 - wy) + (v11 - v10) wy
            d_top = _take(flat, idx[1]) - _take(flat, idx[0])
            d_bot = _take(flat, idx[3]) - _take(flat, idx[2])
            gwx = (g * (d_top * (1 - wy) + d_bot * wy)).sum(-1)
            del d_top, d_bot
            # d out / d wy = bot - top
            top = _take(flat, idx[0]) * (1 - wx) + _take(flat, idx[1]) * wx
            bot = _take(flat, idx[2]) * (1 - wx) + _take(flat, idx[3]) * wx
            gwy = (g * (bot - top)).sum(-1)
            del top, bot
            grad_locs = torch.stack([gwx * _clip_grad_factor(rx) * w,
                                     gwy * _clip_grad_factor(ry) * h], -1)
        return grad_value, grad_locs


def bilinear_sample_level(value, locs):
    """Bilinear sampling of one level at fractional locations.

    ``value``: (B, H, W, C); ``locs``: (B, N, 2) normalised (x, y).
    Indices and weights clamp to the border separately (not
    ``F.grid_sample`` in any padding mode). Returns (B, N, C)."""
    return _BilinearSample.apply(value, locs)


def bilinear_sample_level_plain(value, locs):
    """`bilinear_sample_level` as the plain formula under autograd (the
    reference its Function is held to)."""
    b, h, w, c = value.shape
    idx, rx, ry = _corners(value, locs)
    flat = value.reshape(b, h * w, c)
    wx, wy = rx.clamp(0, 1)[..., None], ry.clamp(0, 1)[..., None]
    v00, v01, v10, v11 = (_take(flat, i) for i in idx)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def point_sample(mask_logits, coords):
    """Bilinear point sampling of per-mask logit grids (mmcv's
    ``point_sample`` on [0, 1] coordinates, border-clamped).
    ``mask_logits``: (B, M, h, w); ``coords``: (B, M, P, 2) or (B, 1, P,
    2). Returns (B, M, P)."""
    b, m, h, w = mask_logits.shape
    coords = coords.expand((b, m) + tuple(coords.shape[2:]))
    grid = mask_logits.reshape(b * m, h, w, 1)
    pts = bilinear_sample_level(grid, coords.reshape(b * m, -1, 2))
    return pts.reshape(b, m, -1)


def _importance_coords(mask_logits, cand, rand, n_imp: int):
    """The ``n_imp`` most uncertain of the candidate points (``-|logit|``
    in ``lax.top_k`` order), then the fresh uniform ones."""
    logits = point_sample(mask_logits.detach(), cand)
    _, idx = topk_stable(-torch.abs(logits), n_imp)
    imp = torch.gather(cand, 2, idx[..., None].expand(-1, -1, -1, 2))
    return torch.cat([imp, rand], dim=2)


def _point_counts(num_points, oversample_ratio, importance_ratio):
    return (int(num_points * oversample_ratio),
            int(num_points * importance_ratio))


def uncertain_point_coords(draws, mask_logits, num_points: int,
                           oversample_ratio: float = 3.0,
                           importance_ratio: float = 0.75):
    """mmcv's ``get_uncertain_point_coords_with_randomness``:
    ``num_points * oversample_ratio`` uniform candidates per mask, the
    ``importance_ratio * num_points`` most uncertain kept, the rest fresh
    uniform points; both uniform draws from ``draws``. ``mask_logits``:
    (B, M, h, w) -> coords (B, M, num_points, 2), no gradient."""
    b, m = mask_logits.shape[:2]
    n_over, n_imp = _point_counts(num_points, oversample_ratio,
                                  importance_ratio)
    dev = mask_logits.device
    cand = draws.uniform((b, m, n_over, 2), dev)
    rand = draws.uniform((b, m, num_points - n_imp, 2), dev)
    return _importance_coords(mask_logits, cand, rand, n_imp)


# --- deformable encoder ------------------------------------------------------

def _offset_bias(heads: int, levels: int, points: int) -> np.ndarray:
    """Deformable DETR's sampling-offset bias: a unit ring per head,
    scaled by the point's rank."""
    angles = (2.0 * np.pi / heads) * np.arange(heads)
    grid = np.stack([np.cos(angles), np.sin(angles)], -1)  # (h, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    base = np.tile(grid[:, None, None, :], (1, levels, points, 1))
    base = base * (np.arange(1, points + 1)[None, None, :, None])
    return base.reshape(-1).astype(np.float32)


class MSDeformAttention(nn.Module):
    """Multi-scale deformable attention: each query attends to ``points``
    learned locations per head per level. Offsets are in pixels of each
    level; the heads fold into the batch before the gathers, so each head
    gathers only its own dh channels."""

    def __init__(self, dim: int = 256, heads: int = 8, points: int = 4,
                 levels: int = 3, device=None):
        super().__init__()
        self.dim, self.heads, self.points, self.levels = (dim, heads, points,
                                                          levels)
        self.sampling_offsets = Dense(dim, heads * levels * points * 2,
                                      device=device)
        self.attention_weights = Dense(dim, heads * levels * points,
                                       device=device)
        for i in range(levels):
            self.add_module(f"value_proj_{i}", Dense(dim, dim,
                                                     device=device))
        self.output_proj = Dense(dim, dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator) -> None:
        for m in self.children():
            m.init_weights(generator)
        for m in (self.sampling_offsets, self.attention_weights):
            nn.init.zeros_(m.weight)
        self.sampling_offsets.bias.copy_(torch.from_numpy(_offset_bias(
            self.heads, self.levels, self.points)))

    def forward(self, query, value_levels, ref_points):
        """``query``: (B, N, D); ``value_levels``: per level (B, H_l, W_l,
        D); ``ref_points``: (B, N, 2) normalised (x, y)."""
        b, n, _ = query.shape
        lv, h, p = len(value_levels), self.heads, self.points
        dh = self.dim // h
        offsets = self.sampling_offsets(query).reshape(b, n, h, lv, p, 2)
        weights = torch.softmax(self.attention_weights(query).reshape(
            b, n, h, lv * p), dim=-1).reshape(b, n, h, lv, p)
        out = torch.zeros((b, n, h, dh), dtype=query.dtype,
                          device=query.device)
        for i, f in enumerate(value_levels):
            hl, wl = f.shape[1], f.shape[2]
            v = getattr(self, f"value_proj_{i}")(f)
            vh = v.reshape(b, hl, wl, h, dh).permute(0, 3, 1, 2, 4).reshape(
                b * h, hl, wl, dh)
            off = offsets[:, :, :, i]
            off = torch.stack([off[..., 0] * (1.0 / wl),
                               off[..., 1] * (1.0 / hl)], -1)
            locs = ref_points[:, :, None, None, :] + off  # (B, N, h, p, 2)
            locs_h = locs.permute(0, 2, 1, 3, 4).reshape(b * h, n * p, 2)
            sampled = bilinear_sample_level(vh, locs_h)  # (B*h, N*p, dh)
            sampled = sampled.reshape(b, h, n, p, dh).permute(0, 2, 1, 3, 4)
            out = out + (sampled * weights[:, :, :, i, :, None]).sum(3)
        return self.output_proj(out.reshape(b, n, self.dim))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, points: int = 4,
                 mlp_dim: int = 1024, levels: int = 3, device=None):
        super().__init__()
        self.norm1 = _layer_norm(dim, device)
        self.attn = MSDeformAttention(dim, heads, points, levels, device)
        self.norm2 = _layer_norm(dim, device)
        self.fc1 = Dense(dim, mlp_dim, device=device)
        self.fc2 = Dense(mlp_dim, dim, device=device)

    def forward(self, x, value_levels, ref_points):
        x = x + self.attn(self.norm1(x), value_levels, ref_points)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        return x + y


# --- distinct queries --------------------------------------------------------

def nms_keep_mask(boxes_xyxy, scores, iou_threshold: float, eligible=None):
    """Greedy NMS as a keep mask over every box, in the original order:
    ``boxes_xyxy`` (Q, 4) or (B, Q, 4), ``scores`` (Q,) or (B, Q).

    The exact sequential sweep in stable ``argsort(-scores)`` order: box i,
    if alive, kills every other box whose f32 IoU ``inter / max(area_i +
    area_j - inter, 1e-9)`` exceeds the threshold, so chains (A kills B,
    C which B would have killed survives) come out as the JAX loop's.
    ``eligible``: boxes that start dead neither suppress nor are kept.
    The IoU matrix is computed once; the sweep is one launch a box, no
    host synchronisation."""
    single = boxes_xyxy.dim() == 2
    if single:
        boxes_xyxy, scores = boxes_xyxy[None], scores[None]
        eligible = None if eligible is None else eligible[None]
    bsz, n = scores.shape
    order = torch.argsort(-scores, dim=1, stable=True)
    b = gather_rows(boxes_xyxy, order)
    x1, y1, x2, y2 = b.unbind(-1)
    area = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    iou = inter / torch.clamp_min(area[:, :, None] + area[:, None, :] - inter,
                                  1e-9)
    # spares[b, i, j]: box i, if alive, lets box j live (itself included)
    spares = ~(iou > iou_threshold)
    spares.diagonal(dim1=1, dim2=2).fill_(True)
    alive = (torch.ones((bsz, n), dtype=torch.bool, device=scores.device)
             if eligible is None
             else torch.gather(eligible.bool(), 1, order))
    for i in range(n):
        alive = torch.where(alive[:, i:i + 1], alive & spares[:, i], alive)
    keep = torch.zeros_like(alive).scatter(1, order, alive)
    return keep[0] if single else keep


def _inverse_sigmoid(x, eps: float = 1e-3):
    """mmdet's inverse_sigmoid(eps=1e-3), the refinement's logit space."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp_min(eps) / (1.0 - x).clamp_min(eps))


# --- geometry ----------------------------------------------------------------

def detr_level_shapes(image_size, out_indices) -> list:
    """The backbone's (H_l, W_l) for ``out_indices`` on an input of
    ``image_size`` (a side or ``(h, w)``): the stem's stride-2 convolution
    and max-pool, then a stride-2 block per stage after the first, each
    rounding up."""
    h, w = ((image_size, image_size) if isinstance(image_size, int)
            else tuple(int(v) for v in image_size))
    h, w = -(-h // 4), -(-w // 4)  # conv1 and the max-pool, each ceil(/2)
    shapes = []
    for s in range(4):
        if s > 0:
            h, w = -(-h // 2), -(-w // 2)
        if s in out_indices:
            shapes.append((h, w))
    return shapes


@functools.lru_cache(maxsize=32)
def _reference_points(level_shapes, device):
    """Each token's own normalised centre, (1, N, 2) f32 on ``device``."""
    refs = []
    for hh, ww in level_shapes:
        gy, gx = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
        refs.append(np.stack([(gx + 0.5) / ww, (gy + 0.5) / hh],
                             -1).reshape(-1, 2))
    return torch.from_numpy(np.concatenate(refs).astype(np.float32))[
        None].to(device)


@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int, device):
    """``jax.image.resize(..., 'nearest')``'s source index per output
    pixel: ``floor((i + 0.5) * in / out)`` in f32 (half-pixel centres)."""
    off = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) / np.float32(out_size)
    return torch.from_numpy(np.floor(off.astype(np.float32)).astype(
        np.int64)).to(device)


def resize_nearest(x, size):
    """``jax.image.resize(x, (B, h, w, C), 'nearest')`` on NHWC ``x``."""
    for axis, (m, n) in ((1, (x.shape[1], size[0])),
                         (2, (x.shape[2], size[1]))):
        if m != n:
            x = torch.index_select(x, axis, _nearest_index(m, n, x.device))
    return x


@functools.lru_cache(maxsize=64)
def _linear_weights(in_size: int, out_size: int, device):
    """JAX's ``compute_weight_mat`` for the antialiased triangle kernel
    (``jax.image.resize(..., 'linear')``), in f32 as JAX evaluates it:
    (out, in)."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    weights = np.where(inside[None, :], weights, f32(0)).astype(f32)
    return torch.from_numpy(np.ascontiguousarray(weights.T)).to(device)


def resize_linear(x, size):
    """``jax.image.resize(x, (B, M, h, w), 'linear')`` (antialiased when it
    shrinks) on (B, M, H, W) ``x``: the separable triangle weights of each
    axis that changes."""
    h, w = x.shape[2], x.shape[3]
    if w != size[1]:
        x = x @ _linear_weights(w, size[1], x.device).T
    if h != size[0]:
        x = _linear_weights(h, size[0], x.device) @ x
    return x


# --- the detector ------------------------------------------------------------

class DETRDetector(nn.Module):
    """Encoder/decoder set-prediction detector over LAUD features: sigmoid
    (cx, cy, w, h) boxes in [0, 1]; ``with_masks`` adds Mask2Former masks
    (query embedding . pixel features on the finest level) with masked
    cross-attention. ``query_init='ddq'`` is the DDQ decoder (distinct
    queries from NMS over dense encoder proposals, per-layer refinement and
    distinct-query masks, ``dn_groups`` denoising groups in training).

    ``image_size`` (a side or ``(h, w)``) fixes the shapes of the
    per-level ``pos_embed_{i}`` parameters, as flax sizes them from its
    init input; a forward on another size is refused. The model is f32."""

    def __init__(self, num_classes: int = 80, num_queries: int = 100,
                 dim: int = 256, enc_layers: int = 3, dec_layers: int = 3,
                 backbone_layers: Sequence[int] = (3, 4, 23, 3),
                 dyn_mode: Sequence[str] = ("channel",) * 4,
                 out_indices: Sequence[int] = (1, 2, 3),
                 sparsity_target: float = 0.5, temperature: float = 0.1,
                 with_masks: bool = False, encoder: str = "deformable",
                 deform_points: int = 4, masked_cross_attention: bool = True,
                 query_init: str = "learned", ddq_nms_iou: float = 0.8,
                 distinct_queries: bool = True, dn_groups: int = 0,
                 dn_box_noise: float = 0.4, dn_label_noise: float = 0.5,
                 image_size=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size is None:
            raise ValueError("DETRDetector needs image_size: its per-level "
                             "position embeddings are sized from the input")
        if encoder not in ("deformable", "full"):
            raise ValueError(f"encoder must be 'deformable' or 'full', got "
                             f"{encoder!r}")
        if query_init not in ("learned", "ddq"):
            raise ValueError(f"query_init must be 'learned' or 'ddq', got "
                             f"{query_init!r}")
        device = resolve_device(device)
        self.num_classes, self.num_queries, self.dim = (num_classes,
                                                        num_queries, dim)
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.out_indices = tuple(out_indices)
        self.sparsity_target = sparsity_target
        self.with_masks, self.encoder = with_masks, encoder
        self.masked_cross_attention = masked_cross_attention
        self.query_init, self.ddq_nms_iou = query_init, ddq_nms_iou
        self.distinct_queries, self.dn_groups = distinct_queries, dn_groups
        self.dn_box_noise, self.dn_label_noise = dn_box_noise, dn_label_noise
        self.image_hw = ((image_size, image_size)
                         if isinstance(image_size, int)
                         else tuple(int(v) for v in image_size))
        self.level_shapes = tuple(detr_level_shapes(self.image_hw,
                                                    self.out_indices))
        self.backbone = LAUDDetBackbone(
            layers=backbone_layers, out_indices=self.out_indices,
            dyn_mode=dyn_mode, temperature=temperature,
            sparsity_target=sparsity_target, device=device)
        nl = len(self.out_indices)
        self.level_embed = nn.Parameter(torch.empty(nl, dim, device=device))
        for i, (cin, (hh, ww)) in enumerate(zip(self.backbone.out_channels,
                                                self.level_shapes)):
            self.add_module(f"input_proj_{i}", Conv(cin, dim, 1,
                                                    device=device))
            self.register_parameter(f"pos_embed_{i}", nn.Parameter(
                torch.empty(1, hh, ww, dim, device=device)))
        for i in range(enc_layers):
            layer = (DeformableEncoderLayer(dim, points=deform_points,
                                            levels=nl, device=device)
                     if encoder == "deformable"
                     else TransformerLayer(dim, device=device))
            self.add_module(f"enc_{i}", layer)
        if with_masks:
            for i in range(nl - 2, -1, -1):
                self.add_module(f"pixdec_lateral_{i}",
                                Conv(dim, dim, 1, device=device))
                self.add_module(f"pixdec_fuse_{i}",
                                Conv(dim, dim, 3, padding=1, device=device))
            self.mask_feature = Conv(dim, dim, 1, device=device)
            self.mask_embed = Dense(dim, dim, device=device)
        k1 = num_classes + 1
        if query_init == "ddq":
            self.enc_cls = Dense(dim, k1, device=device)
            self.enc_box = Dense(dim, 4, device=device)
            self.query_proj = Dense(dim, dim, device=device)
            if dn_groups > 0:
                self.dn_label_embed = Embed(k1, dim, device)
            for i in range(dec_layers):
                self.add_module(f"dec_self_{i}",
                                TransformerLayer(dim, device=device))
                self.add_module(f"dec_cross_{i}",
                                TransformerLayer(dim, device=device))
                self.add_module(f"dec_norm_{i}", _layer_norm(dim, device))
                self.add_module(f"cls_head_l{i}", Dense(dim, k1,
                                                        device=device))
                self.add_module(f"box_fc1_l{i}", Dense(dim, dim,
                                                       device=device))
                self.add_module(f"box_fc2_l{i}", Dense(dim, dim,
                                                       device=device))
                self.add_module(f"box_head_l{i}", Dense(dim, 4,
                                                        device=device))
            if with_masks:
                self.dec_norm = _layer_norm(dim, device)
        else:
            self.query_embed = nn.Parameter(torch.empty(1, num_queries, dim,
                                                        device=device))
            for i in range(dec_layers):
                self.add_module(f"dec_self_{i}",
                                TransformerLayer(dim, device=device))
                self.add_module(f"dec_cross_{i}",
                                TransformerLayer(dim, device=device))
            self.dec_norm = _layer_norm(dim, device)
            self.cls_head = Dense(dim, k1, device=device)
            self.box_fc1 = Dense(dim, dim, device=device)
            self.box_fc2 = Dense(dim, dim, device=device)
            self.box_head = Dense(dim, 4, device=device)
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """The backbone as `models/laud_resnet.py` initialises it; the rest
        with flax's defaults and the JAX module's own: normal(0.02)
        embeddings, zero kernels for the deformable offsets and weights,
        ``enc_box`` and every ``box_head_l{i}``, the offsets' ring bias."""
        self.backbone.init_weights(generator)
        inside = {id(c) for m in self.modules()
                  if isinstance(m, MSDeformAttention) for c in m.children()}
        for name, m in self.named_modules():
            if name.startswith("backbone") or id(m) in inside:
                continue
            if isinstance(m, (MSDeformAttention, Conv, Dense, HeadsIn,
                              HeadsOut, Embed)):
                m.init_weights(generator)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for p in self.parameters(recurse=False):
            p.normal_(0.0, 0.02, generator=generator)
        if self.query_init == "ddq":
            for name in ["enc_box"] + [f"box_head_l{i}"
                                       for i in range(self.dec_layers)]:
                nn.init.zeros_(getattr(self, name).weight)

    # -- forward ---------------------------------------------------------

    def forward(self, images, *, training: bool = False, dn_gt=None,
                noise=None, dn_draws=None):
        """``images``: (B, H, W, 3) f32 at the model's ``image_size``.
        ``noise`` gives the backbone's Gumbel draws in training; ``dn_gt``
        (``boxes_xyxy``, ``labels``, ``valid``) and ``dn_draws`` (a
        `UniformDraws`) feed the denoising groups of a training forward.
        Returns the JAX module's output dict."""
        if tuple(images.shape[1:3]) != self.image_hw:
            raise ValueError(
                f"DETRDetector was built for {self.image_hw} inputs (its "
                f"position embeddings are sized from them), got "
                f"{tuple(images.shape[1:3])}")
        with full_f32_convolutions():
            return self._forward(images, training, dn_gt, noise, dn_draws)

    def _split_levels(self, flat):
        outs, off = [], 0
        b = flat.shape[0]
        for hh, ww in self.level_shapes:
            outs.append(flat[:, off:off + hh * ww].reshape(b, hh, ww,
                                                           self.dim))
            off += hh * ww
        return outs

    def _forward(self, images, training, dn_gt, noise, dn_draws):
        feats, additional, model_configs = self.backbone(
            images, training=training, noise=noise)
        b = images.shape[0]
        tokens = []
        for i, f in enumerate(feats):
            t = getattr(self, f"input_proj_{i}")(f)
            hh, ww = t.shape[1], t.shape[2]
            tokens.append((t + getattr(self, f"pos_embed_{i}")).reshape(
                b, hh * ww, self.dim) + self.level_embed[i])
        x = torch.cat(tokens, dim=1)  # (B, sum H_l W_l, D)
        ref_points = _reference_points(self.level_shapes, x.device).expand(
            b, -1, -1)
        for i in range(self.enc_layers):
            layer = getattr(self, f"enc_{i}")
            x = (layer(x, self._split_levels(x), ref_points)
                 if self.encoder == "deformable" else layer(x))

        pixel_feat = None
        if self.with_masks:
            enc_levels = self._split_levels(x)
            top = enc_levels[-1]
            for i in range(len(enc_levels) - 2, -1, -1):
                fine = enc_levels[i]
                up = resize_nearest(top, fine.shape[1:3])
                top = fine + getattr(self, f"pixdec_lateral_{i}")(up)
                top = torch.relu(getattr(self, f"pixdec_fuse_{i}")(top))
            pixel_feat = self.mask_feature(top)

        def query_masks(q_now):
            return torch.einsum("bqd,bhwd->bqhw", self.mask_embed(q_now),
                                pixel_feat)

        enc_aux = {}
        if self.query_init == "ddq":
            q, sel_box, enc_aux = self._ddq_queries(x, ref_points)
            return self._ddq_decode(q, x, sel_box, images, training, dn_gt,
                                    dn_draws, additional, model_configs,
                                    enc_aux,
                                    query_masks if self.with_masks else None)
        q = self.query_embed.expand(b, -1, -1)
        mask_aux = []
        for i in range(self.dec_layers):
            amask = None
            if self.with_masks:
                y = self.dec_norm(q)
                mlog = query_masks(y)
                mask_aux.append({"cls_logits": self.cls_head(y),
                                 "mask_logits": mlog})
                if self.masked_cross_attention:
                    amask = self._mask_attn(mlog.detach())
            q = getattr(self, f"dec_self_{i}")(q)
            q = getattr(self, f"dec_cross_{i}")(q, x, attn_mask=amask)
        q = self.dec_norm(q)
        h = torch.relu(self.box_fc1(q))
        h = torch.relu(self.box_fc2(h))
        out = {
            "cls_logits": self.cls_head(q),
            "boxes_cxcywh": torch.sigmoid(self.box_head(h)),
            "additional": additional,
            "model_configs": model_configs,
            **enc_aux,
        }
        if self.with_masks:
            out["mask_logits"] = query_masks(q)
            out["mask_aux_outputs"] = tuple(mask_aux)
        return out

    def _mask_attn(self, mlog):
        """Foreground-restricted cross-attention over the concatenated
        levels, with Mask2Former's empty-mask safeguard (a query whose
        mask has no foreground attends everywhere). (B, Q, N) bool."""
        with torch.no_grad():
            fgs = []
            b, qn = mlog.shape[:2]
            for hh, ww in self.level_shapes:
                m = resize_linear(mlog, (hh, ww))
                fgs.append((torch.sigmoid(m) > 0.5).reshape(b, qn, hh * ww))
            fg = torch.cat(fgs, dim=-1)
            return fg | ~fg.any(-1, keepdim=True)

    def _ddq_queries(self, x, ref_points):
        """Dense proposals over every encoder token; class-agnostic NMS
        over the ``min(4Q, N)`` most object-like keeps ``num_queries``
        distinct ones, whose encoder features become the queries."""
        b, n, _ = x.shape
        if n < self.num_queries:
            raise ValueError(
                f"the DDQ query initialisation needs at least num_queries="
                f"{self.num_queries} encoder tokens, the input gives {n}: "
                f"raise the image size")
        enc_cls = self.enc_cls(x)
        r = ref_points.clamp(1e-4, 1 - 1e-4)
        prior = torch.cat([torch.log(r / (1 - r)),
                           torch.full((b, n, 2), -2.0, dtype=x.dtype,
                                      device=x.device)], dim=-1)
        enc_boxes = torch.sigmoid(self.enc_box(x) + prior)
        objness = 1.0 - torch.softmax(enc_cls, dim=-1)[..., -1]
        with torch.no_grad():
            pre = min(4 * self.num_queries, n)
            top_s, top_i = topk_stable(objness.detach(), pre)
            keep, _ = nms(cxcywh_to_xyxy(gather_rows(enc_boxes.detach(),
                                                     top_i)),
                          top_s, self.ddq_nms_iou, self.num_queries)
            sel = torch.gather(top_i, 1, keep)
        q = self.query_proj(gather_rows(x, sel))
        sel_cls, sel_box = gather_rows(enc_cls, sel), gather_rows(enc_boxes,
                                                                  sel)
        return q, sel_box, {"enc_cls_logits": sel_cls,
                            "enc_boxes_cxcywh": sel_box}

    def _denoising(self, images, dn_gt, dn_draws):
        """Noised ground-truth queries and their targets (CDN)."""
        g = self.dn_groups
        if dn_draws is None:
            raise ValueError("a training forward with dn_groups > 0 and "
                             "dn_gt needs dn_draws")
        dev = images.device
        gt_xyxy = dn_gt["boxes_xyxy"] / _xyxy_scale(
            (images.shape[1], images.shape[2]), dev)
        gt_cxcywh = torch.stack([
            (gt_xyxy[..., 0] + gt_xyxy[..., 2]) / 2,
            (gt_xyxy[..., 1] + gt_xyxy[..., 3]) / 2,
            torch.clamp_min(gt_xyxy[..., 2] - gt_xyxy[..., 0], 1e-4),
            torch.clamp_min(gt_xyxy[..., 3] - gt_xyxy[..., 1], 1e-4)], -1)
        rep = gt_cxcywh.repeat(1, g, 1)  # (B, g*M, 4)
        wh = rep[..., 2:4]
        shift = (dn_draws.uniform(rep[..., :2].shape, dev) * 2 - 1) * wh \
            * (self.dn_box_noise / 2)
        scale = 1.0 + (dn_draws.uniform(wh.shape, dev) * 2 - 1) \
            * self.dn_box_noise
        dn_boxes = torch.cat([rep[..., :2] + shift, wh * scale],
                             -1).clamp(1e-4, 1.0)
        labels_rep = dn_gt["labels"].long().repeat(1, g)
        flip = dn_draws.uniform(labels_rep.shape, dev) < self.dn_label_noise
        rand_lab = dn_draws.randint(labels_rep.shape, 0, self.num_classes,
                                    dev)
        noisy = torch.where(flip, rand_lab, labels_rep)
        targets = {"dn_gt_cxcywh": rep, "dn_gt_labels": labels_rep,
                   "dn_valid": dn_gt["valid"].repeat(1, g)}
        return self.dn_label_embed(noisy), dn_boxes, targets

    def _ddq_decode(self, q, x, sel_box, images, training, dn_gt, dn_draws,
                    additional, model_configs, enc_aux, query_masks):
        """The DDQ decoder: per-layer refinement, distinct-query
        self-attention masks and the optional denoising groups."""
        b, qn = q.shape[0], self.num_queries
        dev = q.device
        ref = sel_box.detach()  # (B, Q, 4) cxcywh
        n_dn, dn_targets = 0, None
        if training and self.dn_groups > 0 and dn_gt is not None:
            q_dn, dn_boxes, dn_targets = self._denoising(images, dn_gt,
                                                         dn_draws)
            n_dn = q_dn.shape[1]
            q = torch.cat([q, q_dn], dim=1)
            ref = torch.cat([ref, dn_boxes], dim=1)
        qt = qn + n_dn
        if n_dn:
            # the matchable block sees itself; a dn group sees itself and
            # the matchable block; the matchable block never sees dn
            gid = torch.cat([
                torch.full((qn,), -1, dtype=torch.int64, device=dev),
                torch.arange(self.dn_groups, device=dev).repeat_interleave(
                    n_dn // self.dn_groups)])
            row, col = gid[:, None], gid[None, :]
            base_allowed = (((row == -1) & (col == -1))
                            | ((row >= 0) & ((col == -1) | (col == row))))
            base_allowed = base_allowed[None].expand(b, qt, qt)
        else:
            base_allowed = torch.ones((b, qt, qt), dtype=torch.bool,
                                      device=dev)
        allowed = base_allowed
        aux_outputs, distinct_keep = [], []
        keep_prev = torch.ones((b, qn), dtype=torch.bool, device=dev)
        cls_i = boxes_i = None
        for i in range(self.dec_layers):
            q = getattr(self, f"dec_self_{i}")(q, attn_mask=allowed)
            q = getattr(self, f"dec_cross_{i}")(q, x)
            y = getattr(self, f"dec_norm_{i}")(q)
            cls_i = getattr(self, f"cls_head_l{i}")(y)
            h = torch.relu(getattr(self, f"box_fc1_l{i}")(y))
            h = torch.relu(getattr(self, f"box_fc2_l{i}")(h))
            delta = getattr(self, f"box_head_l{i}")(h)
            boxes_i = torch.sigmoid(delta + _inverse_sigmoid(ref))
            if i < self.dec_layers - 1:
                aux_outputs.append({"cls_logits": cls_i[:, :qn],
                                    "boxes_cxcywh": boxes_i[:, :qn]})
            ref = boxes_i.detach()
            if self.distinct_queries and i < self.dec_layers - 1:
                with torch.no_grad():
                    obj = 1.0 - torch.softmax(cls_i[:, :qn].detach(),
                                              dim=-1)[..., -1]
                    keep = nms_keep_mask(cxcywh_to_xyxy(ref[:, :qn]), obj,
                                         self.ddq_nms_iou, keep_prev)
                keep_prev = keep
                distinct_keep.append(keep)
                # mask the cells where neither endpoint is distinct
                dis = keep[:, :, None] | keep[:, None, :]
                allowed = base_allowed.clone()
                allowed[:, :qn, :qn] = dis
        out = {
            "cls_logits": cls_i[:, :qn],
            "boxes_cxcywh": boxes_i[:, :qn],
            "aux_outputs": tuple(aux_outputs),
            "additional": additional,
            "model_configs": model_configs,
            **enc_aux,
        }
        if distinct_keep:
            out["distinct_keep"] = torch.stack(distinct_keep)  # (L-1, B, Q)
        if n_dn:
            out["dn_cls_logits"] = cls_i[:, qn:]
            out["dn_boxes_cxcywh"] = boxes_i[:, qn:]
            out.update(dn_targets)
        if query_masks is not None:
            out["mask_logits"] = query_masks(self.dec_norm(q[:, :qn]))
        return out


# --- set-prediction loss -----------------------------------------------------

def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def generalized_iou(a_xyxy, b_xyxy):
    """gIoU of aligned (..., 4) boxes."""
    ax0, ay0, ax1, ay1 = a_xyxy.unbind(-1)
    bx0, by0, bx1, by1 = b_xyxy.unbind(-1)
    area_a = torch.clamp_min(ax1 - ax0, 0) * torch.clamp_min(ay1 - ay0, 0)
    area_b = torch.clamp_min(bx1 - bx0, 0) * torch.clamp_min(by1 - by0, 0)
    ix0, iy0 = torch.maximum(ax0, bx0), torch.maximum(ay0, by0)
    ix1, iy1 = torch.minimum(ax1, bx1), torch.minimum(ay1, by1)
    inter = torch.clamp_min(ix1 - ix0, 0) * torch.clamp_min(iy1 - iy0, 0)
    union = torch.clamp_min(area_a + area_b - inter, 1e-9)
    iou = inter / union
    ex0, ey0 = torch.minimum(ax0, bx0), torch.minimum(ay0, by0)
    ex1, ey1 = torch.maximum(ax1, bx1), torch.maximum(ay1, by1)
    enclose = torch.clamp_min(ex1 - ex0, 0) * torch.clamp_min(ey1 - ey0, 0)
    return iou - (enclose - union) / torch.clamp_min(enclose, 1e-9)


def _host_match(costs: np.ndarray) -> np.ndarray:
    """scipy's ``linear_sum_assignment`` per (…, Q, M) f32 cost matrix:
    the query assigned to each ground-truth slot, (…, M) int64."""
    from scipy.optimize import linear_sum_assignment

    flat = costs.reshape((-1,) + costs.shape[-2:])
    out = np.zeros((flat.shape[0], flat.shape[2]), np.int64)
    for k in range(flat.shape[0]):
        rows, cols = linear_sum_assignment(flat[k])
        out[k][cols] = rows
    return out.reshape(costs.shape[:-2] + (costs.shape[-1],))


def hungarian_match(cost):
    """Exact bipartite matching of a (B, Q, M) cost on the host. Returns
    (B, M) int64 on the cost's device: the query assigned to each GT slot
    (any query for an invalid slot; mask downstream). Needs M <= Q."""
    return hungarian_match_many(cost[None])[0]


def hungarian_match_many(costs):
    """`hungarian_match` of an (L, B, Q, M) stack of cost matrices with one
    copy to the host and one back. This is the set loss's host
    synchronisation."""
    if costs.shape[-1] > costs.shape[-2]:
        raise ValueError(
            f"hungarian_match needs num_queries >= max GT slots; got "
            f"Q={costs.shape[-2]} < M={costs.shape[-1]}: raise num_queries "
            f"or shrink the GT padding")
    host = costs.detach().to("cpu", torch.float32).numpy()
    return torch.from_numpy(_host_match(host)).to(costs.device)


def _set_prediction_cost(cls_logits, pred_cxcywh, gt_cxcywh, gt_labels,
                         gt_valid, *, cls_weight, l1_weight, giou_weight):
    """The (B, Q, M) matching cost ``-log p(class) + L1 + (1 - gIoU)``,
    invalid slots at 1e6; no gradient."""
    with torch.no_grad():
        logp = torch.log_softmax(cls_logits, -1)
        idx = gt_labels.long()[:, None, :].expand(-1, logp.shape[1], -1)
        cost_cls = -torch.gather(logp, 2, idx)
        l1 = torch.abs(pred_cxcywh[:, :, None, :]
                       - gt_cxcywh[:, None, :, :]).sum(-1)
        giou = generalized_iou(cxcywh_to_xyxy(pred_cxcywh)[:, :, None, :],
                               cxcywh_to_xyxy(gt_cxcywh)[:, None, :, :])
        cost = cls_weight * cost_cls + l1_weight * l1 + giou_weight * (
            1 - giou)
        return torch.where(gt_valid[:, None, :] > 0, cost,
                           torch.full_like(cost, 1e6))


def _matched_targets(qn, match, gt_labels, gt_valid, num_classes):
    """The class target of every query: its matched GT's label, else the
    no-object class."""
    b = match.shape[0]
    target = torch.full((b, qn), num_classes, dtype=torch.int64,
                        device=match.device)
    return target.scatter(1, match, torch.where(
        gt_valid > 0, gt_labels.long(),
        torch.full_like(gt_labels.long(), num_classes)))


def _set_prediction_losses(cls_logits, pred_cxcywh, gt_cxcywh, gt_labels,
                           gt_valid, match, *, num_classes,
                           no_object_weight):
    """The (cls, l1, giou) losses of one prediction set under ``match``."""
    b, qn, _ = cls_logits.shape
    logp = torch.log_softmax(cls_logits, -1)
    matched_boxes = gather_rows(pred_cxcywh, match)
    target_cls = _matched_targets(qn, match, gt_labels, gt_valid,
                                  num_classes)
    weights = torch.full((b, qn), no_object_weight, dtype=logp.dtype,
                         device=logp.device).scatter(
        1, match, torch.where(gt_valid > 0, torch.ones_like(gt_valid),
                              torch.full_like(gt_valid, no_object_weight)))
    ce = -torch.gather(logp, 2, target_cls[..., None])[..., 0]
    loss_cls = (ce * weights).sum() / torch.clamp_min(weights.sum(), 1.0)
    n_pos = torch.clamp_min(gt_valid.sum(), 1.0)
    loss_l1 = (torch.abs(matched_boxes - gt_cxcywh).sum(-1)
               * gt_valid).sum() / n_pos
    loss_giou = ((1 - generalized_iou(cxcywh_to_xyxy(matched_boxes),
                                      cxcywh_to_xyxy(gt_cxcywh)))
                 * gt_valid).sum() / n_pos
    return loss_cls, loss_l1, loss_giou


def _point_mask_losses(matched_mlog, gt_masks, gt_valid, cand, rand, *,
                       num_points, importance_ratio):
    """Point-sampled BCE and dice of the matched masks on uncertainty-
    chosen points (``cand``, ``rand``: the two uniform draws), averaged
    over the valid masks."""
    n_imp = int(num_points * importance_ratio)
    coords = _importance_coords(matched_mlog, cand, rand, n_imp)
    pred_pts = point_sample(matched_mlog, coords)
    tgt_pts = point_sample(gt_masks.float(), coords)
    n_pos = torch.clamp_min(gt_valid.sum(), 1.0)
    bce = -(tgt_pts * F.logsigmoid(pred_pts)
            + (1 - tgt_pts) * F.logsigmoid(-pred_pts)).mean(-1)
    p = torch.sigmoid(pred_pts)
    inter = (p * tgt_pts).sum(-1)
    dice = 1 - (2 * inter + 1) / (p.sum(-1) + tgt_pts.sum(-1) + 1)
    return (bce * gt_valid).sum() / n_pos, (dice * gt_valid).sum() / n_pos


def _mask_set_cost(cls_logits, mask_logits, gt_masks, gt_labels, gt_valid,
                   coords, *, num_points):
    """Mask2Former's (cls 2, point-BCE 5, point-dice 5) matching cost on
    the shared points ``coords`` (B, 1, P, 2); no gradient."""
    with torch.no_grad():
        pred_pts = point_sample(mask_logits.detach(), coords)
        gt_pts = point_sample(gt_masks.float(), coords)  # (B, M, P)
        pos = -F.logsigmoid(pred_pts)
        neg = -F.logsigmoid(-pred_pts)
        cost_mask = (torch.einsum("bqp,bmp->bqm", pos, gt_pts)
                     + torch.einsum("bqp,bmp->bqm", neg, 1 - gt_pts)) \
            / num_points
        pr = torch.sigmoid(pred_pts)
        inter = torch.einsum("bqp,bmp->bqm", pr, gt_pts)
        cost_dice = 1 - (2 * inter + 1) / (
            pr.sum(-1)[:, :, None] + gt_pts.sum(-1)[:, None, :] + 1)
        probs = torch.softmax(cls_logits.float(), -1)
        idx = gt_labels.long()[:, None, :].expand(-1, probs.shape[1], -1)
        cost_cls = -torch.gather(probs, 2, idx)
        cost = 2.0 * cost_cls + 5.0 * cost_mask + 5.0 * cost_dice
        return torch.where(gt_valid[:, None, :] > 0, cost,
                           torch.full_like(cost, 1e6))


def _mask_set_losses(cls_logits, mask_logits, gt_masks, gt_labels, gt_valid,
                     match, cand, rand, *, num_classes, num_points,
                     importance_ratio, no_object_weight):
    """CE and the point-sampled mask losses of one decoder layer under
    ``match``: (loss_cls, loss_bce, loss_dice)."""
    qn = cls_logits.shape[1]
    target_cls = _matched_targets(qn, match, gt_labels, gt_valid,
                                  num_classes)
    weights = torch.where(target_cls == num_classes, no_object_weight, 1.0)
    logp = torch.log_softmax(cls_logits, -1)
    ce = -torch.gather(logp, 2, target_cls[..., None])[..., 0]
    loss_cls = (ce * weights).sum() / torch.clamp_min(weights.sum(), 1.0)
    loss_bce, loss_dice = _point_mask_losses(
        gather_rows(mask_logits, match), gt_masks, gt_valid, cand, rand,
        num_points=num_points, importance_ratio=importance_ratio)
    return loss_cls, loss_bce, loss_dice


def _xyxy_scale(image_size, device=None):
    """(x0, y0, x1, y1) pixel scale ``[w, h, w, h]`` f32 from a side or an
    ``(h, w)`` pair, made on ``device`` by fills (no host copy)."""
    if isinstance(image_size, (tuple, list)):
        h, w = float(image_size[0]), float(image_size[1])
    else:
        h = w = float(image_size)
    scale = torch.full((4,), w, dtype=torch.float32, device=device)
    scale[1::2] = h
    return scale


def detr_loss(outputs, gt_boxes_xyxy, gt_labels, gt_valid, *,
              num_classes: int, image_size, gt_masks=None,
              sparsity_target: float = 0.5, lambda_sparse: float = 1.0,
              cls_weight: float = 1.0, l1_weight: float = 5.0,
              giou_weight: float = 2.0, no_object_weight: float = 0.1,
              enc_aux_weight: float = 1.0, mask_points: Optional[int] = None,
              oversample_ratio: float = 3.0, importance_ratio: float = 0.75,
              mask_draws=None, mask_weight: float = 1.0,
              dice_weight: float = 1.0, mask_aux_weight: float = 1.0):
    """The DETR set loss plus the LAUD ``loss_sparse`` injection. GT boxes
    are xyxy pixels (``image_size``: a side or ``(h, w)``). DDQ's encoder
    proposals, every decoder layer's auxiliary predictions and the
    denoising groups join as in the JAX function. With ``mask_points`` and
    ``mask_draws`` the mask loss is Mask2Former's point-sampled BCE and
    dice, and every ``mask_aux_outputs`` layer gets its own (cls, mask,
    dice) matching; without them the dense full-grid loss of the final
    layer. The uniform draws are taken in the JAX function's order before
    any match; every cost matrix goes to the host in one copy. Returns
    (total, metrics)."""
    cls_logits = outputs["cls_logits"]
    pred_cxcywh = outputs["boxes_cxcywh"]
    b, qn = cls_logits.shape[:2]
    dev = cls_logits.device
    gt_norm = gt_boxes_xyxy / _xyxy_scale(image_size, dev)
    gt_cxcywh = torch.stack([
        (gt_norm[..., 0] + gt_norm[..., 2]) / 2,
        (gt_norm[..., 1] + gt_norm[..., 3]) / 2,
        torch.clamp_min(gt_norm[..., 2] - gt_norm[..., 0], 1e-6),
        torch.clamp_min(gt_norm[..., 3] - gt_norm[..., 1], 1e-6)], -1)
    cost_kw = dict(cls_weight=cls_weight, l1_weight=l1_weight,
                   giou_weight=giou_weight)
    loss_kw = dict(num_classes=num_classes,
                   no_object_weight=no_object_weight)
    m = gt_boxes_xyxy.shape[1]

    # --- every prediction set whose matching the step needs ---------------
    box_sets = [(cls_logits, pred_cxcywh)]
    if "enc_cls_logits" in outputs:
        box_sets.append((outputs["enc_cls_logits"],
                         outputs["enc_boxes_cxcywh"]))
    aux_outputs = outputs.get("aux_outputs") or ()
    box_sets += [(a["cls_logits"], a["boxes_cxcywh"]) for a in aux_outputs]
    costs = [_set_prediction_cost(c, p, gt_cxcywh, gt_labels, gt_valid,
                                  **cost_kw) for c, p in box_sets]

    use_points = mask_points is not None and mask_draws is not None
    with_mask = gt_masks is not None and "mask_logits" in outputs
    mask_aux = (outputs.get("mask_aux_outputs") or ()) if (
        use_points and gt_masks is not None) else ()
    if use_points and (with_mask or mask_aux):
        n_over, n_imp = _point_counts(mask_points, oversample_ratio,
                                      importance_ratio)

        def point_draws():
            return (mask_draws.uniform((b, m, n_over, 2), dev),
                    mask_draws.uniform((b, m, mask_points - n_imp, 2), dev))

    final_draws = point_draws() if use_points and with_mask else None
    aux_draws = []
    for a in mask_aux:
        coords = mask_draws.uniform((b, 1, mask_points, 2), dev)
        aux_draws.append(point_draws())
        costs.append(_mask_set_cost(a["cls_logits"], a["mask_logits"],
                                    gt_masks, gt_labels, gt_valid, coords,
                                    num_points=mask_points))
    matches = hungarian_match_many(torch.stack(costs))
    n_box = len(box_sets)

    # --- the losses ---------------------------------------------------------
    match = matches[0]
    loss_cls, loss_l1, loss_giou = _set_prediction_losses(
        cls_logits, pred_cxcywh, gt_cxcywh, gt_labels, gt_valid, match,
        **loss_kw)
    metrics = {"loss_cls": loss_cls, "loss_l1": loss_l1,
               "loss_giou": loss_giou}
    total = (cls_weight * loss_cls + l1_weight * loss_l1
             + giou_weight * loss_giou)
    k = 1
    if "enc_cls_logits" in outputs:
        e_cls, e_l1, e_giou = _set_prediction_losses(
            outputs["enc_cls_logits"], outputs["enc_boxes_cxcywh"],
            gt_cxcywh, gt_labels, gt_valid, matches[k], **loss_kw)
        aux = cls_weight * e_cls + l1_weight * e_l1 + giou_weight * e_giou
        metrics["loss_enc_aux"] = aux
        total = total + enc_aux_weight * aux
        k += 1
    if aux_outputs:
        aux_total = 0.0
        for a in aux_outputs:
            a_cls, a_l1, a_giou = _set_prediction_losses(
                a["cls_logits"], a["boxes_cxcywh"], gt_cxcywh, gt_labels,
                gt_valid, matches[k], **loss_kw)
            aux_total = aux_total + (cls_weight * a_cls + l1_weight * a_l1
                                     + giou_weight * a_giou)
            k += 1
        metrics["loss_dec_aux"] = aux_total
        total = total + aux_total

    if "dn_cls_logits" in outputs:
        # each dn query reconstructs its own GT (known assignment)
        dn_cls, dn_box = outputs["dn_cls_logits"], outputs["dn_boxes_cxcywh"]
        dn_lab, dn_tgt = outputs["dn_gt_labels"], outputs["dn_gt_cxcywh"]
        dn_val = outputs["dn_valid"]
        logp_dn = torch.log_softmax(dn_cls, -1)
        tgt_cls = torch.where(dn_val > 0, dn_lab.long(),
                              torch.full_like(dn_lab.long(), num_classes))
        ce_dn = -torch.gather(logp_dn, 2, tgt_cls[..., None])[..., 0]
        w_dn = torch.where(dn_val > 0, torch.ones_like(dn_val),
                           torch.full_like(dn_val, no_object_weight))
        n_dn = torch.clamp_min(dn_val.sum(), 1.0)
        loss_dn = (cls_weight * (ce_dn * w_dn).sum()
                   / torch.clamp_min(w_dn.sum(), 1.0)
                   + l1_weight * (torch.abs(dn_box - dn_tgt).sum(-1)
                                  * dn_val).sum() / n_dn
                   + giou_weight * ((1 - generalized_iou(
                       cxcywh_to_xyxy(dn_box), cxcywh_to_xyxy(dn_tgt)))
                       * dn_val).sum() / n_dn)
        metrics["loss_dn"] = loss_dn
        total = total + loss_dn

    if with_mask:
        mlog = outputs["mask_logits"]
        matched_mlog = gather_rows(mlog, match)  # (B, M, h, w)
        n_pos = torch.clamp_min(gt_valid.sum(), 1.0)
        if use_points:
            lb, ld = _point_mask_losses(
                matched_mlog, gt_masks, gt_valid, *final_draws,
                num_points=mask_points, importance_ratio=importance_ratio)
            loss_mask = mask_weight * lb + dice_weight * ld
        else:
            mh, mw = mlog.shape[2], mlog.shape[3]
            # GT masks average-pooled to the prediction grid
            gm = gt_masks.float().reshape(
                b, m, mh, gt_masks.shape[2] // mh, mw,
                gt_masks.shape[3] // mw).mean((3, 5))
            target = (gm > 0.5).float()
            bce = -(target * F.logsigmoid(matched_mlog)
                    + (1 - target) * F.logsigmoid(-matched_mlog)).mean((2, 3))
            p = torch.sigmoid(matched_mlog)
            inter = (p * target).sum((2, 3))
            dice = 1 - (2 * inter + 1) / (p.sum((2, 3)) + target.sum((2, 3))
                                          + 1)
            loss_mask = (mask_weight * (bce * gt_valid).sum()
                         + dice_weight * (dice * gt_valid).sum()) / n_pos
        metrics["loss_mask"] = loss_mask
        total = total + loss_mask

    if mask_aux:
        aux_cls = aux_bce = aux_dice = 0.0
        for j, a in enumerate(mask_aux):
            ac, ab, ad = _mask_set_losses(
                a["cls_logits"], a["mask_logits"], gt_masks, gt_labels,
                gt_valid, matches[n_box + j], *aux_draws[j],
                num_points=mask_points, importance_ratio=importance_ratio,
                **loss_kw)
            aux_cls, aux_bce, aux_dice = (aux_cls + ac, aux_bce + ab,
                                          aux_dice + ad)
        aux_total = (cls_weight * aux_cls + mask_weight * aux_bce
                     + dice_weight * aux_dice)
        metrics["loss_mask_aux"] = aux_total
        total = total + mask_aux_weight * aux_total

    l_sparse, rate = loss_sparse(outputs["additional"], sparsity_target)
    metrics["loss_sparse"] = l_sparse
    metrics["flops_rate"] = rate
    return total + lambda_sparse * l_sparse, metrics


def detr_detect(outputs, image_size, score_threshold: float = 0.05,
                max_detections: int = 100):
    """Per-image detections from DETR outputs (softmax, no-object dropped):
    (B, k) ``boxes`` (xyxy pixels), ``scores`` (0 under the threshold),
    ``classes`` and ``indices`` (the query behind each detection, for the
    mask logits). The softmax is computed in f64 and rounded to f32, so a
    card and the CPU detect alike to the bit."""
    probs = torch.softmax(outputs["cls_logits"].double(), -1).float()[
        ..., :-1]
    scores, classes = probs.amax(-1), probs.argmax(-1)
    boxes = cxcywh_to_xyxy(outputs["boxes_cxcywh"]) * _xyxy_scale(
        image_size, probs.device)
    k = min(max_detections, scores.shape[1])
    top_s, top_i = topk_stable(scores, k)
    return {
        "boxes": gather_rows(boxes, top_i),
        "scores": torch.where(top_s > score_threshold, top_s,
                              torch.zeros_like(top_s)),
        "classes": torch.gather(classes, 1, top_i),
        "indices": top_i,
    }
