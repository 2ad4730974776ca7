"""Symmetric int8 quantisation for W8A8 serving (counterpart of
`laudnet_tpu/ops/quant.py`).

* weights: per-output-channel symmetric int8, quantised once
  (`quantize_weight`);
* activations: per-row (per-token) dynamic symmetric int8, computed right
  before each product (`quantize_rows`);
* accumulation in integers, dequantised by the rank-1 product of the row
  and column scales (`int8_linear`).

Weights are in torch.nn.Linear layout (N, K), so a channel is a row; the
flax kernel is (K, N) and its `quantize_weight` reduces over axis 0: the
codes and scales are the same, transposed. Codes round half to even
(`torch.round`, as `jnp.round`) after a true divide by the scale.

`fake_quant_weight` and `fake_quant_rows` quantise and dequantise with a
straight-through gradient (QAT); `fake_quant_linear`, which
``QuantDense(fake=True)`` runs, is the float product over both.
`fake_quant_per_image` and `QuantConv` are the CNN family's: one scale per
image, and the convolution of the codes exact in integers (`int_conv2d`).
"""

from __future__ import annotations

import torch
from torch import nn

from laudnet_tpu_torch.device import resolve_device


def quantize_weight(weight: torch.Tensor, eps: float = 1e-8):
    """Per-output-channel symmetric int8 of an (N, K) Linear weight.
    Returns ``(q, scale)``: int8 (N, K) and f32 (N,) with
    ``q * scale[:, None] ~= weight``; codes in [-127, 127]."""
    wf = weight.float()
    scale = wf.abs().amax(dim=1).clamp_min(eps) / 127.0
    q = torch.round(wf / scale[:, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def quantize_rows(x: torch.Tensor, eps: float = 1e-6):
    """Per-row dynamic symmetric int8 over the last axis. Returns
    ``(q, scale)``, scale f32 shaped like x with the last axis 1. A row of
    zeros (a masked-out token) gets scale eps/127 and codes 0. The scale is
    ``max(a, eps) * (1/127)`` and the codes divide by it, as the block
    kernel's row quantiser does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(eps) * (1.0 / 127.0)
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact ``xq @ wq.T`` of int8 codes, returned as f32 (the s32 sum cast
    up, as the kernels do). Computed in f64, which holds every partial sum
    exactly (|sum| <= 127^2 * K < 2^53) on the CPU and on a card alike:
    an int32 matmul has no CUDA implementation in PyTorch."""
    return (xq.double() @ wq.double().t()).float()


def int8_linear(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                bias=None) -> torch.Tensor:
    """W8A8 linear: dynamic per-row activation codes, exact integer sum,
    rank-1 dequant. ``x``: (..., K) float; ``wq``: (N, K) int8;
    ``wscale``: (N,) f32. Returns f32 (..., N)."""
    xq, xs = quantize_rows(x)
    out = int_matmul(xq, wq) * xs * wscale
    if bias is not None:
        out = out + bias.float()
    return out


def fake_quant_weight(weight: torch.Tensor) -> torch.Tensor:
    """Quantise-dequantise an (N, K) weight with a straight-through
    gradient: the forward sees exactly the int8-representable weights the
    serving path uses, the backward passes gradients through unchanged."""
    q, s = quantize_weight(weight)
    deq = (q.float() * s[:, None]).to(weight.dtype)
    return weight + (deq - weight).detach()


def fake_quant_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row activation fake-quant with a straight-through gradient."""
    q, s = quantize_rows(x)
    deq = (q.float() * s).to(x.dtype)
    return x + (deq - x).detach()


def fake_quant_linear(x: torch.Tensor, weight: torch.Tensor,
                      bias=None) -> torch.Tensor:
    """The QAT form of a W8A8 linear: a float product over fake-quantised
    rows and an (N, K) fake-quantised weight, straight-through gradients
    on both, so training sees the serving path's int8 numerics."""
    out = fake_quant_rows(x) @ fake_quant_weight(weight).to(x.dtype).t()
    return out if bias is None else out + bias.to(x.dtype)


class QuantDense(nn.Linear):
    """Drop-in W8A8 replacement for ``nn.Linear``, with its parameter
    names, so float checkpoints load unchanged. The weight is quantised per
    output channel on every call; engine-build paths quantise once instead
    (`infer/fused_vit.py`). ``fake=True`` makes it the QAT layer instead
    (`fake_quant_linear`); that attribute alone decides which of the two a
    call runs."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None, fake: bool = False):
        super().__init__(in_features, out_features, bias=bias,
                         device=resolve_device(device), dtype=dtype)
        self.fake = fake

    def forward(self, x):
        if self.fake:
            return fake_quant_linear(x, self.weight, self.bias)
        wq, ws = quantize_weight(self.weight)
        return int8_linear(x, wq, ws, self.bias).to(x.dtype)


def fake_quant_per_image(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-IMAGE activation fake-quant with a straight-through gradient,
    the `QuantConv` serving scheme: one dynamic scale per image per conv
    input, so the train-time noise matches serving and does not depend on
    the batch's composition."""
    xf = x.float()
    red = tuple(range(1, x.dim()))
    s = xf.abs().amax(dim=red, keepdim=True).clamp_min(eps) * (1.0 / 127.0)
    q = torch.round(xf / s).clamp(-127, 127)
    deq = (q * s).to(x.dtype)
    return x + (deq - x).detach()


def int_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride, padding, dilation,
               groups: int) -> torch.Tensor:
    """The exact convolution of int8 codes, NCHW by OIHW, as f32 (the s32
    sums cast up). ``xq`` holds the activation codes in a float type (they
    are integers of at most 127 in magnitude, exact in any of them), ``wq``
    is int8. f32 cannot hold the sums (127^2 * 9 * 512 > 2^24), so on the
    CPU the convolution runs in f64, and on a card as im2col rows times the
    weight matrix in ``torch._int_mm`` (s8 x s8 -> s32), group by group.
    That product wants more than 16 rows and K and N in multiples of 8:
    rows, K (the 7x7x3 stem's 147) and N are zero-padded up."""
    if not xq.is_cuda:
        out = torch.nn.functional.conv2d(
            xq.double(), wq.double(), None, stride, padding, dilation, groups)
        return out.float()
    b, cin = xq.shape[:2]
    o, cg, kh, kw = wq.shape
    pointwise = (kh, kw) == (1, 1) and tuple(padding) == (0, 0)
    if pointwise:
        xs = xq[:, :, ::stride[0], ::stride[1]]
        ho, wo = xs.shape[2:]
        cols = xs.permute(0, 2, 3, 1).reshape(b * ho * wo, cin)
    else:
        ho = (xq.shape[2] + 2 * padding[0] - dilation[0] * (kh - 1) - 1
              ) // stride[0] + 1
        wo = (xq.shape[3] + 2 * padding[1] - dilation[1] * (kw - 1) - 1
              ) // stride[1] + 1
        # rows ordered (c, kh, kw), as the OIHW weight flattens
        cols = torch.nn.functional.unfold(
            xq.to(torch.bfloat16), (kh, kw), dilation, padding, stride)
        cols = cols.transpose(1, 2).reshape(b * ho * wo, cin * kh * kw)
    cols = cols.to(torch.int8)
    m, per = cols.shape[0], cg * kh * kw
    og = o // groups
    pad_m, pad_k, pad_n = max(17 - m, 0), (-per) % 8, (-og) % 8
    outs = []
    for g in range(groups):
        a = cols[:, g * per:(g + 1) * per]
        w = wq[g * og:(g + 1) * og].reshape(og, per)
        a = torch.nn.functional.pad(a, (0, pad_k, 0, pad_m))
        w = torch.nn.functional.pad(w, (0, pad_k, 0, pad_n))
        outs.append(torch._int_mm(a.contiguous(), w.t())[:m, :og])
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.float().reshape(b, ho, wo, o).permute(0, 3, 1, 2)


class QuantConv(nn.Conv2d):
    """Drop-in W8A8 replacement for a bias-free convolution, with
    ``nn.Conv2d``'s parameter name and OIHW shape, so float checkpoints load
    unchanged: per-image dynamic activation scale (eps 1e-6), per-output-
    channel weight scales (`quantize_weight` over the flattened filter),
    the exact integer convolution (`int_conv2d`), rank-1 dequant, returned
    in the input's dtype. Its ``forward`` takes and returns NHWC, the
    layout of the models that use it. ``fake=True`` is the QAT form: a
    float convolution over the fake-quantised weight and per-image
    fake-quantised activations, straight-through gradients on both. No
    compute dtype enters either form: the int8 path defines its own types
    and the fake-quant path must see the serving numerics."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 device=None, dtype=None, fake: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias=False,
                         device=resolve_device(device), dtype=dtype)
        self.fake = fake

    def forward(self, x, fake=None, padding=None):
        """``x``: (B, H, W, C). ``fake`` and ``padding`` override the
        module's own for one call."""
        fake = self.fake if fake is None else fake
        pad = self.padding if padding is None else (padding, padding)
        xc = x.permute(0, 3, 1, 2)
        w = self.weight
        if fake:
            wf = fake_quant_weight(w.flatten(1)).reshape(w.shape)
            out = torch.nn.functional.conv2d(
                fake_quant_per_image(xc), wf.to(x.dtype), None, self.stride,
                pad, self.dilation, self.groups)
            return out.permute(0, 2, 3, 1)
        wq, ws = quantize_weight(w.flatten(1))
        xf = xc.float()
        xs = xf.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6) * (
            1.0 / 127.0)
        xq = torch.round(xf / xs).clamp(-127, 127)
        acc = int_conv2d(xq, wq.reshape(w.shape), self.stride, pad,
                         self.dilation, self.groups)
        out = (acc * xs * ws[None, :, None, None]).to(x.dtype)
        return out.permute(0, 2, 3, 1)
