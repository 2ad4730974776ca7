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
``QuantDense(fake=True)`` runs, is the float product over both. `fake_quant_per_image` and `QuantConv` belong to the CNN
slice of the port; they raise.
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


def fake_quant_per_image(*args, **kwargs):
    raise NotImplementedError(
        "fake_quant_per_image (the QuantConv activation scheme) belongs to "
        "the CNN slice of the port")


class QuantConv(nn.Module):
    """The W8A8 convolution of the CNN family; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "QuantConv belongs to the CNN slice of the port")
