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

The QAT fake-quant functions belong to the training slice of the port and
`QuantConv` to the CNN slice; they raise.
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


class QuantDense(nn.Linear):
    """Drop-in W8A8 replacement for ``nn.Linear`` at eval, with its
    parameter names, so float checkpoints load unchanged. The weight is
    quantised per output channel on every call; engine-build paths
    quantise once instead (`infer/fused_vit.py`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias,
                         device=resolve_device(device), dtype=dtype)

    def forward(self, x):
        wq, ws = quantize_weight(self.weight)
        return int8_linear(x, wq, ws, self.bias).to(x.dtype)


def _training_slice(name):
    def raiser(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (QAT fake-quant) belongs to the training slice of the "
            "port")
    raiser.__name__ = name
    return raiser


fake_quant_weight = _training_slice("fake_quant_weight")
fake_quant_rows = _training_slice("fake_quant_rows")
fake_quant_per_image = _training_slice("fake_quant_per_image")


class QuantConv(nn.Module):
    """The W8A8 convolution of the CNN family; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "QuantConv belongs to the CNN slice of the port")
