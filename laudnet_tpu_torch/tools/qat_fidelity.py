"""How far a QAT product is from the W8A8 product it trains for.

QAT only holds if the fake-quantised product (`ops/quant.py`:
`fake_quant_linear`, ``QuantConv(fake=True)``) is the serving product
(`int8_linear`, ``QuantConv(fake=False)``). Both take the same codes and
scales from the same functions. W8A8 sums the codes exactly and rounds
three times (the s32 sum cast to f32, the two scales). The fake-quant
product rounds each dequantised operand (``q * s``, then the
straight-through ``x + (deq - x)``: at most three roundings of it) and sums
K products in f32 in the library's order. Every summation order keeps its
error within ``K u sum|terms|`` (u = 2^-24; recursive summation's bound,
which blocked and pairwise orders also meet), so in f32 with TF32 off each
output is held to

    bound = (K + 8) u sum_k |x_k w_k| + 3 u |out|

(``x``, ``w`` the dequantised operands). The bound is the worst case; a
run sits at about a hundredth of it. A wrong scale moves an output by a
share of itself, far past the bound; one code off by one moves it by a
step of the row's scale times a weight, about 3 times the bound at
K = 384 and within it at K = 1536 (the codes are the same by
construction: the same functions on the same input). In bf16 the
fake-quant product rounds its operands and its output to 8 bits; that
distance is reported, not bounded.

`linear_gap` and `conv_gap` run on any device; the card's products are
the ones that matter (``chip_smoke.py``, `tests/test_torch_kernels_cuda.py`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from laudnet_tpu_torch.ops.quant import (fake_quant_linear,
                                         fake_quant_per_image,
                                         fake_quant_rows, fake_quant_weight,
                                         int8_linear, quantize_weight)

U = 2.0 ** -24


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _gap(fake, served, terms, k, fake16) -> dict:
    bound = (k + 8) * U * terms + 3 * U * served.abs()
    diff = (fake - served).abs()
    return {"ratio": (diff / bound.clamp_min(1e-30)).max().item(),
            "max_abs": diff.max().item(), "k": k,
            "bf16_rel": ((fake16.float() - served).norm()
                         / served.norm()).item()}


@torch.no_grad()
def linear_gap(x: torch.Tensor, weight: torch.Tensor) -> dict:
    """``fake_quant_linear`` against ``int8_linear`` on f32 ``x`` (M, K)
    and an (N, K) ``weight``: ``ratio`` (the largest distance over its
    bound: at most 1), ``max_abs``, ``k`` and ``bf16_rel`` (the fake-quant
    product on bf16 ``x``, its distance relative to the W8A8 output's
    norm)."""
    with full_f32():
        served = int8_linear(x, *quantize_weight(weight))
        fake = fake_quant_linear(x, weight)
        terms = fake_quant_rows(x).abs() @ fake_quant_weight(weight).abs().t()
    return _gap(fake, served, terms, x.shape[-1],
                fake_quant_linear(x.bfloat16(), weight))


@torch.no_grad()
def conv_gap(conv, x: torch.Tensor) -> dict:
    """``QuantConv(fake=True)`` against ``fake=False`` (the module ``conv``
    called both ways) on f32 NHWC ``x``; the keys of `linear_gap`."""
    w = conv.weight
    with full_f32():
        served = conv(x, fake=False)
        fake = conv(x, fake=True)
        deq_x = fake_quant_per_image(x.permute(0, 3, 1, 2))
        deq_w = fake_quant_weight(w.flatten(1)).reshape(w.shape)
        terms = F.conv2d(deq_x.abs(), deq_w.abs(), None, conv.stride,
                         conv.padding, conv.dilation, conv.groups
                         ).permute(0, 2, 3, 1)
    return _gap(fake, served, terms, w[0].numel(),
                conv(x.bfloat16(), fake=True))
