"""NHWC BatchNorm with the JAX package's (flax) statistics.

``nn.BatchNorm2d`` keeps the UNBIASED batch variance in its running
statistics and computes the batch variance around the mean; flax keeps the
biased variance, computed as ``E[x^2] - E[x]^2`` in f32 and clipped at 0,
and its ``momentum=0.9`` is PyTorch's ``momentum=0.1``. A converted
checkpoint and a training run must see the same numbers on both sides, so
this module does what flax does. Parameters and statistics stay f32 under
mixed precision; the statistics are buffers named as ``nn.BatchNorm2d``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.device import resolve_device
from laudnet_tpu_torch.ops.batch_stats import global_mean


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of an NHWC tensor.

    ``use_running_average=False`` normalises with the batch statistics (of
    the global batch inside `ops.batch_stats.global_batch`) and moves the
    running ones by ``1 - momentum`` (in place). The arithmetic
    runs in f32 whatever the input's type, and the result is cast to
    ``compute_dtype`` (the promoted type of input and parameters when that
    is None)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.features, self.momentum, self.eps = features, momentum, eps
        self.weight = nn.Parameter(torch.ones(features, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))
        stat = dict(device=kw["device"], dtype=torch.float32)
        self.register_buffer("running_mean", torch.zeros(features, **stat))
        self.register_buffer("running_var", torch.ones(features, **stat))

    def forward(self, x: torch.Tensor, *, use_running_average: bool,
                compute_dtype=None) -> torch.Tensor:
        out_dtype = compute_dtype or torch.promote_types(x.dtype,
                                                         self.weight.dtype)
        if use_running_average:
            # (x - mean) * rsqrt(var + eps) * weight + bias in f32, one pass
            y = F.batch_norm(
                x.permute(0, 3, 1, 2), self.running_mean, self.running_var,
                self.weight, self.bias, False, 0.0, self.eps)
            return y.permute(0, 2, 3, 1).to(out_dtype)
        xf = x.float()
        # the global batch's E[x] and E[x^2] under a data-parallel step
        # (`ops/batch_stats.py`), one all-reduce for both
        mean, mean_sq = global_mean(torch.stack(
            [xf.mean(dim=(0, 1, 2)), (xf * xf).mean(dim=(0, 1, 2))]))
        var = (mean_sq - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(out_dtype)
