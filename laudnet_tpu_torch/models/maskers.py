"""Gating heads ("maskers") for spatial, channel and layer skipping
(counterpart of `laudnet_tpu/models/maskers.py`).

Every head emits paired (keep, skip) logits per decision and gates through
`ops.gating.binary_gate`: Gumbel straight-through in training (noise from
the ``noise`` source it is handed), ``keep >= skip`` at eval. The heads
run in f32 whatever the network's compute type: they cast their input up,
and their 1x1 convolutions are plain f32 matrix products over the channel
axis (`F.linear`), which a card computes in full f32 and never in TF32, so
the hard compares of near-tied logits see the same numbers as on the CPU.

The bias layout keeps the original off-by-one: ``bias[:G]`` is the open
value, ``bias[G + 1:]`` the close value, and element ``G`` keeps its
default uniform draw; released checkpoints bake this in. The FLOPs
constants are the JAX package's, verbatim (including ``out * in + in`` for
the spatial head's conv).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.device import resolve_device
from laudnet_tpu_torch.ops import masking
from laudnet_tpu_torch.ops.batch_stats import global_mean
from laudnet_tpu_torch.ops.gating import binary_gate
from laudnet_tpu_torch.ops.norm import BatchNorm


@torch.no_grad()
def default_weight_init_(weight: torch.Tensor,
                         generator: Optional[torch.Generator]) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): ``nn.Linear``'s and
    ``nn.Conv2d``'s default, from an explicit generator."""
    bound = 1.0 / math.sqrt(weight[0].numel())
    weight.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def default_bias_init_(bias: torch.Tensor, fan_in: int,
                       generator: Optional[torch.Generator]) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def masker_bias_init_(bias: torch.Tensor, group: int, open_value: float,
                      close_value: float, fan_in: int,
                      generator: Optional[torch.Generator]) -> None:
    """The masker bias layout: [:G] = open, [G] = the default draw,
    [G + 1:] = close."""
    default_bias_init_(bias, fan_in, generator)
    bias[:group] = open_value
    bias[group + 1:] = close_value


def _pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution of NHWC ``x`` as a matrix product over channels."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class SpatialMasker(nn.Module):
    """Spatial (or, with ``mask_size=1``, layer) gating head: pool the block
    input to the ``mask_size`` grid (int, or ``(mh, mw)``), project with a
    1x1 conv to 2 G logits per location, gate. Returns
    ``(mask (B, mh, mw, G), density scalar, flops int)``."""

    def __init__(self, in_channels: int, mask_channel_group: int = 1,
                 mask_size=7, device=None, dtype=None):
        super().__init__()
        self.in_channels, self.group = in_channels, mask_channel_group
        self.mask_size = mask_size
        self.conv = nn.Conv2d(in_channels, 2 * mask_channel_group, 1,
                              device=resolve_device(device), dtype=dtype)

    def init_weights(self, generator=None) -> None:
        default_weight_init_(self.conv.weight, generator)
        masker_bias_init_(self.conv.bias, self.group, 5.0, 0.0,
                          self.in_channels, generator)

    def forward(self, x, temperature=None, *, training: bool = False,
                noise=None):
        x = x.float()
        g, in_ch = self.group, x.shape[-1]
        ms = self.mask_size
        mh, mw = (ms, ms) if isinstance(ms, int) else ms
        m = (masking.adaptive_avg_pool(x, (mh, mw))
             if mh < x.shape[1] or mw < x.shape[2] else x)
        flops = in_ch * m.shape[1] * m.shape[2]
        logits = _pointwise(self.conv, m)
        flops += (2 * g * in_ch + in_ch) * logits.shape[1] * logits.shape[2]
        b, mh, mw, _ = logits.shape
        mask = binary_gate(logits.reshape(b, mh, mw, 2, g), temperature,
                           training=training, noise=noise)
        return mask, global_mean(mask.mean()), flops


class ChannelMaskerMLP(nn.Module):
    """Channel gating head: global average -> 1- or 2-layer MLP -> 2 G
    logits; hidden width ``max(G // reduction, 16)``. Returns
    ``(mask (B, G), density, flops)``."""

    def __init__(self, in_channels: int, channel_dyn_group: int,
                 layers: int = 2, reduction: int = 16, device=None,
                 dtype=None):
        super().__init__()
        assert layers in (1, 2)
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.in_channels, self.group = in_channels, channel_dyn_group
        self.layers = layers
        g = channel_dyn_group
        if layers == 2:
            self.width = max(g // reduction, 16)
            self.fc1 = nn.Linear(in_channels, self.width, **kw)
            self.fc2 = nn.Linear(self.width, 2 * g, **kw)
        else:
            self.fc = nn.Linear(in_channels, 2 * g, **kw)

    def init_weights(self, generator=None) -> None:
        c, g = self.in_channels, self.group
        if self.layers == 2:
            default_weight_init_(self.fc1.weight, generator)
            default_bias_init_(self.fc1.bias, c, generator)
            default_weight_init_(self.fc2.weight, generator)
            masker_bias_init_(self.fc2.bias, g, 2.0, -2.0, self.width,
                              generator)
        else:
            default_weight_init_(self.fc.weight, generator)
            masker_bias_init_(self.fc.bias, g, 2.0, -2.0, c, generator)

    def forward(self, x, temperature=None, *, training: bool = False,
                noise=None):
        x = x.float()
        g = self.group
        b, h, w, c = x.shape
        flops = c * h * w
        pooled = masking.global_avg_pool(x)
        if self.layers == 2:
            logits = self.fc2(torch.relu(self.fc1(pooled)))
            flops += c * self.width + self.width * 2 * g
        else:
            logits = self.fc(pooled)
            flops += c * 2 * g
        mask = binary_gate(logits.reshape(b, 2, g), temperature,
                           training=training, noise=noise)
        return mask, global_mean(mask.mean()), flops


class ChannelMaskerConvLinear(nn.Module):
    """Channel gating head: 1x1 conv -> BN -> ReLU -> global average ->
    Linear. Returns ``(mask (B, G), density, flops)``; the FLOPs are the
    post-conv feature volume plus the two projections."""

    def __init__(self, in_channels: int, channel_dyn_group: int,
                 reduction: int = 16, bn_eval: bool = False, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.in_channels, self.group = in_channels, channel_dyn_group
        self.bn_eval = bn_eval  # freeze the BN statistics in training
        self.red = in_channels // reduction
        self.conv = nn.Conv2d(in_channels, self.red, 1, bias=False, **kw)
        self.bn = BatchNorm(self.red, **kw)
        self.linear = nn.Linear(self.red, 2 * channel_dyn_group, **kw)

    def init_weights(self, generator=None) -> None:
        default_weight_init_(self.conv.weight, generator)
        default_weight_init_(self.linear.weight, generator)
        masker_bias_init_(self.linear.bias, self.group, 2.0, -2.0, self.red,
                          generator)

    def forward(self, x, temperature=None, *, training: bool = False,
                noise=None):
        x = x.float()
        g, in_ch = self.group, x.shape[-1]
        m = _pointwise(self.conv, x)
        m = torch.relu(self.bn(
            m, use_running_average=(not training) or self.bn_eval))
        b, h, w, cm = m.shape
        flops = cm * h * w
        logits = self.linear(masking.global_avg_pool(m))
        flops += in_ch * self.red + self.red * 2 * g
        mask = binary_gate(logits.reshape(b, 2, g), temperature,
                           training=training, noise=noise)
        return mask, global_mean(mask.mean()), flops
