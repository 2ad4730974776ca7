"""LAUD-RegNet: dynamic RegNet X/Y with spatial and channel gating, and
the static RegNet teacher (counterpart of
`laudnet_tpu/models/laud_regnet.py`).

A block is 1x1 conv-bn-relu ("a") -> grouped 3x3 conv-bn-relu ("b") ->
optional SqueezeExcitation -> 1x1 conv-bn ("c"), with a projection on the
residual where the stride or the width changes. The channel mask gates the
a and b convolutions' outputs BEFORE their BatchNorms; the spatial mask
gates c's output after its BatchNorm. ``dyn_mode='none'`` is the plain
block of the static teacher (`regnet_static`).

The SE squeeze width is ``round(se_ratio * width_in)``, from the block's
INPUT width, and the SE FLOPs go into the totals but not into the block's
``flops_perc``: two quirks of the reference that the JAX package keeps and
so does the port. `regnet_params` turns the published design-space
parameters into stage widths and depths with numpy (``np.round`` is
banker's rounding), as the JAX function does.

Layout, mixed precision and devices as in `models/laud_resnet.py`: NHWC at
every ``forward``, OIHW weights, ``compute_dtype`` for the convolutions,
the SE and the classifier with f32 masters and f32 gating heads, and
construction on the card unless a ``device`` is given. Module names are
the flax tree's (``stem_conv``, ``stage{s}_{b}``, ``a_conv`` ... ``se.fc1``
... ``fc``), so `convert.from_jax.load_flax_variables` carries a JAX
checkpoint over by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.device import full_f32_convolutions, resolve_device
from laudnet_tpu_torch.models.laud_resnet import (BlockStats, LAUDOutput,
                                                  conv_nhwc,
                                                  init_resnet_weights)
from laudnet_tpu_torch.models.maskers import (ChannelMaskerConvLinear,
                                              ChannelMaskerMLP,
                                              SpatialMasker,
                                              default_bias_init_)
from laudnet_tpu_torch.ops import masking
from laudnet_tpu_torch.ops.batch_stats import global_mean
from laudnet_tpu_torch.ops.norm import BatchNorm


def _make_divisible(v: float, divisor: int) -> int:
    min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclasses.dataclass(frozen=True)
class RegNetParams:
    depths: Tuple[int, ...]
    widths: Tuple[int, ...]
    group_widths: Tuple[int, ...]
    bottleneck_multipliers: Tuple[float, ...]
    se_ratio: Optional[float]


def regnet_params(depth: int, w_0: int, w_a: float, w_m: float,
                  group_width: int, bottleneck_multiplier: float = 1.0,
                  se_ratio: Optional[float] = None) -> RegNetParams:
    """Per-stage widths and depths from the RegNet design-space parameters
    (the published recipe, `laudnet_tpu/models/laud_regnet.py:64-104`)."""
    if w_a < 0 or w_0 <= 0 or w_m <= 1 or w_0 % 8 != 0:
        raise ValueError("Invalid RegNet settings")
    quant = 8
    widths_cont = np.arange(depth) * w_a + w_0
    capacity = np.round(np.log(widths_cont / w_0) / math.log(w_m))
    block_widths = (
        np.round(w_0 * np.power(w_m, capacity) / quant) * quant
    ).astype(int).tolist()

    split = [w != wp for w, wp in zip(block_widths + [0], [0] + block_widths)]
    stage_widths = [w for w, t in zip(block_widths, split[:-1]) if t]
    boundaries = [d for d, t in enumerate(split) if t]
    stage_depths = np.diff(boundaries).astype(int).tolist()

    n = len(stage_widths)
    bms = [bottleneck_multiplier] * n
    gws = [group_width] * n

    # group-width compatibility: bottleneck widths divisible by group width
    w_bots = [int(w * b) for w, b in zip(stage_widths, bms)]
    gws = [min(g, wb) for g, wb in zip(gws, w_bots)]
    w_bots = [_make_divisible(wb, g) for wb, g in zip(w_bots, gws)]
    stage_widths = [int(wb / b) for wb, b in zip(w_bots, bms)]

    return RegNetParams(depths=tuple(stage_depths), widths=tuple(stage_widths),
                        group_widths=tuple(gws),
                        bottleneck_multipliers=tuple(bms), se_ratio=se_ratio)


class SqueezeExcitation(nn.Module):
    """Torchvision-style SE on NHWC ``x``: global average -> 1x1 conv ->
    ReLU -> 1x1 conv -> sigmoid, times ``x``; in the compute dtype."""

    def __init__(self, channels: int, squeeze_channels: int, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.fc1 = nn.Conv2d(channels, squeeze_channels, 1, **kw)
        self.fc2 = nn.Conv2d(squeeze_channels, channels, 1, **kw)

    def forward(self, x, cd=None):
        s = masking.global_avg_pool(x)
        dt = cd or s.dtype
        s = s.to(dt)
        for conv in (self.fc1, self.fc2):
            s = F.linear(s, conv.weight.flatten(1).to(dt), conv.bias.to(dt))
            if conv is self.fc1:
                s = torch.relu(s)
        return x * torch.sigmoid(s)[:, None, None, :]


class LAUDRegNetBlock(nn.Module):
    """Residual bottleneck block with gating heads; ``dyn_mode='none'`` is
    the static teacher's block. The default channel masker is
    ``conv_linear`` (the network's is ``MLP``), as in the JAX block."""

    def __init__(self, width_in: int, width_out: int, stride: int = 1,
                 group_width: int = 16, bottleneck_multiplier: float = 1.0,
                 se_ratio: Optional[float] = None,
                 spatial_mask_channel_group: int = 1,
                 channel_dyn_granularity: int = 1, output_size: int = 56,
                 mask_spatial_granularity: int = 1, dyn_mode: str = "both",
                 channel_masker: str = "conv_linear",
                 channel_masker_layers: int = 2, reduction: int = 16,
                 bn_eval: bool = False, device=None, dtype=None,
                 compute_dtype=None):
        super().__init__()
        if dyn_mode not in ("channel", "spatial", "both", "none"):
            raise ValueError(f"dyn_mode must be channel, spatial, both or "
                             f"none, got {dyn_mode!r}")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.width_in, self.width_out, self.stride = width_in, width_out, stride
        self.output_size, self.dyn_mode = output_size, dyn_mode
        self.bn_eval, self.compute_dtype = bn_eval, compute_dtype
        w_b = self.w_b = int(round(width_out * bottleneck_multiplier))
        self.groups = w_b // group_width
        self.se_ratio = se_ratio
        self.width_se = int(round((se_ratio or 0) * width_in))
        mask_size = output_size // mask_spatial_granularity

        self.masker_channel = self.masker_spatial = None
        if dyn_mode in ("channel", "both"):
            g = w_b // channel_dyn_granularity
            if channel_masker == "conv_linear":
                self.masker_channel = ChannelMaskerConvLinear(
                    width_in, g, reduction=reduction, bn_eval=bn_eval, **kw)
            else:
                self.masker_channel = ChannelMaskerMLP(
                    width_in, g, layers=channel_masker_layers,
                    reduction=reduction, **kw)
        if dyn_mode in ("spatial", "both"):
            self.masker_spatial = SpatialMasker(
                width_in, spatial_mask_channel_group, mask_size, **kw)

        self.a_conv = nn.Conv2d(width_in, w_b, 1, bias=False, **kw)
        self.a_bn = BatchNorm(w_b, **kw)
        self.b_conv = nn.Conv2d(w_b, w_b, 3, stride, 1, groups=self.groups,
                                bias=False, **kw)
        self.b_bn = BatchNorm(w_b, **kw)
        self.se = (SqueezeExcitation(w_b, self.width_se, **kw)
                   if se_ratio else None)
        self.c_conv = nn.Conv2d(w_b, width_out, 1, bias=False, **kw)
        self.c_bn = BatchNorm(width_out, **kw)
        self.proj_conv = self.proj_bn = None
        if stride != 1 or width_in != width_out:
            self.proj_conv = nn.Conv2d(width_in, width_out, 1, stride,
                                       bias=False, **kw)
            self.proj_bn = BatchNorm(width_out, **kw)

    def forward(self, x, temperature=None, *, training: bool = False,
                noise=None):
        """``x``: (B, H, W, width_in). Training draws one Gumbel sample per
        masker from ``noise``, the channel masker's first. Returns ``(out,
        BlockStats)``."""
        cd = self.compute_dtype
        conv = lambda m, t: conv_nhwc(m, t, cd)
        frozen = (not training) or self.bn_eval
        bn = lambda m, t: m(t, use_running_average=frozen, compute_dtype=cd)
        width_in, w_b, groups = x.shape[-1], self.w_b, self.groups
        f32 = lambda v: torch.full((), v, dtype=torch.float32,
                                   device=x.device)
        one = torch.ones((), dtype=torch.float32, device=x.device)

        conv1_fpp = width_in * w_b
        conv2_fpp = w_b * w_b * 9 // groups
        conv3_fpp = w_b * self.width_out
        se_fpp = w_b * self.width_se * 2 if self.se_ratio else 0

        # --- gating heads -------------------------------------------------
        channel_mask = spatial_mask3 = None
        channel_s = s1 = s2 = s3 = one
        channel_mask_flops = spatial_mask_flops = 0
        gate_kw = dict(training=training, noise=noise)
        if self.masker_channel is not None:
            channel_mask, channel_s, channel_mask_flops = self.masker_channel(
                x, temperature, **gate_kw)
        s3_img = torch.ones((x.shape[0],), dtype=torch.float32,
                            device=x.device)
        if self.masker_spatial is not None:
            spatial_mask3, s3, spatial_mask_flops = self.masker_spatial(
                x, temperature, **gate_kw)
            s3_img = spatial_mask3.float().mean(dim=(1, 2, 3))
            spatial_mask3 = masking.upsample_mask_nearest(
                spatial_mask3, self.output_size)
            m2 = masking.expand_mask(spatial_mask3, stride=1, padding=0)
            s2 = global_mean(m2.float().mean())
            m1 = masking.expand_mask(m2, stride=self.stride, padding=1)
            s1 = global_mean(m1.float().mean())

        sparse_flops = f32(channel_mask_flops + spatial_mask_flops)
        dense_flops = f32(channel_mask_flops + spatial_mask_flops)
        in_hw = (self.output_size * self.stride) ** 2
        out_hw = self.output_size ** 2

        # --- transform ----------------------------------------------------
        out = conv(self.a_conv, x)
        if channel_mask is not None:
            out = masking.apply_channel_mask(out, channel_mask)
        out = torch.relu(bn(self.a_bn, out))
        dense_flops = dense_flops + conv1_fpp * in_hw
        sparse_flops = sparse_flops + conv1_fpp * in_hw * channel_s * s1

        out = conv(self.b_conv, out)
        if channel_mask is not None:
            out = masking.apply_channel_mask(out, channel_mask)
        out = torch.relu(bn(self.b_bn, out))
        dense_flops = dense_flops + conv2_fpp * out_hw
        sparse_flops = sparse_flops + conv2_fpp * out_hw * channel_s ** 2 * s2

        if self.se is not None:
            out = self.se(out, cd)

        out = bn(self.c_bn, conv(self.c_conv, out))
        if spatial_mask3 is not None:
            out = masking.apply_spatial_mask(out, spatial_mask3)
        dense_flops = dense_flops + conv3_fpp * out_hw
        sparse_flops = sparse_flops + conv3_fpp * out_hw * channel_s * s3

        identity = x
        if self.proj_conv is not None:
            identity = bn(self.proj_bn, conv(self.proj_conv, x))
            ds = width_in * self.width_out * out_hw
            dense_flops = dense_flops + ds
            sparse_flops = sparse_flops + ds

        out = torch.relu(out + identity)
        # SE counted dense, outside flops_perc (the reference's quirk)
        return out, BlockStats(
            spatial_s3=s3, spatial_s2=s2, spatial_s1=s1, channel_s=channel_s,
            flops_perc=sparse_flops / dense_flops,
            sparse_flops=sparse_flops + se_fpp, s3_img=s3_img,
            dense_flops=dense_flops + se_fpp)


class LAUDRegNet(nn.Module):
    """The full dynamic RegNet; returns `LAUDOutput`. Per-stage tuples have
    one entry per stage of ``params_cfg``. Blocks are attributes named
    ``stage{s}_{b}`` (s from 1). Parameters are drawn from ``generator``
    when given, else left to the caller."""

    def __init__(self, params_cfg: RegNetParams, num_classes: int = 1000,
                 stem_width: int = 32, input_size: int = 224,
                 spatial_mask_channel_group: Sequence[int] = (1, 1, 1, 1),
                 mask_spatial_granularity: Sequence[int] = (1, 1, 1, 1),
                 channel_dyn_granularity: Sequence[int] = (1, 1, 1, 1),
                 dyn_mode: Sequence[str] = ("both",) * 4,
                 channel_masker: Sequence[str] = ("MLP",) * 4,
                 channel_masker_layers: Sequence[int] = (1, 1, 1, 1),
                 reduction_ratio: Sequence[int] = (16, 16, 16, 16),
                 bn_eval: bool = False, in_chans: int = 3, device=None,
                 dtype=None, compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        p = self.params_cfg = params_cfg
        self.num_classes, self.input_size = num_classes, input_size
        self.dyn_mode = tuple(dyn_mode)
        self.compute_dtype, self.bn_eval = compute_dtype, bn_eval
        self.stem_conv = nn.Conv2d(in_chans, stem_width, 3, 2, 1, bias=False,
                                   **kw)
        self.stem_bn = BatchNorm(stem_width, **kw)
        width_in = stem_width
        self.block_names = []
        for s in range(len(p.depths)):
            names = []
            for b in range(p.depths[s]):
                block = LAUDRegNetBlock(
                    width_in, p.widths[s], stride=2 if b == 0 else 1,
                    group_width=p.group_widths[s],
                    bottleneck_multiplier=p.bottleneck_multipliers[s],
                    se_ratio=p.se_ratio,
                    spatial_mask_channel_group=spatial_mask_channel_group[s],
                    channel_dyn_granularity=channel_dyn_granularity[s],
                    output_size=input_size // (2 ** (s + 2)),
                    mask_spatial_granularity=mask_spatial_granularity[s],
                    dyn_mode=self.dyn_mode[s],
                    channel_masker=channel_masker[s],
                    channel_masker_layers=channel_masker_layers[s],
                    reduction=reduction_ratio[s], bn_eval=bn_eval,
                    compute_dtype=compute_dtype, **kw)
                name = f"stage{s + 1}_{b}"
                self.add_module(name, block)
                names.append(name)
                width_in = p.widths[s]
            self.block_names.append(names)
        self.fc = nn.Linear(width_in, num_classes, **kw)
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """The JAX package's initialisers: He-normal (fan-out) convolutions
        (the SE's too, with the default uniform biases), unit BatchNorms,
        the maskers' own, and the classifier at normal(0.01) with a zero
        bias."""
        init_resnet_weights(self, generator)
        for m in self.modules():
            if isinstance(m, SqueezeExcitation):
                for conv in (m.fc1, m.fc2):
                    default_bias_init_(conv.bias, conv.in_channels, generator)
        self.fc.weight.normal_(0.0, 0.01, generator=generator)
        self.fc.bias.zero_()

    def stages(self):
        """The blocks, stage by stage."""
        return [[getattr(self, n) for n in names]
                for names in self.block_names]

    def forward(self, x, temperature=None, *, training: bool = False,
                noise=None):
        """``x``: NHWC images; gates as `LAUDResNet.forward`."""
        if training and noise is None and any(m != "none"
                                              for m in self.dyn_mode):
            raise ValueError("training=True needs a Gumbel noise source")
        if self.compute_dtype is None:
            with full_f32_convolutions():
                return self._forward(x, temperature, training, noise)
        return self._forward(x, temperature, training, noise)

    def _forward(self, x, temperature, training, noise):
        cd = self.compute_dtype
        c_in = x.shape[-1]
        x = conv_nhwc(self.stem_conv, x, cd)
        x = torch.relu(self.stem_bn(
            x, use_running_average=(not training) or self.bn_eval,
            compute_dtype=cd))
        flops = torch.full(
            (), float(c_in * x.shape[-1] * x.shape[1] * x.shape[2] * 9),
            dtype=torch.float32, device=x.device)

        per_stage = {"s3": [], "s2": [], "s1": [], "ch": [], "s3i": []}
        flops_perc_all = []
        for blocks in self.stages():
            stats = []
            for block in blocks:
                x, st = block(x, temperature, training=training, noise=noise)
                stats.append(st)
                flops_perc_all.append(st.flops_perc)
                flops = flops + st.sparse_flops
            for key, field in (("s3", "spatial_s3"), ("s2", "spatial_s2"),
                               ("s1", "spatial_s1"), ("ch", "channel_s"),
                               ("s3i", "s3_img")):
                per_stage[key].append(
                    torch.stack([getattr(st, field) for st in stats]))

        x = masking.global_avg_pool(x)
        flops = flops + x.shape[-1]
        fc = self.fc
        if cd is None:
            logits = fc(x)
        else:
            logits = F.linear(x.to(cd), fc.weight.to(cd), fc.bias.to(cd))
        flops = flops + x.shape[-1] * self.num_classes
        return LAUDOutput(
            logits=logits,
            spatial_s3=tuple(per_stage["s3"]),
            spatial_s2=tuple(per_stage["s2"]),
            spatial_s1=tuple(per_stage["s1"]),
            channel_s=tuple(per_stage["ch"]),
            flops_perc=torch.stack(flops_perc_all),
            flops=flops,
            spatial_s3_img=tuple(per_stage["s3i"]),
        )


# --- constructors (published RegNet design-space parameters) -----------------

_REGNET_CFGS = {
    "y_400mf": dict(depth=16, w_0=48, w_a=27.89, w_m=2.09, group_width=8,
                    se_ratio=0.25),
    "y_800mf": dict(depth=14, w_0=56, w_a=38.84, w_m=2.4, group_width=16,
                    se_ratio=0.25),
    "y_1_6gf": dict(depth=27, w_0=48, w_a=20.71, w_m=2.65, group_width=24,
                    se_ratio=0.25),
    "y_3_2gf": dict(depth=21, w_0=80, w_a=42.63, w_m=2.66, group_width=24,
                    se_ratio=0.25),
    "y_8gf": dict(depth=17, w_0=192, w_a=76.82, w_m=2.19, group_width=56,
                  se_ratio=0.25),
    "y_16gf": dict(depth=18, w_0=200, w_a=106.23, w_m=2.48, group_width=112,
                   se_ratio=0.25),
    "y_32gf": dict(depth=20, w_0=232, w_a=115.89, w_m=2.53, group_width=232,
                   se_ratio=0.25),
    "y_128gf": dict(depth=27, w_0=456, w_a=160.83, w_m=2.52, group_width=264,
                    se_ratio=0.25),
    "x_400mf": dict(depth=22, w_0=24, w_a=24.48, w_m=2.54, group_width=16),
    "x_800mf": dict(depth=16, w_0=56, w_a=35.73, w_m=2.28, group_width=16),
    "x_1_6gf": dict(depth=18, w_0=80, w_a=34.01, w_m=2.25, group_width=24),
    "x_3_2gf": dict(depth=25, w_0=88, w_a=26.31, w_m=2.25, group_width=48),
    "x_8gf": dict(depth=23, w_0=80, w_a=49.56, w_m=2.88, group_width=120),
    "x_16gf": dict(depth=22, w_0=216, w_a=55.59, w_m=2.1, group_width=128),
    "x_32gf": dict(depth=23, w_0=320, w_a=69.86, w_m=2.0, group_width=168),
}


def _make_ctor(key):
    def ctor(**kwargs) -> LAUDRegNet:
        return LAUDRegNet(params_cfg=regnet_params(**_REGNET_CFGS[key]),
                          **kwargs)

    ctor.__name__ = f"lad_regnet_{key}"
    ctor.__doc__ = f"LAUD-RegNet-{key.upper()}."
    return ctor


lad_regnet_y_400mf = _make_ctor("y_400mf")
lad_regnet_y_800mf = _make_ctor("y_800mf")
lad_regnet_y_1_6gf = _make_ctor("y_1_6gf")
lad_regnet_y_3_2gf = _make_ctor("y_3_2gf")
lad_regnet_y_8gf = _make_ctor("y_8gf")
lad_regnet_y_16gf = _make_ctor("y_16gf")
lad_regnet_y_32gf = _make_ctor("y_32gf")
lad_regnet_y_128gf = _make_ctor("y_128gf")
lad_regnet_x_400mf = _make_ctor("x_400mf")
lad_regnet_x_800mf = _make_ctor("x_800mf")
lad_regnet_x_1_6gf = _make_ctor("x_1_6gf")
lad_regnet_x_3_2gf = _make_ctor("x_3_2gf")
lad_regnet_x_8gf = _make_ctor("x_8gf")
lad_regnet_x_16gf = _make_ctor("x_16gf")
lad_regnet_x_32gf = _make_ctor("x_32gf")


def regnet_static(key: str, **kwargs) -> LAUDRegNet:
    """The static RegNet teacher: the same architecture with every gate
    off (``dyn_mode='none'`` in all four stages)."""
    return LAUDRegNet(params_cfg=regnet_params(**_REGNET_CFGS[key]),
                      dyn_mode=("none",) * 4, **kwargs)
