"""LAUD-ResNet: latency-aware unified dynamic ResNet with spatial, channel
and layer gating (counterpart of `laudnet_tpu/models/laud_resnet.py`).

``dyn_mode`` per stage is one of 'channel', 'spatial', 'both', 'layer';
layer mode is a spatial masker with ``mask_size=1``. Channel masks gate the
conv1 and conv2 outputs, the spatial mask gates the conv3 output after
bn3, and the dilated spatial masks feed only the FLOPs bookkeeping, which
follows the JAX package formula for formula, so the sparsity losses see
the same values.

Layout: images and activations are NHWC at every module's ``forward``, as
in the JAX package; masks are (B, mh, mw, G) and (B, G). Inside, a
convolution sees ``x.permute(0, 3, 1, 2)``, which for an NHWC-contiguous
tensor IS the channels-last layout cuDNN prefers, so nothing is copied;
the weights are ``nn.Conv2d``'s OIHW.

``compute_dtype`` (the JAX modules' ``dtype``) is mixed precision: the
convolutions and the classifier run in it, BatchNorm computes in f32 and
rounds its output to it, parameters and BN statistics stay f32 masters,
and the gating heads run in f32 (`models/maskers.py`). With
``compute_dtype=None`` the model is f32, and its convolutions are full
f32 on a card too: ``forward`` switches cuDNN's TF32 off for its own
duration (`device.full_f32_convolutions`), because the gates compare
near-tied f32 logits and TF32's three digits flip them against the CPU.

``execution='sparse'`` (eval only) runs conv2 and conv3 of every eligible
block (spatial mode, stride 1, one mask group) on ``patch_capacity`` of
the patch cells only, through `ops/sparse.py`. ``conv_impl='int8'`` runs
the convolutions W8A8 at eval (`ops/quant.py::QuantConv`) and
``'int8_qat'`` additionally fake-quantises them in training.

Constructors build on the card unless given a ``device``
(`laudnet_tpu_torch/device.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.device import full_f32_convolutions, resolve_device
from laudnet_tpu_torch.models.maskers import (ChannelMaskerConvLinear,
                                              ChannelMaskerMLP,
                                              SpatialMasker,
                                              default_bias_init_,
                                              default_weight_init_)
from laudnet_tpu_torch.ops import masking
from laudnet_tpu_torch.ops.batch_stats import global_mean
from laudnet_tpu_torch.ops import sparse as sp
from laudnet_tpu_torch.ops.norm import BatchNorm
from laudnet_tpu_torch.ops.quant import QuantConv
from laudnet_tpu_torch.parallel.tp import (copy_to_model_parallel,
                                           gather_from_model_parallel,
                                           reduce_from_model_parallel,
                                           scatter_to_model_parallel)

EXPANSION = 4
CONV_IMPLS = ("dense", "int8", "int8_qat")


@dataclasses.dataclass
class BlockStats:
    """Per-block dynamic-execution statistics (f32 scalars on the device
    unless noted)."""
    spatial_s3: torch.Tensor   # conv3-output spatial density
    spatial_s2: torch.Tensor   # conv2-input spatial density (dilated)
    spatial_s1: torch.Tensor   # conv1-input density (dilated, strided)
    channel_s: torch.Tensor    # channel-group density
    flops_perc: torch.Tensor   # sparse / dense FLOPs of this block
    sparse_flops: torch.Tensor
    s3_img: Any = None         # (B,) per-image conv3 spatial density
    flops_img: Any = None      # (B,) the formulas at per-image densities
    dense_flops: Any = None


@dataclasses.dataclass
class LAUDOutput:
    logits: torch.Tensor
    spatial_s3: Tuple[torch.Tensor, ...]   # per stage, each (blocks,)
    spatial_s2: Tuple[torch.Tensor, ...]
    spatial_s1: Tuple[torch.Tensor, ...]
    channel_s: Tuple[torch.Tensor, ...]
    flops_perc: torch.Tensor               # (total_blocks,)
    flops: torch.Tensor                    # total sparse multiply-adds
    spatial_s3_img: Any = None             # per stage, each (blocks, B)


# a pytree node, so that code walking a forward's outputs finds its tensors
# (FSDP2 hooks its gradient's gathers onto them, `parallel/fsdp.py`)
torch.export.register_dataclass(
    LAUDOutput, serialized_type_name=f"{__name__}.LAUDOutput")


def quantised(conv_impl: str, training: bool) -> bool:
    """Whether the convolutions take their W8A8 path in this call."""
    return (conv_impl == "int8" and not training) or conv_impl == "int8_qat"


def make_conv(conv_impl: str, cin: int, cout: int, kernel: int,
              stride: int = 1, padding: int = 0, dilation: int = 1,
              groups: int = 1, **kw) -> nn.Conv2d:
    """A bias-free convolution: ``nn.Conv2d``, or the checkpoint-compatible
    `QuantConv` where the model may run W8A8."""
    if conv_impl == "dense":
        return nn.Conv2d(cin, cout, kernel, stride, padding, dilation, groups,
                         bias=False, **kw)
    return QuantConv(cin, cout, kernel, stride, padding, dilation, groups,
                     **kw)


def conv_nhwc(m: nn.Conv2d, x: torch.Tensor, cd, *, quant: bool = False,
              fake: bool = False, padding: Optional[int] = None):
    """Applies conv module ``m`` to NHWC ``x``: W8A8 (or, with ``fake``,
    fake-quant) where ``quant`` asks for it, else a float convolution in
    the compute dtype ``cd`` (the promoted dtype when None)."""
    if quant:
        return m(x, fake=fake, padding=padding)
    w = m.weight
    if cd is not None:
        x, w = x.to(cd), w.to(cd)
    pad = m.padding if padding is None else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, m.stride, pad, m.dilation,
                 m.groups)
    return y.permute(0, 2, 3, 1)


def max_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool, stride 2, padding 1."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


@torch.no_grad()
def he_normal_fan_out_(weight: torch.Tensor,
                       generator: Optional[torch.Generator]) -> None:
    """``kaiming_normal_(mode='fan_out', nonlinearity='relu')`` from an
    explicit generator."""
    fan_out = weight.shape[0] * weight[0, 0].numel()
    weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class LAUDBottleneck(nn.Module):
    """Dynamic bottleneck: 1x1 -> 3x3 -> 1x1 with gating heads."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, group_width: int = 1,
                 dilation: int = 1, spatial_mask_channel_group: int = 1,
                 channel_dyn_granularity: int = 1, output_size=56,
                 mask_spatial_granularity: int = 1, dyn_mode: str = "both",
                 channel_masker: str = "conv_linear",
                 channel_masker_layers: int = 2, reduction: int = 16,
                 execution: str = "dense", patch_capacity: float = 1.0,
                 bn_eval: bool = False, conv_impl: str = "dense",
                 device=None, dtype=None, compute_dtype=None):
        super().__init__()
        assert dyn_mode in ("channel", "spatial", "both", "layer")
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got "
                             f"{conv_impl!r}")
        if execution not in ("dense", "sparse"):
            raise ValueError(f"execution must be 'dense' or 'sparse', got "
                             f"{execution!r}")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.inplanes, self.planes, self.stride = inplanes, planes, stride
        self.group_width, self.dilation = group_width, dilation
        self.spatial_mask_channel_group = spatial_mask_channel_group
        self.mask_spatial_granularity = mask_spatial_granularity
        self.dyn_mode, self.execution = dyn_mode, execution
        self.patch_capacity, self.bn_eval = patch_capacity, bn_eval
        self.conv_impl, self.compute_dtype = conv_impl, compute_dtype
        width = self.width = planes * group_width
        out_planes = self.out_planes = planes * EXPANSION

        self.masker_channel = self.masker_spatial = None
        if dyn_mode in ("channel", "both"):
            group = width // channel_dyn_granularity
            if channel_masker == "conv_linear":
                self.masker_channel = ChannelMaskerConvLinear(
                    inplanes, group, reduction=reduction, bn_eval=bn_eval,
                    **kw)
            else:
                self.masker_channel = ChannelMaskerMLP(
                    inplanes, group, layers=channel_masker_layers,
                    reduction=reduction, **kw)
        if dyn_mode in ("spatial", "layer", "both"):
            self.masker_spatial = SpatialMasker(
                inplanes, spatial_mask_channel_group, 1, **kw)
        self.set_output_size(output_size)

        self.conv1 = make_conv(conv_impl, inplanes, width, 1, **kw)
        self.bn1 = BatchNorm(width, **kw)
        self.conv2 = make_conv(conv_impl, width, width, 3, stride, dilation,
                               dilation, group_width, **kw)
        self.bn2 = BatchNorm(width, **kw)
        self.conv3 = make_conv(conv_impl, width, out_planes, 1, **kw)
        self.bn3 = BatchNorm(out_planes, **kw)
        self.downsample_conv = self.downsample_bn = None
        if has_downsample:
            self.downsample_conv = make_conv(conv_impl, inplanes, out_planes,
                                             1, stride, **kw)
            self.downsample_bn = BatchNorm(out_planes, **kw)
        # tensor parallelism (`parallel/tp.py::shard_params`): conv2 and
        # bn2 hold this rank's channels, conv3 its input channels
        self.tp = None

    def set_output_size(self, output_size) -> None:
        """Points the block at an output resolution (an int, or ``(h, w)``)
        and sizes the spatial mask grid from it. No parameter depends on
        it, so a detector backbone re-targets its blocks at each input
        size, as the JAX module derives them from the traced shape."""
        if isinstance(output_size, int):
            self.out_h = self.out_w = output_size
        else:
            self.out_h, self.out_w = output_size
        g = self.mask_spatial_granularity
        self.mask_size = ((max(self.out_h // g, 1), max(self.out_w // g, 1))
                          if self.dyn_mode != "layer" else (1, 1))
        if self.masker_spatial is not None:
            self.masker_spatial.mask_size = self.mask_size

    def sparse_eligible(self, training: bool) -> bool:
        """The gather/scatter path: eval only, spatial mode, stride 1, one
        mask group, a real patch grid (not layer mode)."""
        return (self.execution == "sparse" and not training
                and self.dyn_mode == "spatial" and self.stride == 1
                and self.spatial_mask_channel_group == 1)

    def sparse_capacity(self) -> int:
        """Patch slots per image in sparse mode."""
        n_cells = self.mask_size[0] * self.mask_size[1]
        return max(1, min(n_cells, math.ceil(self.patch_capacity * n_cells)))

    def forward(self, x, temperature=None, *, training: bool = False,
                noise=None):
        """``x``: (B, H, W, inplanes). Training draws one Gumbel sample per
        masker from ``noise``, the channel masker's before the spatial
        one's. Returns ``(out, BlockStats)``."""
        cd = self.compute_dtype
        inplanes, width, out_planes = x.shape[-1], self.width, self.out_planes
        out_h, out_w = self.out_h, self.out_w
        quant = quantised(self.conv_impl, training)
        fake = self.conv_impl == "int8_qat" and training
        conv = lambda m, t, padding=None: conv_nhwc(
            m, t, cd, quant=quant, fake=fake, padding=padding)
        frozen = (not training) or self.bn_eval
        bn = lambda m, t: m(t, use_running_average=frozen, compute_dtype=cd)

        conv1_fpp = inplanes * width
        conv2_fpp = width * width * 9 // self.group_width
        conv3_fpp = width * out_planes
        # a fill on the device: a Python number copied to the card would
        # be a pageable host-to-device copy, and a stream sync, per block
        f32 = lambda v: torch.full((), v, dtype=torch.float32,
                                   device=x.device)

        # --- gating heads -------------------------------------------------
        one = torch.ones((), dtype=torch.float32, device=x.device)
        channel_mask = spatial_mask3 = None
        channel_s = one
        s1 = s2 = s3 = one
        channel_mask_flops = spatial_mask_flops = 0
        gate_kw = dict(training=training, noise=noise)
        if self.masker_channel is not None:
            channel_mask, channel_s, channel_mask_flops = self.masker_channel(
                x, temperature, **gate_kw)
        if self.masker_spatial is not None:
            spatial_mask3, s3, spatial_mask_flops = self.masker_spatial(
                x, temperature, **gate_kw)

        spatial_mask3_small = spatial_mask3  # before the upsample
        batch = x.shape[0]
        ones_b = torch.ones((batch,), dtype=torch.float32, device=x.device)
        s3_img = s1_img = s2_img = ones_b
        ch_img = (channel_mask.float().mean(dim=-1)
                  if channel_mask is not None else ones_b)
        if self.dyn_mode != "channel":
            s3_img = spatial_mask3_small.float().mean(dim=(1, 2, 3))
            # upsample the coarse conv3-output mask to full resolution, then
            # dilate backwards through conv2 (group OR) and conv1 (3x3
            # receptive field and stride); bookkeeping only, but exact
            spatial_mask3 = masking.upsample_mask_nearest(
                spatial_mask3, (out_h, out_w))
            spatial_mask2 = masking.expand_mask(spatial_mask3, stride=1,
                                                padding=0)
            s2_img = spatial_mask2.float().mean(dim=(1, 2, 3))
            s2 = global_mean(s2_img.mean())
            spatial_mask1 = masking.expand_mask(spatial_mask2,
                                                stride=self.stride, padding=1)
            s1_img = spatial_mask1.float().mean(dim=(1, 2, 3))
            s1 = global_mean(s1_img.mean())

        # --- FLOPs bookkeeping ---------------------------------------------
        masker_flops = f32(channel_mask_flops + spatial_mask_flops)
        sparse_flops = masker_flops
        dense_flops = masker_flops
        in_hw = x.shape[1] * x.shape[2]  # conv1 runs at the input resolution
        out_hw = out_h * out_w
        dense_flops = dense_flops + (conv1_fpp * in_hw + conv2_fpp * out_hw
                                     + conv3_fpp * out_hw)
        sparse_flops = sparse_flops + conv1_fpp * in_hw * channel_s * s1
        sparse_flops = sparse_flops + (conv2_fpp * out_hw * channel_s ** 2
                                       * s2)
        sparse_flops = sparse_flops + conv3_fpp * out_hw * channel_s * s3
        flops_img = (masker_flops
                     + conv1_fpp * in_hw * ch_img * s1_img
                     + conv2_fpp * out_hw * ch_img ** 2 * s2_img
                     + conv3_fpp * out_hw * ch_img * s3_img)

        identity = x
        if self.downsample_conv is not None:
            identity = bn(self.downsample_bn, conv(self.downsample_conv, x))
            ds_flops = inplanes * out_planes * out_hw
            dense_flops = dense_flops + ds_flops
            sparse_flops = sparse_flops + ds_flops
            flops_img = flops_img + ds_flops

        if self.sparse_eligible(training):
            # conv1 stays dense; conv2 and conv3 run on the gathered patches
            # of a fixed capacity, and the results scatter-add onto the
            # identity
            patch = self.mask_spatial_granularity
            capacity = self.sparse_capacity()
            x1 = torch.relu(bn(self.bn1, conv(self.conv1, x)))
            cells = spatial_mask3_small[..., 0]
            idx, valid = sp.select_patches(cells, capacity)
            g = sp.gather_patches(x1, idx, patch, halo=1)
            b_, k_, ph, pw, cg = g.shape
            gflat = g.reshape(b_ * k_, ph, pw, cg)
            gflat = torch.relu(bn(self.bn2,
                                  conv(self.conv2, gflat, padding=0)))
            gflat = bn(self.bn3, conv(self.conv3, gflat))
            patches = gflat.reshape(b_, k_, patch, patch, out_planes)
            out = sp.scatter_patches_add(identity, patches, idx, valid,
                                         patch)
        else:
            mp = self.tp
            out = conv(self.conv1, x)
            if channel_mask is not None:
                out = masking.apply_channel_mask(out, channel_mask)
            out = torch.relu(bn(self.bn1, out))
            if mp is not None:  # column-parallel conv2: this rank's channels
                out = copy_to_model_parallel(out, mp)
            out = conv(self.conv2, out)
            if channel_mask is not None:
                mask2 = channel_mask
                if mp is not None:  # the gates of this rank's channels
                    mask2 = scatter_to_model_parallel(
                        mask2.repeat_interleave(width // mask2.shape[-1],
                                                dim=-1), mp)
                out = masking.apply_channel_mask(out, mask2)
            out = torch.relu(bn(self.bn2, out))
            out = conv(self.conv3, out)
            if mp is not None:  # row-parallel conv3: partial sums reduced
                out = reduce_from_model_parallel(out, mp)
            out = bn(self.bn3, out)
            if spatial_mask3 is not None:
                out = masking.apply_spatial_mask(out, spatial_mask3)
            out = out + identity
        out = torch.relu(out)

        return out, BlockStats(
            spatial_s3=s3, spatial_s2=s2, spatial_s1=s1, channel_s=channel_s,
            flops_perc=sparse_flops / dense_flops, sparse_flops=sparse_flops,
            s3_img=s3_img, dense_flops=dense_flops, flops_img=flops_img)


class LAUDResNet(nn.Module):
    """The full dynamic ResNet; returns `LAUDOutput`. The per-stage
    configuration tuples have length 4. Blocks are attributes named
    ``layer{stage}_{block}``, as in the JAX parameter tree. Parameters are
    drawn from ``generator`` when given, else left to the caller
    (`convert.from_jax.load_flax_variables`)."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 width_mult: float = 1.0, input_size: int = 224,
                 group_width: int = 1,
                 spatial_mask_channel_group: Sequence[int] = (1, 1, 1, 1),
                 mask_spatial_granularity: Sequence[int] = (1, 1, 1, 1),
                 channel_dyn_granularity: Sequence[int] = (1, 1, 1, 1),
                 dyn_mode: Sequence[str] = ("both",) * 4,
                 channel_masker: Sequence[str] = ("MLP",) * 4,
                 channel_masker_layers: Sequence[int] = (1, 1, 1, 1),
                 reduction_ratio: Sequence[int] = (16, 16, 16, 16),
                 execution: str = "dense",
                 patch_capacity: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 conv_impl: str = "dense", in_chans: int = 3, device=None,
                 dtype=None, compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.layers, self.num_classes = tuple(layers), num_classes
        self.width_mult, self.input_size = width_mult, input_size
        self.dyn_mode = tuple(dyn_mode)
        self.execution, self.conv_impl = execution, conv_impl
        self.compute_dtype = compute_dtype
        stem_width = int(64 * width_mult)
        self.conv1 = make_conv(conv_impl, in_chans, stem_width, 7, 2, 3, **kw)
        self.bn1 = BatchNorm(stem_width, **kw)

        inplanes = stem_width
        stage_planes = [int(p * width_mult) for p in (64, 128, 256, 512)]
        stage_strides = [1, 2, 2, 2]
        stage_out_sizes = [input_size // 4, input_size // 8,
                           input_size // 16, input_size // 32]
        self.block_names = []
        for s in range(4):
            planes = stage_planes[s]
            names = []
            for b in range(self.layers[s]):
                stride = stage_strides[s] if b == 0 else 1
                has_ds = b == 0 and (stride != 1
                                     or inplanes != planes * EXPANSION)
                block = LAUDBottleneck(
                    inplanes, planes, stride=stride, has_downsample=has_ds,
                    group_width=group_width,
                    spatial_mask_channel_group=spatial_mask_channel_group[s],
                    channel_dyn_granularity=channel_dyn_granularity[s],
                    output_size=stage_out_sizes[s],
                    mask_spatial_granularity=mask_spatial_granularity[s],
                    dyn_mode=dyn_mode[s], channel_masker=channel_masker[s],
                    channel_masker_layers=channel_masker_layers[s],
                    reduction=reduction_ratio[s], execution=execution,
                    patch_capacity=patch_capacity[s], conv_impl=conv_impl,
                    compute_dtype=compute_dtype, **kw)
                name = f"layer{s + 1}_{b}"
                self.add_module(name, block)
                names.append(name)
                inplanes = planes * EXPANSION
            self.block_names.append(names)
        self.fc = nn.Linear(inplanes, num_classes, **kw)
        # tensor parallelism (`parallel/tp.py::shard_params`)
        self.tp = None
        self.tp_head = False
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """The JAX package's initialisers: He-normal (fan-out) convolutions,
        unit BatchNorms, the default uniform for the classifier and the
        gating heads, and the maskers' open biases."""
        init_resnet_weights(self, generator)

    def stages(self):
        """The blocks, stage by stage."""
        return [[getattr(self, n) for n in names]
                for names in self.block_names]

    def forward(self, x, temperature=None, *, training: bool = False,
                noise=None):
        """``x``: NHWC images. Training gates are Gumbel samples at
        ``temperature`` with noise from ``noise`` (`ops/gating.py`); at
        eval ``temperature`` is unused. The densities, ``flops_perc`` and
        ``flops`` carry the gate gradients."""
        if training and noise is None:
            raise ValueError("training=True needs a Gumbel noise source")
        if self.compute_dtype is None:
            with full_f32_convolutions():
                return self._forward(x, temperature, training, noise)
        return self._forward(x, temperature, training, noise)

    def _forward(self, x, temperature, training, noise):
        cd = self.compute_dtype
        c_in = x.shape[-1]
        x = conv_nhwc(self.conv1, x, cd,
                      quant=quantised(self.conv_impl, training),
                      fake=self.conv_impl == "int8_qat" and training)
        x = torch.relu(self.bn1(x, use_running_average=not training,
                                compute_dtype=cd))
        flops = torch.full(
            (), float(c_in * x.shape[-1] * x.shape[1] * x.shape[2] * 49),
            dtype=torch.float32, device=x.device)
        x = max_pool_nhwc(x)
        flops = flops + x.shape[-1] * x.shape[1] * x.shape[2] * 9

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
        if self.tp_head:  # class-sharded logits, gathered
            x = copy_to_model_parallel(x, self.tp)
        if cd is None:
            logits = fc(x)
        else:
            logits = F.linear(x.to(cd), fc.weight.to(cd), fc.bias.to(cd))
        if self.tp_head:
            logits = gather_from_model_parallel(logits, self.tp)
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


@torch.no_grad()
def init_resnet_weights(model: nn.Module,
                        generator: Optional[torch.Generator]) -> None:
    """Initialises a `LAUDResNet` or a dense `ResNet` in place."""
    maskers = (SpatialMasker, ChannelMaskerMLP, ChannelMaskerConvLinear)
    in_masker = set()
    for m in model.modules():
        if isinstance(m, maskers):
            m.init_weights(generator)
            in_masker.update(id(c) for c in m.modules())
    for m in model.modules():
        if id(m) in in_masker:
            continue
        if isinstance(m, nn.Conv2d):
            he_normal_fan_out_(m.weight, generator)
        elif isinstance(m, nn.Linear):
            default_weight_init_(m.weight, generator)
            default_bias_init_(m.bias, m.in_features, generator)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def uni_resnet50(**kwargs) -> LAUDResNet:
    """LAUD-ResNet-50."""
    return LAUDResNet(layers=(3, 4, 6, 3), **kwargs)


def uni_resnet101(**kwargs) -> LAUDResNet:
    """LAUD-ResNet-101."""
    return LAUDResNet(layers=(3, 4, 23, 3), **kwargs)
