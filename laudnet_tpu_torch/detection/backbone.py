"""LAUD-ResNet backbone for detectors (counterpart of
`laudnet_tpu/detection/backbone.py`).

``forward`` returns ``(features, additional, model_configs)``: the
requested stage outputs, the sparsities and sparse/dense FLOPs that feed
the detector's ``loss_sparse`` and the eval-with-info accounting, and the
``dyn_mode``/``sparsity_target`` the model was built with.

What detection changes against the classification network: the Gumbel
temperature is fixed (detectors never anneal), stages can be frozen, and
``norm_eval`` keeps every BatchNorm on its running statistics in training
while the Gumbel gates stay live. The blocks' output sizes, and with them
the spatial mask grids, follow each input's shape, as the JAX module
derives them from the traced shape: a rectangular input pools a masker
grid per dimension and the FLOPs use the true rectangular areas.

NHWC throughout, flax's parameter names (``conv1``, ``bn1``,
``layer{s}_{b}``), so `convert.from_jax.load_flax_variables` fills it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from laudnet_tpu_torch.device import full_f32_convolutions, resolve_device
from laudnet_tpu_torch.models.laud_resnet import (EXPANSION, LAUDBottleneck,
                                                  conv_nhwc,
                                                  init_resnet_weights,
                                                  max_pool_nhwc)
from laudnet_tpu_torch.models.resnet import Bottleneck
from laudnet_tpu_torch.ops.norm import BatchNorm

DYN_MODES = ("channel", "layer", "spatial", "static")


class LAUDDetBackbone(nn.Module):
    """LAUD-ResNet backbone with the detector contract. ``dyn_mode`` per
    stage in {'channel', 'layer', 'spatial', 'static'}; ``frozen_stages``
    freezes the stem and the stages up to it (no gradient, and a frozen
    stage runs its gates and BatchNorms as at eval); ``compute_dtype`` is
    the JAX module's ``dtype`` (bf16 towers, f32 gating heads and
    statistics)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 temperature: float = 0.1, sparsity_target: float = 0.5,
                 dyn_mode: Sequence[str] = ("channel",) * 4,
                 mask_spatial_granularity: Sequence[int] = (4, 4, 2, 1),
                 channel_dyn_granularity: Sequence[int] = (2, 2, 2, 2),
                 channel_masker: Sequence[str] = ("MLP",) * 4,
                 channel_masker_layers: Sequence[int] = (2, 2, 2, 2),
                 reduction_ratio: Sequence[int] = (16, 16, 16, 16),
                 device=None, dtype=None, compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for mode in dyn_mode:
            if mode not in DYN_MODES:
                raise ValueError(f"dyn_mode must be one of {DYN_MODES}, got "
                                 f"{mode!r}")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.layers, self.out_indices = tuple(layers), tuple(out_indices)
        self.frozen_stages, self.norm_eval = frozen_stages, norm_eval
        self.temperature, self.sparsity_target = temperature, sparsity_target
        self.dyn_mode = tuple(dyn_mode)
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, **kw)
        self.bn1 = BatchNorm(64, **kw)
        self.block_names = []
        inplanes = 64
        for s in range(4):
            planes = 64 * 2 ** s
            names = []
            for b in range(self.layers[s]):
                stride = (2 if s > 0 else 1) if b == 0 else 1
                has_ds = b == 0 and (stride != 1
                                     or inplanes != planes * EXPANSION)
                if self.dyn_mode[s] == "static":
                    block = Bottleneck(inplanes, planes, stride, has_ds,
                                       compute_dtype=compute_dtype, **kw)
                else:
                    block = LAUDBottleneck(
                        inplanes, planes, stride=stride,
                        has_downsample=has_ds, output_size=1,
                        mask_spatial_granularity=mask_spatial_granularity[s],
                        dyn_mode=self.dyn_mode[s],
                        channel_dyn_granularity=channel_dyn_granularity[s],
                        channel_masker=channel_masker[s],
                        channel_masker_layers=channel_masker_layers[s],
                        reduction=reduction_ratio[s], bn_eval=norm_eval,
                        compute_dtype=compute_dtype, **kw)
                name = f"layer{s + 1}_{b}"
                self.add_module(name, block)
                names.append(name)
                inplanes = planes * EXPANSION
            self.block_names.append(names)
        self.out_channels = [64 * 2 ** s * EXPANSION for s in self.out_indices]
        if generator is not None:
            self.init_weights(generator)

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """`models/laud_resnet.py`'s initialisers: He-normal (fan-out)
        convolutions, unit BatchNorms, the gating heads' own."""
        init_resnet_weights(self, generator)

    def forward(self, x, *, training: bool = False, noise=None):
        """``x``: NHWC images. Training gates draw Gumbel noise from
        ``noise`` at the fixed temperature. Returns ``(features,
        additional, model_configs)``."""
        if self.compute_dtype is None:
            with full_f32_convolutions():
                return self._forward(x, training, noise)
        return self._forward(x, training, noise)

    def _forward(self, x, training, noise):
        cd = self.compute_dtype
        bn_training = training and not self.norm_eval
        x = conv_nhwc(self.conv1, x, cd)
        x = torch.relu(self.bn1(x, use_running_average=not bn_training,
                                compute_dtype=cd))
        x = max_pool_nhwc(x)
        if self.frozen_stages >= 0:
            x = x.detach()

        dev = x.device
        f32 = lambda v: torch.full((), float(v), dtype=torch.float32,
                                   device=dev)
        outs = []
        sparse_flops = dense_flops = f32(0.0)
        flops_img = torch.zeros((x.shape[0],), dtype=torch.float32,
                                device=dev)
        channel_s, layer_s, flops_perc, s3_img_all = [], [], [], []
        for s, names in enumerate(self.block_names):
            stage_training = training and s + 1 > self.frozen_stages
            for b, name in enumerate(names):
                block = getattr(self, name)
                stride = (2 if s > 0 else 1) if b == 0 else 1
                out_size = (-(-x.shape[1] // stride), -(-x.shape[2] // stride))
                if self.dyn_mode[s] == "static":
                    x, blk_flops = self._static_block(
                        block, x, stage_training and bn_training)
                    # static blocks compute densely: count them in both sums
                    blk_flops = f32(blk_flops)
                    sparse_flops = sparse_flops + blk_flops
                    dense_flops = dense_flops + blk_flops
                    flops_img = flops_img + blk_flops
                else:
                    block.set_output_size(out_size)
                    x, st = block(x, self.temperature,
                                  training=stage_training, noise=noise)
                    channel_s.append(st.channel_s)
                    layer_s.append(st.spatial_s3)
                    flops_perc.append(st.flops_perc)
                    s3_img_all.append(st.s3_img)
                    sparse_flops = sparse_flops + st.sparse_flops
                    dense_flops = dense_flops + st.dense_flops
                    flops_img = flops_img + st.flops_img
                if s + 1 <= self.frozen_stages:
                    x = x.detach()
            if s in self.out_indices:
                outs.append(x)

        ones = lambda *shape: torch.ones(shape, dtype=torch.float32,
                                         device=dev)
        additional = {
            "flops": sparse_flops,
            "dense_flops": dense_flops,
            "flops_perc": torch.stack(flops_perc) if flops_perc else ones(1),
            "channel_sparsity": (torch.stack(channel_s) if channel_s
                                 else ones(1)),
            "layer_sparsity": torch.stack(layer_s) if layer_s else ones(1),
            # per-image accounting: (B,) sparse FLOPs per image and
            # (blocks, B) per-image conv3 spatial densities
            "flops_img": flops_img,
            "s3_img": (torch.stack(s3_img_all) if s3_img_all
                       else ones(1, x.shape[0])),
        }
        model_configs = {"dyn_mode": self.dyn_mode,
                         "sparsity_target": self.sparsity_target}
        return tuple(outs), additional, model_configs

    @staticmethod
    def _static_block(block, x, training):
        """A plain bottleneck; returns (out, dense multiply-adds) by the
        LAUD block's per-block formulas, rectangular-safe."""
        inplanes = x.shape[-1]
        in_hw = x.shape[1] * x.shape[2]
        out = block(x, training=training)
        out_hw = out.shape[1] * out.shape[2]
        planes = block.conv1.out_channels
        out_planes = planes * EXPANSION
        flops = (inplanes * planes * in_hw          # conv1 1x1
                 + planes * planes * 9 * out_hw     # conv2 3x3
                 + planes * out_planes * out_hw)    # conv3 1x1
        if block.downsample_conv is not None:
            flops += inplanes * out_planes * out_hw
        return out, flops
