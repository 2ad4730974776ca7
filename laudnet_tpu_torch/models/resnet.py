"""Static ResNet teachers, NHWC (counterpart of
`laudnet_tpu/models/resnet.py`): the dense networks the LAUD-ResNets
distil from and are measured against. Module names mirror
`models/laud_resnet.py`, so one converter serves both. ``compute_dtype``
and the f32 precision on a card are as described there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.device import full_f32_convolutions, resolve_device
from laudnet_tpu_torch.models.laud_resnet import (EXPANSION, conv_nhwc,
                                                  init_resnet_weights,
                                                  max_pool_nhwc)
from laudnet_tpu_torch.ops import masking
from laudnet_tpu_torch.ops.norm import BatchNorm


def _conv(cin, cout, kernel, stride=1, padding=0, dilation=1, groups=1,
          **kw):
    return nn.Conv2d(cin, cout, kernel, stride, padding, dilation, groups,
                     bias=False, **kw)


class _Block(nn.Module):
    """What the two block kinds share: the shortcut and the BN call."""

    def _shortcut(self, inplanes, out_planes, stride, has_downsample, kw):
        self.downsample_conv = self.downsample_bn = None
        if has_downsample:
            self.downsample_conv = _conv(inplanes, out_planes, 1, stride,
                                         **kw)
            self.downsample_bn = BatchNorm(out_planes, **kw)

    def _bn(self, m, x, training):
        return m(x, use_running_average=not training,
                 compute_dtype=self.compute_dtype)

    def _identity(self, x, training):
        if self.downsample_conv is None:
            return x
        return self._bn(self.downsample_bn,
                        conv_nhwc(self.downsample_conv, x,
                                  self.compute_dtype), training)


class Bottleneck(_Block):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, group_width: int = 1,
                 dilation: int = 1, device=None, dtype=None,
                 compute_dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.compute_dtype = compute_dtype
        width, out_planes = planes * group_width, planes * EXPANSION
        self.conv1 = _conv(inplanes, width, 1, **kw)
        self.bn1 = BatchNorm(width, **kw)
        self.conv2 = _conv(width, width, 3, stride, dilation, dilation,
                           group_width, **kw)
        self.bn2 = BatchNorm(width, **kw)
        self.conv3 = _conv(width, out_planes, 1, **kw)
        self.bn3 = BatchNorm(out_planes, **kw)
        self._shortcut(inplanes, out_planes, stride, has_downsample, kw)

    def forward(self, x, *, training: bool = False):
        cd = self.compute_dtype
        out = torch.relu(self._bn(self.bn1, conv_nhwc(self.conv1, x, cd),
                                  training))
        out = torch.relu(self._bn(self.bn2, conv_nhwc(self.conv2, out, cd),
                                  training))
        out = self._bn(self.bn3, conv_nhwc(self.conv3, out, cd), training)
        return torch.relu(out + self._identity(x, training))


class BasicBlock(_Block):
    """Two-conv residual block (ResNet-18/34)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, device=None, dtype=None,
                 compute_dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.compute_dtype = compute_dtype
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, **kw)
        self.bn1 = BatchNorm(planes, **kw)
        self.conv2 = _conv(planes, planes, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(planes, **kw)
        self._shortcut(inplanes, planes, stride, has_downsample, kw)

    def forward(self, x, *, training: bool = False):
        cd = self.compute_dtype
        out = torch.relu(self._bn(self.bn1, conv_nhwc(self.conv1, x, cd),
                                  training))
        out = self._bn(self.bn2, conv_nhwc(self.conv2, out, cd), training)
        return torch.relu(out + self._identity(x, training))


class ResNet(nn.Module):
    """Dense ResNet; ``forward`` takes NHWC images and returns logits.
    ``block``: 'bottleneck' or 'basic'."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 width_mult: float = 1.0, group_width: int = 1,
                 block: str = "bottleneck", in_chans: int = 3, device=None,
                 dtype=None, compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if block not in ("bottleneck", "basic"):
            raise ValueError(f"block must be 'bottleneck' or 'basic', got "
                             f"{block!r}")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.layers, self.num_classes = tuple(layers), num_classes
        self.compute_dtype = compute_dtype
        stem_width = int(64 * width_mult)
        self.conv1 = _conv(in_chans, stem_width, 7, 2, 3, **kw)
        self.bn1 = BatchNorm(stem_width, **kw)
        inplanes = stem_width
        expansion = EXPANSION if block == "bottleneck" else 1
        self.block_names = []
        for s, base in enumerate((64, 128, 256, 512)):
            planes = int(base * width_mult)
            for b in range(self.layers[s]):
                stride = (1, 2, 2, 2)[s] if b == 0 else 1
                has_ds = b == 0 and (stride != 1
                                     or inplanes != planes * expansion)
                if block == "bottleneck":
                    m = Bottleneck(inplanes, planes, stride, has_ds,
                                   group_width, compute_dtype=compute_dtype,
                                   **kw)
                else:
                    m = BasicBlock(inplanes, planes, stride, has_ds,
                                   compute_dtype=compute_dtype, **kw)
                name = f"layer{s + 1}_{b}"
                self.add_module(name, m)
                self.block_names.append(name)
                inplanes = planes * expansion
        self.fc = nn.Linear(inplanes, num_classes, **kw)
        if generator is not None:
            init_resnet_weights(self, generator)

    def forward(self, x, *, training: bool = False):
        if self.compute_dtype is None:
            with full_f32_convolutions():
                return self._forward(x, training)
        return self._forward(x, training)

    def _forward(self, x, training):
        cd = self.compute_dtype
        x = conv_nhwc(self.conv1, x, cd)
        x = torch.relu(self.bn1(x, use_running_average=not training,
                                compute_dtype=cd))
        x = max_pool_nhwc(x)
        for name in self.block_names:
            x = getattr(self, name)(x, training=training)
        x = masking.global_avg_pool(x)
        fc = self.fc
        if cd is None:
            return fc(x)
        return F.linear(x.to(cd), fc.weight.to(cd), fc.bias.to(cd))


def resnet18(**kwargs) -> ResNet:
    return ResNet(layers=(2, 2, 2, 2), block="basic", **kwargs)


def resnet34(**kwargs) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), block="basic", **kwargs)


def resnet50(**kwargs) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), **kwargs)


def resnet101(**kwargs) -> ResNet:
    return ResNet(layers=(3, 4, 23, 3), **kwargs)


def resnet152(**kwargs) -> ResNet:
    return ResNet(layers=(3, 8, 36, 3), **kwargs)


def resnet_dense_flops(layers: Sequence[int], input_size: int = 224,
                       width_mult: float = 1.0,
                       num_classes: int = 1000) -> float:
    """Dense multiply-adds by the LAUD-ResNet's own bookkeeping (what
    `models/laud_resnet.py` accumulates with every density at 1, the gating
    heads left out)."""
    stem_w = int(64 * width_mult)
    h = input_size // 2
    flops = 3 * stem_w * h * h * 49
    h = input_size // 4
    flops += stem_w * h * h * 9  # the max-pool, as the bookkeeping counts it
    inplanes = stem_w
    sizes = [input_size // 4, input_size // 8, input_size // 16,
             input_size // 32]
    for s, planes in enumerate(int(p * width_mult)
                               for p in (64, 128, 256, 512)):
        hw = sizes[s] * sizes[s]
        for b in range(layers[s]):
            width = planes
            stride = (2 if s > 0 else 1) if b == 0 else 1
            # conv1 is 1x1 at the block's INPUT resolution
            flops += inplanes * width * hw * stride * stride
            flops += width * width * 9 * hw
            flops += width * planes * EXPANSION * hw
            if b == 0 and (s > 0 or inplanes != planes * EXPANSION):
                flops += inplanes * planes * EXPANSION * hw
            inplanes = planes * EXPANSION
    flops += inplanes  # the global average pool counts C
    flops += inplanes * num_classes
    return float(flops)
