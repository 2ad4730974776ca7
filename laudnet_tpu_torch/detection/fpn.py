"""Feature Pyramid Network, the RetinaNet P3-P7 variant (counterpart of
`laudnet_tpu/detection/fpn.py`), and `Conv`, the NHWC convolution with
flax's precision rules that every detection head is built from."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.device import resolve_device


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's default kernel initialiser: a normal of variance 1/fan_in
    truncated at two standard deviations (the stddev corrected for the
    truncation, as ``variance_scaling`` does)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on NHWC tensors. With ``compute_dtype`` the input,
    kernel and bias are cast to it and the bias is added after the
    convolution's result is rounded, as flax does; without it they are
    promoted to a common type (a head's f32 predictor thus takes a bf16
    tower's output in f32)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, compute_dtype=None,
                 device=None, dtype=None):
        super().__init__(cin, cout, kernel, stride, padding, bias=bias,
                         device=resolve_device(device), dtype=dtype)
        self.compute_dtype = compute_dtype

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """flax's defaults: LeCun-normal kernel, zero bias."""
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), self.weight.to(cd), None,
                     self.stride, self.padding).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(cd)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Each NHWC pixel repeated 2 x 2 (``jnp.repeat`` on both axes)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


class FPN(nn.Module):
    """Lateral 1x1, top-down 2x upsample cropped to the finer level, 3x3
    smoothing; ``num_extra_levels`` stride-2 3x3 convolutions on the last
    backbone feature (the second and later after a ReLU)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_extra_levels: int = 2, device=None, dtype=None,
                 compute_dtype=None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, device=device, dtype=dtype)
        self.num_levels = len(in_channels)
        self.num_extra_levels = num_extra_levels
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", Conv(c, out_channels, 1, **kw))
        for i in range(self.num_levels):
            self.add_module(f"smooth_{i}", Conv(out_channels, out_channels,
                                                3, padding=1, **kw))
        for j in range(num_extra_levels):
            cin = in_channels[-1] if j == 0 else out_channels
            self.add_module(f"extra_{j}", Conv(cin, out_channels, 3, 2, 1,
                                               **kw))

    def forward(self, features):
        n = len(features)
        laterals = [getattr(self, f"lateral_{i}")(f)
                    for i, f in enumerate(features)]
        for i in range(n - 1, 0, -1):
            h, w = laterals[i - 1].shape[1:3]
            laterals[i - 1] = laterals[i - 1] + upsample2(laterals[i])[
                :, :h, :w]
        outs = [getattr(self, f"smooth_{i}")(l)
                for i, l in enumerate(laterals)]
        extra = features[-1]
        for j in range(self.num_extra_levels):
            extra = getattr(self, f"extra_{j}")(
                extra if j == 0 else torch.relu(extra))
            outs.append(extra)
        return tuple(outs)
