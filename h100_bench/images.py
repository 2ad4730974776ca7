"""The images of a traffic mix, made on the run's device from a seed.

A mix's ``image`` parameters: ``noise``, the scale of the white noise on
every pixel (1 by default). NHWC float32, as the port's entries take them.
"""

from __future__ import annotations

import torch


def make(spec: dict, size: int, n: int, generator, device) -> torch.Tensor:
    x = torch.randn(n, size, size, 3, generator=generator, device=device)
    return x.mul_(spec.get("noise", 1.0))
