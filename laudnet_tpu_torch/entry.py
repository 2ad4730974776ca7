"""The flagship and its eval forward (counterpart of
`__graft_entry__.py::entry`): LAUD-ResNet-50 with spatial gating at
granularity 4-4-2-1.

    from laudnet_tpu_torch.entry import entry
    forward, args = entry()          # on the card; entry("cpu") for the CPU
    logits = forward(*args)          # (8, 1000)
"""

from __future__ import annotations

import numpy as np
import torch

from laudnet_tpu_torch.device import resolve_device


def flagship(device=None, seed=0, **kwargs):
    """LAUD-ResNet-50, ``dyn_mode=('spatial',) * 4``, mask granularity
    (4, 4, 2, 1), with weights drawn from ``seed`` (None: left as
    allocated, for a caller that loads them). ``kwargs`` go to the
    constructor (``compute_dtype``, ``execution``, ``conv_impl``, ...)."""
    from laudnet_tpu_torch.models import uni_resnet50

    device = resolve_device(device)
    return uni_resnet50(
        dyn_mode=("spatial",) * 4,
        mask_spatial_granularity=(4, 4, 2, 1),
        channel_masker=("MLP",) * 4,
        channel_masker_layers=(1, 1, 1, 1),
        device=device,
        generator=(None if seed is None
                   else torch.Generator(device).manual_seed(seed)),
        **kwargs)


def entry(device=None):
    """Returns ``(forward, (model, x, temperature))``: the eval forward of
    the flagship and its arguments, a batch of 8 random 224 x 224 images
    from seed 0. ``forward(model, x, temperature)`` returns the logits."""
    device = resolve_device(device)
    model = flagship(device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)).to(device)

    @torch.no_grad()
    def forward(model, x, temperature):
        return model(x, temperature, training=False).logits

    return forward, (model, x, 0.1)
