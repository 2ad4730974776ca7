"""Where the port's constructors build.

The port runs on the card: every constructor that takes ``device`` reads
``None`` as CUDA, not as PyTorch's CPU default. On a machine without a card
that makes PyTorch raise its own error; nothing here catches it. The CPU
parity tests pass ``device="cpu"``.

`full_f32_convolutions` is the f32 precision of the CNN models on a card:
PyTorch runs an f32 matrix product in full f32 by default but hands an f32
convolution to cuDNN in TF32 (about three decimal digits). The models'
gates are hard compares of near-tied f32 logits, so an f32 model switches
TF32 off while it runs; a bf16 (``compute_dtype``) model is not touched.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as given."""
    return torch.device("cuda" if device is None else device)


@contextlib.contextmanager
def full_f32_convolutions():
    """Within the block cuDNN computes f32 convolutions, forward and
    backward, in full f32 (``torch.backends.cudnn.allow_tf32 = False``);
    the previous setting comes back on exit."""
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous
