"""Where the port's constructors build.

The port runs on the card: every constructor that takes ``device`` reads
``None`` as CUDA, not as PyTorch's CPU default. On a machine without a card
that makes PyTorch raise its own error; nothing here catches it. The CPU
parity tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as given."""
    return torch.device("cuda" if device is None else device)
