"""Discrete gates (counterpart of `laudnet_tpu/ops/gating.py`).

Every gate produces a pair of logits per decision. Evaluation takes the
deterministic comparison ``logits_on >= logits_off``: ties resolve to *on*.
The straight-through Gumbel-softmax used in training is not ported yet.
"""

from __future__ import annotations

import torch


def binary_gate(logits_pair: torch.Tensor, temperature=None, *,
                training: bool = False) -> torch.Tensor:
    """Turns paired (on, off) logits of shape ``(..., 2, G)`` into a 0/1
    mask of shape ``(..., G)`` in the logits' dtype: ``on >= off``."""
    if training:
        raise NotImplementedError(
            "Gumbel-softmax training gates belong to the training slice of "
            "the port")
    on = logits_pair[..., 0, :]
    off = logits_pair[..., 1, :]
    return (on >= off).to(logits_pair.dtype)
