"""Discrete gates (counterpart of `laudnet_tpu/ops/gating.py`).

Every gate produces a pair of logits per decision. Training samples a hard
straight-through Gumbel-softmax over the pair; evaluation takes the
deterministic comparison ``logits_on >= logits_off``: ties resolve to *on*.

Gumbel noise never comes from the global RNG: a gate asks a noise source
for it. `GumbelNoise` wraps a ``torch.Generator``; anything with the same
``gumbel(shape, dtype, device)`` method may stand in (the tests replay
recorded noise).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class GumbelNoise:
    """Gumbel(0, 1) noise from an explicit ``torch.Generator``, drawn on the
    generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device=None) -> "GumbelNoise":
        gen = torch.Generator(device if device is not None else "cpu")
        return cls(gen.manual_seed(seed))

    def reseed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    def gumbel(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, dtype=dtype,
                       device=self.generator.device)
        # u in [0, 1): keep both logs finite
        tiny = torch.finfo(dtype).tiny
        e = (-torch.log(u.clamp_min(tiny))).clamp_min(tiny)  # Exp(1) > 0
        g = -torch.log(e)
        return g if device is None else g.to(device)


class ReplayNoise:
    """A noise source that hands back recorded arrays in order, checking
    each shape: both frameworks then gate on the same noise."""

    def __init__(self, arrays):
        self.arrays = list(arrays)
        self.used = 0

    def gumbel(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        g = torch.tensor(self.arrays[self.used])
        self.used += 1
        if tuple(g.shape) != tuple(shape):
            raise ValueError(f"recorded noise {self.used - 1} has shape "
                             f"{tuple(g.shape)}, asked for {tuple(shape)}")
        return g.to(device=device, dtype=dtype)


def gumbel_softmax(noise, logits: torch.Tensor, tau, dim: int = -1,
                   hard: bool = True) -> torch.Tensor:
    """Gumbel-softmax with optional straight-through hard sampling:
    Gumbel(0, 1) noise (from ``noise``, in the logits' dtype) is added to
    the logits and softmax is taken over ``dim`` at temperature ``tau``.
    With ``hard`` the forward value is the one-hot argmax and the gradient
    is the soft sample's."""
    gumbels = noise.gumbel(logits.shape, logits.dtype, logits.device)
    y_soft = torch.softmax((logits + gumbels) / tau, dim=dim)
    if not hard:
        return y_soft
    index = y_soft.argmax(dim=dim)
    y_hard = F.one_hot(index, logits.shape[dim]).to(logits.dtype)
    y_hard = y_hard.movedim(-1, dim if dim >= 0 else logits.dim() + dim)
    # straight-through: forward = y_hard, backward = d(y_soft)
    return y_hard + y_soft - y_soft.detach()


def binary_gate(logits_pair: torch.Tensor, temperature=None, *,
                training: bool = False, noise=None) -> torch.Tensor:
    """Turns paired (on, off) logits of shape ``(..., 2, G)`` into a 0/1
    mask of shape ``(..., G)`` in the logits' dtype. Training: hard
    straight-through Gumbel-softmax over the pair axis, keeping index 0;
    eval: ``on >= off``."""
    if training:
        if noise is None:
            raise ValueError("binary_gate requires a noise source in "
                             "training mode")
        y = gumbel_softmax(noise, logits_pair, temperature, dim=-2,
                           hard=True)
        return y[..., 0, :]
    on = logits_pair[..., 0, :]
    off = logits_pair[..., 1, :]
    return (on >= off).to(logits_pair.dtype)
