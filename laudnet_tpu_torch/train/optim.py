"""Optimizer factory with backbone and masker parameter groups
(counterpart of `laudnet_tpu/train/optim.py`).

`make_sgd` and `make_rmsprop` return ``torch.optim`` optimizers over two
groups, ``backbone`` and ``masker`` (any parameter whose name contains
``_policy`` or ``masker``), each with a learning-rate multiplier; where
weight decay is masked a group splits into a decayed and an undecayed part.
Weight decay is folded into the gradient before the momentum, which is
PyTorch's own semantics (Nesterov included: ``g + m * (m * buf + g)``).
Parameters with ``requires_grad=False`` (the T2T performers' fixed feature
matrix ``w``) never enter the optimizer, so are never decayed.
`set_learning_rate` sets the step's rate on every group as ``lr * mult``.
"""

from __future__ import annotations

import torch
from torch import nn


def is_masker_path(name: str) -> bool:
    """True if a parameter name belongs to a gating head: CNN maskers or
    the ViT policy heads (token, head, layer)."""
    return "masker" in name or "_policy" in name


def is_frozen_path(name: str) -> bool:
    """True for the fixed leaves, the T2T performers' random feature
    matrices (``t2t_stem.attn{1,2}.w``): the leaf name alone is too loose,
    so the T2T stem scope is required."""
    parts = name.split(".")
    return parts[-1] == "w" and any("t2t" in p.lower() for p in parts[:-1])


def _decays_weights_only(name: str, param) -> bool:
    """Decay only leaves named ``weight`` with rank > 1: biases, norm
    scales and 1-D parameters are exempt."""
    return "weight" in name.rsplit(".", 1)[-1] and param.dim() > 1


def _groups(model: nn.Module, weight_decay, backbone_lr_mult, masker_lr_mult,
            decay_weights_only=False):
    buckets = {}
    for name, param in model.named_parameters():
        if not param.requires_grad or is_frozen_path(name):
            continue
        masker = is_masker_path(name)
        decayed = not decay_weights_only or _decays_weights_only(name, param)
        buckets.setdefault((masker, decayed), []).append(param)
    return [dict(params=params,
                 name=("masker" if masker else "backbone")
                 + ("" if decayed else "_no_decay"),
                 lr_mult=masker_lr_mult if masker else backbone_lr_mult,
                 weight_decay=weight_decay if decayed else 0.0)
            for (masker, decayed), params in sorted(buckets.items())]


def _foreach(model: nn.Module):
    """None (PyTorch's choice), or False for a model whose parameters mix
    FSDP's sharded DTensors with plain tensors (`parallel/fsdp.py` leaves
    the small ones plain): the multi-tensor kernels refuse such a mix on
    the torch 2.11 of the H100 machine. Both compute the same update."""
    from torch.distributed.tensor import DTensor

    kinds = {isinstance(p, DTensor) for p in model.parameters()}
    return False if len(kinds) > 1 else None


def make_sgd(model: nn.Module, *, momentum=0.9, nesterov=True,
             weight_decay=5e-5, backbone_lr_mult=1.0, masker_lr_mult=1.0,
             decay_weights_only=False) -> torch.optim.SGD:
    """SGD with Nesterov momentum and weight decay folded into the
    gradient, over the backbone and masker groups. ``decay_weights_only``
    exempts biases and norm parameters from the decay. The learning rate
    starts at 0: set it every step with `set_learning_rate`."""
    return torch.optim.SGD(
        _groups(model, weight_decay, backbone_lr_mult, masker_lr_mult,
                decay_weights_only),
        lr=0.0, momentum=momentum, nesterov=nesterov,
        foreach=_foreach(model))


def make_rmsprop(model: nn.Module, *, alpha=0.9, momentum=0.9,
                 weight_decay=5e-5, eps=1e-8, backbone_lr_mult=1.0,
                 masker_lr_mult=1.0) -> torch.optim.RMSprop:
    """RMSprop with ``alpha`` smoothing of the raw second moment, eps
    OUTSIDE the square root (``sqrt(nu) + eps``: at the tiny gradients of
    fresh masker heads the other placement changes the step size more than
    tenfold), heavy-ball momentum applied after the rescale, and weight
    decay folded into the gradient."""
    return torch.optim.RMSprop(
        _groups(model, weight_decay, backbone_lr_mult, masker_lr_mult),
        lr=0.0, alpha=alpha, eps=eps, momentum=momentum, centered=False,
        foreach=_foreach(model))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The step's learning rate: ``lr * lr_mult`` on every group."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
