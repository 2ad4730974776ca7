"""Mixup augmentation (counterpart of `laudnet_tpu/utils/mixup.py`,
reference `utils/utils.py:227-246`)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mix(x, y, lam, perm, num_classes: int = 1000):
    """``lam * x + (1 - lam) * x[perm]`` and the soft targets mixed alike."""
    mixed = lam * x + (1 - lam) * x[perm]
    y1 = F.one_hot(y.long(), num_classes).to(mixed.dtype)
    y2 = F.one_hot(y[perm].long(), num_classes).to(mixed.dtype)
    return mixed, lam * y1 + (1 - lam) * y2


def mixup_data(generator: torch.Generator, x, y, alpha: float = 1.0,
               num_classes: int = 1000):
    """Returns mixed inputs and soft targets: lam*x + (1-lam)*x[perm], with
    lam ~ Beta(alpha, alpha) (1.0 when alpha is 0) and the permutation
    drawn from ``generator`` (a CPU generator: the Beta draw is numpy's,
    seeded from it)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    lam = (float(np.random.default_rng(seed).beta(alpha, alpha))
           if alpha > 0 else 1.0)
    perm = torch.randperm(x.shape[0], generator=generator).to(x.device)
    return mix(x, y, lam, perm, num_classes)


def mixup_criterion(logits, soft_targets):
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(soft_targets * logp, dim=-1))
