"""Detection losses: the LAUD sparsity injection and the focal and box
losses (counterpart of `laudnet_tpu/detection/losses.py`).

``loss_sparse`` is the term the reference patches into every detector:
``(flops / dense_flops - sparsity_target) ** 2``, logged with the realised
``flops_rate``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def loss_sparse(additional, sparsity_target: float):
    """Returns (loss, flops_rate) from a backbone's ``additional`` stats."""
    rate = additional["flops"] / torch.clamp_min(additional["dense_flops"],
                                                 1e-9)
    return (rate - sparsity_target) ** 2, rate


def focal_loss(logits, targets_onehot, alpha: float = 0.25,
               gamma: float = 2.0):
    """Sigmoid focal loss per anchor and class; the targets are one-hot
    with background rows all zero."""
    p = torch.sigmoid(logits)
    t = targets_onehot
    ce = -(t * F.logsigmoid(logits) + (1 - t) * F.logsigmoid(-logits))
    p_t = t * p + (1 - t) * (1 - p)
    a_t = t * alpha + (1 - t) * (1 - alpha)
    return a_t * (1 - p_t) ** gamma * ce


def smooth_l1(pred, target, beta: float = 1.0 / 9.0):
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
