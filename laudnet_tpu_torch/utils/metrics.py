"""Metrics helpers (counterpart of `laudnet_tpu/utils/metrics.py`)."""

from __future__ import annotations

import torch


class AverageMeter:
    """Running average (host-side)."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0
        self.avg = 0.0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return (f"{self.name} {self.val:{self.fmt[1:]}} "
                f"({self.avg:{self.fmt[1:]}})")


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1,),
                  weights=None):
    """Top-k accuracy in percent, as f32 tensors on the logits' device.

    When k exceeds the class count (smoke runs with few classes) the entry
    degrades to top-C accuracy (trivially 100%) rather than erroring.
    ``weights``: optional per-example weights (e.g. a 0/1 valid mask for a
    wrap-padded final eval batch): weighted mean instead of mean."""
    maxk = min(max(topk), logits.shape[-1])
    pred = logits.topk(maxk, dim=-1).indices
    correct = pred == labels[:, None]

    def agg(hit):
        if weights is None:
            return hit.mean()
        return (hit * weights).sum() / weights.sum().clamp_min(1.0)

    return tuple(100.0 * agg(correct[:, :min(k, maxk)].any(dim=1).float())
                 for k in topk)
