"""Batch statistics over the global batch of a data-parallel step.

The JAX package trains data-parallel as one program over a batch sharded on
the mesh's 'data' axis, so every batch mean in it is a mean over the GLOBAL
batch: BatchNorm's statistics (SyncBatchNorm semantics) and the gate
densities that the FLOPs bookkeeping and the sparsity loss read (the loss is
quadratic in the token density, so it is not separable over ranks). The
port runs one process per rank, each on its slice of the batch; inside
``global_batch(group)`` the models' batch means are averaged over
``group`` through a differentiable all-reduce, so that a step computes the
global loss and, once the gradients are averaged over the group, its
gradients. Outside it (and for a group of one rank) they are the local
means, unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_group",
                                                        default=None)


@contextlib.contextmanager
def global_batch(group):
    """Within the block the batch means of `global_mean` are taken over the
    ranks of ``group`` (a process group; None: the local batch alone)."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def global_mean(local_mean: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch of a tensor of local batch means
    (every rank holds an equal share of the batch). Differentiable: the
    all-reduce's backward sums the gradients over the group, which the
    gradient average after the step turns into the global loss's."""
    group = _GROUP.get()
    if group is None:
        return local_mean
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    n = dist.get_world_size(group)
    if n == 1:
        return local_mean
    return all_reduce(local_mean, op=dist.ReduceOp.SUM, group=group) / n
