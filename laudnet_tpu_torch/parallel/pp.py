"""Pipeline parallelism: a GPipe schedule over a mesh's 'stage' dim
(counterpart of `laudnet_tpu/parallel/pp.py`).

Consecutive layer groups (stages) live on consecutive ranks of the 'stage'
dim; microbatches stream through them. JAX writes the schedule as one SPMD
program of ``M + S - 1`` ticks rotating the buffers with ``ppermute`` and
differentiates through it. The port runs the same fill-and-drain order
with point-to-point ``send``/``recv``, one process per stage: stage 0
injects microbatch ``m`` while stage 1 works on ``m - 1``, and so on, for
``M + S - 1`` ticks in all. Every stage keeps the autograd graph of each
microbatch it ran.

The loss is not separable by microbatch (the LAUD-ViT sparsity loss reads
densities averaged over the whole batch, `parallel/pp_train.py`), so the
schedule takes no loss per microbatch, as ``torch.distributed.pipelining``'s
schedules do: the last stage's outputs reach every rank of the stage group
whole, the caller takes its loss on the whole batch, and the backward
(`_Pipeline.backward`) sends each microbatch's output gradient back stage
by stage, running ``torch.autograd.backward`` on each stage's stored
outputs in reverse microbatch order. The input's gradient reaches every
rank of the group, so parameters used before the pipeline (a stem,
replicated over the stages) get the same gradient on each.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn


def stack_layer_params(params, prefix: str = "block_"):
    """The per-layer modules in layer order and their count: ``params`` is
    a ``ModuleList`` (or list) of layers, a model with one (``.blocks``),
    or a dict whose keys are ``{prefix}{i}``. JAX stacks its layers' trees
    on a new leading dim; the port's layers are modules, kept as a list."""
    if isinstance(params, dict):
        names = sorted((k for k in params if k.startswith(prefix)),
                       key=lambda k: int(k[len(prefix):]))
        layers = [params[n] for n in names]
    elif isinstance(params, (nn.ModuleList, list, tuple)):
        layers = list(params)
    else:
        layers = list(getattr(params, "blocks", []))
    if not layers:
        raise ValueError(f"no '{prefix}*' subtrees in params")
    return layers, len(layers)


def _flatten(x):
    if isinstance(x, dict):
        keys = sorted(x)
        return keys, [x[k] for k in keys]
    return None, [x]


def _unflatten(keys, leaves):
    return leaves[0] if keys is None else dict(zip(keys, leaves))


class _Schedule:
    """One pipelined call: the stage's place in its group, the microbatch
    graphs its forward kept, and the two passes."""

    def __init__(self, fn, params, keys, mesh, axis, microbatches):
        self.fn, self.params, self.keys = fn, params, keys
        self.group = mesh.get_group(axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.stage = mesh.get_local_rank(axis)
        self.n_stages = len(self.ranks)
        self.m = microbatches
        self.inputs, self.outputs = [], []

    def _peer(self, offset):
        return self.ranks[self.stage + offset]

    def forward(self, leaves, grad: bool):
        self.meta = [(t.shape, t.dtype, t.device) for t in leaves]
        batch = leaves[0].shape[0]
        mb = batch // self.m
        first, last = self.stage == 0, self.stage == self.n_stages - 1
        done = []
        for m in range(self.m):
            if first:
                buf = [t[m * mb:(m + 1) * mb] for t in leaves]
                if grad:
                    buf = [b.detach().requires_grad_(b.is_floating_point())
                           for b in buf]
            else:
                buf = [torch.empty((mb,) + t.shape[1:], dtype=t.dtype,
                                   device=t.device) for t in leaves]
                for b in buf:
                    dist.recv(b, src=self._peer(-1), group=self.group)
                if grad:
                    buf = [b.requires_grad_(b.is_floating_point())
                           for b in buf]
            with torch.set_grad_enabled(grad):
                _, out = _flatten(self.fn(self.params,
                                          _unflatten(self.keys, buf)))
            if grad:
                self.inputs.append(buf)
                self.outputs.append(out)
            if last:
                done.append([o.detach() for o in out])
            else:
                for o in out:
                    dist.send(o.detach().contiguous(), dst=self._peer(1),
                              group=self.group)
        # the last stage's outputs, whole, on every rank of the group
        result = []
        for i, t in enumerate(leaves):
            full = (torch.cat([d[i] for d in done]) if last
                    else torch.empty_like(t))
            dist.broadcast(full, src=self.ranks[-1], group=self.group)
            result.append(full)
        return result

    def backward(self, grads):
        first, last = self.stage == 0, self.stage == self.n_stages - 1
        floats = [i for i, t in enumerate(self.inputs[0])
                  if t.is_floating_point()]
        in_grads = [None] * self.m
        for m in reversed(range(self.m)):
            outs, bufs = self.outputs[m], self.inputs[m]
            mb = bufs[0].shape[0]
            if last:
                g_out = {i: (grads[i][m * mb:(m + 1) * mb]
                             if grads[i] is not None
                             else torch.zeros_like(outs[i]))
                         for i in floats}
            else:
                g_out = {}
                for i in floats:
                    g_out[i] = torch.empty_like(outs[i])
                    dist.recv(g_out[i], src=self._peer(1), group=self.group)
            pairs = [(outs[i], g_out[i]) for i in floats
                     if outs[i].requires_grad]
            if pairs:
                torch.autograd.backward([p[0] for p in pairs],
                                        [p[1] for p in pairs])
            g_in = {i: (bufs[i].grad if bufs[i].grad is not None
                        else torch.zeros_like(bufs[i])) for i in floats}
            if first:
                in_grads[m] = g_in
            else:
                for i in floats:
                    dist.send(g_in[i].contiguous(), dst=self._peer(-1),
                              group=self.group)
        self.inputs, self.outputs = [], []
        # the input's gradient, whole, on every rank of the group
        result = [None] * len(grads)
        for i in floats:
            shape, dtype, device = self.meta[i]
            full = (torch.cat([g[i] for g in in_grads]) if first
                    else torch.empty(shape, dtype=dtype, device=device))
            dist.broadcast(full, src=self.ranks[0], group=self.group)
            result[i] = full
        return result


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule, *leaves):
        ctx.schedule = schedule
        out = schedule.forward(leaves, grad=True)
        ctx.mark_non_differentiable(*[o for o in out
                                      if not o.is_floating_point()])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.schedule.backward(list(grads)))


def pipeline_apply(fn: Callable[[Any, Any], Any], stage_params: Any, x: Any,
                   *, mesh, axis: str = "stage", microbatches: int,
                   batch_axis: str | None = None) -> Any:
    """Runs ``x`` through the ``S = mesh.size(axis)`` stages of this rank's
    stage group, GPipe order (module docstring).

    ``stage_params``: THIS rank's stage's parameters (stage i's layers on
    rank i of the group), handed to ``fn`` as they are.
    ``fn(stage_params, x_mb) -> y_mb`` applies one stage to one
    microbatch; input and output are tensors, or dicts of tensors, of the
    same structure and shapes (the buffer that travels between stages).
    ``x``: this rank's batch (a tensor or a dict of them), every leaf's
    leading dim divisible into ``microbatches``; stage 0 reads it.
    ``batch_axis``: the mesh dim carrying data parallelism, as JAX's: each
    data index runs its own stage group on its own batch.

    Returns the last stage's outputs for the whole batch on every rank of
    the group. Under autograd they are differentiable: the backward runs
    the stages in reverse (gradients reach ``stage_params`` on their own
    rank, and ``x`` on every rank)."""
    keys, leaves = _flatten(x)
    batch = leaves[0].shape[0]
    if batch % microbatches:
        raise ValueError(f"batch {batch} not divisible into "
                         f"{microbatches} microbatches")
    schedule = _Schedule(fn, stage_params, keys, mesh, axis, microbatches)
    if torch.is_grad_enabled():
        out = _Pipeline.apply(schedule, *leaves)
    else:
        out = schedule.forward(leaves, grad=False)
    return _unflatten(keys, list(out))
