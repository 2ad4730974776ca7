"""A training run's layout over its ranks: gradients, metrics and
checkpoints across data, tensor, FSDP and pipeline parallelism.

JAX's single program averages gradients and metrics implicitly and saves
the sharded state through orbax. The port does it here, explicitly:

* `Layout.sync_gradients` averages every plain gradient over the 'data'
  group after the backward (FSDP's sharded parameters are averaged by
  FSDP's own reduce-scatter); the gradients of replicated parameters are
  equal on the ranks of a tensor- or pipeline-parallel group already;
* `Layout.mean_metrics` averages the logged metrics over the 'data' group;
* `Layout.full_state` gathers the model's and the optimizer's state into the
  single-device layout (TP slices concatenated, FSDP shards gathered, each
  pipeline stage's blocks taken from the rank that trains them), so a
  checkpoint written by rank 0 is the one a single-device run writes; and
  `Layout.load_full_state` lays such a state back out.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from laudnet_tpu_torch.parallel.tp import (ModelParallel, gather_shards,
                                           local_shard, packed_sections)


@dataclasses.dataclass
class Layout:
    """``data_group``: the ranks that hold other slices of the batch (None:
    one); ``tp``: the 'model' group of a tensor-parallel model; ``stage`` /
    ``stages`` / ``stage_group`` / ``per_stage``: this rank's pipeline
    stage, their count, its group and the blocks of a stage."""
    data_group: Any = None
    data_rank: int = 0
    tp: Optional[ModelParallel] = None
    stage: int = 0
    stages: int = 1
    stage_group: Any = None
    per_stage: int = 0
    tp_specs: dict = dataclasses.field(default_factory=dict)

    @property
    def writer(self) -> bool:
        """The rank that writes logs and checkpoints."""
        return not dist.is_initialized() or dist.get_rank() == 0

    @property
    def data_size(self) -> int:
        return (1 if self.data_group is None
                else dist.get_world_size(self.data_group))

    # --- each step ----------------------------------------------------------

    @torch.no_grad()
    def sync_gradients(self, model) -> None:
        """Averages the plain gradients over the data group, one
        all-reduce per dtype."""
        if self.data_size == 1:
            return
        grads = [p.grad for p in model.parameters()
                 if p.grad is not None and not isinstance(p.grad, DTensor)]
        for dtype in {g.dtype for g in grads}:
            same = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in same])
            dist.all_reduce(flat, group=self.data_group)
            flat /= self.data_size
            for g, v in zip(same, flat.split([g.numel() for g in same])):
                g.copy_(v.view_as(g))

    @torch.no_grad()
    def mean_metrics(self, metrics: dict, keys) -> dict:
        """``metrics`` with ``keys`` averaged over the data group."""
        if self.data_size == 1:
            return metrics
        v = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(v, group=self.data_group)
        v /= self.data_size
        return dict(metrics, **{k: v[i] for i, k in enumerate(keys)})

    # --- checkpoints --------------------------------------------------------

    def _owner(self, name: str) -> Optional[int]:
        """The pipeline stage that trains ``name`` (None: every stage)."""
        if self.stages == 1:
            return None
        m = re.match(r"blocks\.(\d+)\.", name)
        return None if m is None else int(m.group(1)) // self.per_stage

    def _full(self, name: str, t: Optional[torch.Tensor], like=None,
              scalar: bool = False):
        """``t`` (this rank's part of ``name``, or of a ``scalar`` that
        goes with it) in the single-device layout; collective over the
        ranks that hold other parts."""
        if isinstance(t, DTensor):
            t = t.full_tensor()
        spec = self.tp_specs.get(name)
        if self.tp is not None and isinstance(spec, Shard) and not scalar:
            t = gather_shards(t, spec.dim, self.tp.group,
                              packed_sections(name))
        owner = self._owner(name)
        if owner is not None:
            src = dist.get_process_group_ranks(self.stage_group)[owner]
            mine = self.stage == owner
            has = torch.tensor([float(t is not None)],
                               device=like.device if t is None else t.device)
            dist.broadcast(has, src=src, group=self.stage_group)
            if not has.item():
                return None
            t = (t.detach().clone() if mine
                 else torch.empty_like(like if t is None else t))
            dist.broadcast(t, src=src, group=self.stage_group)
        return None if t is None else t.detach().cpu()

    def full_state(self, model, optimizer):
        """(model state dict, optimizer state dict) in the single-device
        layout, on every rank (collective)."""
        if hasattr(model, "reshard"):  # FSDP: the sharded parameters
            model.reshard()
        names = {p: n for n, p in model.named_parameters()}
        msd = {n: self._full(n, t) for n, t in model.state_dict().items()}
        osd = optimizer.state_dict()
        state, index = {}, 0
        for group in optimizer.param_groups:
            for p in group["params"]:
                name = names[p]
                entry = {}
                keys = sorted(optimizer.state.get(p, {}))
                if self._owner(name) is not None:
                    keys = _broadcast_keys(keys, self, name)
                for k in keys:
                    v = optimizer.state.get(p, {}).get(k)
                    scalar = v.dim() == 0 if v is not None else k == "step"
                    entry[k] = self._full(name, v, scalar=scalar,
                                          like=p.new_zeros(()) if scalar
                                          else p)
                if entry:
                    state[index] = entry
                index += 1
        return msd, {"state": state, "param_groups": osd["param_groups"]}

    @torch.no_grad()
    def _local(self, name: str, full: torch.Tensor, dst: torch.Tensor):
        """Copies this rank's part of the single-device ``full`` into
        ``dst``."""
        spec = self.tp_specs.get(name)
        if self.tp is not None and isinstance(spec, Shard):
            full = local_shard(full, spec.dim, self.tp.rank, self.tp.size,
                               packed_sections(name))
        if isinstance(dst, DTensor):
            (placement,) = dst.placements
            mesh = dst.device_mesh
            chunks = full.chunk(mesh.size(), placement.dim)
            rank = mesh.get_local_rank()
            full = (chunks[rank] if rank < len(chunks)
                    else full.narrow(placement.dim, 0, 0))
            dst = dst.to_local()
        dst.copy_(full.to(dst.device, dst.dtype).view_as(dst))

    def load_full_state(self, model, optimizer, msd: dict, osd: dict):
        """Lays a single-device state back out over this rank."""
        if hasattr(model, "reshard"):
            model.reshard()
        names = {p: n for n, p in model.named_parameters()}
        live = model.state_dict(keep_vars=True)
        for name, full in msd.items():
            self._local(name, full, live[name])
        index = 0
        for group in optimizer.param_groups:
            for p in group["params"]:
                entry = osd["state"].get(index, osd["state"].get(str(index)))
                index += 1
                if not entry:
                    continue
                state = optimizer.state[p]
                for k, v in entry.items():
                    if v.dim() == 0:
                        state[k] = v.clone()
                        continue
                    if k not in state:
                        state[k] = torch.zeros_like(p)
                    self._local(names[p], v, state[k])


def _broadcast_keys(keys, layout: Layout, name: str):
    """The optimizer-state keys of a pipeline stage's parameter, as its
    owner holds them."""
    src = dist.get_process_group_ranks(layout.stage_group)[
        layout._owner(name)]
    box = [keys]
    dist.broadcast_object_list(box, src=src, group=layout.stage_group)
    return box[0]
