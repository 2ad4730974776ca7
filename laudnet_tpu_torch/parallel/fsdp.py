"""FSDP / ZeRO-3 parameter sharding over the data dim (counterpart of
`laudnet_tpu/parallel/fsdp.py`).

JAX places every large parameter with a sharding that splits its largest
dimension over the 'data' axis and lets GSPMD gather each weight before use
and reduce-scatter its gradient; the optimizer state takes the same layout.
The port states the same rule (`fsdp_specs`) in its own layouts (Linear
``(out, in)``, conv ``(out, in, kh, kw)``: the same dimension as JAX's,
with the axes transposed) and applies it through FSDP2's ``fully_shard``
(`fsdp_shard_params`): each large parameter becomes a DTensor sharded on
the dim the rule picks (``shard_placement_fn``), gathered before the
model's forward and reduce-scattered (averaged) after its backward. Leaves
under ``min_size`` elements stay replicated plain tensors (FSDP ignores
them; the train step averages their gradients). ``torch.optim`` creates
the momentum buffers in the parameters' layout, so they are sharded alike.

Composes with the Megatron layout (`parallel/tp.py`): shard the model for
tensor parallelism first; FSDP then takes the largest dim the TP layout
left free (of the full, unsharded shapes, as JAX's rule reads them).
"""

from __future__ import annotations

from torch import nn
from torch.distributed.tensor import Replicate, Shard


def _taken(base) -> set:
    """The dims a base (TP) spec splits: a placement, a tuple of them, or
    anything carrying ``placements`` (a DTensor or its spec)."""
    if base is None:
        return set()
    base = getattr(base, "placements", base)
    if isinstance(base, (tuple, list)):
        return {p.dim for p in base if isinstance(p, Shard)}
    return {base.dim} if isinstance(base, Shard) else set()


def fsdp_specs(params, *, axis: str = "data", mesh=None, min_size: int = 4096,
               base_specs=None):
    """``{name: Shard(dim) or Replicate()}`` sharding each large
    parameter's largest dim over ``axis``.

    ``params``: a module (its parameters, at their full shapes where
    `parallel/tp.py::shard_params` recorded them) or a dict of tensors.
    Leaves smaller than ``min_size`` elements (biases, norms, gating heads)
    stay replicated. Dims taken by ``base_specs`` (a TP layout, by name)
    are respected: the FSDP dim is the largest one the base leaves free
    and the axis size divides (every dim divides without ``mesh``)."""
    axis_size = None
    if mesh is not None and axis in mesh.mesh_dim_names:
        axis_size = mesh.size(mesh.mesh_dim_names.index(axis))
    if isinstance(params, nn.Module):
        full = getattr(params, "tp_full_shapes", {})
        shapes = {n: full.get(n, tuple(p.shape))
                  for n, p in params.named_parameters()}
    else:
        shapes = {n: tuple(p.shape) for n, p in params.items()}
    specs = {}
    for name, shape in shapes.items():
        size = 1
        for s in shape:
            size *= s
        taken = _taken((base_specs or {}).get(name))
        free = [i for i in range(len(shape)) if i not in taken
                and (axis_size is None or shape[i] % axis_size == 0)]
        if size < min_size or not shape or not free:
            specs[name] = Replicate()
        else:
            specs[name] = Shard(max(free, key=lambda i: shape[i]))
    return specs


def fsdp_shard_params(model: nn.Module, mesh, *, axis: str = "data",
                      min_size: int = 4096, base_specs=None) -> nn.Module:
    """Shards ``model`` in place with ``fully_shard`` over ``mesh``'s
    ``axis`` dim in the `fsdp_specs` layout (a TP-sharded model's own
    layout is the base unless ``base_specs`` is given). Build the optimizer
    after this: its parameters are the sharded ones. Returns ``model``."""
    from torch.distributed.fsdp import fully_shard

    if base_specs is None:
        base_specs = getattr(model, "tp_specs", None)
    specs = fsdp_specs(model, axis=axis, mesh=mesh, min_size=min_size,
                       base_specs=base_specs)
    dims, ignored = {}, set()
    for name, p in model.named_parameters():
        if isinstance(specs[name], Shard):
            dims[p] = specs[name].dim
        else:
            ignored.add(p)
    sub = mesh[axis] if mesh.ndim > 1 else mesh
    # resharded after the forward too (ZeRO-3: gathered again for the
    # backward), the root module included
    fully_shard(model, mesh=sub, reshard_after_forward=True,
                shard_placement_fn=lambda p: Shard(dims[p]),
                ignored_params=ignored)
    model.fsdp_specs = specs
    return model
