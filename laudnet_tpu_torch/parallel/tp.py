"""Tensor parallelism in the Megatron form (counterpart of
`laudnet_tpu/parallel/tp.py`).

The JAX package annotates each weight with a sharding and lets GSPMD insert
the collectives. The port's kernels are `torch.library` ops with no DTensor
sharding rule (`ops/library.py`), so they must see plain local tensors, as
JAX's ``shard_map`` hands its kernel (`tp.py:161-170` there). The port
therefore runs the layout by hand: each rank of the mesh's 'model' dim holds
its slice of the sharded weights as plain parameters (`shard_params`), and
the layers run on those slices between Megatron's two collectives, small
``torch.autograd.Function``s:

* column-parallel ``qkv`` / ``fc1`` (the OUTPUT feature dim split, biases
  split to match): the input passes `copy_to_model_parallel` (identity
  forward, all-reduce of the gradient backward) and each rank computes its
  slice of heads / hidden units;
* row-parallel ``proj`` / ``fc2`` (the INPUT feature dim split): each rank's
  partial product passes `reduce_from_model_parallel` (all-reduce forward,
  identity backward) and the bias is added once after it;
* the classifier ``head`` column-parallel, its logits gathered
  (`gather_from_model_parallel`);
* everything small replicated: LayerNorms, the policy and gating heads and
  the maskers (every rank takes the same gate decisions), cls/pos
  embeddings.

The packed qkv projection is sharded BY HEADS, not contiguously: its weight
(3D, D) is viewed as (3, H, dh, D) and split on H, so each rank owns its
heads' q, k and v, and its local (B, L, 3D/tp) activation is already the
(3, H/tp, dh) layout the attention takes. JAX instead shards the packed dim
contiguously and reshards the activation to (B, L, 3, H, dh) before its
kernel (`tp.py:120-127` there). `tensor_parallel_specs` reports the dim
that is split (``Shard(0)`` for qkv); checkpoints hold the full tensors in
the single-device layout (`parallel/state.py`).

For LAUD-ResNets the bottleneck's 3x3 ``conv2`` is column-parallel (output
channels split), ``conv3`` row-parallel (input channels split) and the
classifier ``fc`` column-parallel. BatchNorm ``bn2``, which normalises
conv2's output channels, holds the same channel slice: JAX keeps it
replicated and GSPMD reshards around it; a local-slice layout has no
resharding, so the port splits it with its channels. A grouped conv2
(``group_width`` > 1) is split by whole groups, each rank taking its groups'
input channels; where the groups do not divide over the axis, conv2, bn2
and conv3 stay replicated (never split mid-group). The sparse execution
runs the same layout on its gathered patches.

The quantised products (``linear_impl`` / ``conv_impl`` 'int8' and
'int8_qat') run the same layout: a row-parallel product takes its scales
over the whole input dim and sums its int8 partials exactly
(`ops/quant.py`), so every scale is the unsharded product's.

Sequence parallelism lays the residual stream out token-sharded over the
'model' dim at the boundaries between blocks, where JAX places its
sharding constraint: `sequence_parallel_constraint` hands a rank its token
slice, and `gather_tokens` joins the slices again before the next block,
which runs unchanged. As JAX's constraint, it changes the layout and not the
math.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard

# (parameter-name regex, template) — first match wins; the template names
# the split dim with 'model' and lines up with the tensor's LEADING dims
# (Linear (out, in), conv (out, in, kh, kw)).
VIT_TP_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    (r".*\.(qkv|fc1)\.weight$", ("model", None)),    # column-parallel
    (r".*\.(qkv|fc1)\.bias$", ("model",)),
    (r".*\.(proj|fc2)\.weight$", (None, "model")),   # row-parallel
    (r"(.*\.)?head\.weight$", ("model", None)),      # class-sharded logits
    (r"(.*\.)?head\.bias$", ("model",)),
)

RESNET_TP_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    (r".*\.conv2\.weight$", ("model", None, None, None)),  # out channels,
    # by whole groups of a grouped conv2 (`_GROUPS` below)
    (r".*\.bn2\.(weight|bias|running_mean|running_var)$", ("model",)),
    (r".*\.conv3\.weight$", (None, "model", None, None)),  # in channels
    (r"(.*\.)?fc\.weight$", ("model", None)),
    (r"(.*\.)?fc\.bias$", ("model",)),
)

# packed projections split by heads: (name regex, sections)
PACKED = ((r".*\.qkv\.(weight|bias)$", 3),)
# the products whose split must follow whole heads
_HEADS = r".*\.(qkv|proj)\.(weight|bias)$"
# the tensors whose split must follow conv2's whole groups
_GROUPS = r".*\.(conv2|bn2|conv3)\.[a-z_]+$"


def packed_sections(name: str) -> int:
    for pattern, sections in PACKED:
        if re.match(pattern, name):
            return sections
    return 1


def _spec_for(name: str, shape, rules, axis_size: int,
              num_heads: Optional[int], group_width: Optional[int] = None):
    for pattern, template in rules:
        if re.match(pattern, name):
            if len(shape) < len(template):
                return Replicate()
            dim = template.index("model")
            # only split dims the axis divides evenly, else replicate; the
            # attention's products only along whole heads (the layers run
            # local heads), so 7 heads on a 2-way axis stay replicated
            parts = axis_size * packed_sections(name)
            if shape[dim] % parts:
                return Replicate()
            if (num_heads is not None and re.match(_HEADS, name)
                    and num_heads % axis_size):
                return Replicate()
            if (group_width and group_width > 1
                    and re.match(_GROUPS, name) and group_width % axis_size):
                return Replicate()
            return Shard(dim)
    return Replicate()


def _named_tensors(params):
    if isinstance(params, nn.Module):
        return dict(params.state_dict(keep_vars=True))
    return dict(params)


def tensor_parallel_specs(params, rules=VIT_TP_RULES, *, axis: str = "model",
                          mesh=None, num_heads: Optional[int] = None,
                          group_width: Optional[int] = None):
    """``{name: Shard(dim) or Replicate()}`` for ``params`` (a module, whose
    parameters and buffers are named, or a dict of tensors) under
    Megatron-style ``rules``. ``mesh`` gives the axis size the split dims
    must divide (without it every dim divides, as JAX's). ``num_heads``
    keeps qkv and proj replicated where the heads do not divide, and
    ``group_width`` (conv2's groups) conv2, bn2 and conv3 where the groups
    do not (a module's own ``num_heads`` / ``group_width`` is used when it
    has one)."""
    axis_size = 1
    if mesh is not None and axis in mesh.mesh_dim_names:
        axis_size = mesh.size(mesh.mesh_dim_names.index(axis))
    if isinstance(params, nn.Module):
        if num_heads is None:
            num_heads = getattr(params, "num_heads", None)
        if group_width is None:
            group_width = getattr(params, "group_width", None)
    return {name: _spec_for(name, tuple(t.shape), rules, axis_size,
                            num_heads, group_width)
            for name, t in _named_tensors(params).items()}


def local_shard(full: torch.Tensor, dim: int, rank: int, size: int,
                sections: int = 1) -> torch.Tensor:
    """Rank ``rank``'s slice of ``full`` split ``size`` ways on ``dim``; a
    packed dim of ``sections`` sections splits each section alike (qkv by
    heads)."""
    if sections > 1:
        v = full.unflatten(dim, (sections, -1))
        return v.chunk(size, dim + 1)[rank].flatten(dim, dim + 1).contiguous()
    return full.chunk(size, dim)[rank].contiguous()


def gather_shards(local: torch.Tensor, dim: int, group,
                  sections: int = 1) -> torch.Tensor:
    """The inverse of `local_shard` over ``group`` (every rank gets the
    full tensor)."""
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    if sections > 1:
        parts = [p.unflatten(dim, (sections, -1)) for p in parts]
        return torch.cat(parts, dim + 1).flatten(dim, dim + 1)
    return torch.cat(parts, dim)


@dataclasses.dataclass
class ModelParallel:
    """What a sharded layer needs at run time: the 'model' group, this
    rank's index in it and its size."""
    group: Any
    rank: int
    size: int


# --- Megatron's collectives ---------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterDim(torch.autograd.Function):
    """Forward: this rank's chunk of a replicated tensor along ``dim``
    (zero-padded to a multiple of the group size). Backward: the chunks'
    gradients gathered, so that a replicated producer gets its whole
    gradient on every rank."""

    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim, ctx.n = mp, dim, x.shape[dim]
        return _pad(x, dim, mp.size).chunk(mp.size, dim)[mp.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _unpad(_all_gather(g, ctx.mp, ctx.dim), ctx.dim, ctx.n), \
            None, None


class _GatherDim(torch.autograd.Function):
    """Forward: the ranks' chunks along ``dim`` concatenated (and the
    padding dropped to ``n``). Backward: this rank's chunk of the gradient
    (the gathered tensor feeds replicated work, whose gradient every rank
    has whole)."""

    @staticmethod
    def forward(ctx, x, mp, dim, n):
        ctx.mp, ctx.dim = mp, dim
        return _unpad(_all_gather(x, mp, dim), dim, n)

    @staticmethod
    def backward(ctx, g):
        g = _pad(g, ctx.dim, ctx.mp.size)
        return (g.chunk(ctx.mp.size, ctx.dim)[ctx.mp.rank].contiguous(),
                None, None, None)


def _pad(x, dim, size):
    extra = -x.shape[dim] % size
    if not extra:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim)


def _unpad(x, dim, n):
    """``x`` cut to ``n`` along ``dim``; a copy, not a view, where it is
    cut (a module's output may not be a view under FSDP)."""
    return x if x.shape[dim] == n else x.narrow(dim, 0, n).contiguous()


def _all_gather(x, mp, dim):
    parts = [torch.empty_like(x) for _ in range(mp.size)]
    dist.all_gather(parts, x.contiguous(), group=mp.group)
    return torch.cat(parts, dim)


def copy_to_model_parallel(x, mp: ModelParallel):
    """Megatron's f: identity forward, gradient all-reduced backward."""
    return _CopyToModel.apply(x, mp.group)


def reduce_from_model_parallel(x, mp: ModelParallel):
    """Megatron's g: partial sums all-reduced forward, identity backward."""
    return _ReduceFromModel.apply(x, mp.group)


def gather_from_model_parallel(x, mp: ModelParallel):
    """A column-parallel output's slices concatenated on the last dim; the
    gradient's own slice backward."""
    return _GatherDim.apply(x, mp, x.dim() - 1, x.shape[-1] * mp.size)


def scatter_to_model_parallel(x, mp: ModelParallel, dim: int = -1):
    """This rank's chunk of a replicated tensor (e.g. its heads' gates),
    the gradient gathered backward."""
    return _ScatterDim.apply(x, mp, dim % x.dim())


def _model_parallel(mesh, axis: str) -> Optional[ModelParallel]:
    """``mesh``'s ``axis`` dim as a `ModelParallel` (None where the mesh
    lacks it); a `ModelParallel` is taken as it is."""
    if isinstance(mesh, ModelParallel):
        return mesh
    names = mesh.mesh_dim_names
    if axis not in names:
        return None
    return ModelParallel(mesh.get_group(axis), mesh.get_local_rank(axis),
                         mesh.size(names.index(axis)))


def gather_tokens(x_local, mesh, n_tokens: int, *, axis: str = "model",
                  token_axis: int = 1):
    """The inverse of `sequence_parallel_constraint`: the ranks' token
    slices joined to the whole ``n_tokens`` stream (the padding dropped),
    this rank's slice of the gradient backward. The identity where
    ``mesh`` lacks the axis or it has size 1."""
    mp = _model_parallel(mesh, axis)
    if mp is None or mp.size == 1:
        return x_local
    return _GatherDim.apply(x_local, mp, token_axis, n_tokens)


# --- the layout ------------------------------------------------------------------

def shard_params(model: nn.Module, mesh, rules=None, *,
                 axis: str = "model") -> nn.Module:
    """Puts ``model`` in the tensor-parallel layout over ``mesh``'s
    ``axis`` dim, in place: every tensor ``rules`` split (default: the
    model family's rules) is replaced by this rank's slice, and the layers
    learn their group (`ModelParallel`). The model then runs as the
    unsharded one does, its logits whole on every rank. Returns ``model``; ``model.tp_specs`` holds the layout and
    ``model.tp_full_shapes`` the unsharded shapes."""
    from laudnet_tpu_torch.models.laud_resnet import (LAUDBottleneck,
                                                      LAUDResNet)
    from laudnet_tpu_torch.models.laud_vit import LAUDViT, LAUDViTBlock

    if rules is None:
        rules = RESNET_TP_RULES if isinstance(model, LAUDResNet) \
            else VIT_TP_RULES
    mp = _model_parallel(mesh, axis)
    specs = tensor_parallel_specs(model, rules, axis=axis, mesh=mesh)
    full_shapes = {n: tuple(t.shape)
                   for n, t in model.state_dict(keep_vars=True).items()}
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, spec in specs.items():
            if not isinstance(spec, Shard):
                continue
            owner, _, leaf = name.rpartition(".")
            module = modules[owner]
            local = local_shard(getattr(module, leaf), spec.dim, mp.rank,
                                mp.size, packed_sections(name))
            if leaf in module._parameters:
                old = module._parameters[leaf]
                module._parameters[leaf] = nn.Parameter(
                    local, requires_grad=old.requires_grad)
            else:
                module._buffers[leaf] = local
    sharded = lambda name: isinstance(specs.get(name), Shard)
    for name, m in modules.items():
        prefix = f"{name}." if name else ""
        if isinstance(m, LAUDViTBlock):
            m.tp = mp
            m.tp_attn = sharded(prefix + "qkv.weight")
            m.tp_mlp = sharded(prefix + "fc1.weight")
        elif isinstance(m, LAUDBottleneck) and sharded(prefix
                                                       + "conv2.weight"):
            m.tp = mp
            m.tp_grouped = m.conv2.groups > 1
            if m.tp_grouped:               # whole groups a rank
                m.conv2.groups //= mp.size
        elif isinstance(m, (LAUDViT, LAUDResNet)):
            m.tp = mp
            m.tp_head = sharded(prefix + ("head.weight"
                                          if isinstance(m, LAUDViT)
                                          else "fc.weight"))
    model.tp_specs, model.tp_full_shapes = specs, full_shapes
    return model


def tp_fused_vit_attention(qkv, key_mask, head_mask, num_heads: int,
                           sm_scale: float, mesh, *,
                           model_axis: str = "model",
                           batch_axis: str = "data"):
    """The fused attention (`ops/vit_attention.py::fused_vit_attention`:
    B4 forward, B5 as its registered backward) on this rank's LOCAL heads.

    ``qkv``: the rank's column-parallel qkv activation (B_local, L,
    3 * D / tp), its heads' q, k and v in the (3, H / tp, dh) layout (the
    qkv weight is sharded by heads, module docstring); ``head_mask``: the
    whole (B_local, H) gate, of which the rank takes its heads (their
    gradient gathered backward); ``num_heads``: all heads. Returns the
    (B_local, L, D / tp) output that the row-parallel proj consumes. Any
    local head count runs (an odd one such as DeiT-S's 3 at tp=2 needs no
    fake head); ``num_heads % tp != 0`` raises with JAX's message (the
    layout of `shard_params` keeps qkv and proj whole there, and the block
    runs the fused attention on all heads). ``batch_axis`` is JAX's: the batch is this rank's
    already. ``mesh`` may also be a sharded layer's `ModelParallel`."""
    from laudnet_tpu_torch.ops.vit_attention import fused_vit_attention

    mp = _model_parallel(mesh, model_axis)
    tp = 1 if mp is None else mp.size
    if num_heads % tp:
        raise ValueError(
            f"tp_fused_vit_attention: num_heads={num_heads} not divisible "
            f"by the {model_axis!r} axis ({tp}) — fall back to the "
            "reference attention graph for this geometry")
    if head_mask is not None and tp > 1:
        head_mask = scatter_to_model_parallel(head_mask, mp)
    return fused_vit_attention(qkv, key_mask, head_mask, num_heads // tp,
                               sm_scale)


def sequence_parallel_constraint(x, mesh, *, axis: str = "model",
                                 batch_axis: str = "data",
                                 token_axis: int = 1):
    """Megatron sequence parallelism's layout at a block boundary: this
    rank's token slice of a (batch, tokens, features) stream that every
    rank of ``axis`` holds whole (the tokens zero-padded to a multiple of
    the axis); the gradient is gathered backward. `gather_tokens` joins the
    slices before the next block. The identity where ``mesh`` lacks the
    axis or it has size 1. ``batch_axis`` is JAX's: the batch is this
    rank's already."""
    mp = _model_parallel(mesh, axis)
    if mp is None or mp.size == 1:
        return x
    return scatter_to_model_parallel(x, mp, token_axis)
