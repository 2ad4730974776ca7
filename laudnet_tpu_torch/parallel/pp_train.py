"""Pipeline-parallel LAUD-ViT: the forward and the train step with the
block trunk in GPipe stages over a 'stage' mesh dim (counterpart of
`laudnet_tpu/parallel/pp_train.py`).

The trunk's blocks split into ``S`` contiguous stages, one per rank of the
'stage' dim, and microbatches stream through them (`parallel/pp.py`); the
patch embed, the classifier head and the KD teacher run on every rank of a
stage group, data-parallel over the mesh's 'data' dim.

Stats plumbing: each stage writes its blocks' rows of a ``(B, depth, 5)``
buffer carried with the activations — the LINEAR densities
``[token_density, head_density, attn_density, mlp_density, token_keep]``.
Microbatch means of linear densities average exactly to the batch means,
so the FLOPs bookkeeping (quadratic in the token density) is recomputed
AFTER the pipeline from the densities averaged over the whole batch and
over the 'data' dim (`vit_block_bookkeeping`): per-microbatch bookkeeping
would report E[rho_mb^2], not E[rho]^2. For the same reason the sparsity
loss is taken on the whole batch, not per microbatch, which is why the
schedule is the port's own (`parallel/pp.py`).

Under ``compute_dtype`` (``--amp``) the stem, the blocks and the head
compute as the data-parallel model does: the head in the compute dtype too,
where the JAX package's pipelined head stays in f32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from laudnet_tpu_torch.ops.batch_stats import global_batch, global_mean
from laudnet_tpu_torch.parallel.mesh import mesh_ranks
from laudnet_tpu_torch.parallel.pp import pipeline_apply, stack_layer_params


def make_pp_mesh(n_stages: int, n_devices: int | None = None, *,
                 device=None) -> DeviceMesh:
    """A ``("data", "stage")`` mesh over the group's ranks: the inner dim
    carries the pipeline, so consecutive ranks are consecutive stages."""
    device_type, world = mesh_ranks(n_devices, device)
    if world % n_stages:
        raise ValueError(f"{world} devices not divisible by pp={n_stages}")
    return init_device_mesh(device_type, (world // n_stages, n_stages),
                            mesh_dim_names=("data", "stage"))


def stage_noise_seed(seed: int, data: int, microbatch: int,
                     block: int) -> int:
    """The Gumbel seed of one block on one microbatch of one data shard
    (JAX folds the same three indices into its key, `pp_train.py:129-137`
    there): independent streams, so data shards draw no common noise."""
    return (((seed * 1_000_003 + data) * 1_009 + microbatch) * 1_009
            + block) % (2 ** 63)


def pp_vit_forward(model, images, temperature, *, mesh: DeviceMesh,
                   microbatches: int, rng: Optional[int] = None,
                   noise: Optional[Callable] = None, training: bool = False):
    """`LAUDViT` forward with the block trunk pipelined over ``mesh``'s
    'stage' dim: the same `LAUDViTOutput` as ``model(images, temperature,
    training=...)``, from the same parameters; only the schedule differs,
    so the data-parallel step stays its oracle. This rank runs stage
    ``mesh.get_local_rank('stage')``'s blocks; its copies of the other
    stages' blocks are not read.

    Training draws the Gumbel noise of block ``i`` on microbatch ``m`` of
    data shard ``s`` from ``noise(s, m, i)`` (a source with the
    `ops/gating.py` interface), or from a generator seeded with
    `stage_noise_seed` ``(rng, s, m, i)``."""
    from laudnet_tpu_torch.models.laud_vit import (
        LAUDViTOutput, _linear, _norm, vit_block_bookkeeping,
        vit_policy_flops)
    from laudnet_tpu_torch.ops.gating import GumbelNoise

    names = mesh.mesh_dim_names
    depth, d = model.depth, model.dim
    n_stages = mesh.size(names.index("stage"))
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    per_stage = depth // n_stages
    stage = mesh.get_local_rank("stage")
    data = mesh.get_local_rank("data") if "data" in names else 0
    b = images.shape[0]
    cd = model.compute_dtype

    # --- stem: every rank of the stage group, on its data shard ----------
    x, n, stem_flops = model.embed(images)
    l = n + 1
    blocks, n_layers = stack_layer_params(model.blocks)
    if n_layers != depth:
        raise ValueError(f"{n_layers} block_* subtrees != depth {depth}")
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible into {microbatches} "
                         f"microbatches")
    mb_rows = b // microbatches
    if training and noise is None:
        if rng is None:
            raise ValueError("training=True needs rng or noise")
        noise = lambda s, m, i: GumbelNoise.seeded(
            stage_noise_seed(rng, s, m, i), x.device)
    mine = blocks[stage * per_stage:(stage + 1) * per_stage]

    def stage_fn(own, buf):
        y, m, stats = buf["x"], buf["mask"], buf["stats"]
        # the microbatch index rides in the buffer, as JAX's ``mbid``; a
        # host read only where training draws noise
        mb_id = int(buf["mbid"][0]) if training else 0
        with global_batch(None):  # microbatch densities; averaged after
            for j, blk in enumerate(own):
                gidx = stage * per_stage + j
                y, m, st = blk(y, m, temperature, training=training,
                               noise=noise(data, mb_id, gidx)
                               if training else None, book_len=l)
                row = torch.stack([
                    st.token_density.expand(mb_rows),
                    st.head_density.expand(mb_rows),
                    st.attn_density.expand(mb_rows),
                    st.mlp_density.expand(mb_rows),
                    st.token_keep.float()], dim=-1)            # (mb, 5)
                stats = stats.index_copy(
                    1, torch.tensor([gidx], device=stats.device),
                    row[:, None, :].to(stats.dtype))
        return {"x": y, "mask": m, "stats": stats, "mbid": buf["mbid"]}

    out = pipeline_apply(
        stage_fn, mine,
        {"x": x,
         "mask": torch.ones((b, l), dtype=torch.float32, device=x.device),
         "stats": torch.zeros((b, depth, 5), dtype=torch.float32,
                              device=x.device),
         "mbid": torch.arange(microbatches, device=x.device
                              ).repeat_interleave(mb_rows)},
        mesh=mesh, axis="stage", microbatches=microbatches,
        batch_axis="data" if "data" in names else None)

    # --- head: every rank, on the whole batch ------------------------------
    y = _norm(model.norm, out["x"], cd)
    logits = _linear(model.head, y[:, 0], cd)

    # FLOPs bookkeeping from the densities of the whole (global) batch: the
    # formula the blocks use, whose quadratic terms need the global means
    mean = out["stats"].mean(0)                            # (depth, 5)
    if "data" in names:
        with global_batch(mesh.get_group("data")):
            mean = global_mean(mean)
    hidden = int(d * model.mlp_ratio)
    pflops = vit_policy_flops(l, d, model.num_heads,
                              token_skip=model.token_skip,
                              head_skip=model.head_skip,
                              layer_skip=model.layer_skip)
    sparse, dense = (torch.stack(v) for v in zip(*(
        vit_block_bookkeeping(r[0], r[1], r[2], r[3], l_book=l, d=d,
                              h=model.num_heads, hidden=hidden,
                              policy_flops=pflops) for r in mean)))
    flops = (stem_flops.to(mean.device) + sparse.sum()
             + d * model.num_classes)
    return LAUDViTOutput(
        logits=logits,
        token_density=mean[:, 0], head_density=mean[:, 1],
        attn_density=mean[:, 2], mlp_density=mean[:, 3],
        flops_perc=sparse / dense.to(sparse.device), flops=flops,
        token_keep=out["stats"][:, :, 4].T)


def make_pp_train_step(model, teacher, optimizer, cfg, *, mesh: DeviceMesh,
                       microbatches: int, seed: int = 0, layout=None):
    """The LAUD-ViT train step with the trunk pipelined: the signature, loss
    and metrics of `train/trainer.py::make_train_step` (KD + CE + sparsity,
    per-step learning rate and temperature), so the CLI's loop and
    checkpoints drive it unchanged. The Gumbel noise of each (data shard,
    microbatch, block) is seeded from the step's seed (`step_seed`)."""
    from laudnet_tpu_torch.train.trainer import make_train_step, step_seed

    def forward(images, temperature, step):
        return pp_vit_forward(model, images, temperature, mesh=mesh,
                              microbatches=microbatches,
                              rng=step_seed(seed, step), training=True)

    return make_train_step(model, teacher, optimizer, cfg, seed=seed,
                           forward=forward, layout=layout)
