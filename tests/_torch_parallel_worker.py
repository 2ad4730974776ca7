"""One rank of the port's parallel tests: ``python _torch_parallel_worker.py
SET RANK WORLD PORT DIR`` joins a gloo group of WORLD CPU processes, runs
the scenarios of SET (``pair``: 2 ranks, ``quad``: 4) and saves each
scenario's results to ``DIR/<scenario>_<rank>.pt``. Inputs that only the
JAX side can make (its recorded Gumbel noise) are read from DIR. Imports
torch and the port only; the test files compare the results with the JAX
package (`tests/test_torch_parallel.py`, `tests/test_torch_tp_pp.py`).

The models are built from seeds on every rank and in the test process
alike (`vit_model`, `cnn_model`)."""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

VIT = dict(depth=2, dim=64, num_heads=4, patch_size=16, num_classes=12,
           img_size=32, mlp_ratio=2.0)
PP_VIT = dict(VIT, depth=4)
INDIVISIBLE = dict(VIT, dim=48, num_heads=3)   # 3 heads over 2 ranks
CNN_KW = dict(layers=(1, 1, 1, 1), num_classes=10, input_size=64,
              width_mult=0.25,
              dyn_mode=("spatial", "channel", "both", "layer"),
              mask_spatial_granularity=(4, 2, 1, 1),
              channel_dyn_granularity=(1, 2, 2, 1),
              channel_masker=("MLP", "MLP", "conv_linear", "MLP"),
              channel_masker_layers=(1, 2, 2, 1),
              reduction_ratio=(16, 16, 8, 16))
# the flagship's form (`entry.flagship`: spatial gates at granularity
# 4-4-2-1) cut to one block a stage at a quarter of the width
FLAGSHIP_FORM = dict(CNN_KW, dyn_mode=("spatial",) * 4,
                     mask_spatial_granularity=(4, 4, 2, 1),
                     channel_masker=("MLP",) * 4,
                     channel_masker_layers=(1, 1, 1, 1))
TRAIN = dict(num_epochs=2, steps_per_epoch=3, base_lr=0.05, t0=5.0,
             t_last=0.5, t_last_epoch=2, lambda_act=10.0, alpha_kd=0.5,
             t_kd=4.0, target_rate=0.5)
# weight and image seeds of the quantised scenarios whose int8 codes sit on
# no rounding tie: jitted JAX divides by a broadcast scale as a multiply by
# its reciprocal (`tests/test_torch_trainer.py`), one ulp off the port's
# divide, which flips a code near a tie (of 18 CNN seeds tried, 1 has no
# flip in training, where BatchNorm's batch statistics spread one flip to
# every image)
QUANT_SEEDS = {"vit": (1, 7), "cnn": (4, 4)}


def vit_model(seed: int, geom=VIT, **kw):
    """A LAUD-ViT on the CPU whose policy heads are randomised (zero
    biases, kernels of std 0.2), so that the gates close decisions."""
    from laudnet_tpu_torch.models import LAUDViT

    model = LAUDViT(**geom, **kw, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for blk in model.blocks:
            for head in (blk.token_policy, blk.head_policy,
                         blk.layer_policy):
                if head is not None:
                    head.bias.zero_()
                    head.weight.copy_(torch.randn(head.weight.shape,
                                                  generator=g) * 0.2)
    return model


def _close_maskers(model):
    """Zeroes the maskers' biases (the gates close decisions)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "masker" in name and name.endswith("bias"):
                p.zero_()
    return model


def cnn_model(seed: int):
    """The trainer test's LAUD-ResNet, its maskers' biases zeroed (the gates
    close), and its dense teacher."""
    from laudnet_tpu_torch.models import LAUDResNet, ResNet

    gen = torch.Generator().manual_seed(seed)
    model = LAUDResNet(**CNN_KW, device="cpu", generator=gen)
    teacher = ResNet(layers=(1, 1, 1, 1), num_classes=10, width_mult=0.25,
                     device="cpu", generator=gen)
    return _close_maskers(model), teacher


def laud_cnn(seed: int, geom=CNN_KW, **kw):
    """A LAUD-ResNet of ``geom`` on the CPU, its maskers' biases zeroed."""
    from laudnet_tpu_torch.models import LAUDResNet

    return _close_maskers(LAUDResNet(
        **dict(geom, **kw), device="cpu",
        generator=torch.Generator().manual_seed(seed)))


def half_open_cnn(seed: int, x: torch.Tensor, **kw):
    """`laud_cnn` of the flagship's form whose spatial maskers keep about
    half of the cells of the batch ``x``: block by block, each keep-logit
    bias is moved by the median of its keep-minus-skip logits (to the
    midpoint of the two middle ones, so that no cell sits on the
    threshold)."""
    from laudnet_tpu_torch.models.maskers import _pointwise
    from laudnet_tpu_torch.ops.masking import adaptive_avg_pool

    model = laud_cnn(seed, FLAGSHIP_FORM, **kw)
    for names in model.block_names:
        for name in names:
            masker = getattr(model, name).masker_spatial
            seen = []
            hook = masker.register_forward_pre_hook(
                lambda m, args: seen.append(args[0].detach()))
            with torch.no_grad():
                model(x, 0.1, training=False)
                hook.remove()
                logits = _pointwise(masker.conv, adaptive_avg_pool(
                    seen[0], masker.mask_size))
            d = (logits[..., 0] - logits[..., 1]).flatten().sort().values
            k = d.numel() // 2
            with torch.no_grad():
                masker.conv.bias[0] -= (d[k - 1] + d[k]) / 2
    return model


class ZeroNoise:
    """Gumbel draws of 0: the training gates take the eval decisions and
    keep their straight-through gradients."""

    def gumbel(self, shape, dtype=torch.float32, device=None):
        return torch.zeros(shape, dtype=dtype, device=device)


def images(seed: int, b: int = 4, size: int = 32) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32))


def vit_loss(out, labels):
    """CE plus a sparsity-style term on the FLOPs ratio: not separable over
    the batch, so a data-parallel run must average the densities first."""
    ce = torch.nn.functional.cross_entropy(out.logits, labels)
    return ce + (out.flops_perc.mean() - 0.5) ** 2


def _save(d, name, rank, obj):
    torch.save(obj, os.path.join(d, f"{name}_{rank}.pt"))


def _full_grads(model, layout):
    """Every parameter's gradient in the single-device layout, by name."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        if g is None:
            continue
        out[name] = layout._full(name, g)
    return out


# --- two ranks -------------------------------------------------------------

def dp_step(rank, world, d, kind):
    """One data-parallel train step on the global batch of 4, two rows a
    rank, with the JAX step's recorded noise replayed row-sliced."""
    from laudnet_tpu_torch.convert.from_jax import (to_flax_batch_stats,
                                                    to_flax_tree)
    from laudnet_tpu_torch.ops.gating import ReplayNoise
    from laudnet_tpu_torch.parallel import make_mesh, shard_batch
    from laudnet_tpu_torch.parallel.state import Layout
    from laudnet_tpu_torch.train import optim
    from laudnet_tpu_torch.train import trainer as tt

    z = np.load(os.path.join(d, f"noise_{kind}.npz"))
    noise = [z[k] for k in sorted((k for k in z.files if k.isdigit()), key=int)]
    rows = slice(rank * 4 // world, (rank + 1) * 4 // world)
    if kind == "vit":
        model = vit_model(0, token_skip=False)
        teacher = vit_model(2, token_skip=False, head_skip=False,
                            layer_skip=False)
        x, size = images(5), 32
    else:
        model, teacher = cnn_model(0)
        x, size = images(4, size=64), 64
    labels = torch.from_numpy(np.random.default_rng(6).integers(
        0, 10, (4,)))
    teacher.requires_grad_(False)
    mesh = make_mesh(device="cpu")
    layout = Layout(data_group=mesh.get_group("data"),
                    data_rank=mesh.get_local_rank("data"))
    opt = optim.make_sgd(model, weight_decay=1e-3)
    cfg = tt.TrainConfig(full_flops=float(z["full_flops"]) if "full_flops"
                         in z.files else 1.0, **TRAIN,
                         **({} if kind == "vit" else dict(
                             sparsity_criterion="cs",
                             dyn_mode=CNN_KW["dyn_mode"])))
    step = tt.make_train_step(model, teacher, opt, cfg, layout=layout,
                              noise=ReplayNoise([a[rows] for a in noise]))
    state = tt.TrainState(step=0, model=model, optimizer=opt, layout=layout)
    m = step(state, shard_batch(x, mesh), shard_batch(labels, mesh))
    _save(d, f"dp_{kind}", rank, {
        "metrics": {k: float(v) for k, v in m.items()},
        "params": to_flax_tree(model),
        "batch_stats": to_flax_batch_stats(model) if kind == "cnn" else {}})


def tp_forward_and_grads(rank, world, d, sequence_parallel=False):
    """The ViT over a (1, 2) mesh in the Megatron layout: eval logits and
    the gradients of `vit_loss` at eval gates. With
    ``sequence_parallel`` the stream is token-sharded at every block
    boundary (`sequence_parallel_constraint`, where JAX's test places it)
    and joined for the block (`gather_tokens`)."""
    from laudnet_tpu_torch.parallel import (make_mesh,
                                            sequence_parallel_constraint,
                                            shard_params)
    from laudnet_tpu_torch.parallel.state import Layout
    from laudnet_tpu_torch.parallel.tp import gather_tokens

    mesh = make_mesh(model_parallel=2, device="cpu")
    model = shard_params(vit_model(1, attn_impl="fused"), mesh)
    sharded_tokens = []

    def boundary(block, args):
        y = sequence_parallel_constraint(args[0], mesh)
        sharded_tokens.append(y.shape[1])
        return (gather_tokens(y, mesh, args[0].shape[1]),) + args[1:]

    if sequence_parallel:
        for blk in model.blocks:
            blk.register_forward_pre_hook(boundary)
    x = images(7)
    labels = torch.arange(4) % 12
    out = model(x, 0.1, training=False)
    vit_loss(out, labels).backward()
    layout = Layout(tp=model.tp, tp_specs=model.tp_specs)
    local = model.blocks[0].qkv.weight.shape
    _save(d, "sp" if sequence_parallel else "tp", rank, {
        "logits": out.logits.detach(), "flops_perc": out.flops_perc.detach(),
        "grads": _full_grads(model, layout), "qkv_local": tuple(local),
        "sharded_tokens": sharded_tokens})


def tp_indivisible_heads(rank, world, d):
    """The CLI's layout (`train/main.py::lay_out`, ``--tp 2 --vit_attn
    fused``) of a ViT whose 3 heads do not divide over 2 ranks: its eval
    logits, the head count of each call of the fused attention, the local
    shapes and the log."""
    from laudnet_tpu_torch.models import laud_vit
    from laudnet_tpu_torch.train import main as tmain

    calls, fused = [], laud_vit.fused_vit_attention

    def counted(qkv, key_mask, head_mask, num_heads, sm_scale):
        calls.append(num_heads)
        return fused(qkv, key_mask, head_mask, num_heads, sm_scale)

    model = vit_model(1, INDIVISIBLE, attn_impl="fused")
    lines = []
    tmain.lay_out(tmain.parse_args(["--arch", "laud_deit_tiny", "--tp", "2",
                                    "--vit_attn", "fused", "--device",
                                    "cpu"]),
                  model, world, 2, 4, torch.device("cpu"), lines.append)
    laud_vit.fused_vit_attention = counted
    try:
        with torch.no_grad():
            out = model(images(7), 0.1, training=False)
    finally:
        laud_vit.fused_vit_attention = fused
    _save(d, "tp_indivisible", rank, {
        "logits": out.logits, "calls": calls, "log": lines,
        "qkv_local": tuple(model.blocks[0].qkv.weight.shape),
        "fc1_local": tuple(model.blocks[0].fc1.weight.shape)})


def tp_sparse(rank, world, d):
    """The flagship's form in sparse execution over a (1, 2) mesh: conv2
    and conv3 on the gathered patches in the Megatron layout. Eval logits
    and ``flops_perc``."""
    from laudnet_tpu_torch.parallel import make_mesh, shard_params

    x = images(4, size=64)
    model = half_open_cnn(0, x, execution="sparse")
    shard_params(model, make_mesh(model_parallel=2, device="cpu"))
    with torch.no_grad():
        out = model(x, 0.1, training=False)
    _save(d, "tp_sparse", rank, {
        "logits": out.logits, "flops_perc": out.flops_perc,
        "conv3_local": tuple(model.layer1_0.conv3.weight.shape)})


def tp_quant(rank, world, d, kind):
    """``int8_qat`` over a (1, 2) mesh: the eval logits (W8A8 products),
    then a training forward at zero noise (fake-quant products, every
    gate as at eval) and the gradients of `vit_loss`."""
    from laudnet_tpu_torch.parallel import make_mesh, shard_params
    from laudnet_tpu_torch.parallel.state import Layout

    seed, image_seed = QUANT_SEEDS[kind]
    if kind == "vit":
        model = vit_model(seed, token_skip=False, linear_impl="int8_qat")
        x, labels = images(image_seed), torch.arange(4) % 12
    else:
        model = laud_cnn(seed, conv_impl="int8_qat")
        x, labels = images(image_seed, size=64), torch.arange(4) % 10
    shard_params(model, make_mesh(model_parallel=2, device="cpu"))
    with torch.no_grad():
        served = model(x, 0.1, training=False).logits
    out = model(x, 0.1, training=True, noise=ZeroNoise())
    vit_loss(out, labels).backward()
    layout = Layout(tp=model.tp, tp_specs=model.tp_specs)
    row = model.blocks[0].fc2 if kind == "vit" else model.layer1_0.conv3
    _save(d, f"tp_quant_{kind}", rank, {
        "served": served, "logits": out.logits.detach(),
        "grads": _full_grads(model, layout),
        "row_local": tuple(row.weight.shape)})


def tp_grouped(rank, world, d):
    """A grouped conv2 (``group_width=2``) over a (1, 2) mesh, one group a
    rank: eval logits and the gradients of `vit_loss` at eval gates."""
    from laudnet_tpu_torch.parallel import make_mesh, shard_params
    from laudnet_tpu_torch.parallel.state import Layout

    model = laud_cnn(0, group_width=2)
    shard_params(model, make_mesh(model_parallel=2, device="cpu"))
    out = model(images(4, size=64), 0.1, training=False)
    vit_loss(out, torch.arange(4) % 10).backward()
    layout = Layout(tp=model.tp, tp_specs=model.tp_specs)
    conv2 = model.layer1_0.conv2
    _save(d, "tp_grouped", rank, {
        "logits": out.logits.detach(), "grads": _full_grads(model, layout),
        "conv2": (tuple(conv2.weight.shape), conv2.groups)})


def fsdp_forward_and_grads(rank, world, d, model_parallel=1):
    """The ViT under FSDP over the data ranks (over a TP base with
    ``model_parallel``): logits of this rank's rows and the full gradients
    of the global `vit_loss`."""
    from torch.distributed.tensor import DTensor

    from laudnet_tpu_torch.parallel import (fsdp_shard_params, make_mesh,
                                            shard_batch, shard_params)
    from laudnet_tpu_torch.parallel.state import Layout

    mesh = make_mesh(model_parallel=model_parallel, device="cpu")
    model = vit_model(1)
    layout = Layout(data_group=mesh.get_group("data"),
                    data_rank=mesh.get_local_rank("data"))
    if model_parallel > 1:
        shard_params(model, mesh)
        layout.tp, layout.tp_specs = model.tp, model.tp_specs
    fsdp_shard_params(model, mesh, min_size=256)
    sharded = sorted(n for n, p in model.named_parameters()
                     if isinstance(p, DTensor))
    x = shard_batch(images(7), mesh)
    labels = shard_batch(torch.arange(4) % 12, mesh)
    from laudnet_tpu_torch.ops.batch_stats import global_batch

    with global_batch(layout.data_group):
        out = model(x, 0.1, training=False)
        loss = vit_loss(out, labels)
    loss.backward()
    layout.sync_gradients(model)
    model.reshard()
    _save(d, f"fsdp{model_parallel}", rank, {
        "logits": out.logits.detach(), "grads": _full_grads(model, layout),
        "sharded": sharded, "specs": {n: str(s) for n, s in
                                      model.fsdp_specs.items()}})


def attention_on_local_heads(rank, world, d):
    """`tp_fused_vit_attention` on this rank's heads of a (B, L, 3D) qkv,
    forward and backward."""
    from laudnet_tpu_torch.parallel import make_mesh
    from laudnet_tpu_torch.parallel.tp import local_shard, \
        tp_fused_vit_attention

    mesh = make_mesh(model_parallel=2, device="cpu")
    z = np.load(os.path.join(d, "attention.npz"))
    qkv = torch.from_numpy(z["qkv"])
    local = local_shard(qkv, 2, rank, 2, sections=3).requires_grad_()
    head_mask = torch.from_numpy(z["head_mask"]).requires_grad_()
    out = tp_fused_vit_attention(local, torch.from_numpy(z["key_mask"]),
                                 head_mask, 6, 0.125, mesh)
    g = torch.from_numpy(z["g"])
    (out * local_shard(g, 2, rank, 2)).sum().backward()
    _save(d, "attention", rank, {"out": out.detach(),
                                 "dqkv": local.grad,
                                 "dhead": head_mask.grad})


def serve(rank, world, d):
    """`ServingEngine(mesh=)` against the engine without a mesh."""
    from laudnet_tpu_torch.infer.engine import ServingEngine
    from laudnet_tpu_torch.parallel import make_mesh

    model = vit_model(3)
    if rank == 1:  # the mesh's engine replicates the first rank's weights
        with torch.no_grad():
            model.head.weight.add_(1.0)
    x = images(8)
    mesh = make_mesh(device="cpu")
    logits = ServingEngine(model, mesh=mesh)(x)
    _save(d, "serve", rank, {"mesh": logits,
                             "alone": ServingEngine(model)(x)})


# --- four ranks --------------------------------------------------------------

def pipeline_trunk(rank, world, d):
    """`pipeline_apply` over a (2 data, 2 stage) mesh against the
    sequential trunk: 4 layers, 2 a stage, 2 microbatches; the output and
    the gradients of the stage's layers and of the input."""
    from laudnet_tpu_torch.parallel import (make_pp_mesh, pipeline_apply,
                                            shard_batch, stack_layer_params)

    mesh = make_pp_mesh(2, device="cpu")
    model = vit_model(4, PP_VIT, token_skip=False)
    layers, n = stack_layer_params(model.blocks)
    stage = mesh.get_local_rank("stage")
    mine = layers[stage * 2:(stage + 1) * 2]
    tokens = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (8, 5, 64)).astype(np.float32))
    x = shard_batch(tokens, mesh).requires_grad_()

    def fn(blocks, buf):
        y, m = buf["x"], buf["mask"]
        for blk in blocks:
            y, m, _ = blk(y, m, 0.1, book_len=5)
        return {"x": y, "mask": m}

    out = pipeline_apply(fn, mine, {"x": x, "mask": torch.ones(4, 5)},
                         mesh=mesh, microbatches=2, batch_axis="data")
    (out["x"] ** 2).mean().backward()
    grads = {f"blocks.{stage * 2 + j}.{k}": p.grad
             for j, blk in enumerate(mine)
             for k, p in blk.named_parameters() if p.grad is not None}
    _save(d, "pipeline", rank, {"out": out["x"].detach(), "dx": x.grad,
                                "grads": grads, "n": n})


def pp_forward(rank, world, d):
    """`pp_vit_forward` at eval over (2 data, 2 stage): this rank's rows."""
    from laudnet_tpu_torch.parallel import (make_pp_mesh, pp_vit_forward,
                                            shard_batch)

    mesh = make_pp_mesh(2, device="cpu")
    model = vit_model(4, PP_VIT)
    with torch.no_grad():
        out = pp_vit_forward(model, shard_batch(images(10, b=8), mesh), 0.1,
                             mesh=mesh, microbatches=2)
    _save(d, "pp_forward", rank, {k: getattr(out, k) for k in (
        "logits", "token_density", "head_density", "attn_density",
        "mlp_density", "flops_perc", "flops", "token_keep")})


def pp_noise(d: str, geom=PP_VIT, b: int = 8, per_stage: int = 2):
    """Per block, the Gumbel draws of the global batch of ``b`` rows for its
    layer and head gates: the draws JAX's pipelined step made, saved by the
    test in ``d/noise_pp.npz``. There each draw of a stage's ``j``-th block
    is traced once inside the pipeline's scan, so every stage, microbatch
    and data shard reuses it: block ``i``'s row ``r`` takes row ``r % mb``
    of the draws of position ``i % per_stage``. (Token gates are left out:
    the straight-through residue makes a token-gated step hang on the last
    bit of a soft sample, `tests/test_torch_trainer.py`, and a microbatch
    of other rows may round that bit otherwise.)"""
    z = np.load(os.path.join(d, "noise_pp.npz"))
    drawn = [z[str(k)] for k in range(2 * per_stage)]
    mb = drawn[0].shape[0]
    tile = lambda a: np.concatenate([a] * (b // mb))
    return [[tile(drawn[2 * (i % per_stage) + g]) for g in (0, 1)]
            for i in range(geom["depth"])]


def pp_train(rank, world, d, amp=False):
    """The pipelined train step over (2 data, 2 stage), 2 microbatches,
    with the global noise of `pp_noise` handed to each (data shard,
    microbatch, block): metrics and the updated parameters."""
    from laudnet_tpu_torch.convert.from_jax import to_flax_tree
    from laudnet_tpu_torch.ops.gating import ReplayNoise
    from laudnet_tpu_torch.parallel import (make_pp_mesh, pp_vit_forward,
                                            shard_batch)
    from laudnet_tpu_torch.parallel.state import Layout
    from laudnet_tpu_torch.train import optim
    from laudnet_tpu_torch.train import trainer as tt

    mesh = make_pp_mesh(2, device="cpu")
    cd = torch.bfloat16 if amp else None
    model = vit_model(4, PP_VIT, token_skip=False, compute_dtype=cd)
    teacher = vit_model(5, PP_VIT, token_skip=False, head_skip=False,
                        layer_skip=False, compute_dtype=cd)
    teacher.requires_grad_(False)
    noise = pp_noise(d)
    mb = 2  # rows of a microbatch: 8 rows / 2 data shards / 2 microbatches

    def source(s, m, i):
        lo = s * 4 + m * mb
        return ReplayNoise([a[lo:lo + mb] for a in noise[i]])

    layout = Layout(data_group=mesh.get_group("data"),
                    data_rank=mesh.get_local_rank("data"),
                    stage=mesh.get_local_rank("stage"), stages=2,
                    stage_group=mesh.get_group("stage"), per_stage=2)
    opt = optim.make_sgd(model, weight_decay=1e-3)
    step = tt.make_train_step(
        model, teacher, opt, tt.TrainConfig(full_flops=1e7, **TRAIN),
        layout=layout,
        forward=lambda x, t, _: pp_vit_forward(
            model, x, t, mesh=mesh, microbatches=2, noise=source,
            training=True))
    state = tt.TrainState(step=0, model=model, optimizer=opt, layout=layout)
    m = step(state, shard_batch(images(12, b=8), mesh),
             shard_batch(torch.arange(8) % 12, mesh))
    msd, _ = layout.full_state(model, opt)
    model.load_state_dict(msd)
    _save(d, "pp_train_amp" if amp else "pp_train", rank, {
        "metrics": {k: float(v) for k, v in m.items()},
        "params": to_flax_tree(model)})


SETS = {
    "pair": (lambda r, w, d: dp_step(r, w, d, "vit"),
             lambda r, w, d: dp_step(r, w, d, "cnn"),
             tp_forward_and_grads,
             lambda r, w, d: tp_forward_and_grads(r, w, d, True),
             tp_indivisible_heads, fsdp_forward_and_grads,
             attention_on_local_heads, serve, tp_sparse,
             lambda r, w, d: tp_quant(r, w, d, "vit"),
             lambda r, w, d: tp_quant(r, w, d, "cnn"), tp_grouped),
    "quad": (lambda r, w, d: fsdp_forward_and_grads(r, w, d, 2),
             pipeline_trunk, pp_forward, pp_train,
             lambda r, w, d: pp_train(r, w, d, amp=True)),
}


def main(name, rank, world, port, d):
    from laudnet_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    for scenario in SETS[name]:
        scenario(rank, world, d)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
