"""The flagship and its eval forward (counterpart of
`__graft_entry__.py::entry`): LAUD-ResNet-50 with spatial gating at
granularity 4-4-2-1.

    from laudnet_tpu_torch.entry import entry
    forward, args = entry()          # on the card; entry("cpu") for the CPU
    logits = forward(*args)          # (8, 1000)

`dryrun_multichip(n)` runs the multi-device legs (data, tensor, sequence,
FSDP and pipeline parallelism) in ``n`` processes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from laudnet_tpu_torch.device import resolve_device


def flagship(device=None, seed=0, **kwargs):
    """LAUD-ResNet-50, ``dyn_mode=('spatial',) * 4``, mask granularity
    (4, 4, 2, 1), with weights drawn from ``seed`` (None: left as
    allocated, for a caller that loads them). ``kwargs`` go to the
    constructor (``compute_dtype``, ``execution``, ``conv_impl``, ...)."""
    from laudnet_tpu_torch.models import uni_resnet50

    device = resolve_device(device)
    return uni_resnet50(
        dyn_mode=("spatial",) * 4,
        mask_spatial_granularity=(4, 4, 2, 1),
        channel_masker=("MLP",) * 4,
        channel_masker_layers=(1, 1, 1, 1),
        device=device,
        generator=(None if seed is None
                   else torch.Generator(device).manual_seed(seed)),
        **kwargs)


def entry(device=None):
    """Returns ``(forward, (model, x, temperature))``: the eval forward of
    the flagship and its arguments, a batch of 8 random 224 x 224 images
    from seed 0. ``forward(model, x, temperature)`` returns the logits."""
    device = resolve_device(device)
    model = flagship(device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)).to(device)

    @torch.no_grad()
    def forward(model, x, temperature):
        return model(x, temperature, training=False).logits

    return forward, (model, x, 0.1)


class _RowSlice:
    """A noise source for one data rank: draws the noise of the global
    batch (``n`` times the rows asked for, from a generator seeded alike on
    every rank) and hands back this rank's rows, so that a data-parallel
    step gates as the one-process step on the global batch does."""

    def __init__(self, noise, rank: int, n: int):
        self.noise, self.rank, self.n = noise, rank, n

    def gumbel(self, shape, dtype=torch.float32, device=None):
        rows = shape[0]
        g = self.noise.gumbel((rows * self.n,) + tuple(shape[1:]), dtype,
                              device)
        return g[self.rank * rows:(self.rank + 1) * rows]


def _rel(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


LEGS = ("dp", "tp", "sp", "fsdp", "pp")


def _dryrun_rank(n_devices: int, device: torch.device,
                 full_width: bool = False, legs=LEGS,
                 model_parallel: Optional[int] = None) -> dict:
    """One rank's legs of `dryrun_multichip` (the process group joined):
    each leg runs sharded and, on this rank too, unsharded on the whole
    batch (the world-size-1 result), prints JAX's ``ok`` line with the
    distance between the two (relative to the unsharded result's norm) and
    returns the distances."""
    import torch.distributed as dist

    from laudnet_tpu_torch import models
    from laudnet_tpu_torch.ops.gating import GumbelNoise
    from laudnet_tpu_torch.parallel import (
        VIT_TP_RULES, fsdp_shard_params, make_mesh, make_pp_mesh,
        make_pp_train_step, pp_vit_forward, sequence_parallel_constraint,
        shard_batch, shard_params)
    from laudnet_tpu_torch.parallel.state import Layout
    from laudnet_tpu_torch.parallel.tp import gather_tokens
    from laudnet_tpu_torch.train import optim
    from laudnet_tpu_torch.train.trainer import (TrainConfig, TrainState,
                                                 make_train_step)

    tag = f"dryrun_multichip({n_devices})"
    talk = dist.get_rank() == 0
    print_ = lambda *a: print(*a, flush=True) if talk else None
    model_par = model_parallel or (2 if n_devices % 2 == 0 else 1)
    mesh = make_mesh(model_parallel=model_par, device=device)
    # the Megatron layout where the mesh has a model dim to split over
    tp_layout = ((lambda m, rules=None: shard_params(m, mesh, rules))
                 if model_par > 1 else (lambda m, rules=None: m))
    dp = n_devices // model_par
    gen = lambda seed: torch.Generator(device).manual_seed(seed)
    rng = lambda seed: np.random.default_rng(seed)
    out = {}
    if full_width:   # LAUD-DeiT-S at bs128, 224^2
        vit_kw = dict(depth=12, dim=384, num_heads=6, num_classes=1000,
                      img_size=224, compute_dtype=torch.bfloat16)
        batch, size = 128, 224
    else:            # JAX's dry-run geometry
        vit_kw = dict(depth=4, dim=64, num_heads=4, patch_size=16,
                      num_classes=10, img_size=32)
        batch, size = 2 * n_devices, 32

    def vit(seed, **kw):
        return models.LAUDViT(**dict(vit_kw, **kw), device=device,
                              generator=gen(seed))

    def images(seed, b=batch, s=size):
        return torch.from_numpy(rng(seed).standard_normal(
            (b, s, s, 3)).astype(np.float32)).to(device)

    # --- dp x tp train step (the CNN flagship's family; DeiT-S at full
    # width), against one process on the global batch ---------------------
    if full_width:
        student = lambda: vit(3, attn_impl="fused", token_skip=False)
        teacher = vit(4, attn_impl="fused", token_skip=False, head_skip=False,
                      layer_skip=False)
        x, rules, full_flops = images(2), VIT_TP_RULES, 4.6e9
    else:
        cnn = dict(layers=(1, 1, 1, 1), num_classes=10, input_size=64,
                   dyn_mode=("spatial", "channel", "both", "layer"),
                   mask_spatial_granularity=(4, 4, 2, 1),
                   channel_dyn_granularity=(1, 2, 2, 1),
                   channel_masker=("MLP", "MLP", "conv_linear", "MLP"),
                   channel_masker_layers=(1, 2, 2, 1), device=device)
        student = lambda: models.LAUDResNet(**cnn, generator=gen(0))
        teacher = models.ResNet(layers=(1, 1, 1, 1), num_classes=10,
                                device=device, generator=gen(1))
        x, rules, full_flops = images(0, s=64), None, 6.5e8
    teacher.requires_grad_(False)
    labels = torch.arange(batch, device=device) % vit_kw["num_classes"] \
        if full_width else torch.arange(batch, device=device) % 10
    cfg = TrainConfig(num_epochs=2, steps_per_epoch=2, base_lr=0.01,
                      full_flops=full_flops)

    def train(model, layout, rows, data_rank, data_n):
        opt = optim.make_sgd(model)
        noise = _RowSlice(GumbelNoise.seeded(7, device), data_rank, data_n)
        step = make_train_step(model, teacher, opt, cfg, noise=noise,
                               layout=layout)
        state = TrainState(step=0, model=model, optimizer=opt, layout=layout)
        m = step(state, x[rows], labels[rows])
        assert state.step == 1
        return m

    if "dp" in legs:
        ref = train(student(), None, slice(None), 0, 1)
        model = tp_layout(student(), rules)
        d_rank = mesh.get_local_rank("data")
        layout = Layout(data_group=mesh.get_group("data"), data_rank=d_rank,
                        tp=model.tp, tp_specs=getattr(model, "tp_specs", {}))
        rows = slice(d_rank * batch // dp, (d_rank + 1) * batch // dp)
        m = train(model, layout, rows, d_rank, dp)
        assert np.isfinite(float(m["loss"]))
        out["dp"] = max(abs(float(m[k]) - float(ref[k])) / abs(float(ref[k]))
                        for k in ("loss", "loss_cls", "loss_kd",
                                  "loss_flops"))
        print_(f"{tag}: ok — loss={float(m['loss']):.4f} "
               f"act_rate={float(m['act_rate']):.3f} "
               f"lr={float(m['lr']):.5f} (dp{dp} x tp{model_par}; one "
               f"process: loss {float(ref['loss']):.4f}, worst loss part "
               f"{out['dp']:.3g} apart)")
        del model
    del teacher

    # --- tensor parallelism: the ViT forward with the fused attention on
    # each rank's local heads ------------------------------------------------
    xv = images(2)
    unsharded = vit(3, attn_impl="fused")
    vit_tp = tp_layout(vit(3, attn_impl="fused"))
    if "tp" in legs:
        with torch.no_grad():
            ref_logits = unsharded(xv, 0.1, training=False).logits
            logits = vit_tp(shard_batch(xv, mesh), 0.1,
                            training=False).logits
        assert torch.isfinite(logits).all()
        out["tp"] = _rel(logits, shard_batch(ref_logits, mesh))
        print_(f"{tag}: tp ok — dp{dp} x tp{model_par} ViT forward, fused "
               f"attention sharded over local heads (logits "
               f"{out['tp']:.3g} of the unsharded model's)")

    # --- sequence parallelism: two blocks with token-sharded residuals ----
    if "sp" in legs:
        tokens = torch.from_numpy(rng(5).standard_normal(
            (batch, 8, vit_kw["dim"])).astype(np.float32)).to(device)
        mask8 = torch.ones(tokens.shape[:2], device=device)
        with torch.no_grad():
            y_ref, m_ref = tokens, mask8
            for blk in unsharded.blocks[:2]:
                y_ref, m_ref, _ = blk(y_ref, m_ref, 0.1, book_len=8)
            y, mk = shard_batch(tokens, mesh), shard_batch(mask8, mesh)
            for blk in vit_tp.blocks[:2]:
                # token-sharded at the block boundary, joined for the block
                y = gather_tokens(sequence_parallel_constraint(y, mesh),
                                  mesh, 8)
                y, mk, _ = blk(y, mk, 0.1, book_len=8)
            y = sequence_parallel_constraint(y, mesh)
            assert y.shape[1] == -(-8 // model_par)  # token-sharded
            y = gather_tokens(y, mesh, 8)
        out["sp"] = _rel(y, shard_batch(y_ref, mesh))
        print_(f"{tag}: sp ok — the stream token-sharded at the block "
               f"boundaries over tp{model_par} ({out['sp']:.3g} of the "
               f"unsharded blocks')")
    del vit_tp

    # --- FSDP composed with TP: parameters sharded over both dims ---------
    if "fsdp" in legs:
        def loss_of(model, xb):
            o = model(xb, 0.1, training=False)
            return (o.logits.float() ** 2).mean()

        loss_of(unsharded, xv).backward()
        vit_fs = fsdp_shard_params(
            tp_layout(vit(3, attn_impl="fused")), mesh, min_size=1024)
        lval = loss_of(vit_fs, shard_batch(xv, mesh))
        lval.backward()
        fs_layout = Layout(tp=vit_fs.tp,
                           tp_specs=getattr(vit_fs, "tp_specs", {}))
        grad = fs_layout._full("blocks.0.qkv.weight",
                               vit_fs.blocks[0].qkv.weight.grad)
        # each data rank's loss is its slice's mean, and FSDP averages the
        # gradients over the data ranks: the global mean's gradient
        assert np.isfinite(lval.item())
        out["fsdp"] = _rel(grad, unsharded.blocks[0].qkv.weight.grad)
        print_(f"{tag}: fsdp ok — tp+zero3 grads sharded over dp{dp} x "
               f"tp{model_par} (qkv gradient {out['fsdp']:.3g} of the "
               f"unsharded model's)")
        del vit_fs
    del unsharded

    # --- pipeline parallelism: the full LAUD-ViT train step, pp x dp ------
    n_stages = 4 if n_devices >= 8 else (2 if n_devices >= 2 else 1)
    if "pp" in legs and n_stages > 1:
        micro = 4
        depth = vit_kw["depth"] if full_width else 8
        pp_vit = vit(7, depth=depth)
        pp_mesh = make_pp_mesh(n_stages, device=device)
        per_stage = depth // n_stages
        xp = images(6)
        with torch.no_grad():
            ref_out = pp_vit(xp, 0.1, training=False)
            pp_out = pp_vit_forward(pp_vit, shard_batch(xp, pp_mesh), 0.1,
                                    mesh=pp_mesh, microbatches=micro)
        out["pp"] = _rel(pp_out.logits, shard_batch(ref_out.logits,
                                                      pp_mesh))
        opt = optim.make_sgd(pp_vit)
        pp_layout = Layout(data_group=pp_mesh.get_group("data"),
                           data_rank=pp_mesh.get_local_rank("data"),
                           stage=pp_mesh.get_local_rank("stage"),
                           stages=n_stages,
                           stage_group=pp_mesh.get_group("stage"),
                           per_stage=per_stage)
        pp_step = make_pp_train_step(
            pp_vit, pp_vit, opt,
            TrainConfig(num_epochs=1, steps_per_epoch=2, base_lr=0.01,
                        full_flops=1e9),
            mesh=pp_mesh, microbatches=micro, seed=8, layout=pp_layout)
        pm = pp_step(TrainState(step=0, model=pp_vit, optimizer=opt,
                                layout=pp_layout),
                     shard_batch(xp, pp_mesh),
                     shard_batch(torch.arange(batch, device=device) % 10,
                                 pp_mesh))
        assert np.isfinite(float(pm["loss"]))
        print_(f"{tag}: pp ok — full train step, {n_stages} stages x "
               f"{per_stage} layers x {micro} microbatches, "
               f"dp{n_devices // n_stages}, loss={float(pm['loss']):.4f} "
               f"(eval logits {out['pp']:.3g} of the sequential model's)")
    return out


def _dryrun_worker(n_devices: int, rank: int, port: int, device: str,
                   backend: str, full_width: bool, legs,
                   model_parallel: Optional[int] = None) -> None:
    from laudnet_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    dev = initialize_distributed(f"127.0.0.1:{port}", n_devices, rank,
                                 device=device, backend=backend)
    out = _dryrun_rank(n_devices, dev, full_width, legs, model_parallel)
    if rank == 0:
        print(DISTANCES + json.dumps(out), flush=True)


DISTANCES = "dryrun_multichip distances: "


def dryrun_multichip(n_devices: int, *, device=None, backend=None,
                     full_width: bool = False, legs=LEGS,
                     model_parallel: Optional[int] = None,
                     timeout: float = 900) -> dict:
    """The multi-device dry run (counterpart of
    `__graft_entry__.py::dryrun_multichip`): ``n_devices`` ranks, each a
    process of its own, run JAX's legs at JAX's tiny shapes — a dp x tp
    LAUD-ResNet train step, a tp ViT forward with the fused attention on
    local heads, sequence parallelism, FSDP over a TP layout, and a pp x dp
    train step — each also run on one rank unsharded on the whole batch.
    Prints rank 0's lines (JAX's ``ok`` lines, each with the distance
    between the two, relative to the unsharded result's norm) and returns
    the distances by leg.

    The ranks run on the cards (NCCL) where the machine has ``n_devices``
    of them, else as gloo ranks on the CPU, as JAX's re-runs on virtual CPU
    devices; ``device`` and ``backend`` choose otherwise (``device='cuda',
    backend='gloo'``: several ranks on one card). ``full_width`` runs the
    legs on LAUD-DeiT-S (12 layers, D=384, bf16, bs128, 224^2) instead,
    with a LAUD-DeiT-S train step as the dp leg; ``legs`` picks some of
    `LEGS`; ``model_parallel`` sets the model dim of the dp, tp, sp and
    fsdp legs' mesh (JAX's: 2 where ``n_devices`` is even, else 1; 1 gives
    a dp ``n_devices`` x tp1 mesh). A rank that fails fails the run."""
    from laudnet_tpu_torch.parallel.mesh import free_port

    if device is None:
        device = ("cuda" if torch.cuda.is_available()
                  and torch.cuda.device_count() >= n_devices else "cpu")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "from laudnet_tpu_torch.entry import _dryrun_worker; "
         f"_dryrun_worker({n_devices}, {r}, {port}, {device!r}, "
         f"{backend!r}, {full_width}, {tuple(legs)!r}, "
         f"{model_parallel!r})"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"dryrun_multichip: ranks exited with {codes}:\n"
                           + "\n".join(o[-4000:] for o in outs))
    lines = outs[0].splitlines()
    print("\n".join(ln for ln in lines if ln.startswith("dryrun_multichip")))
    return json.loads(next(ln for ln in lines if ln.startswith(DISTANCES))
                      [len(DISTANCES):])
