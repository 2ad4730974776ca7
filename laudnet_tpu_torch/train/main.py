"""LAUD ImageNet training CLI (counterpart of `laudnet_tpu/train/main.py`).

One process trains on one card through `train.trainer.make_train_step`:
Gumbel temperature schedules, the FLOPs-targeted sparsity loss with KD from
a dense teacher of the same geometry, recipe presets through python config
files, auto-resume, CSV metric logs and per-block density dumps. The flags
and defaults are the JAX CLI's, plus ``--device`` (the card unless ``cpu``
is asked for).

With ``--data_url DIR`` it trains and validates on the image folders
``DIR/train`` and ``DIR/val`` (``<class>/<image>``, torchvision's
ImageFolder layout) through the native C++ loader (`data/native_loader.py`)
or, with ``--no_native_loader``, an extra augmentation flag, or where that
library does not build, through the PIL pipeline (`data/loader.py`); the
log says which and why. ``--finetune_from`` and ``--teacher_path`` take
reference ``.pth``/``.pth.tar`` checkpoints through the family's converter
(`convert/`), loaded loosely (strict=False: the maskers stay as
initialised), and ``--evaluate_from`` evaluates one. Without
``--data_url`` it trains on synthetic data::

    python -m laudnet_tpu_torch.train.main --arch laud_deit_small \\
        --vit_attn fused --amp --epochs 1 --steps_per_epoch 8 \\
        --batch_size 128

or, for the CNN flagship (LAUD-ResNet-50 distilled from a dense
ResNet-50)::

    python -m laudnet_tpu_torch.train.main --arch uni_resnet50 --amp \
        --epochs 1 --steps_per_epoch 8 --batch_size 128

or a LAUD-RegNet, distilled from the static RegNet of the same recipe
(the repo's recipe for RegNetY-1.6GF, `train_scripts.sh`)::

    python -m laudnet_tpu_torch.train.main --arch lad_regnet_y_1_6gf \
        --dyn_mode channel-channel-channel-channel \
        --channel_dyn_granularity 2-2-2-2 --lr_mult 0.1 --amp \
        --epochs 1 --steps_per_epoch 8 --batch_size 128

Several processes train one model through ``--dist_coordinator HOST:PORT
--dist_num_processes N --dist_process_id I`` (one process per card, NCCL;
``--device cpu`` runs gloo ranks on the CPU): each loads ``batch_size //
N`` images (the loader's ``shard=(I, N)``), rank 0 writes the logs and
checkpoints. On top of data parallelism, as the JAX CLI: ``--tp K``
Megatron tensor parallelism over groups of K ranks (ViT and ResNet archs,
`parallel/tp.py`; a ViT's fused attention runs on each rank's heads),
``--fsdp`` the parameters and the optimizer state sharded over the data
ranks (`parallel/fsdp.py`), ``--pp K`` the ViT trunk in K GPipe stages
with ``--pp_microbatches`` (`parallel/pp_train.py`). On one card::

    python -m laudnet_tpu_torch.train.main --arch laud_deit_small \
        --vit_attn fused --amp --batch_size 128 --fsdp \
        --dist_coordinator 127.0.0.1:29500 --dist_num_processes 1 \
        --dist_process_id 0
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from laudnet_tpu_torch.data.loader import synthetic_batches

RESNET_ARCHS = ("uni_resnet50", "uni_resnet101")
REGNET_ARCHS = tuple(
    f"lad_regnet_{k}" for k in (
        "y_400mf", "y_800mf", "y_1_6gf", "y_3_2gf", "y_8gf", "y_16gf",
        "y_32gf", "y_128gf", "x_400mf", "x_800mf", "x_1_6gf", "x_3_2gf",
        "x_8gf", "x_16gf", "x_32gf",
    )
)
VIT_ARCHS = ("laud_deit_small", "laud_deit_tiny", "laud_deit_base",
             "laud_t2t_vit_19")
CSV_HEADER = ["epoch", "train_top1", "train_loss", "val_top1", "val_top5",
              "act_rate", "gflops", "lr", "temperature"]


def arch_family(arch: str) -> str:
    if arch in RESNET_ARCHS:
        return "resnet"
    if arch in REGNET_ARCHS:
        return "regnet"
    if arch in VIT_ARCHS:
        return "vit"
    raise ValueError(f"unknown arch {arch}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LAUDNet (PyTorch) ImageNet "
                                            "training")
    p.add_argument("--arch", default="uni_resnet50",
                   choices=list(RESNET_ARCHS + REGNET_ARCHS + VIT_ARCHS))
    p.add_argument("--config", default=None,
                   help="python config file selecting hyperparams_set_index")
    p.add_argument("--hyperparams_set_index", type=int, default=None)
    p.add_argument("--train_url", default="./output")
    p.add_argument("--data_url", default=None,
                   help="ImageNet root with train/ and val/; synthetic if "
                        "unset")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU; the card otherwise")
    # dynamic config of the CNN archs (dash-separated per stage)
    p.add_argument("--dyn_mode", default="spatial-spatial-spatial-spatial")
    p.add_argument("--mask_spatial_granularity", default="4-4-2-1")
    p.add_argument("--channel_dyn_granularity", default="1-1-1-1")
    p.add_argument("--spatial_mask_channel_group", default="1-1-1-1")
    p.add_argument("--channel_masker", default="MLP-MLP-MLP-MLP")
    p.add_argument("--channel_masker_layers", default="1-1-1-1")
    p.add_argument("--masker_reduction", default="16-16-16-16")
    # ViT paradigms (comma-separated subset of token,head,layer)
    p.add_argument("--vit_skip", default="token,head,layer",
                   help="LAUD-ViT gated paradigms (comma list)")
    p.add_argument("--vit_attn", default="reference",
                   choices=["reference", "fused"],
                   help="ViT attention: 'fused' runs the CUDA forward and "
                        "backward kernels (bf16 under --amp, else f32)")
    p.add_argument("--vit_linear", default="dense",
                   choices=["dense", "int8_qat"],
                   help="'int8_qat' fine-tunes the STUDENT under the int8 "
                        "serving path's fake-quant numerics "
                        "(straight-through gradients); the teacher stays "
                        "dense")
    p.add_argument("--conv_impl", default="dense",
                   choices=["dense", "int8_qat"])
    # gumbel temperature
    p.add_argument("--t0", type=float, default=5.0)
    p.add_argument("--t_last", type=float, default=0.1)
    p.add_argument("--t_last_epoch", type=int, default=None)
    p.add_argument("--temp_scheduler", default="exp",
                   choices=["exp", "linear", "cosine"])
    # sparsity + KD
    p.add_argument("--target_rate", type=float, default=0.5)
    p.add_argument("--lambda_act", type=float, default=10.0)
    p.add_argument("--T_kd", type=float, default=4.0)
    p.add_argument("--alpha_kd", type=float, default=0.5)
    p.add_argument("--lr_mult", type=float, default=1.0)
    # checkpoints
    p.add_argument("--finetune_from", default=None,
                   help="torch .pth[.tar] with static weights (strict=False)")
    p.add_argument("--teacher_path", default=None)
    p.add_argument("--evaluate_from", default=None,
                   help="evaluate a reference .pth[.tar] (a state_dict, or "
                        "one under 'state_dict' or 'model') through the "
                        "arch family's converter; a ViT keeps its "
                        "initialised policy heads. Not the ckpt/step_<n>.pt "
                        "this CLI writes")
    # overrides / smoke knobs
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="only for synthetic data")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--no_native_loader", action="store_true",
                   help="the PIL input pipeline even where the native C++ "
                        "loader builds")
    p.add_argument("--colorjitter", action="store_true")
    p.add_argument("--autoaugment", action="store_true")
    p.add_argument("--change_light", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dist_coordinator", default=None)
    p.add_argument("--dist_num_processes", type=int, default=None)
    p.add_argument("--dist_process_id", type=int, default=None)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=4)
    p.add_argument("--optimizer", default="SGD", choices=["SGD", "RMSprop"])
    p.add_argument("--no_decay_biases", action="store_true",
                   help="weight decay only on rank>1 weights (biases and "
                        "norms exempt)")
    p.add_argument("--amp", action="store_true",
                   help="bf16 mixed precision: body products and norm "
                        "outputs in bfloat16 with f32 master parameters; "
                        "policy heads, softmax and losses stay f32. bf16 "
                        "needs no loss scaling")
    return p.parse_args(argv)


def _check_flags(args) -> None:
    """Flag combinations that do not apply raise; none is ignored."""
    family = arch_family(args.arch)
    if family == "regnet" and args.conv_impl != "dense":
        raise SystemExit("--conv_impl int8_qat is LAUD-ResNet-only "
                         "(QuantConv covers the ResNet conv set)")
    if family == "vit" and args.conv_impl != "dense":
        raise SystemExit("--conv_impl applies to LAUD-ResNets; for ViT QAT "
                         "use --vit_linear int8_qat")
    if family != "vit" and args.vit_linear != "dense":
        raise SystemExit("--vit_linear applies to ViT archs; for LAUD-ResNet "
                         "QAT use --conv_impl int8_qat")


def _stage_list(spec: str, cast=str):
    return tuple(cast(v) for v in spec.split("-"))


def _density_rows(s):
    """The 4 x blocks ``all_density`` matrix: s3/s2/s1/channel per CNN
    block, or token/head/attn/mlp per ViT block."""
    if "spatial_s3" in s:
        return np.stack([
            np.concatenate([v.float().cpu().numpy() for v in s[k]])
            for k in ("spatial_s3", "spatial_s2", "spatial_s1", "channel_s")])
    return np.stack([s[k].float().cpu().numpy() for k in (
        "token_density", "head_density", "attn_density", "mlp_density")])


def _pad_val_batch(images, labels, full_bs: int):
    """Wrap-pad a final partial val batch (the drop_last=False tail) up to
    the full batch size and return a 0/1 validity mask: the eval step
    weights top1/top5 by it, so they stay exact over the real rows."""
    n = len(labels)
    weights = np.ones((full_bs,), np.float32)
    if n == full_bs:
        return images, labels, weights
    reps = -(-full_bs // n)  # ceil
    images = np.concatenate([np.asarray(images)] * reps)[:full_bs]
    labels = np.concatenate([np.asarray(labels)] * reps)[:full_bs]
    weights[n:] = 0.0
    return images, labels, weights


def build_loaders(args, batch_size: int, log=print, shard=(0, 1)):
    """The train and val loaders of ``--data_url`` (this process's
    ``shard``): the native C++ loader unless ``--no_native_loader``, an
    augmentation only the PIL transform has, or a library that does not
    build says otherwise. The log names the pipeline and, for PIL, why."""
    from laudnet_tpu_torch.data import (DataLoader, ImageFolderDataset,
                                        eval_transform, train_transform)
    from laudnet_tpu_torch.data import native_loader

    train_ds = ImageFolderDataset(
        os.path.join(args.data_url, "train"),
        train_transform(args.input_size,
                        color_jitter=0.4 if args.colorjitter else 0.0,
                        auto_augment="original" if args.autoaugment else None,
                        change_light=args.change_light))
    val_ds = ImageFolderDataset(os.path.join(args.data_url, "val"),
                                eval_transform(args.input_size))
    # flags first: native_available() may compile the C++ loader, which
    # must not run when the user opted out or needs the PIL-only augs
    if args.no_native_loader:
        why = "--no_native_loader"
    elif args.colorjitter or args.autoaugment or args.change_light:
        why = "--colorjitter/--autoaugment/--change_light run in PIL"
    elif not native_loader.native_available():
        error = (native_loader.build_error() or "").strip().splitlines()
        why = ("the native loader does not build: "
               + (error[0] if error else "unknown error"))
    else:
        log("input pipeline: native C++ loader (data/csrc/loader.cpp)")
        return (native_loader.NativeDataLoader(
                    train_ds, batch_size, train=True, size=args.input_size,
                    seed=args.seed, shard=shard),
                native_loader.NativeDataLoader(
                    val_ds, batch_size, train=False, size=args.input_size,
                    shuffle=False, drop_last=False, shard=shard))
    log(f"input pipeline: PIL (data/transforms.py); {why}")
    return (DataLoader(train_ds, batch_size, seed=args.seed, shard=shard),
            DataLoader(val_ds, batch_size, shuffle=False, drop_last=False,
                       shard=shard))


def convert_checkpoint(family: str, path: str) -> dict:
    """A reference ``.pth``/``.pth.tar`` as the flax-named tree of numpy
    arrays, through the arch family's converter. Raises on a file whose
    names the converter does not know (the port's own ``step_<n>.pt``
    among them)."""
    from laudnet_tpu_torch import convert

    fn = {"regnet": convert.convert_regnet_state_dict,
          "vit": convert.convert_vit_state_dict,
          "resnet": convert.convert_resnet_state_dict}[family]
    return fn(convert.load_pth_tar(path))


def _merge_loose(variables, loaded) -> int:
    """strict=False load (reference `main.py:281`): copies into
    ``variables`` every loaded leaf whose path exists there with the same
    shape; the rest (maskers, policy heads, another head width) stays as
    it was. Returns the number of leaves copied."""
    copied = 0

    def merge(dst, src):
        nonlocal copied
        for k, v in src.items():
            if k in dst:
                if isinstance(v, dict):
                    merge(dst[k], v)
                elif dst[k].shape == np.shape(v):
                    dst[k] = np.asarray(v, dst[k].dtype)
                    copied += 1

    for coll in loaded:
        if coll in variables:
            merge(variables[coll], loaded[coll])
    return copied


def load_loose(model, family: str, path: str) -> str:
    """``path``'s weights into ``model`` wherever a leaf matches
    (`_merge_loose`); returns how many leaves of the model it set."""
    from laudnet_tpu_torch.convert import (load_flax_variables,
                                           to_flax_variables)

    variables = to_flax_variables(model)
    copied = _merge_loose(variables, convert_checkpoint(family, path))
    load_flax_variables(model, variables)
    total = sum(1 for tree in variables.values() for _ in _leaves(tree))
    return f"{copied} of {total} leaves"


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def load_for_evaluation(model, family: str, path: str) -> None:
    """``--evaluate_from``: the checkpoint's weights, all of them. A
    CNN's are loaded strictly (a parameter the file lacks raises); a ViT
    takes a plain DeiT checkpoint's into its initialised policy heads."""
    from laudnet_tpu_torch.convert import (load_flax_variables,
                                           merge_variables, to_flax_tree)

    loaded = convert_checkpoint(family, path)
    if family == "vit":
        # plain DeiT checkpoints carry no policy heads; keep the init ones
        params = merge_variables(to_flax_tree(model), loaded["params"])
        load_flax_variables(model, {"params": params})
    else:
        load_flax_variables(model, loaded)


@dataclasses.dataclass
class Training:
    """What `build_training` sets up and `main` drives."""
    args: Any
    device: torch.device
    model: torch.nn.Module
    teacher: torch.nn.Module
    cfg: Any
    state: Any
    train_step: Callable
    eval_step: Callable
    epochs: int
    # the rows of a batch this process loads: the global batch // processes
    batch_size: int
    steps_per_epoch: int
    # the image-folder loaders of --data_url; None on synthetic data
    train_loader: Any = None
    val_loader: Any = None
    # several processes: the mesh, this process's rank and their count
    mesh: Any = None
    proc_id: int = 0
    n_proc: int = 1

    def to_device(self, images: np.ndarray, labels: np.ndarray):
        """A host batch onto the device; through pinned memory on a card,
        so the copy does not hold the host. Under tensor or pipeline
        parallelism the ranks of a group join their rows
        (`parallel/mesh.py::put_global_batch`)."""
        x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
        return self.place(x), self.place(y)

    def place(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            t = t.pin_memory()
        t = t.to(self.device, non_blocking=True)
        if self.mesh is None:
            return t
        from laudnet_tpu_torch.parallel import put_global_batch

        return put_global_batch(t, self.mesh)


def build_training(args, log=print) -> Training:
    """Model, teacher, optimizer and the two steps for parsed ``args``."""
    from laudnet_tpu_torch import models
    from laudnet_tpu_torch.models.laud_vit import vit_dense_flops
    from laudnet_tpu_torch.parallel import initialize_distributed
    from laudnet_tpu_torch.train import optim
    from laudnet_tpu_torch.train.hyperparams import get_hyperparams
    from laudnet_tpu_torch.train.trainer import (
        TrainConfig, TrainState, make_eval_step, make_train_step)
    from laudnet_tpu_torch.utils.config import Config
    from laudnet_tpu_torch.utils.flops import resnet_full_flops

    _check_flags(args)
    # before any device use; without --dist_* it joins no group
    device = initialize_distributed(args.dist_coordinator,
                                    args.dist_num_processes,
                                    args.dist_process_id, device=args.device)
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    proc_id = dist.get_rank() if dist.is_initialized() else 0
    set_index = args.hyperparams_set_index
    if args.config:
        set_index = Config.fromfile(args.config).train_cfg[
            "hyperparams_set_index"]
    recipe = get_hyperparams(set_index if set_index is not None else 2)
    epochs = args.epochs or recipe.epochs
    batch_size = args.batch_size or recipe.batch_size
    if batch_size % n_proc:
        raise ValueError(f"global batch {batch_size} must divide over "
                         f"{n_proc} processes")
    # per-process batch, the reference's per-GPU division (`main.py:324-325`)
    local_bs = batch_size // n_proc
    t_last_epoch = args.t_last_epoch or epochs

    # mixed precision: student AND teacher compute in bf16; the losses
    # reduce in f32
    compute_dtype = torch.bfloat16 if args.amp else None
    family = arch_family(args.arch)
    ctor = getattr(models, args.arch)
    gen = lambda: torch.Generator(device).manual_seed(args.seed)
    if family == "vit":
        skips = set(args.vit_skip.split(","))
        common = dict(num_classes=args.num_classes, attn_impl=args.vit_attn,
                      compute_dtype=compute_dtype, device=device)
        if args.arch != "laud_t2t_vit_19":  # the T2T stem's geometry is fixed
            common["img_size"] = args.input_size
        model = ctor(token_skip="token" in skips, head_skip="head" in skips,
                     layer_skip="layer" in skips,
                     linear_impl=args.vit_linear, generator=gen(), **common)
        # dense teacher of the same geometry (all gates off), frozen
        teacher = ctor(token_skip=False, head_skip=False, layer_skip=False,
                       generator=gen(), **common)
    else:
        common = (dict(conv_impl=args.conv_impl) if family == "resnet"
                  else {})
        model = ctor(
            num_classes=args.num_classes, input_size=args.input_size,
            dyn_mode=_stage_list(args.dyn_mode),
            mask_spatial_granularity=_stage_list(
                args.mask_spatial_granularity, int),
            channel_dyn_granularity=_stage_list(
                args.channel_dyn_granularity, int),
            spatial_mask_channel_group=_stage_list(
                args.spatial_mask_channel_group, int),
            channel_masker=_stage_list(args.channel_masker),
            channel_masker_layers=_stage_list(args.channel_masker_layers,
                                              int),
            reduction_ratio=_stage_list(args.masker_reduction, int),
            compute_dtype=compute_dtype, device=device, generator=gen(),
            **common)
        teacher_kw = dict(num_classes=args.num_classes,
                          compute_dtype=compute_dtype, device=device,
                          generator=gen())
        if family == "regnet":
            # the static RegNet of the same recipe, frozen
            teacher = models.regnet_static(args.arch[len("lad_regnet_"):],
                                           input_size=args.input_size,
                                           **teacher_kw)
        else:
            # the dense ResNet of the same depth, frozen
            teacher = models.ResNet(layers=model.layers, **teacher_kw)
    teacher.requires_grad_(False)

    train_loader = val_loader = None
    if args.data_url:
        train_loader, val_loader = build_loaders(args, local_bs, log,
                                                 shard=(proc_id, n_proc))
        steps_per_epoch = len(train_loader)
    else:
        steps_per_epoch = args.steps_per_epoch or 10
        log("no --data_url: training on synthetic data (smoke mode)")
    if family == "vit":
        full_flops = vit_dense_flops(model, input_size=args.input_size)
    elif family == "regnet":
        # the static teacher's in-graph bookkeeping IS the dense count (all
        # gates off: sparse == dense, the SE quirk included)
        probe = torch.zeros((1, args.input_size, args.input_size, 3),
                            device=device)
        with torch.no_grad():
            full_flops = float(teacher(probe).flops)
    else:
        full_flops = resnet_full_flops(model.layers,
                                       input_size=args.input_size,
                                       num_classes=args.num_classes)
    log(f"full_flops (dense multiply-adds): {full_flops / 1e9:.3f} G")

    alpha_kd = args.alpha_kd
    if args.teacher_path is None and args.data_url:
        # The reference REQUIRES teacher weights (strict load,
        # `train/main.py:294`); distilling a real run toward a random
        # teacher would silently degrade accuracy, so disable KD instead.
        # (Synthetic smoke runs keep KD to exercise the code path.)
        log("WARNING: no --teacher_path; disabling KD (alpha_kd=0) — a "
            "random teacher would corrupt real-data training")
        alpha_kd = 0.0
    if args.finetune_from:
        got = load_loose(model, family, args.finetune_from)
        log(f"loaded finetune weights from {args.finetune_from} ({got})")
    if args.teacher_path:
        got = load_loose(teacher, family, args.teacher_path)
        log(f"loaded teacher from {args.teacher_path} ({got})")
    if args.evaluate_from:  # full weights, before any sharding
        load_for_evaluation(model, family, args.evaluate_from)
    mesh, layout = lay_out(args, model, n_proc, local_bs, batch_size,
                           device, log)

    cfg = TrainConfig(
        num_epochs=epochs, steps_per_epoch=steps_per_epoch,
        base_lr=recipe.lr, lr_min=recipe.lr_min, scheduler=recipe.scheduler,
        warmup_epochs=recipe.warmup_epochs,
        t0=args.t0, t_last=args.t_last, t_last_epoch=t_last_epoch,
        temp_scheduler=args.temp_scheduler,
        lambda_act=args.lambda_act, alpha_kd=alpha_kd, t_kd=args.T_kd,
        label_smooth=recipe.label_smooth, target_rate=args.target_rate,
        full_flops=full_flops,
    )
    # lr_mult scales the BACKBONE group; the maskers stay at 1.0
    if args.optimizer == "RMSprop":
        if args.no_decay_biases:
            raise SystemExit("--no_decay_biases is SGD-only")
        optimizer = optim.make_rmsprop(
            model, momentum=recipe.momentum,
            weight_decay=recipe.weight_decay,
            backbone_lr_mult=args.lr_mult, masker_lr_mult=1.0)
    else:
        optimizer = optim.make_sgd(
            model, momentum=recipe.momentum, nesterov=recipe.nesterov,
            weight_decay=recipe.weight_decay,
            backbone_lr_mult=args.lr_mult, masker_lr_mult=1.0,
            decay_weights_only=args.no_decay_biases)
    if args.pp > 1:
        from laudnet_tpu_torch.parallel import (make_pp_train_step,
                                                pp_vit_forward)

        train_step = make_pp_train_step(
            model, teacher, optimizer, cfg, mesh=mesh,
            microbatches=args.pp_microbatches, seed=args.seed, layout=layout)
        eval_step = make_eval_step(
            model, cfg, layout=layout,
            forward=lambda x, t: pp_vit_forward(
                model, x, t, mesh=mesh, microbatches=args.pp_microbatches))
    else:
        # each data shard draws its own noise; data rank 0 the one-process
        # run's
        data_rank = 0 if layout is None else layout.data_rank
        train_step = make_train_step(model, teacher, optimizer, cfg,
                                     seed=args.seed + 7919 * data_rank,
                                     layout=layout)
        eval_step = make_eval_step(model, cfg, layout=layout)
    return Training(
        args=args, device=device, model=model, teacher=teacher, cfg=cfg,
        state=TrainState(step=0, model=model, optimizer=optimizer,
                         layout=layout),
        train_step=train_step, eval_step=eval_step,
        epochs=epochs, batch_size=local_bs,
        steps_per_epoch=steps_per_epoch, train_loader=train_loader,
        val_loader=val_loader, mesh=mesh, proc_id=proc_id, n_proc=n_proc)


def lay_out(args, model, n_proc: int, local_bs: int, batch_size: int,
            device, log):
    """The JAX CLI's checks of ``--tp/--fsdp/--pp`` against the ranks and
    the model (`laudnet_tpu/train/main.py:409-450`, its messages), then
    the mesh and the model's layout on it: TP, then FSDP over the data dim,
    or the pipeline's mesh. Returns ``(mesh, layout)``, both None for one
    process without a group."""
    from laudnet_tpu_torch.parallel import (RESNET_TP_RULES, VIT_TP_RULES,
                                            fsdp_shard_params, make_mesh,
                                            make_pp_mesh, shard_params)
    from laudnet_tpu_torch.parallel.state import Layout

    family = arch_family(args.arch)
    if args.tp > 1 and family == "regnet":
        raise SystemExit("--tp supports ViT and ResNet archs (no Megatron "
                         "rules for the RegNet block layout yet)")
    if n_proc % args.tp:
        raise SystemExit(f"--tp {args.tp} must divide the device count "
                         f"({n_proc})")
    if args.pp > 1:
        if family != "vit":
            raise SystemExit("--pp supports ViT archs only (the trunk "
                             "split needs homogeneous block_* layers)")
        if args.tp > 1 or args.fsdp:
            raise SystemExit("--pp is exclusive with --tp/--fsdp in this "
                             "CLI (compose via parallel/ APIs directly)")
        if n_proc % args.pp:
            raise SystemExit(f"--pp {args.pp} must divide the device "
                             f"count ({n_proc})")
        if model.depth % args.pp:
            raise SystemExit(f"--pp {args.pp} must divide the model depth "
                             f"({model.depth})")
        if (local_bs * n_proc) % args.pp_microbatches:
            raise SystemExit(
                f"global batch {local_bs * n_proc} must be divisible by "
                f"--pp_microbatches {args.pp_microbatches}")
    data_axis = n_proc // (args.tp * args.pp)
    per_shard = ((local_bs * n_proc) // args.pp_microbatches
                 if args.pp > 1 else local_bs * n_proc)
    if per_shard % data_axis:
        raise SystemExit(
            f"{'microbatch' if args.pp > 1 else 'global batch'} "
            f"{per_shard} (--batch_size {batch_size}) must be divisible "
            f"by the data axis ({n_proc} devices / "
            f"tp*pp {args.tp * args.pp} = {data_axis})")
    if not dist.is_initialized() and not (args.fsdp or args.tp > 1
                                          or args.pp > 1):
        return None, None
    log(f"devices: {n_proc} processes, {device}")
    if args.pp > 1:
        mesh = make_pp_mesh(args.pp, device=device)
        log(f"PP: GPipe {args.pp} stages x "
            f"{model.depth // args.pp} layers/stage, "
            f"{args.pp_microbatches} microbatches, dp={data_axis}")
        return mesh, Layout(
            data_group=mesh.get_group("data"),
            data_rank=mesh.get_local_rank("data"),
            stage=mesh.get_local_rank("stage"), stages=args.pp,
            stage_group=mesh.get_group("stage"),
            per_stage=model.depth // args.pp)
    mesh = make_mesh(model_parallel=args.tp, device=device)
    layout = Layout(data_group=mesh.get_group("data"),
                    data_rank=mesh.get_local_rank("data"))
    if args.tp > 1:
        if family == "vit" and model.num_heads % args.tp:
            # JAX's CLI drops to its reference attention here; the port
            # keeps qkv and proj replicated (`parallel/tp.py::_spec_for`),
            # so the attention runs as chosen, on all heads on every rank
            log(f"--tp {args.tp} does not divide {model.num_heads} heads; "
                "qkv and proj stay replicated and the attention "
                f"({model.attn_impl}) runs all heads on every rank")
        if family == "resnet" and model.group_width > 1 and (
                model.group_width % args.tp):
            # never split mid-group (`parallel/tp.py::_spec_for`)
            log(f"--tp {args.tp} does not divide conv2's "
                f"{model.group_width} groups; conv2, bn2 and conv3 stay "
                "replicated")
        shard_params(model, mesh, VIT_TP_RULES if family == "vit"
                     else RESNET_TP_RULES)
        layout.tp, layout.tp_specs = model.tp, model.tp_specs
        log(f"TP: Megatron {family} layout over model axis "
            f"(tp={args.tp}, dp={n_proc // args.tp})")
    if args.fsdp:
        fsdp_shard_params(model, mesh, axis="data")
        log("FSDP: params + optimizer state sharded over the data axis")
    return mesh, layout


def train_batches(tr: Training, epoch: int):
    """One epoch's host batches: the image folder's, or synthetic ones."""
    if tr.train_loader is not None:
        return tr.train_loader.epoch(epoch)
    return synthetic_batches(tr.batch_size, tr.args.input_size,
                             tr.args.num_classes, tr.steps_per_epoch,
                             seed=epoch + tr.proc_id * 7919)


def _validate(tr: Training):
    """The val folder (or two synthetic batches), a partial last batch
    wrap-padded and weighted; batch-size-weighted means."""
    top1 = top5 = act = gflops = 0.0
    n_val = 0.0
    density_rows = None
    batches = (tr.val_loader.epoch(0) if tr.val_loader is not None
               else synthetic_batches(tr.batch_size, tr.args.input_size,
                                      tr.args.num_classes, 2,
                                      seed=10_000 + tr.proc_id * 7919))
    for images, labels in batches:
        images, labels, w = _pad_val_batch(images, labels, tr.batch_size)
        x, y = tr.to_device(images, labels)
        s = tr.eval_step(x, y, tr.place(torch.from_numpy(w)))
        bsz = float(s["n_valid"])
        top1 += float(s["top1"]) * bsz
        top5 += float(s["top5"]) * bsz
        act += float(s["act_rate"]) * bsz
        gflops += float(s["flops"]) / 1e9 * bsz
        n_val += bsz
        rows = _density_rows(s) * bsz
        density_rows = rows if density_rows is None else density_rows + rows
    if n_val == 0:
        raise RuntimeError(
            f"empty validation set under {tr.args.data_url!r} — check that "
            "val/ contains class directories with images")
    return (top1 / n_val, top5 / n_val, act / n_val, gflops / n_val,
            density_rows / n_val)


def main(argv=None):
    from laudnet_tpu_torch.train.checkpoint import CheckpointManager
    from laudnet_tpu_torch.utils.logging_utils import Logger
    from laudnet_tpu_torch.utils.metrics import AverageMeter

    from laudnet_tpu_torch.parallel import initialize_distributed

    args = parse_args(argv)
    _check_flags(args)  # before anything is written
    # before any device use (joins nothing without --dist_*)
    initialize_distributed(args.dist_coordinator, args.dist_num_processes,
                           args.dist_process_id, device=args.device)
    writer = not dist.is_initialized() or dist.get_rank() == 0
    os.makedirs(args.train_url, exist_ok=True)
    if writer:
        log = Logger(os.path.join(args.train_url, "train.log"))
    else:  # one writer per shared train_url; the other ranks stay quiet
        log = lambda *a, **k: None
    tr = build_training(args, log)
    log(f"device: {tr.device}")
    state, epochs, steps_per_epoch = tr.state, tr.epochs, tr.steps_per_epoch

    if args.evaluate_from:
        # evaluation only (reference `main.py:304-307,435-436`); the
        # weights were loaded before the model was laid out
        top1, top5, act, gflops, _ = _validate(tr)
        log(f"evaluate: top1 {top1:.3f} top5 {top5:.3f} "
            f"act_rate {act:.3f} GFLOPs {gflops:.3f}")
        return top1

    ckpt = CheckpointManager(os.path.join(args.train_url, "ckpt"))
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        log(f"auto-resumed from step {state.step}")

    csv_path = os.path.join(args.train_url, "log.txt")
    if writer and not os.path.exists(csv_path):
        with open(csv_path, "w", newline="") as f:
            csv.writer(f).writerow(CSV_HEADER)

    # On auto-resume, recover the running best so the first epoch after it
    # cannot overwrite the best checkpoint with a worse one.
    best_top1 = -1.0
    best_path = os.path.join(args.train_url, "best_result.txt")
    if os.path.exists(best_path):
        try:
            with open(best_path) as f:
                best_top1 = float(f.read().split()[0])
            log(f"restored best top1 {best_top1:.3f} from best_result.txt")
        except (ValueError, IndexError):
            pass
    for epoch in range(state.step // steps_per_epoch, epochs):
        meters = {k: AverageMeter(k) for k in
                  ("loss", "top1", "act_rate", "flops")}
        # The metrics accumulate on the device every step and reach the
        # host once per print_freq and at the epoch's end: a read per step
        # would stall the card.
        dev_sums = {k: torch.zeros((), device=tr.device) for k in meters}
        dev_count = 0
        t0 = time.time()
        m = {}
        for i, (images, labels) in enumerate(train_batches(tr, epoch)):
            m = tr.train_step(state, *tr.to_device(images, labels))
            bsz = len(labels)
            for k in meters:
                dev_sums[k] += m[k].float() * bsz
            dev_count += bsz
            if i % args.print_freq == 0:
                log(f"epoch {epoch} [{i}/{steps_per_epoch}] "
                    f"loss {float(m['loss']):.4f} "
                    f"top1 {float(m['top1']):.2f} "
                    f"act {float(m['act_rate']):.3f} "
                    f"lr {m['lr']:.5f} T {m['temperature']:.3f}")
        if dev_count:
            for k in meters:
                meters[k].update(float(dev_sums[k]) / dev_count, dev_count)
        train_time = time.time() - t0

        val_top1, val_top5, act, gflops, density_rows = _validate(tr)
        log(f"epoch {epoch}: val top1 {val_top1:.3f} top5 {val_top5:.3f} "
            f"act_rate {act:.3f} GFLOPs {gflops:.3f} "
            f"({train_time:.1f}s train)")

        is_best = val_top1 > best_top1
        if is_best:
            best_top1 = val_top1
        if writer:
            np.savetxt(os.path.join(args.train_url,
                                    "all_density_latest.txt"), density_rows)
            with open(csv_path, "a", newline="") as f:
                csv.writer(f).writerow(
                    [epoch, meters["top1"].avg, meters["loss"].avg,
                     val_top1, val_top5, act, gflops, m.get("lr"),
                     m.get("temperature")])
        if is_best and writer:
            np.savetxt(os.path.join(args.train_url, "all_density_best.txt"),
                       density_rows)
            with open(best_path, "w") as f:
                f.write(f"{best_top1:.6f}\t{act:.6f}\t{gflops:.6f}")
        ckpt.save(state.step, state,
                  metadata={"epoch": epoch, "val_top1": val_top1},
                  is_best=is_best)
    ckpt.close()
    log(f"done; best top1 {best_top1:.3f}")
    return best_top1


if __name__ == "__main__":
    main()
