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

``--tp/--fsdp/--pp`` and ``--dist_*`` are parsed and raise
`NotImplementedError` naming the slice that brings them.
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


def _refuse_later_slices(args) -> None:
    """Flags whose code is not ported yet raise; none is ignored."""
    def later(what, which):
        raise NotImplementedError(
            f"{what} belongs to {which} of the port, not to this one")

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
    if args.tp != 1 or args.fsdp or args.pp != 1:
        later("--tp/--fsdp/--pp", "the parallel slice")
    if any(v is not None for v in (args.dist_coordinator,
                                   args.dist_num_processes,
                                   args.dist_process_id)):
        later("--dist_* (multi-process training)", "the parallel slice")


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


def build_loaders(args, batch_size: int, log=print):
    """The train and val loaders of ``--data_url``: the native C++ loader
    unless ``--no_native_loader``, an augmentation only the PIL transform
    has, or a library that does not build says otherwise. The log names
    the pipeline and, for PIL, why."""
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
                    seed=args.seed),
                native_loader.NativeDataLoader(
                    val_ds, batch_size, train=False, size=args.input_size,
                    shuffle=False, drop_last=False))
    log(f"input pipeline: PIL (data/transforms.py); {why}")
    return (DataLoader(train_ds, batch_size, seed=args.seed),
            DataLoader(val_ds, batch_size, shuffle=False, drop_last=False))


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
    batch_size: int
    steps_per_epoch: int
    # the image-folder loaders of --data_url; None on synthetic data
    train_loader: Any = None
    val_loader: Any = None

    def to_device(self, images: np.ndarray, labels: np.ndarray):
        """A host batch onto the device; through pinned memory on a card,
        so the copy does not hold the host."""
        x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
        if self.device.type == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
        return (x.to(self.device, non_blocking=True),
                y.to(self.device, non_blocking=True))


def build_training(args, log=print) -> Training:
    """Model, teacher, optimizer and the two steps for parsed ``args``."""
    from laudnet_tpu_torch import models
    from laudnet_tpu_torch.device import resolve_device
    from laudnet_tpu_torch.models.laud_vit import vit_dense_flops
    from laudnet_tpu_torch.train import optim
    from laudnet_tpu_torch.train.hyperparams import get_hyperparams
    from laudnet_tpu_torch.train.trainer import (
        TrainConfig, TrainState, make_eval_step, make_train_step)
    from laudnet_tpu_torch.utils.config import Config
    from laudnet_tpu_torch.utils.flops import resnet_full_flops

    _refuse_later_slices(args)
    set_index = args.hyperparams_set_index
    if args.config:
        set_index = Config.fromfile(args.config).train_cfg[
            "hyperparams_set_index"]
    recipe = get_hyperparams(set_index if set_index is not None else 2)
    epochs = args.epochs or recipe.epochs
    batch_size = args.batch_size or recipe.batch_size
    t_last_epoch = args.t_last_epoch or epochs
    device = resolve_device(args.device)

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
        train_loader, val_loader = build_loaders(args, batch_size, log)
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
    return Training(
        args=args, device=device, model=model, teacher=teacher, cfg=cfg,
        state=TrainState(step=0, model=model, optimizer=optimizer),
        train_step=make_train_step(model, teacher, optimizer, cfg,
                                   seed=args.seed),
        eval_step=make_eval_step(model, cfg),
        epochs=epochs, batch_size=batch_size,
        steps_per_epoch=steps_per_epoch, train_loader=train_loader,
        val_loader=val_loader)


def train_batches(tr: Training, epoch: int):
    """One epoch's host batches: the image folder's, or synthetic ones."""
    if tr.train_loader is not None:
        return tr.train_loader.epoch(epoch)
    return synthetic_batches(tr.batch_size, tr.args.input_size,
                             tr.args.num_classes, tr.steps_per_epoch,
                             seed=epoch)


def _validate(tr: Training):
    """The val folder (or two synthetic batches), a partial last batch
    wrap-padded and weighted; batch-size-weighted means."""
    top1 = top5 = act = gflops = 0.0
    n_val = 0.0
    density_rows = None
    batches = (tr.val_loader.epoch(0) if tr.val_loader is not None
               else synthetic_batches(tr.batch_size, tr.args.input_size,
                                      tr.args.num_classes, 2, seed=10_000))
    for images, labels in batches:
        images, labels, w = _pad_val_batch(images, labels, tr.batch_size)
        x, y = tr.to_device(images, labels)
        s = tr.eval_step(x, y, torch.from_numpy(w).to(tr.device))
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

    args = parse_args(argv)
    _refuse_later_slices(args)  # before anything is written
    os.makedirs(args.train_url, exist_ok=True)
    log = Logger(os.path.join(args.train_url, "train.log"))
    tr = build_training(args, log)
    log(f"device: {tr.device}")
    state, epochs, steps_per_epoch = tr.state, tr.epochs, tr.steps_per_epoch

    if args.evaluate_from:
        # evaluation only (reference `main.py:304-307,435-436`)
        load_for_evaluation(tr.model, arch_family(args.arch),
                            args.evaluate_from)
        top1, top5, act, gflops, _ = _validate(tr)
        log(f"evaluate: top1 {top1:.3f} top5 {top5:.3f} "
            f"act_rate {act:.3f} GFLOPs {gflops:.3f}")
        return top1

    ckpt = CheckpointManager(os.path.join(args.train_url, "ckpt"))
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        log(f"auto-resumed from step {state.step}")

    csv_path = os.path.join(args.train_url, "log.txt")
    if not os.path.exists(csv_path):
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
        np.savetxt(os.path.join(args.train_url, "all_density_latest.txt"),
                   density_rows)
        with open(csv_path, "a", newline="") as f:
            csv.writer(f).writerow(
                [epoch, meters["top1"].avg, meters["loss"].avg, val_top1,
                 val_top5, act, gflops, m.get("lr"), m.get("temperature")])
        if is_best:
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
