"""LAUD ImageNet training CLI (counterpart of `laudnet_tpu/train/main.py`).

One process trains on one card through `train.trainer.make_train_step`:
Gumbel temperature schedules, the FLOPs-targeted sparsity loss with KD from
a dense teacher of the same geometry, recipe presets through python config
files, auto-resume, CSV metric logs and per-block density dumps. The flags
and defaults are the JAX CLI's, plus ``--device`` (the card unless ``cpu``
is asked for).

Run without ``--data_url`` to train on synthetic data::

    python -m laudnet_tpu_torch.train.main --arch laud_deit_small \\
        --vit_attn fused --amp --epochs 1 --steps_per_epoch 8 \\
        --batch_size 128

or, for the CNN flagship (LAUD-ResNet-50 distilled from a dense
ResNet-50)::

    python -m laudnet_tpu_torch.train.main --arch uni_resnet50 --amp \
        --epochs 1 --steps_per_epoch 8 --batch_size 128

The ViT family and the LAUD-ResNets train on synthetic batches. The
LAUD-RegNet archs, ``--data_url``, ``--finetune_from``,
``--teacher_path``, ``--tp/--fsdp/--pp`` and ``--dist_*`` are parsed and
raise `NotImplementedError` naming the slice that brings them.
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
                        "backward kernels (bf16 only: needs --amp on a card)")
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
    p.add_argument("--finetune_from", default=None)
    p.add_argument("--teacher_path", default=None)
    p.add_argument("--evaluate_from", default=None,
                   help="a checkpoint this CLI wrote (ckpt/step_<n>.pt)")
    # overrides / smoke knobs
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="only for synthetic data")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--no_native_loader", action="store_true")
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
    if family == "regnet":
        later(f"--arch {args.arch}", "the RegNet slice")
    if family == "vit" and args.conv_impl != "dense":
        raise SystemExit("--conv_impl applies to LAUD-ResNets; for ViT QAT "
                         "use --vit_linear int8_qat")
    if family != "vit" and args.vit_linear != "dense":
        raise SystemExit("--vit_linear applies to ViT archs; for LAUD-ResNet "
                         "QAT use --conv_impl int8_qat")
    if args.data_url is not None:
        later("--data_url (real ImageNet input)", "the data slice")
    if args.colorjitter or args.autoaugment or args.change_light:
        later("the train-time augmentations", "the data slice")
    for flag in ("finetune_from", "teacher_path"):
        if getattr(args, flag) is not None:
            later(f"--{flag} (external checkpoints)", "the data slice")
    if args.tp != 1 or args.fsdp or args.pp != 1:
        later("--tp/--fsdp/--pp", "the parallel slice")
    if any(v is not None for v in (args.dist_coordinator,
                                   args.dist_num_processes,
                                   args.dist_process_id)):
        later("--dist_* (multi-process training)", "the parallel slice")


def synthetic_batches(batch_size: int, size: int = 224,
                      num_classes: int = 1000, steps: int = 10,
                      seed: int = 0):
    """Dataset-free batches: NHWC f32 images and int32 labels (numpy)."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield (
            rng.standard_normal((batch_size, size, size, 3)).astype(
                np.float32),
            rng.integers(0, num_classes, (batch_size,)).astype(np.int32),
        )


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
    if (args.vit_attn == "fused" and not args.amp
            and device.type == "cuda"):
        raise ValueError("--vit_attn fused on a card needs --amp: the "
                         "attention kernels take bf16 only")

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
            conv_impl=args.conv_impl, compute_dtype=compute_dtype,
            device=device, generator=gen())
        # the dense ResNet of the same depth, frozen
        teacher = models.ResNet(
            layers=model.layers, num_classes=args.num_classes,
            compute_dtype=compute_dtype, device=device, generator=gen())
    teacher.requires_grad_(False)

    steps_per_epoch = args.steps_per_epoch or 10
    log("no --data_url: training on synthetic data (smoke mode)")
    if family == "vit":
        full_flops = vit_dense_flops(model, input_size=args.input_size)
    else:
        full_flops = resnet_full_flops(model.layers,
                                       input_size=args.input_size,
                                       num_classes=args.num_classes)
    log(f"full_flops (dense multiply-adds): {full_flops / 1e9:.3f} G")

    cfg = TrainConfig(
        num_epochs=epochs, steps_per_epoch=steps_per_epoch,
        base_lr=recipe.lr, lr_min=recipe.lr_min, scheduler=recipe.scheduler,
        warmup_epochs=recipe.warmup_epochs,
        t0=args.t0, t_last=args.t_last, t_last_epoch=t_last_epoch,
        temp_scheduler=args.temp_scheduler,
        lambda_act=args.lambda_act, alpha_kd=args.alpha_kd, t_kd=args.T_kd,
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
        steps_per_epoch=steps_per_epoch)


def _validate(tr: Training):
    """Two synthetic validation batches; batch-size-weighted means."""
    top1 = top5 = act = gflops = 0.0
    n_val = 0.0
    density_rows = None
    for images, labels in synthetic_batches(
            tr.batch_size, tr.args.input_size, tr.args.num_classes, 2,
            seed=10_000):
        s = tr.eval_step(*tr.to_device(images, labels))
        bsz = float(s["n_valid"])
        top1 += float(s["top1"]) * bsz
        top5 += float(s["top5"]) * bsz
        act += float(s["act_rate"]) * bsz
        gflops += float(s["flops"]) / 1e9 * bsz
        n_val += bsz
        rows = _density_rows(s) * bsz
        density_rows = rows if density_rows is None else density_rows + rows
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
        payload = torch.load(args.evaluate_from, map_location=tr.device,
                             weights_only=True)
        tr.model.load_state_dict(payload["model"])
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
        for i, (images, labels) in enumerate(synthetic_batches(
                tr.batch_size, args.input_size, args.num_classes,
                steps_per_epoch, seed=epoch)):
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
