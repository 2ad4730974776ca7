"""Train and eval steps for LAUD training: KD + sparsity + CE (counterpart
of `laudnet_tpu/train/trainer.py`).

One ``train_step`` holds the per-iteration learning rate and Gumbel
temperature, the frozen teacher's forward, the student's forward under
Gumbel straight-through gates, the composite loss ``lambda_act * sparsity
+ CE + alpha_kd * KD``, the backward and the optimizer update. The model
and optimizer are updated in place; the step count lives in `TrainState`.
The metrics stay on the device (lr and temperature are host floats): the
caller decides when to read them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from laudnet_tpu_torch.device import full_f32_convolutions
from laudnet_tpu_torch.ops.gating import GumbelNoise
from laudnet_tpu_torch.train import losses, schedules
from laudnet_tpu_torch.train.optim import set_learning_rate
from laudnet_tpu_torch.utils.metrics import topk_accuracy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 100
    steps_per_epoch: int = 1000
    base_lr: float = 0.08
    lr_min: float = 0.0
    scheduler: str = "cosine"
    warmup_epochs: int = 0
    # Gumbel temperature
    t0: float = 5.0
    t_last: float = 0.1
    t_last_epoch: int = 100
    temp_scheduler: str = "exp"
    # loss weights
    lambda_act: float = 10.0
    alpha_kd: float = 0.5
    t_kd: float = 4.0
    label_smooth: float = 0.0
    target_rate: float = 0.5
    full_flops: float = 4.1e9
    sparsity_criterion: str = "bounds"
    dyn_mode: Any = ("both",) * 4


@dataclasses.dataclass
class TrainState:
    """What a step updates: the count, and in place the model's parameters
    and the optimizer's buffers."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def teacher_logits_fn(teacher: nn.Module, images: torch.Tensor):
    """Runs a frozen teacher (eval gates, no gradient) and returns plain
    logits, whether it returns them bare or as an output's ``.logits``."""
    with torch.no_grad():
        out = teacher(images, training=False)
    return getattr(out, "logits", out)


CNN_CRITERIA = ("basic", "channel_factor", "cs", "cs_v2", "channel_bounds",
                "channel_bounds_v2")


def compute_sparsity_loss(cfg: TrainConfig, epoch, out):
    """The sparsity loss of ``cfg.sparsity_criterion``. 'bounds' consumes
    only ``flops_perc`` and ``flops``, so it applies to `LAUDViTOutput`
    (the per-block ratios over the transformer depth) as to `LAUDOutput`.
    The other six criteria read the CNN family's per-stage channel and
    spatial densities."""
    common = dict(target=cfg.target_rate, num_epochs=cfg.num_epochs,
                  full_flops=cfg.full_flops)
    name = cfg.sparsity_criterion
    if name == "bounds":
        return losses.sparsity_bounds(epoch, out.flops_perc, out.flops,
                                      **common)
    if name == "basic":
        return losses.sparsity_basic(epoch, torch.cat(out.channel_s),
                                     out.flops_perc, out.flops, **common)
    if name == "channel_factor":
        return losses.sparsity_channel_factor(
            epoch, out.channel_s, out.flops_perc, out.flops,
            dyn_mode=cfg.dyn_mode, **common)
    if name == "cs":
        return losses.sparsity_cs(
            epoch, out.channel_s, out.spatial_s3, out.flops_perc, out.flops,
            dyn_mode=cfg.dyn_mode, **common)
    if name == "cs_v2":
        return losses.sparsity_cs_v2(
            epoch, out.channel_s, out.spatial_s3, out.flops_perc, out.flops,
            dyn_mode=cfg.dyn_mode, **common)
    if name == "channel_bounds":
        return losses.sparsity_channel_bounds(
            epoch, torch.cat(out.channel_s), out.flops_perc, out.flops,
            **common)
    if name == "channel_bounds_v2":
        return losses.sparsity_channel_bounds_v2(
            epoch, torch.cat(out.channel_s), out.flops_perc, out.flops,
            **common)
    raise ValueError(f"unknown sparsity criterion {name}")


def step_seed(seed: int, step: int) -> int:
    """The Gumbel seed of one step, a function of (seed, step) alone, so a
    resumed run draws what an uninterrupted one would."""
    return (seed * 1_000_003 + step) % (2 ** 63)


def make_train_step(model: nn.Module, teacher: nn.Module,
                    optimizer: torch.optim.Optimizer, cfg: TrainConfig, *,
                    seed: int = 0, noise=None) -> Callable:
    """Builds ``train_step(state, images, labels) -> metrics``. The teacher
    is frozen and runs at eval. Gumbel noise comes from a `GumbelNoise` on
    the model's device, re-seeded every step from (seed, step); a given
    ``noise`` source is used as it is instead. An f32 model (no
    ``compute_dtype``) takes the whole step, backward included, with
    cuDNN's TF32 off (`device.full_f32_convolutions`)."""
    own_noise: Optional[GumbelNoise] = None
    if noise is None:
        device = next(model.parameters()).device
        own_noise = noise = GumbelNoise.seeded(seed, device)

    f32_model = getattr(model, "compute_dtype", None) is None

    def train_step(state: TrainState, images, labels):
        if f32_model:
            with full_f32_convolutions():
                return _train_step(state, images, labels)
        return _train_step(state, images, labels)

    def _train_step(state: TrainState, images, labels):
        step = state.step
        lr = schedules.lr_at(
            step, base_lr=cfg.base_lr, total_epochs=cfg.num_epochs,
            steps_per_epoch=cfg.steps_per_epoch, scheduler=cfg.scheduler,
            warmup_epochs=cfg.warmup_epochs, lr_min=cfg.lr_min)
        temp = schedules.gumbel_temperature_at(
            step, t0=cfg.t0, t_last=cfg.t_last,
            t_last_epoch=cfg.t_last_epoch,
            steps_per_epoch=cfg.steps_per_epoch,
            temp_scheduler=cfg.temp_scheduler)
        epoch = step / cfg.steps_per_epoch
        if own_noise is not None:
            own_noise.reseed(step_seed(seed, step))

        teacher_logits = teacher_logits_fn(teacher, images)
        out = model(images, temp, training=True, noise=noise)
        loss_flops = compute_sparsity_loss(cfg, epoch, out)
        loss, parts = losses.total_train_loss(
            out.logits, teacher_logits, labels, loss_flops,
            lambda_act=cfg.lambda_act, alpha_kd=cfg.alpha_kd, t_kd=cfg.t_kd,
            label_smooth=cfg.label_smooth)

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        set_learning_rate(optimizer, lr)
        optimizer.step()
        state.step = step + 1

        with torch.no_grad():
            top1, top5 = topk_accuracy(out.logits, labels, topk=(1, 5))
            return {
                "loss": loss.detach(),
                "loss_cls": parts["loss_cls"].detach(),
                "loss_kd": parts["loss_kd"].detach(),
                "loss_flops": parts["loss_flops"].detach(),
                "act_rate": out.flops_perc.mean().detach(),
                "flops": out.flops.detach(),
                "lr": lr,
                "temperature": temp,
                "top1": top1,
                "top5": top5,
            }

    return train_step


def make_eval_step(model: nn.Module, cfg: TrainConfig) -> Callable:
    """Eval forward at the final temperature (deterministic gates)."""

    @torch.no_grad()
    def eval_step(images, labels, weights=None):
        out = model(images, cfg.t_last, training=False)
        # ``weights``: 0/1 valid mask of a wrap-padded final batch; it
        # keeps top1/top5 exact. The densities are per-block batch means
        # and stay plain means.
        top1, top5 = topk_accuracy(out.logits, labels, topk=(1, 5),
                                   weights=weights)
        n_valid = (torch.tensor(float(labels.shape[0]),
                                device=out.logits.device)
                   if weights is None else weights.sum().float())
        stats = {"top1": top1, "top5": top5, "n_valid": n_valid,
                 "act_rate": out.flops_perc.mean(), "flops": out.flops}
        # the density breakdown: per stage s3/s2/s1/channel for the CNNs,
        # per block token/head/attn/mlp for the ViTs
        for k in ("spatial_s3", "spatial_s2", "spatial_s1", "channel_s",
                  "token_density", "head_density", "attn_density",
                  "mlp_density"):
            if getattr(out, k, None) is not None:
                stats[k] = getattr(out, k)
        return stats

    return eval_step
