"""Training losses: sparsity criteria, label-smoothed CE, KD (counterpart
of `laudnet_tpu/train/losses.py`).

All seven sparsity criteria as plain functions on tensors. Over the first
33% of epochs the upper and lower bounds relax cosinely from the target.
``epoch`` is a Python float (the step count over the steps per epoch).
Only `sparsity_bounds` is reachable from a ViT; the others serve the CNN
family.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _progress(epoch, num_epochs) -> float:
    p = min(max(float(epoch) / (0.33 * num_epochs), 0.0), 1.0)
    return math.cos(p * (math.pi / 2)) ** 2


def _bounds(epoch, num_epochs, target):
    """Cosine^2-annealed (upper, lower) bounds: pinned AT the target at
    epoch 0 (progress = 1) and relaxing to (1, 0) over the first 33% of
    training."""
    progress = _progress(epoch, num_epochs)
    return 1.0 - progress * (1.0 - target), progress * target


def _bound_penalty(values, upper, lower):
    """Mean squared hinge penalty outside [lower, upper]."""
    over = (values - upper).clamp_min(0.0) ** 2
    under = (lower - values).clamp_min(0.0) ** 2
    return (over + under).mean()


def sparsity_bounds(epoch, flops_perc, flops, *, target, num_epochs,
                    full_flops):
    """The criterion the trainer uses. ``flops_perc`` is the per-block
    sparse/dense ratio; ``flops``/``full_flops`` any consistent unit."""
    upper, lower = _bounds(epoch, num_epochs, target)
    loss_blocks = _bound_penalty(flops_perc, upper, lower)
    loss_net = (flops / full_flops - target) ** 2
    return loss_blocks + loss_net


def sparsity_basic(epoch, channel_s, flops_perc, flops, *, target, num_epochs,
                   full_flops):
    """Block bounds + channel density pulled to sqrt(target) + network
    term."""
    upper, lower = _bounds(epoch, num_epochs, target)
    loss_blocks = _bound_penalty(flops_perc, upper, lower)
    loss_channel = ((channel_s - math.sqrt(target)) ** 2).mean()
    loss_net = (flops / full_flops - target) ** 2
    return loss_channel + loss_blocks + loss_net


def sparsity_channel_factor(epoch, channel_s_stages, flops_perc, flops, *,
                            target, num_epochs, full_flops, dyn_mode,
                            channel_loss_factor=1.0, channel_target=None):
    """Per-stage channel penalty only where dyn_mode == 'both', scaled."""
    upper, lower = _bounds(epoch, num_epochs, target)
    loss_blocks = _bound_penalty(flops_perc, upper, lower)
    ct = math.sqrt(target) if channel_target is None else channel_target
    loss_channel = 0.0
    for i in range(4):
        if dyn_mode[i] == "both":
            loss_channel = loss_channel + ((channel_s_stages[i] - ct) ** 2
                                           ).mean()
    loss_net = (flops / full_flops - target) ** 2
    return channel_loss_factor * loss_channel + loss_blocks + loss_net


def sparsity_cs(epoch, channel_s_stages, spatial_s_stages, flops_perc, flops,
                *, target, num_epochs, full_flops, dyn_mode,
                cs_loss_factor=1.0, channel_target=None):
    """Channel and spatial densities per stage where dyn_mode == 'both'."""
    upper, lower = _bounds(epoch, num_epochs, target)
    loss_blocks = _bound_penalty(flops_perc, upper, lower)
    ct = math.sqrt(target) if channel_target is None else channel_target
    loss_cs = 0.0
    for i in range(4):
        if dyn_mode[i] == "both":
            loss_cs = loss_cs + ((channel_s_stages[i] - ct) ** 2).mean()
            loss_cs = loss_cs + ((spatial_s_stages[i] - target) ** 2).mean()
    loss_net = (flops / full_flops - target) ** 2
    return cs_loss_factor * loss_cs + loss_blocks + loss_net


def sparsity_cs_v2(epoch, channel_s_stages, spatial_s_stages, flops_perc,
                   flops, *, target, num_epochs, full_flops, dyn_mode,
                   cs_loss_factor=1.0, channel_target=None):
    """One global mean density per modality instead of per-stage
    penalties."""
    upper, lower = _bounds(epoch, num_epochs, target)
    loss_blocks = _bound_penalty(flops_perc, upper, lower)
    ct = math.sqrt(target) if channel_target is None else channel_target
    dens_c = [channel_s_stages[i] for i in range(4)
              if dyn_mode[i] in ("channel", "both")]
    dens_s = [spatial_s_stages[i] for i in range(4)
              if dyn_mode[i] in ("spatial", "both")]
    loss_cs = (torch.cat(dens_c).mean() - ct) ** 2 if dens_c else 0.0
    if dens_s:
        loss_cs = loss_cs + (torch.cat(dens_s).mean() - target) ** 2
    loss_net = (flops / full_flops - target) ** 2
    return cs_loss_factor * loss_cs + loss_blocks + loss_net


def sparsity_channel_bounds(epoch, channel_s, flops_perc, flops, *, target,
                            num_epochs, full_flops, channel_loss_factor=1.0,
                            channel_upper_start=1.0):
    """FLOPs bounds + annealed bounds on the channel densities toward
    sqrt(target), both mean-squared hinges, + network term."""
    upper, lower = _bounds(epoch, num_epochs, target)
    loss_blocks = _bound_penalty(flops_perc, upper, lower)
    ct = math.sqrt(target)
    progress = _progress(epoch, num_epochs)
    upper_c = channel_upper_start - progress * (channel_upper_start - ct)
    lower_c = progress * ct
    loss_channel = _bound_penalty(channel_s, upper_c, lower_c)
    loss_net = (flops / full_flops - target) ** 2
    return channel_loss_factor * loss_channel + loss_blocks + loss_net


def sparsity_channel_bounds_v2(epoch, channel_s, flops_perc, flops, *, target,
                               num_epochs, full_flops,
                               channel_loss_factor=1.0):
    """As `sparsity_channel_bounds` with the channel UPPER bound starting at
    0.85: even after the bounds relax the channel density is pushed below
    85%."""
    return sparsity_channel_bounds(
        epoch, channel_s, flops_perc, flops, target=target,
        num_epochs=num_epochs, full_flops=full_flops,
        channel_loss_factor=channel_loss_factor, channel_upper_start=0.85)


def cross_entropy(logits, labels):
    """Plain mean CE over integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def cross_entropy_label_smooth(logits, labels, epsilon, num_classes=None):
    """Label-smoothed CE: ``sum(mean(-targets * logp, axis=0))``."""
    n = num_classes or logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), n).to(logits.dtype)
    targets = (1.0 - epsilon) * onehot + epsilon / n
    return (-targets * logp).mean(dim=0).sum()


def kd_loss(student_logits, teacher_logits, temperature):
    """KL(teacher || student) at temperature T, scaled by T^2; the teacher
    gets no gradient."""
    t = teacher_logits.detach()
    log_p_s = F.log_softmax(student_logits / temperature, dim=-1)
    p_t = F.softmax(t / temperature, dim=-1)
    log_p_t = F.log_softmax(t / temperature, dim=-1)
    kl = (p_t * (log_p_t - log_p_s)).sum(dim=-1)
    return kl.mean() * temperature ** 2


def total_train_loss(student_logits, teacher_logits, labels, loss_flops, *,
                     lambda_act, alpha_kd, t_kd, label_smooth=0.0):
    """``lambda_act * loss_flops + CE + alpha_kd * KD``. The losses reduce
    in f32: under mixed precision the model emits bf16 logits."""
    student_logits = student_logits.float()
    teacher_logits = teacher_logits.float()
    if label_smooth:
        ce = cross_entropy_label_smooth(student_logits, labels, label_smooth)
    else:
        ce = cross_entropy(student_logits, labels)
    kd = kd_loss(student_logits, teacher_logits, t_kd)
    return lambda_act * loss_flops + ce + alpha_kd * kd, {
        "loss_cls": ce,
        "loss_kd": kd,
        "loss_flops": loss_flops,
    }
