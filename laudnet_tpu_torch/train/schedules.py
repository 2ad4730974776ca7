"""Per-iteration learning-rate and Gumbel-temperature schedules
(counterpart of `laudnet_tpu/train/schedules.py`).

Python numbers in, a Python float out: the schedules run on the host, once
a step, and nothing here belongs on the device.
"""

from __future__ import annotations

import math


def lr_at(step, *, base_lr, total_epochs, steps_per_epoch, scheduler="cosine",
          warmup_epochs=0, warmup_lr=None, lr_min=0.0, lr_decay_rate=0.1,
          lr_decay_step=30, milestones=()) -> float:
    """Learning rate at a global iteration."""
    step = float(step)
    total_steps = total_epochs * steps_per_epoch
    warmup_steps = warmup_epochs * steps_per_epoch
    if warmup_lr is None:
        warmup_lr = base_lr * 0.1

    if scheduler == "cosine":
        decay_total = max(total_steps - warmup_steps, 1)
        t_cur = step - warmup_steps
        main = lr_min + 0.5 * (base_lr - lr_min) * (
            1 + math.cos(math.pi * t_cur / decay_total))
    elif scheduler == "linear":
        main = base_lr * (1 - step / total_steps)
    elif scheduler in ("multistep", "exponential"):
        epoch = math.floor(step / steps_per_epoch)
        main = base_lr * lr_decay_rate ** math.floor(epoch / lr_decay_step)
    elif scheduler == "uneven_multistep":
        epoch = math.floor(step / steps_per_epoch)
        main = base_lr * lr_decay_rate ** sum(m <= epoch for m in milestones)
    elif scheduler == "rmsprop_step":  # per-iteration step decay
        main = base_lr * lr_decay_rate ** math.floor(
            step / (lr_decay_step * steps_per_epoch))
    else:
        raise NotImplementedError(scheduler)

    if warmup_epochs and step < warmup_steps:
        return warmup_lr + (base_lr - warmup_lr) * (step / warmup_steps)
    return main


def gumbel_temperature_at(step, *, t0, t_last, t_last_epoch, steps_per_epoch,
                          temp_scheduler="exp") -> float:
    """Gumbel-softmax temperature at a global iteration: anneals t0 ->
    t_last over ``t_last_epoch`` epochs, then holds t_last."""
    step = float(step)
    total = float(t_last_epoch * steps_per_epoch)
    if step >= total:
        return float(t_last)
    if temp_scheduler == "exp":
        alpha = (t_last / t0) ** (1.0 / total)
        return t0 * alpha ** step
    if temp_scheduler == "linear":
        return (t0 - t_last) * (1 - step / total) + t_last
    # cosine
    return 0.5 * (t0 - t_last) * (1 + math.cos(math.pi * step / total)) + t_last
