"""LAUD-ResNet-50, spatial gating 4-4-2-1 (the flagship): the weights made
from the seed and the port's entries built on them.

Weights: every convolution He-normal over its fan-out (the model's own
initialiser), the classifier normal at 1/sqrt(fan_in), BatchNorm scales
about 1 (the last of each residual branch about ``residual_scale``, as a
trained network's branches are small beside the identity) and shifts
small and random, all cut at two standard deviations
and drawn on the card from one generator in one call, in float32 (the
masters; the convolutions compute in ``compute_dtype``). Each masker's
logit kernels are +v and -v, v at unit scale and summing to zero over the
channels, so the common level of the features cancels. Then the
reference's forward over ``centre_images`` seeded images sets, block after
block (on images made as the cell's traffic makes them), the BatchNorm
statistics to the batch's and each masker's keep bias
so that the median cell sits at the tie: about half of the cells close.
"""

from __future__ import annotations

import math

import torch

from h100_bench import images


def shapes(cfg, blocks) -> dict:
    """name -> shape of every weight and BatchNorm statistic, under the
    port's names; ``blocks`` is the reference's list of bottlenecks."""
    exp = cfg["expansion"]

    def bn(pre, c):
        return {pre + k: (c,) for k in ("weight", "bias", "running_mean",
                                         "running_var")}

    out = {"conv1.weight": (64, 3, 7, 7), **bn("bn1.", 64)}
    for name, inplanes, planes, _, ds, _, _ in blocks:
        pre = name + "."
        out.update({pre + "masker_spatial.conv.weight": (2, inplanes, 1, 1),
                    pre + "masker_spatial.conv.bias": (2,),
                    pre + "conv1.weight": (planes, inplanes, 1, 1),
                    **bn(pre + "bn1.", planes),
                    pre + "conv2.weight": (planes, planes, 3, 3),
                    **bn(pre + "bn2.", planes),
                    pre + "conv3.weight": (planes * exp, planes, 1, 1),
                    **bn(pre + "bn3.", planes * exp)})
        if ds:
            out.update({pre + "downsample_conv.weight": (planes * exp,
                                                         inplanes, 1, 1),
                        **bn(pre + "downsample_bn.", planes * exp)})
    last = cfg["stage_planes"][-1] * exp
    out.update({"fc.weight": (cfg["num_labels"], last),
                "fc.bias": (cfg["num_labels"],)})
    return out


def _draw(run, table, salt) -> dict:
    """Every weight of ``table`` from one draw of the seed, scaled by the
    recipe; masker biases and BatchNorm statistics zero (set by
    `_centre`)."""
    rec = run.config["weights"]
    total = sum(math.prod(s) for s in table.values())
    g = torch.Generator(run.device).manual_seed(run.sub_seed(salt))
    flat = torch.randn(total, generator=g, device=run.device).clamp_(-2, 2)
    out, at = {}, 0
    with torch.no_grad():
        for name, shape in table.items():
            n = math.prod(shape)
            w = flat[at:at + n].view(shape)
            at += n
            leaf = name.rsplit(".", 1)[-1]
            if "masker" in name and leaf == "weight":
                v = w[0, :, 0, 0]
                v -= v.mean()
                w[1] = -w[0]
            elif "masker" in name or leaf in ("running_mean", "running_var"):
                w.zero_()
            elif leaf == "weight" and len(shape) == 4:
                w.mul_(math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])))
            elif leaf == "weight" and len(shape) == 2:
                w.mul_(1 / math.sqrt(shape[1]))
            elif leaf == "weight":   # BatchNorm scale
                w.mul_(rec["norm_scale"]).add_(1.0)
                if ".bn3." in name:  # the residual branch's last
                    w.mul_(rec["residual_scale"])
            else:                    # BatchNorm shift, classifier bias
                w.mul_(rec["small_scale"])
            out[name] = w
    return out


def _centre(run, weights, dense=False) -> dict:
    cfg = run.config
    g = torch.Generator(run.device).manual_seed(run.sub_seed(2))
    x = images.make(run.traffic.get("image", {}), cfg["image_size"],
                    cfg["weights"]["centre_images"], g, run.device)
    run.reference.centre(weights, x, cfg, dense=dense)
    return weights


def make_weights(run) -> dict:
    cfg = run.config
    return _centre(run, _draw(run, shapes(cfg, run.reference.blocks(cfg)),
                              salt=0))


def make_teacher_weights(run) -> dict:
    """The dense teacher's (ResNet-50, no maskers): the same recipe from
    another draw, its BatchNorm statistics set on the same images."""
    cfg = run.config
    table = {k: v for k, v in shapes(cfg, run.reference.blocks(cfg)).items()
             if "masker" not in k}
    return _centre(run, _draw(run, table, salt=3), dense=True)


def model(run, weights):
    """The port's LAUD-ResNet as ``entry.py::flagship`` builds it (at the
    configuration's sizes), its f32 masters loaded with ``weights``."""
    from laudnet_tpu_torch.models.laud_resnet import LAUDResNet

    cfg = run.config
    m = LAUDResNet(layers=cfg["depths"], num_classes=cfg["num_labels"],
                   input_size=cfg["image_size"],
                   dyn_mode=tuple(cfg["dyn_mode"]),
                   mask_spatial_granularity=tuple(cfg["mask_granularity"]),
                   channel_masker=("MLP",) * 4,
                   channel_masker_layers=(1,) * 4, device=run.device,
                   compute_dtype=getattr(torch, cfg["compute_dtype"]))
    m.load_state_dict(weights)
    return m


class gate_decisions:
    """Within the block, every masker of ``model`` appends the mask it
    decided (the forward value, (B, 1, cells, cells)) to ``masks``."""

    def __init__(self, model):
        self.model, self.masks, self.hooks = model, [], []

    def __enter__(self):
        for blocks in self.model.stages():
            for blk in blocks:
                self.hooks.append(blk.masker_spatial.register_forward_hook(
                    lambda m, args, out: self.masks.append(
                        out[0].detach().permute(0, 3, 1, 2).float())))
        return self.masks

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def decisions(serve):
    """While open, each call of the serving entry appends to the list it
    yields the mask each masker decided, block after block: the decisions
    the reference follows (views, nothing computed on the card)."""
    return gate_decisions(serve.model)


def build_train(run, weights, teacher_weights, noise):
    """The port's training step on the flagship (f32 masters, computing in
    ``compute_dtype``), the dense ResNet-50 teacher, SGD with Nesterov
    momentum over the backbone and masker groups, and the recipe of the
    configuration's ``train``; Gumbel noise from ``noise``. Returns
    ``(train_step, state)``."""
    from laudnet_tpu_torch.models.resnet import ResNet
    from laudnet_tpu_torch.train.optim import make_sgd
    from laudnet_tpu_torch.train.trainer import (TrainConfig, TrainState,
                                                 make_train_step)

    cfg, r = run.config, run.config["train"]
    student = model(run, weights)
    teacher = ResNet(layers=cfg["depths"], num_classes=cfg["num_labels"],
                     device=run.device,
                     compute_dtype=getattr(torch, cfg["compute_dtype"]))
    teacher.load_state_dict(teacher_weights)
    teacher.requires_grad_(False)
    tcfg = TrainConfig(
        num_epochs=r["num_epochs"], steps_per_epoch=r["steps_per_epoch"],
        base_lr=r["base_lr"], lr_min=r["lr_min"], scheduler="cosine",
        warmup_epochs=0, t0=r["t0"], t_last=r["t_last"],
        t_last_epoch=r["t_last_epoch"], temp_scheduler="exp",
        lambda_act=r["lambda_act"], alpha_kd=r["alpha_kd"], t_kd=r["t_kd"],
        label_smooth=0.0, target_rate=r["target_rate"],
        full_flops=r["full_flops"], sparsity_criterion="bounds",
        dyn_mode=tuple(cfg["dyn_mode"]))
    optimizer = make_sgd(student, momentum=r["momentum"], nesterov=True,
                         weight_decay=r["weight_decay"])
    step = make_train_step(student, teacher, optimizer, tcfg, noise=noise)
    return step, TrainState(step=0, model=student, optimizer=optimizer)


def build_serve(run, weights):
    """The port's `ServingEngine` over the flagship, uncalibrated: the
    exact dense-masked eval forward."""
    from laudnet_tpu_torch.infer.engine import ServingEngine

    return ServingEngine(model(run, weights).eval(),
                         temperature=run.config["temperature"],
                         batch_size=run.traffic["batch"])
