"""Plain PyTorch reference of LAUD-ResNet-50 with spatial gating at
granularity 4-4-2-1, at eval.

ResNet-50 (He et al., arXiv:1512.03385; the stride on the 3x3
convolution, as torchvision's and the LAUDNet reference's ``uni_resnet50``
have it): a 7x7 stem with BatchNorm, ReLU and a 3x3 max-pool, four stages
of 3-4-6-3 bottlenecks (1x1, 3x3, 1x1 with BatchNorm, widths 64-512 times
4 out), global average pooling and a linear classifier. LAUDNet's spatial
gating (Han et al., TPAMI 2024): before each bottleneck a masker averages
the block's input over a grid of the block's output size over the
granularity, projects it with a 1x1 convolution to a pair of logits per
cell and keeps a cell where ``keep >= skip``; the cells are upsampled to
the output resolution and multiply the residual branch after its last
BatchNorm, before the identity is added. BatchNorm uses its running
statistics (eps 1e-5).

Besides the logits the forward returns each block's densities per image:
``s3`` the kept share of the output cells, ``s2`` that of conv2's output
(the same mask, upsampled), ``s1`` that of conv1's output that conv2
reads (the mask spread by conv2's stride and its 3x3 window), which the
work of `work/laud_resnet50_spatial_4421.py` is counted from.

`centre` sets the weights' BatchNorm statistics and masker biases from a
batch of images (the benchmark's weight recipe). It imports nothing of the
port, computes in float32 with TF32 off, and takes only the weights and
images the benchmark made. ``precision='fp8'`` is the control: every
convolution and the classifier on float8 (e4m3) operands, activations
scaled per tensor and weights per output channel (the usual float8
inference recipe), the rest in float32; in training, each product's
gradient is besides rounded to float8 e5m2 (one scale a tensor) on its way
back, as the usual float8 training recipe computes the backward.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0  # the largest finite float8 e4m3 value
E5M2_MAX = 57344.0  # the largest finite float8 e5m2 value


@contextlib.contextmanager
def full_f32():
    """Float32 products and convolutions in full float32 (no TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(t: torch.Tensor, dims) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice over ``dims``,
    back in float32."""
    scale = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def blocks(cfg):
    """(name, inplanes, planes, stride, downsample, out_size, granularity)
    of every bottleneck, in order."""
    out, inplanes = [], 64
    size = cfg["image_size"] // 4
    for s, (n, planes) in enumerate(zip(cfg["depths"], cfg["stage_planes"])):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            if stride == 2:
                size //= 2
            out.append((f"layer{s + 1}_{b}", inplanes, planes, stride,
                        b == 0, size, cfg["mask_granularity"][s]))
            inplanes = planes * cfg["expansion"]
    return out


def conv(x, w, stride=1, padding=0, precision="f32"):
    if precision == "fp8":
        x, w = fp8(x, (0, 1, 2, 3)), fp8(w, (1, 2, 3))
    return F.conv2d(x, w, None, stride, padding)


class _Norms:
    """BatchNorm over the weights' running statistics; under ``centre``,
    the statistics are first set to the batch's own (mean and biased
    variance), as a recalibration of BatchNorm on data does."""

    def __init__(self, w, centre: bool):
        self.w, self.centre = w, centre

    def __call__(self, x, pre):
        w = self.w
        if self.centre:
            w[pre + "running_mean"].copy_(x.mean((0, 2, 3)))
            w[pre + "running_var"].copy_(x.var((0, 2, 3), unbiased=False))
        return F.batch_norm(x, w[pre + "running_mean"],
                            w[pre + "running_var"], w[pre + "weight"],
                            w[pre + "bias"], False, 0.0, BN_EPS)


def spread(mask, stride):
    """Where conv1's output is read by conv2 for the output cells
    ``mask`` (B, 1, h, w): at the input resolution, every pixel in the 3x3
    window of a kept output (zero-upsampled by the stride)."""
    if stride > 1:
        b, _, h, w = mask.shape
        up = torch.zeros(b, 1, h * stride, w * stride, device=mask.device)
        up[:, :, ::stride, ::stride] = mask
        mask = up
    return F.max_pool2d(mask, 3, 1, 1)


def _decide(w, pre, x, cells, centre):
    """A masker's eval decisions on the block input ``x``; under
    ``centre``, its keep bias first set so that the median cell of ``x``
    sits at the tie."""
    pooled = F.adaptive_avg_pool2d(x, cells)
    logits = torch.einsum("bchw,oc->bohw", pooled,
                          w[pre + "masker_spatial.conv.weight"].flatten(1))
    if centre:
        margin = logits[:, 0] - logits[:, 1]
        w[pre + "masker_spatial.conv.bias"][0] -= margin.median()
    bias = w[pre + "masker_spatial.conv.bias"]
    return ((logits[:, 0] + bias[0]) >= (logits[:, 1] + bias[1])
            ).float()[:, None]


def forward_rows(w, x, cfg, precision, centre=False, masks=None,
                 dense=False):
    """Logits and facts of one block of rows of NHWC ``x``. ``masks``, one
    (B, 1, cells, cells) tensor a block, are decisions to apply in place of
    the maskers' own; each block's own decision is compared with them.
    ``dense``: no maskers, every cell kept (the dense teacher)."""
    bn = _Norms(w, centre)
    x = x.permute(0, 3, 1, 2)
    x = torch.relu(bn(conv(x, w["conv1.weight"], 2, 3, precision), "bn1."))
    x = F.max_pool2d(x, 3, 2, 1)
    facts = {"s1": [], "s2": [], "s3": [], "disagree": []}
    used = []
    for i, (name, _, _, stride, ds, size, g) in enumerate(blocks(cfg)):
        pre = name + "."
        cells = size // g
        if dense:
            own = torch.ones(x.shape[0], 1, cells, cells, device=x.device)
        else:
            own = _decide(w, pre, x, cells, centre)
        mask = own if masks is None else masks[i].float()
        facts["disagree"].append((own != mask).float().sum((1, 2, 3)))
        used.append(mask)
        mask_up = mask.repeat_interleave(g, 2).repeat_interleave(g, 3)
        identity = x
        if ds:
            identity = bn(conv(x, w[pre + "downsample_conv.weight"], stride,
                               0, precision), pre + "downsample_bn.")
        y = torch.relu(bn(conv(x, w[pre + "conv1.weight"], 1, 0, precision),
                          pre + "bn1."))
        y = torch.relu(bn(conv(y, w[pre + "conv2.weight"], stride, 1,
                               precision), pre + "bn2."))
        y = bn(conv(y, w[pre + "conv3.weight"], 1, 0, precision), pre + "bn3.")
        x = torch.relu(y * mask_up + identity)
        facts["s3"].append(mask.mean((1, 2, 3)))
        facts["s2"].append(mask_up.mean((1, 2, 3)))
        facts["s1"].append(spread(mask_up, stride).mean((1, 2, 3)))
    x = x.mean((2, 3))
    wf = w["fc.weight"]
    if precision == "fp8":
        x, wf = fp8(x, (0, 1)), fp8(wf, -1)
    logits = x @ wf.t() + w["fc.bias"]
    facts = {k: torch.stack(v, 1) for k, v in facts.items()}
    facts["cells"] = torch.full_like(facts["disagree"][:, 0], sum(
        m[0].numel() for m in used))
    return logits, facts, used


@torch.no_grad()
def forward(weights, images, cfg, precision="f32", state=None, rows=64):
    """Float32 logits of NHWC ``images`` and, per image, each block's
    densities (``s1``, ``s2``, ``s3``: (B, blocks)), the cells where the
    block's own decision differs from the mask applied (``disagree``) and
    the cells in all (``cells``); ``state``, the masks applied. ``state``:
    the masks a served run decided (one (B, 1, cells, cells) tensor a
    block), applied in place of the maskers' own."""
    w = {k: v.float() for k, v in weights.items()}
    logits, facts, used = [], [], []
    with full_f32():
        for i in range(0, images.shape[0], rows):
            forced = (None if state is None
                      else [m[i:i + rows] for m in state])
            lg, f, u = forward_rows(w, images[i:i + rows].float(), cfg,
                                    precision, masks=forced)
            logits.append(lg)
            facts.append(f)
            used.append(u)
    info = {k: torch.cat([f[k] for f in facts]) for k in facts[0]}
    info["state"] = [torch.cat(ms) for ms in zip(*used)]
    return torch.cat(logits), info


@torch.no_grad()
def centre(weights, images, cfg, dense=False) -> None:
    """Sets, block after block in one forward over ``images``, every
    BatchNorm's running statistics to the batch's and every masker's keep
    bias so that the median cell sits at the tie (``weights`` in place;
    float32 weights). ``dense``: the dense teacher's weights."""
    with full_f32():
        forward_rows(weights, images.float(), cfg, "f32", centre=True,
                     dense=dense)


# --- training ---------------------------------------------------------------
#
# LAUDNet's training step (the reference's ``train.py`` with its
# ``finetune`` recipe): the dense teacher's eval forward, the student's
# forward with straight-through Gumbel gates at the step's temperature and
# BatchNorm on the batch's statistics, the loss ``lambda_act * sparsity +
# CE + alpha_kd * KD`` with the ``bounds`` sparsity criterion, its
# gradients, and SGD with Nesterov momentum and weight decay folded into
# the gradient.


def _train_norm(x, w, pre):
    """BatchNorm on the batch's mean and biased variance (E[x^2] - E[x]^2,
    at least 0)."""
    mean = x.mean((0, 2, 3))
    var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
    scale = torch.rsqrt(var + BN_EPS) * w[pre + "weight"]
    return ((x - mean[:, None, None]) * scale[:, None, None]
            + w[pre + "bias"][:, None, None])


class _E5M2Grad(torch.autograd.Function):
    """The identity, whose gradient is rounded to float8 e5m2 (one scale a
    tensor) on its way back: a product's backward on float8 gradients, as
    the usual float8 training recipe computes it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        scale = g.abs().amax().clamp_min(1e-30) / E5M2_MAX
        return (g / scale).to(torch.float8_e5m2).float() * scale


def _back(y, precision):
    return _E5M2Grad.apply(y) if precision == "fp8" else y


def _st(x, precision):
    """A float8 operand with the gradient passed straight through."""
    if precision != "fp8":
        return x
    dims = tuple(range(x.dim())) if x.requires_grad else (1, 2, 3)
    return x + (fp8(x.detach(), dims) - x.detach())


def _tconv(x, w, stride=1, padding=0, precision="f32"):
    wq = w + (fp8(w.detach(), (1, 2, 3)) - w.detach()) \
        if precision == "fp8" else w
    return _back(F.conv2d(_st(x, precision), wq, None, stride, padding),
                 precision)


def student_train_forward(w, x, cfg, noise, tau, masks=None,
                          precision="f32"):
    """The student's training forward on NHWC ``x``. ``noise``: the Gumbel
    draws of the step, one (B, cells, cells, 2, 1) tensor a block (the
    port's layout); ``masks``: the hard decisions to apply in place of the
    gates' own (their gradients stay the soft sample's). Returns the
    logits, the per-block ``flops_perc``, the ``flops``, per block the
    decisions taken, then the count of cells where the gate's own decision
    differs with the widest gate margin among them (over the root mean
    square margin of its block), and the densities per image."""
    exp = cfg["expansion"]
    x = x.permute(0, 3, 1, 2)
    x = _tconv(x, w["conv1.weight"], 2, 3, precision)
    x = torch.relu(_train_norm(x, w, "bn1."))
    flops = 3.0 * x.shape[1] * x.shape[2] * x.shape[3] * 49
    x = F.max_pool2d(x, 3, 2, 1)
    flops = flops + x.shape[1] * x.shape[2] * x.shape[3] * 9
    perc, taken, disagree, flip = [], [], 0.0, 0.0
    dens = {"s1": [], "s2": [], "s3": []}
    for i, (name, inplanes, planes, stride, ds, size, g) in enumerate(
            blocks(cfg)):
        pre = name + "."
        cells = size // g
        pooled = F.adaptive_avg_pool2d(x, cells)
        pair = torch.einsum("bchw,oc->bohw", pooled, w[
            pre + "masker_spatial.conv.weight"].flatten(1)) + w[
            pre + "masker_spatial.conv.bias"][None, :, None, None]
        gumbel = noise[i][..., 0].permute(0, 3, 1, 2)
        soft = torch.softmax((pair + gumbel) / tau, dim=1)
        own = (soft[:, 0] >= soft[:, 1]).float()[:, None]
        hard = own if masks is None else (masks[i] > 0.5).float()
        flips = (own != hard).float()
        disagree += float(flips.sum())
        margin = ((pair + gumbel)[:, :1] - (pair + gumbel)[:, 1:]).detach()
        rms = float(margin.square().mean().sqrt().clamp_min(1e-30))
        flip = max(flip, float((margin.abs() * flips).amax()) / rms)
        taken.append(hard)
        mask = hard + soft[:, :1] - soft[:, :1].detach()
        mask_up = mask.repeat_interleave(g, 2).repeat_interleave(g, 3)
        s3 = mask.mean()
        hard_up = hard.repeat_interleave(g, 2).repeat_interleave(g, 3)
        s2 = hard_up.mean()
        spread_up = spread(hard_up, stride)
        s1 = spread_up.mean()
        dens["s3"].append(hard.mean((1, 2, 3)))
        dens["s2"].append(hard_up.mean((1, 2, 3)))
        dens["s1"].append(spread_up.mean((1, 2, 3)))
        width, out = planes, planes * exp
        in_hw, out_hw = x.shape[2] * x.shape[3], size * size
        masker = inplanes * cells * cells + 3 * inplanes * cells * cells
        c1, c2, c3 = inplanes * width, width * width * 9, width * out
        dense = masker + c1 * in_hw + c2 * out_hw + c3 * out_hw
        sparse = masker + c1 * in_hw * s1 + c2 * out_hw * s2 \
            + c3 * out_hw * s3
        identity = x
        if ds:
            dsf = inplanes * out * out_hw
            dense, sparse = dense + dsf, sparse + dsf
            identity = _train_norm(_tconv(
                x, w[pre + "downsample_conv.weight"], stride, 0, precision),
                w, pre + "downsample_bn.")
        y = torch.relu(_train_norm(_tconv(x, w[pre + "conv1.weight"], 1, 0,
                                          precision), w, pre + "bn1."))
        y = torch.relu(_train_norm(_tconv(y, w[pre + "conv2.weight"],
                                          stride, 1, precision), w,
                                   pre + "bn2."))
        y = _train_norm(_tconv(y, w[pre + "conv3.weight"], 1, 0, precision),
                        w, pre + "bn3.")
        x = torch.relu(y * mask_up + identity)
        flops = flops + sparse
        perc.append(sparse / dense)
    x = x.mean((2, 3))
    flops = flops + x.shape[1]
    wf = w["fc.weight"]
    logits = _back(_st(x, precision) @ (
        wf + (fp8(wf.detach(), -1) - wf.detach())
        if precision == "fp8" else wf).t(), precision) + w["fc.bias"]
    flops = flops + x.shape[1] * cfg["num_labels"]
    facts = {k: torch.stack(v, 1).detach() for k, v in dens.items()}
    return (logits, torch.stack(perc), flops, taken, (disagree, flip),
            facts)


def teacher_forward(w, x, cfg, rows=64):
    """The dense teacher's eval logits (every cell kept, BatchNorm on its
    running statistics)."""
    out = []
    for i in range(0, x.shape[0], rows):
        out.append(forward_rows(w, x[i:i + rows].float(), cfg, "f32",
                                dense=True)[0])
    return torch.cat(out)


def lr_at(step, r):
    """The cosine schedule without warm-up, from ``base_lr`` to ``lr_min``
    over ``num_epochs * steps_per_epoch`` steps."""
    total = r["num_epochs"] * r["steps_per_epoch"]
    return r["lr_min"] + 0.5 * (r["base_lr"] - r["lr_min"]) * (
        1 + math.cos(math.pi * step / total))


def temperature_at(step, r):
    """The Gumbel temperature, annealed exponentially from ``t0`` to
    ``t_last`` over ``t_last_epoch`` epochs."""
    total = r["t_last_epoch"] * r["steps_per_epoch"]
    if step >= total:
        return r["t_last"]
    return r["t0"] * (r["t_last"] / r["t0"]) ** (step / total)


def loss_of(logits, teacher_logits, labels, perc, flops, step, r):
    """``lambda_act * sparsity + CE + alpha_kd * KD``: the sparsity loss the
    ``bounds`` criterion (each block's FLOPs share held between bounds
    that relax cosine-squared from the target over the first third of the
    epochs, and the network's share pulled to the target), plain CE, and
    KL(teacher || student) at temperature ``t_kd`` times its square."""
    epoch = step / r["steps_per_epoch"]
    progress = min(max(epoch / (0.33 * r["num_epochs"]), 0.0), 1.0)
    progress = math.cos(progress * math.pi / 2) ** 2
    target = r["target_rate"]
    upper, lower = 1.0 - progress * (1.0 - target), progress * target
    blocks_ = ((perc - upper).clamp_min(0) ** 2
               + (lower - perc).clamp_min(0) ** 2).mean()
    sparsity = blocks_ + (flops / r["full_flops"] - target) ** 2
    ce = -F.log_softmax(logits, -1).gather(1, labels[:, None]).mean()
    t = r["t_kd"]
    p_t = F.softmax(teacher_logits / t, -1)
    kd = (p_t * (F.log_softmax(teacher_logits / t, -1)
                 - F.log_softmax(logits / t, -1))).sum(-1).mean() * t * t
    return r["lambda_act"] * sparsity + ce + r["alpha_kd"] * kd


def train_steps(weights, teacher, batches, cfg, recipe, state=None,
                precision="f32"):
    """Follows the first ``len(batches)`` training steps from ``weights``
    (the student's f32 masters, BatchNorm statistics included) and
    ``teacher`` (the dense teacher's). ``batches``: (images, labels,
    noise) of each step; ``state``: the hard gate decisions a served run
    took at each step, applied in place of the gates' own. Returns each
    step's loss, the first gradient as SGD takes it (weight decay added),
    the parameters after the last step, the decisions taken, each step's
    densities per image (``info``, as `forward`'s), and of the first step,
    where both sides start from the same state, the share of decisions
    where the gates' own differed (``mask_disagree``) and the widest gate
    margin among those, over the root mean square margin of its block
    (``gate_flip_margin``)."""
    r = recipe
    with full_f32():
        params = {k: v.detach().float().clone().requires_grad_(True)
                  for k, v in weights.items()
                  if not k.endswith(("running_mean", "running_var"))}
        stats = {k: v.float() for k, v in weights.items()
                 if k.endswith(("running_mean", "running_var"))}
        tw = {k: v.float() for k, v in teacher.items()}
        momentum = {}
        losses, first, taken, infos = [], None, [], []
        disagree = cells = flip_margin = 0.0
        for step, (x, labels, noise) in enumerate(batches):
            with torch.no_grad():
                t_logits = teacher_forward(tw, x, cfg)
            logits, perc, flops, hard, dis, facts = student_train_forward(
                {**params, **stats}, x.float(), cfg, noise,
                temperature_at(step, r),
                None if state is None else state[step], precision)
            loss = loss_of(logits, t_logits, labels.long(), perc, flops,
                           step, r)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            taken.append(hard)
            infos.append(facts)
            if step == 0:  # later steps start from states that differ
                disagree, flip_margin = dis
                cells = sum(h.numel() for h in hard)
            lr = lr_at(step, r)
            with torch.no_grad():
                for (k, p), grad in zip(params.items(), grads):
                    d = grad + r["weight_decay"] * p
                    if k in momentum:
                        momentum[k].mul_(r["momentum"]).add_(d)
                    else:
                        momentum[k] = d.clone()
                    if step == 0:
                        first = first or {}
                        first[k] = d.clone()
                    p.sub_(lr * (d + r["momentum"] * momentum[k]))
        after = {k: p.detach() for k, p in params.items()}
    return {"losses": losses, "first_grad": first, "after": after,
            "masks": taken, "info": infos,
            "mask_disagree": disagree / max(cells, 1.0),
            "gate_flip_margin": flip_margin}
