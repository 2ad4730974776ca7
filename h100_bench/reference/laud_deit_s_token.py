"""Plain PyTorch reference of LAUD-DeiT-S served with token selection.

The model as LAUDNet's token paradigm describes it on a DeiT backbone
(Touvron et al., arXiv:2012.12877): a 16 x 16 patch embedding, a class
token and position embeddings, then pre-norm transformer blocks (LayerNorm
with eps 1e-6, multi-head attention, erf GELU MLP), a final LayerNorm and
the class head on the class token. Before each block a token gate compares
two logits of a linear head on each token (``keep >= drop``, the class
token always kept); the gates compose over depth, a gated-off token is no
key of the attention and its residual update is dropped. Where the block's
capacity is below the tokens carried, the carried tokens are ranked
(kept before dropped, then by the sigmoid of the gate's margin, the class
token first, ties to the lower index) and the best ``capacity`` go on.
Capacities are ``int(capacity * (N + 1))``, at least 2, snapped down to a
multiple of 8, or of 128 where that loses under a tenth.

It imports nothing of the port, computes in float32 with TF32 off, and
takes only the weights and images the benchmark made. ``precision='fp8'``
is the control: every product of the body, the patch embedding and the
head on float8 (e4m3) operands, activations scaled per tensor and weights
per output channel (the usual float8 inference recipe), the rest in
float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
FP8_MAX = 448.0  # the largest finite float8 e4m3 value
# the margin from which a float32 sigmoid rounds to 1: log(2 ** 24)
SATURATED = 24 * math.log(2.0)


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
    """``t`` rounded to float8 e4m3 with one scale per slice over ``dims``
    (the slice's largest magnitude maps to 448), back in float32."""
    scale = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x, w, b, precision):
    if precision == "fp8":
        x, w = fp8(x, tuple(range(x.dim()))), fp8(w, -1)
    return x @ w.t() + b


def snap(k: int) -> int:
    """A capacity snapped down: a multiple of 8, or of 128 where that keeps
    more than nine tenths of the multiple of 8."""
    k8 = max(8, (k // 8) * 8)
    k128 = (k // 128) * 128
    return k128 if k128 >= 128 and (k8 - k128) / k8 < 0.10 else k8


def token_counts(cfg) -> list:
    """The token count each block runs at."""
    n = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    cur, counts = n, []
    for cap in cfg["token_capacity"]:
        k = min(max(2, int(cap * n)), cur)
        if cfg["snap_capacities"] and k < cur:
            k = min(max(2, snap(k)), cur)
        cur = k
        counts.append(cur)
    return counts


def attention(qkv, keep, heads):
    """Multi-head attention over the kept keys; ``keep`` (B, L) 0/1."""
    b, l, three_d = qkv.shape
    d = three_d // 3
    q, k, v = qkv.reshape(b, l, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * (d // heads) ** -0.5
    s = s.masked_fill(keep[:, None, None, :] == 0, float("-inf"))
    return (s.softmax(-1) @ v).transpose(1, 2).reshape(b, l, d)


def forward_rows(w, x, cfg, precision, forced=None, centre=False):
    """Logits of one block of rows of NHWC f32 images ``x``, the facts of
    the gates (``forward``'s ``disagree``, ``cells`` and ``flip_margin``)
    and the gathers taken. ``forced``: for each block that gathers, the
    tokens a served run kept (B, k) and their masks (B, k), applied in
    place of the block's own selection. ``centre``: each gate of
    ``gated_layers`` first gets the keep bias that puts the median margin
    of the tokens reaching it kept at the tie (``w`` in place)."""
    b = x.shape[0]
    p = cfg["patch_size"]
    d, heads = cfg["hidden_size"], cfg["num_heads"]
    # patch embedding as a product over each patch's (c, i, j) pixels
    s = x.shape[1] // p
    patches = (x.permute(0, 3, 1, 2).reshape(b, 3, s, p, s, p)
               .permute(0, 2, 4, 1, 3, 5).reshape(b, s * s, 3 * p * p))
    t = linear(patches, w["patch_embed.weight"].reshape(d, -1),
               w["patch_embed.bias"], precision)
    t = torch.cat([w["cls_token"].expand(b, 1, d), t], 1) + w["pos_embed"]
    keep = torch.ones(t.shape[:2], device=x.device)
    counts = token_counts(cfg)
    disagree = torch.zeros(b, device=x.device)
    decided = torch.zeros(b, device=x.device)
    flip_margin = torch.zeros(b, device=x.device)
    gathers, taken = iter(forced or ()), []
    for i in range(cfg["num_hidden_layers"]):
        pre = f"blocks.{i}."
        logits = t @ w[pre + "token_policy.weight"].t() + w[
            pre + "token_policy.bias"]
        if centre and i in cfg["gated_layers"]:
            reach = keep.clone()
            reach[:, 0] = 0.0
            margin = logits[..., 0] - logits[..., 1]
            w[pre + "token_policy.bias"][0] -= margin[reach > 0].median()
            logits = t @ w[pre + "token_policy.weight"].t() + w[
                pre + "token_policy.bias"]
        gate = (logits[..., 0] >= logits[..., 1]).float()
        gate[:, 0] = 1.0
        carried = keep
        keep = keep * gate
        k = counts[i]
        if k < t.shape[1]:
            margin = logits[..., 0] - logits[..., 1]
            rank = torch.sigmoid(margin) + 2 * keep
            rank[:, 0] += 4.0
            order = torch.sort(rank, dim=1, descending=True,
                               stable=True).indices
            idx = order[:, :k]
            kept = torch.gather(keep, 1, idx)
            if forced is not None:
                own = torch.zeros_like(keep).scatter_(1, idx, kept)
                idx, kept = next(gathers)
                idx, kept = idx.long(), kept.float()
                chosen = torch.zeros_like(keep).scatter_(1, idx, kept)
                # over the tokens that reached the gate kept (the class
                # token aside): those the served call carried on as kept,
                # against those the reference's own gate and selection
                # keep, and each one's distance from the reference's
                # boundary: the gate's tie or, where the capacity binds,
                # the midpoint of the last margin taken and the first left
                # out. The ranking reads the margins through a float32
                # sigmoid, which is 1 from SATURATED on: margins past it
                # tie, and their order is the tokens' own
                live = carried.clone()
                live[:, 0] = 0.0
                flips = (chosen != own).float() * live
                near = margin.clamp(max=SATURATED)
                edge = torch.gather(near, 1, order[:, k - 1:k + 1])
                binds = torch.gather(keep, 1, order[:, k:k + 1])[:, 0] > 0
                tie = torch.where(binds, edge.mean(1),
                                  torch.zeros_like(edge[:, 0]))
                rms = ((margin.square() * live).sum(1)
                       / live.sum(1).clamp_min(1)).sqrt().clamp_min(1e-30)
                dist = (near - tie[:, None]).abs() * flips
                disagree += flips.sum(1)
                decided += live.sum(1)
                flip_margin = torch.maximum(flip_margin, dist.amax(1) / rms)
            taken.append((idx, kept))
            t = torch.gather(t, 1, idx[..., None].expand(-1, -1, d))
            keep = kept
        y = F.layer_norm(t, (d,), w[pre + "norm1.weight"],
                         w[pre + "norm1.bias"], LN_EPS)
        y = attention(linear(y, w[pre + "qkv.weight"], w[pre + "qkv.bias"],
                             precision), keep, heads)
        y = linear(y, w[pre + "proj.weight"], w[pre + "proj.bias"], precision)
        t = t + y * keep[..., None]
        y = F.layer_norm(t, (d,), w[pre + "norm2.weight"],
                         w[pre + "norm2.bias"], LN_EPS)
        y = F.gelu(linear(y, w[pre + "fc1.weight"], w[pre + "fc1.bias"],
                          precision))
        y = linear(y, w[pre + "fc2.weight"], w[pre + "fc2.bias"], precision)
        t = t + y * keep[..., None]
    t = F.layer_norm(t[:, 0], (d,), w["norm.weight"], w["norm.bias"], LN_EPS)
    return (linear(t, w["head.weight"], w["head.bias"], precision),
            (disagree, decided, flip_margin), taken)


@torch.no_grad()
def forward(weights, images, cfg, precision="f32", state=None, rows=128):
    """Float32 logits of ``images`` (B, H, W, 3) and, per image, the token
    count of each block (``tokens``, (B, depth)). ``state``: the gathers a
    served run decided (`forward_rows`'s ``forced``), which the reference
    then follows; per image, ``cells`` counts the tokens that reached a
    gathering gate kept (the class token aside), ``disagree`` those of
    them that the served call carried on otherwise than the reference's
    own gate decides, and ``flip_margin`` is the widest gate margin among
    those, over the root mean square margin of its image's tokens at that
    gate (0 where none differs)."""
    w = {k: v.float() for k, v in weights.items()}
    state = state or None  # the model's own graph reads no gathers
    out, facts, taken = [], [], []
    with full_f32():
        for i in range(0, images.shape[0], rows):
            forced = (None if state is None else
                      [(a[i:i + rows], m[i:i + rows]) for a, m in state])
            lg, f, tk = forward_rows(w, images[i:i + rows].float(), cfg,
                                     precision, forced)
            out.append(lg)
            facts.append(f)
            taken.append(tk)
    b = images.shape[0]
    counts = token_counts(cfg)
    info = {"tokens": torch.tensor(counts, dtype=torch.float32
                                   ).expand(b, -1),
            "state": [(torch.cat(a), torch.cat(m)) for a, m in
                      (zip(*layer) for layer in zip(*taken))]}
    for key, part in zip(("disagree", "cells", "flip_margin"), zip(*facts)):
        info[key] = torch.cat(part)
    return torch.cat(out), info


@torch.no_grad()
def centre(weights, images, cfg) -> None:
    """Sets the keep bias of every gate of ``gated_layers``, layer after
    layer in one forward over ``images``, so that the median margin of the
    tokens that reach it kept sits at the tie (``weights`` in place, in
    their own type)."""
    w = {k: v.float() for k, v in weights.items()}
    with full_f32():
        forward_rows(w, images.float(), cfg, "f32", centre=True)
    for i in cfg["gated_layers"]:
        name = f"blocks.{i}.token_policy.bias"
        weights[name].copy_(w[name])
