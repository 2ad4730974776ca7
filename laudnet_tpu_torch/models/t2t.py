"""Tokens-to-Token (T2T) stem with performer attention (counterpart of
`laudnet_tpu/models/t2t.py`).

Two soft-split (unfold) + token-performer stages and a final projection
turn a 224x224 image into the 14x14 token grid the LAUD trunk gates. The
token performer is linear attention with positive random features
(exp(w^T x - |x|^2 / 2)); the feature matrix ``w`` is fixed, never trained
and never re-drawn when weights are carried across.

Images and maps are NHWC (B, H, W, C) as in the JAX package. `unfold`
emits patch rows in (ki, kj, c) order, NOT `torch.nn.Unfold`'s
channel-major order, so Dense kernels carry over unpermuted. All stock
PyTorch: the JAX package computes the stem outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.device import resolve_device

LN_EPS = 1e-6  # flax's LayerNorm default


def t2t_stem_flops(embed_dim: int, token_dim: int = 64) -> float:
    """Analytic multiply-adds of the T2T stem (dense, never gated)."""

    def performer(l, din, d):
        m = d // 2
        return l * (3 * din * d + 2 * d * m  # kqv + q/k random features
                    + 2 * d * m + m  # kptv, qp@kptv, denom
                    + d * d  # proj
                    + 2 * d * d)  # mlp

    return float(
        performer(56 * 56, 147, token_dim)
        + performer(28 * 28, 9 * token_dim, token_dim)
        + 196 * 9 * token_dim * embed_dim
    )


def unfold(x, kernel: int, stride: int, padding: int):
    """(B, H, W, C) -> ((B, L, k*k*C) patches, (out_h, out_w)); a patch row
    is ordered (ki, kj, c)."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, padding, padding, padding, padding))
    out_h = (h + 2 * padding - kernel) // stride + 1
    out_w = (w + 2 * padding - kernel) // stride + 1
    patches = [x[:, ki:ki + out_h * stride:stride,
                 kj:kj + out_w * stride:stride, :]
               for ki in range(kernel) for kj in range(kernel)]
    out = torch.cat(patches, dim=-1)
    return out.reshape(b, out_h * out_w, kernel * kernel * c), (out_h, out_w)


def _performer_attention(kqv, w, m: int):
    """Linear attention with positive random features over a (B, L, 3d)
    kqv projection (split order k, q, v). Returns ``(v, attn)``."""
    k, q, v = kqv.chunk(3, dim=-1)

    def prm_exp(t):
        xd = (t ** 2).sum(-1, keepdim=True) / 2.0
        return torch.exp(t @ w.t() - xd) / m ** 0.5

    kp, qp = prm_exp(k), prm_exp(q)  # (B, L, m)
    denom = qp @ kp.sum(dim=1)[:, :, None]  # (B, L, 1)
    kptv = torch.einsum("bld,blm->bdm", v, kp)
    attn = torch.einsum("blm,bdm->bld", qp, kptv) / (denom + 1e-8)
    return v, attn


class TokenPerformer(nn.Module):
    """Performer (linear-attention) token transformer block from ``in_dim``
    features to ``dim``; the skip rides on the value stream."""

    def __init__(self, in_dim: int, dim: int, kernel_ratio: float = 0.5, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.dim = dim
        self.m = int(dim * kernel_ratio)
        self.norm1 = nn.LayerNorm(in_dim, eps=LN_EPS, **kw)
        self.kqv = nn.Linear(in_dim, 3 * dim, **kw)
        # fixed random features: orthonormal rows * sqrt(m) at init
        self.w = nn.Parameter(torch.empty(self.m, dim, **kw),
                              requires_grad=False)
        self.proj = nn.Linear(dim, dim, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.fc1 = nn.Linear(dim, dim, **kw)
        self.fc2 = nn.Linear(dim, dim, **kw)

    def forward(self, x):
        v, attn = _performer_attention(self.kqv(self.norm1(x)), self.w,
                                       self.m)
        x = v + self.proj(attn)
        h = F.gelu(self.fc1(self.norm2(x)), approximate="none")
        return x + self.fc2(h)


class T2TStem(nn.Module):
    """Two unfold + performer stages and a projection:
    (B, 224, 224, C) -> (B, 196, embed_dim)."""

    def __init__(self, token_dim: int = 64, embed_dim: int = 448,
                 in_chans: int = 3, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.token_dim, self.embed_dim = token_dim, embed_dim
        self.attn1 = TokenPerformer(49 * in_chans, token_dim, **kw)
        self.attn2 = TokenPerformer(9 * token_dim, token_dim, **kw)
        self.project = nn.Linear(9 * token_dim, embed_dim, **kw)

    def forward(self, images):
        b = images.shape[0]
        t, _ = unfold(images, 7, 4, 2)  # (B, 56*56, 147)
        t = self.attn1(t).reshape(b, 56, 56, self.token_dim)
        t, _ = unfold(t, 3, 2, 1)  # (B, 28*28, 9*token_dim)
        t = self.attn2(t).reshape(b, 28, 28, self.token_dim)
        t, _ = unfold(t, 3, 2, 1)  # (B, 14*14, 9*token_dim)
        return self.project(t)


# --- conv-folded stem (the serving path) -------------------------------------

def _conv_weight(weight, k: int, c: int):
    """A Linear weight (dout, k*k*c) over (ki, kj, c)-ordered patch rows as
    the OIHW weight of the equal k x k convolution."""
    return weight.reshape(weight.shape[0], k, k, c).permute(0, 3, 1, 2)


def _folded_unfold_ln_dense(xmap, norm1, dense, k: int, s: int, pad: int,
                            eps: float = LN_EPS):
    """unfold(k, s, pad) -> LayerNorm -> Linear, folded into convolutions
    of the raw NHWC map. For a patch row u, LayerNorm + Linear is
    ``((u - mu) / sqrt(var + eps)) @ (gamma * W) + (beta @ W + b)`` with
    per-patch scalars mu and var: ``u @ (gamma * W)`` is a convolution with
    the weight reshaped to (dout, c, k, k), and mu and E[u^2] are
    one-channel convolutions with an all-ones kernel, so the (B, L, k*k*c)
    patch tensor never materialises. LN statistics stay f32."""
    c = xmap.shape[-1]
    din = k * k * c
    gamma = norm1.weight.float()
    beta = norm1.bias.float()
    w = dense.weight.float()  # (dout, din)
    wg = w * gamma[None, :]

    def conv(z, kern):
        return F.conv2d(z, kern.to(z.dtype), stride=s, padding=pad)

    xc = xmap.permute(0, 3, 1, 2)  # NCHW view
    y = conv(xc, _conv_weight(wg, k, c)).float()
    xf = xc.float()
    ones = torch.ones((1, c, k, k), dtype=torch.float32, device=xmap.device)
    mu = conv(xf, ones) / din
    ex2 = conv(xf * xf, ones) / din
    inv = torch.rsqrt((ex2 - mu * mu).clamp_min(0.0) + eps)
    const = w @ beta + dense.bias.float()
    out = (y - mu * wg.sum(1)[:, None, None]) * inv + const[:, None, None]
    return out.to(xmap.dtype).permute(0, 2, 3, 1)  # NHWC


def _performer_tail(p: TokenPerformer, kqv):
    """`TokenPerformer.forward` from its kqv projection on, in kqv's dtype
    with norm2 in f32."""
    dt = kqv.dtype

    def lin(m, t):
        return t @ m.weight.to(dt).t() + m.bias.to(dt)

    v, attn = _performer_attention(kqv, p.w.to(dt), p.m)
    x = v + lin(p.proj, attn)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + LN_EPS) * p.norm2.weight.float()
         + p.norm2.bias.float()).to(dt)
    h = F.gelu(lin(p.fc1, y), approximate="none")
    return x + lin(p.fc2, h)


def t2t_stem_conv_apply(stem: T2TStem, images):
    """Conv-folded forward of a `T2TStem`, the serving path of
    `infer/fused_vit.py::build_fused_vit` for ``stem='t2t'``. Equal to
    ``stem(images)`` up to f32 reassociation, but never materialises the
    (B, 3136, 147) and (B, 784, 576) unfolded patch tensors: each unfold +
    LayerNorm + kqv chain runs as three convolutions of the raw map, and
    the final unfold + projection is one 3x3 stride-2 convolution. Runs in
    the dtype of ``images``."""
    b = images.shape[0]
    td = stem.token_dim
    p1, p2 = stem.attn1, stem.attn2
    t = _folded_unfold_ln_dense(images, p1.norm1, p1.kqv, 7, 4, 2)
    t = _performer_tail(p1, t.reshape(b, 56 * 56, 3 * td))
    t = t.reshape(b, 56, 56, td)
    t = _folded_unfold_ln_dense(t, p2.norm1, p2.kqv, 3, 2, 1)
    t = _performer_tail(p2, t.reshape(b, 28 * 28, 3 * td))
    t = t.reshape(b, 28, 28, td)
    proj = stem.project
    out = F.conv2d(t.permute(0, 3, 1, 2),
                   _conv_weight(proj.weight, 3, td).to(t.dtype), stride=2,
                   padding=1)
    out = out + proj.bias.to(t.dtype)[:, None, None]
    return out.flatten(2).transpose(1, 2)
