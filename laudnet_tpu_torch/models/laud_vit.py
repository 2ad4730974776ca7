"""LAUD-ViT with token, head and layer (block) gating (counterpart of
`laudnet_tpu/models/laud_vit.py`).

DeiT-style backbone. Gates are straight-through Gumbel-softmax samples in
training and ``on >= off`` comparisons at eval (`ops/gating.py`). Skipped
tokens are removed as attention keys by an
additive -1e9 mask and contribute nothing to the residual stream; with
``token_capacity`` the surviving tokens are gathered down to a fixed
budget at block entry (the serving selection path). FLOPs bookkeeping
follows the simulator's cost model in the JAX package exactly, quirks
included.

Images enter NHWC (B, H, W, 3) as in the JAX package; token streams are
(B, L, D) and masks (B, L). ``stem='t2t'`` swaps the conv patchifier for
the tokens-to-token performer stem (`models/t2t.py`), ``attn_impl='fused'``
runs the attention through the fused kernels (`ops/vit_attention.py`,
forward and backward), ``linear_impl='int8'`` the four body products as
W8A8 at eval (`ops/quant.py::QuantDense`), and ``linear_impl='int8_qat'``
additionally as fake-quant products in training.

``compute_dtype`` (the JAX modules' ``dtype``) is mixed precision: the
parameters stay in their own dtype (f32 masters), the body products run in
``compute_dtype`` and the LayerNorms in f32 with their output rounded to
it, the residual stream is ``compute_dtype``, and the policy heads run in
f32 on the f32-promoted input, so gate decisions are f32. ``dtype`` is the
parameter dtype.

Constructors build on the card unless given a ``device``
(`laudnet_tpu_torch/device.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.device import resolve_device
from laudnet_tpu_torch.models.t2t import (T2TStem, TokenPerformer,
                                          t2t_stem_flops)
from laudnet_tpu_torch.ops.gating import binary_gate
from laudnet_tpu_torch.ops.quant import QuantDense, fake_quant_linear
from laudnet_tpu_torch.ops.vit_attention import (
    fused_vit_attention, reference_vit_attention)

LN_EPS = 1e-6  # flax's LayerNorm default (torch's is 1e-5)


@dataclasses.dataclass
class ViTBlockStats:
    token_density: torch.Tensor
    head_density: torch.Tensor
    attn_density: torch.Tensor
    mlp_density: torch.Tensor
    flops_perc: torch.Tensor
    sparse_flops: torch.Tensor
    token_keep: torch.Tensor      # (B,) per-image kept-token fraction
    token_score: torch.Tensor     # (B, L) token-gate logit margin


@dataclasses.dataclass
class LAUDViTOutput:
    logits: torch.Tensor
    token_density: torch.Tensor   # (depth,)
    head_density: torch.Tensor
    attn_density: torch.Tensor
    mlp_density: torch.Tensor
    flops_perc: torch.Tensor      # (depth,)
    flops: torch.Tensor
    token_keep: torch.Tensor      # (depth, B)


def vit_block_bookkeeping(tok, hd, ak, mk, *, l_book: int, d: int, h: int,
                          hidden: int, policy_flops: float):
    """The block FLOPs model as a function of the four densities; returns
    ``(sparse, dense)`` multiply-adds as f32 tensors. The operation order
    is the JAX package's, so f32 results agree to the last bits."""
    dh = d // h
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)
    one = f32(1.0)

    def block_flops(tok, hd, ak, mk):
        qkv_f = 3 * l_book * d * d * hd
        attn_f = 2 * h * (l_book * tok) ** 2 * dh * hd
        proj_f = (l_book * tok) * d * d * hd * hd
        mlp_f = (l_book * tok) * d * hidden * (hd + 1.0)
        return ak * (qkv_f + attn_f + proj_f) + mk * mlp_f

    sparse = f32(policy_flops) + block_flops(f32(tok), f32(hd), f32(ak),
                                             f32(mk))
    dense = f32(policy_flops) + block_flops(one, one, one, one)
    return sparse, dense


def vit_policy_flops(l_book: int, d: int, h: int, *, token_skip: bool,
                     head_skip: bool, layer_skip: bool) -> float:
    """Multiply-adds of the policy heads one block runs."""
    flops = 0
    if layer_skip:
        flops += d * 4
    if head_skip:
        flops += d * 2 * h
    if token_skip:
        flops += l_book * d * 2
    return flops


def _open_bias_(bias: torch.Tensor, split: int) -> None:
    """Policy biases start the gates OPEN: keep-logits +2, skip-logits -2."""
    with torch.no_grad():
        bias.fill_(-2.0)
        bias[:split] = 2.0


def _check_impls(attn_impl: str, linear_impl: str) -> None:
    if attn_impl not in ("reference", "fused"):
        raise ValueError(f"attn_impl must be 'reference' or 'fused', got "
                         f"{attn_impl!r}")
    if linear_impl not in ("dense", "int8", "int8_qat"):
        raise ValueError(f"linear_impl must be 'dense', 'int8' or "
                         f"'int8_qat', got {linear_impl!r}")


def _linear(m: nn.Linear, x, cd, training: bool = False, qat: bool = False):
    """A body product: in the parameters' dtype, or, under mixed precision,
    on ``cd`` copies of the f32 masters. A `QuantDense` runs W8A8 at eval;
    in training its weights run fake-quant under ``qat`` and dense
    otherwise."""
    if isinstance(m, QuantDense):
        if not training:
            return m(x)
        if qat:
            return fake_quant_linear(x, m.weight, m.bias)
    if cd is None:
        return F.linear(x, m.weight, m.bias)
    return F.linear(x.to(cd), m.weight.to(cd), m.bias.to(cd))


def _norm(m: nn.LayerNorm, x, cd):
    """LayerNorm; under mixed precision in f32 with the output rounded to
    ``cd``, as flax's LayerNorm with a compute dtype."""
    if cd is None:
        return m(x)
    return F.layer_norm(x.float(), m.normalized_shape, m.weight.float(),
                        m.bias.float(), m.eps).to(cd)


def _policy(m: nn.Linear, x, cd):
    """A policy head; under mixed precision on the f32-promoted input."""
    return m(x) if cd is None else m(x.float())


class LAUDViTBlock(nn.Module):
    """Pre-norm transformer block with the three gating paradigms."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, *,
                 token_skip: bool = True, head_skip: bool = True,
                 layer_skip: bool = True, attn_impl: str = "reference",
                 linear_impl: str = "dense", device=None, dtype=None,
                 compute_dtype=None):
        super().__init__()
        _check_impls(attn_impl, linear_impl)
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.dim, self.num_heads = dim, num_heads
        self.hidden = int(dim * mlp_ratio)
        self.token_skip, self.head_skip = token_skip, head_skip
        self.layer_skip = layer_skip
        self.attn_impl, self.linear_impl = attn_impl, linear_impl
        self.compute_dtype = compute_dtype
        # body products: nn.Linear, or the checkpoint-compatible W8A8
        # QuantDense: real s8 at eval; in training 'int8_qat' runs its
        # weights through fake-quant and 'int8' trains dense.
        # Policy heads and norms stay float.
        dense = nn.Linear if linear_impl == "dense" else QuantDense
        self.layer_policy = nn.Linear(dim, 4, **kw) if layer_skip else None
        self.head_policy = (nn.Linear(dim, 2 * num_heads, **kw)
                            if head_skip else None)
        self.token_policy = nn.Linear(dim, 2, **kw) if token_skip else None
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.qkv = dense(dim, 3 * dim, **kw)
        self.proj = dense(dim, dim, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.fc1 = dense(dim, self.hidden, **kw)
        self.fc2 = dense(self.hidden, dim, **kw)

    def forward(self, x, token_mask, temperature=None, *,
                training: bool = False, noise=None,
                capacity: Optional[int] = None,
                book_len: Optional[int] = None):
        """``capacity``: static keep count gathered right after the token
        gate, before this block's attention (eval only); ``book_len``: the
        original token count (N+1) the FLOPs are booked against. Training
        draws its Gumbel noise from ``noise`` in the order layer, head,
        token."""
        b, l, d = x.shape
        l_book = book_len or l
        h = self.num_heads
        cd = self.compute_dtype
        # made on the device: a host scalar copied over would hold the
        # host until the card has caught up, once a block
        one = torch.ones((), dtype=torch.float32, device=x.device)
        cls = x[:, 0]
        gate_kw = dict(training=training, noise=noise)

        attn_keep = mlp_keep = one
        attn_gate = mlp_gate = None
        policy_flops = 0
        if self.layer_policy is not None:
            pair = _policy(self.layer_policy, cls, cd).reshape(b, 2, 2)
            gate = binary_gate(pair, temperature, **gate_kw)
            attn_gate, mlp_gate = gate[:, 0], gate[:, 1]  # (B,) each
            attn_keep, mlp_keep = attn_gate.mean(), mlp_gate.mean()
            policy_flops += d * 4

        head_mask = None
        head_density = one
        if self.head_policy is not None:
            head_mask = binary_gate(
                _policy(self.head_policy, cls, cd).reshape(b, 2, h),
                temperature, **gate_kw)
            head_density = head_mask.mean()
            policy_flops += d * 2 * h

        token_score = torch.zeros((b, l), dtype=torch.float32,
                                  device=x.device)
        if self.token_policy is not None:
            tlogits = _policy(self.token_policy, x, cd)
            tmask = binary_gate(tlogits.reshape(b, l, 2, 1), temperature,
                                **gate_kw)[..., 0]
            # class token always kept (out of place: tmask is on the
            # autograd path in training); gates compose across depth
            tmask = torch.cat([torch.ones_like(tmask[:, :1]), tmask[:, 1:]],
                              dim=1)
            token_mask = token_mask * tmask
            token_score = (tlogits[..., 0] - tlogits[..., 1]).float()
            policy_flops += l_book * d * 2
        # density of the current buffer, rescaled to the full length
        token_density = token_mask.mean() * (l / l_book)
        token_keep = token_mask.mean(dim=1) * (l / l_book)

        if capacity is not None and not training and capacity < l:
            # kept strictly above dropped, ties among kept by confidence,
            # class token pinned; descending stable sort = lax.top_k order
            pin = torch.zeros(l, dtype=torch.float32, device=x.device)
            pin[0] = 4.0
            rank = (token_mask.float() * 2.0 + torch.sigmoid(token_score)
                    + pin)
            idx = torch.sort(rank, dim=1, descending=True,
                             stable=True).indices[:, :capacity]
            x = torch.gather(x, 1, idx[..., None].expand(-1, -1, d))
            token_mask = torch.gather(token_mask, 1, idx)
            token_score = torch.gather(token_score, 1, idx)
            l = capacity

        y = _norm(self.norm1, x, cd)
        attend = (fused_vit_attention if self.attn_impl == "fused"
                  else reference_vit_attention)
        qat = self.linear_impl == "int8_qat"
        out = attend(_linear(self.qkv, y, cd, training, qat), token_mask,
                     head_mask, h, (d // h) ** -0.5)
        out = _linear(self.proj, out, cd, training, qat)
        out = out * token_mask.to(out.dtype)[:, :, None]
        if attn_gate is not None:
            out = out * attn_gate.to(out.dtype)[:, None, None]
        x = x + out

        y = _linear(self.fc1, _norm(self.norm2, x, cd), cd, training, qat)
        y = _linear(self.fc2, F.gelu(y, approximate="none"), cd, training,
                    qat)
        y = y * token_mask.to(y.dtype)[:, :, None]
        if mlp_gate is not None:
            y = y * mlp_gate.to(y.dtype)[:, None, None]
        x = x + y

        sparse, dense = vit_block_bookkeeping(
            token_density, head_density, attn_keep, mlp_keep, l_book=l_book,
            d=d, h=h, hidden=self.hidden, policy_flops=policy_flops)
        stats = ViTBlockStats(
            token_density=token_density, head_density=head_density,
            attn_density=attn_keep, mlp_density=mlp_keep,
            flops_perc=sparse / dense, sparse_flops=sparse,
            token_keep=token_keep, token_score=token_score)
        return x, token_mask, stats


class LAUDViT(nn.Module):
    """DeiT-style LAUD-ViT.

    ``token_capacity`` (eval only) enables the token-selection serving
    path: right
    after block ``i``'s token gate, surviving tokens are gathered down to
    ``int(capacity[i] * (N+1))`` so that block's attention and MLP and
    every later one run at the reduced length. ``img_size`` fixes the
    position-embedding length (the JAX module infers it at init); the T2T
    stem's geometry is fixed at 224 (14 x 14 tokens).
    Parameters are drawn from ``generator`` (an explicit
    ``torch.Generator``) when given, else left to the caller (e.g.
    `convert.from_jax.load_flax_variables`)."""

    def __init__(self, depth: int = 12, dim: int = 384, num_heads: int = 6,
                 mlp_ratio: float = 4.0, patch_size: int = 16,
                 num_classes: int = 1000, token_skip: bool = True,
                 head_skip: bool = True, layer_skip: bool = True,
                 token_capacity: Optional[Sequence[float]] = None,
                 stem: str = "patch", attn_impl: str = "reference",
                 linear_impl: str = "dense", img_size: int = 224,
                 in_chans: int = 3, device=None, dtype=None,
                 compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem not in ("patch", "t2t"):
            raise ValueError(f"stem must be 'patch' or 't2t', got {stem!r}")
        _check_impls(attn_impl, linear_impl)
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.depth, self.dim, self.num_heads = depth, dim, num_heads
        self.mlp_ratio, self.patch_size = mlp_ratio, patch_size
        self.num_classes, self.stem = num_classes, stem
        self.token_skip, self.head_skip = token_skip, head_skip
        self.layer_skip = layer_skip
        self.token_capacity = token_capacity
        self.attn_impl, self.linear_impl = attn_impl, linear_impl
        self.compute_dtype = compute_dtype
        if stem == "t2t":
            # the stem reduces 4 * 2 * 2 = 16x whatever patch_size says
            self.num_patches = (img_size // 16) ** 2
            self.t2t_stem = T2TStem(embed_dim=dim, in_chans=in_chans, **kw)
        else:
            self.num_patches = (img_size // patch_size) ** 2
            self.patch_embed = nn.Conv2d(in_chans, dim, patch_size,
                                         stride=patch_size, **kw)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.num_patches + 1, dim, **kw))
        self.blocks = nn.ModuleList(
            LAUDViTBlock(dim, num_heads, mlp_ratio, token_skip=token_skip,
                         head_skip=head_skip, layer_skip=layer_skip,
                         attn_impl=attn_impl, linear_impl=linear_impl,
                         compute_dtype=compute_dtype, **kw)
            for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.head = nn.Linear(dim, num_classes, **kw)
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's defaults: lecun-normal kernels (truncated, std
        1/sqrt(fan_in)), zero biases, unit LayerNorms, truncated-normal
        0.02 cls/pos embeddings, policy gates open, and the performers'
        fixed features orthonormal rows times sqrt(m)."""
        def lecun_(w, fan_in):
            nn.init.trunc_normal_(w, std=1.0 / math.sqrt(fan_in),
                                  a=-2.0 / math.sqrt(fan_in),
                                  b=2.0 / math.sqrt(fan_in),
                                  generator=generator)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_(m.weight, m.in_features)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                lecun_(m.weight, m.weight[0].numel())
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, TokenPerformer):
                g = torch.empty(m.dim, m.dim, device=m.w.device)
                q, _ = torch.linalg.qr(g.normal_(generator=generator))
                m.w.copy_(q[:m.m] * m.m ** 0.5)
        for p in (self.cls_token, self.pos_embed):
            nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
        for blk in self.blocks:
            if blk.layer_policy is not None:
                _open_bias_(blk.layer_policy.bias, 2)
            if blk.head_policy is not None:
                _open_bias_(blk.head_policy.bias, self.num_heads)
            if blk.token_policy is not None:
                _open_bias_(blk.token_policy.bias, 1)

    def forward(self, x, temperature=None, *, training: bool = False,
                noise=None):
        """``x``: NHWC images. Training gates are Gumbel samples at
        ``temperature`` with noise from ``noise`` (`ops/gating.py`), three
        draws a block in the order layer, head, token; at eval
        ``temperature`` is unused. ``flops_perc`` and ``flops`` of the
        result carry the gate gradients."""
        if training and noise is None:
            raise ValueError("training=True needs a Gumbel noise source")
        b, _, _, c = x.shape
        cd = self.compute_dtype
        if self.stem == "t2t":
            x = self.t2t_stem(x)  # in the parameters' dtype, never in cd
            n = x.shape[1]
            flops = torch.tensor(t2t_stem_flops(self.dim),
                                 dtype=torch.float32)
        else:
            x = x.permute(0, 3, 1, 2)
            pe = self.patch_embed
            if cd is None:
                x = pe(x)
            else:
                x = F.conv2d(x.to(cd), pe.weight.to(cd), pe.bias.to(cd),
                             stride=pe.stride)
            n = x.shape[2] * x.shape[3]
            x = x.flatten(2).transpose(1, 2)
            flops = torch.tensor(
                float(c * self.dim * self.patch_size ** 2 * n),
                dtype=torch.float32)
        if cd is not None:
            x = x.to(self.cls_token.dtype)  # joins the f32 masters
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embed
        if cd is not None:
            x = x.to(cd)  # the residual stream stays in the compute dtype

        token_mask = torch.ones((b, n + 1), dtype=torch.float32,
                                device=x.device)
        select = self.token_capacity is not None and not training
        cur_len = n + 1
        stats_all = []
        for i, blk in enumerate(self.blocks):
            cap = None
            if select:
                k = min(max(2, int(self.token_capacity[i] * (n + 1))),
                        cur_len)
                if k < cur_len:
                    cap = cur_len = k
            x, token_mask, st = blk(x, token_mask, temperature,
                                    training=training, noise=noise,
                                    capacity=cap, book_len=n + 1)
            stats_all.append(st)
            flops = flops + st.sparse_flops

        x = _norm(self.norm, x, cd)
        logits = _linear(self.head, x[:, 0], cd)
        flops = flops + self.dim * self.num_classes

        def stack(f):
            return torch.stack([f(s).to(logits.device) for s in stats_all])

        return LAUDViTOutput(
            logits=logits,
            token_density=stack(lambda s: s.token_density),
            head_density=stack(lambda s: s.head_density),
            attn_density=stack(lambda s: s.attn_density),
            mlp_density=stack(lambda s: s.mlp_density),
            flops_perc=stack(lambda s: s.flops_perc),
            flops=flops,
            token_keep=stack(lambda s: s.token_keep),
        )


def vit_dense_flops(model: LAUDViT, input_size: int = 224,
                    in_chans: int = 3) -> float:
    """Closed-form dense multiply-adds of a :class:`LAUDViT` (all gates
    open): blocks, policy heads, stem and classifier."""
    d, h = model.dim, model.num_heads
    dh = d // h
    hidden = int(d * model.mlp_ratio)
    if model.stem == "t2t":
        stem = float(t2t_stem_flops(d))
        n = (input_size // 16) ** 2  # the T2T stem reduces 4 * 2 * 2 = 16x
    else:
        n = (input_size // model.patch_size) ** 2
        stem = float(in_chans * d * model.patch_size ** 2 * n)
    l = n + 1
    policy = vit_policy_flops(l, d, h, token_skip=model.token_skip,
                              head_skip=model.head_skip,
                              layer_skip=model.layer_skip)
    block = (policy + 3 * l * d * d + 2 * h * l * l * dh + l * d * d
             + 2 * l * d * hidden)
    return stem + model.depth * block + d * model.num_classes


def laud_deit_small(**kwargs) -> LAUDViT:
    """LAUD-DeiT-S: 12 blocks, dim 384, 6 heads."""
    return LAUDViT(depth=12, dim=384, num_heads=6, mlp_ratio=4.0, **kwargs)


def laud_deit_tiny(**kwargs) -> LAUDViT:
    return LAUDViT(depth=12, dim=192, num_heads=3, mlp_ratio=4.0, **kwargs)


def laud_deit_base(**kwargs) -> LAUDViT:
    return LAUDViT(depth=12, dim=768, num_heads=12, mlp_ratio=4.0, **kwargs)


def laud_t2t_vit_19_backbone(**kwargs) -> LAUDViT:
    """The T2T-ViT-19 trunk geometry (14 blocks, dim 448, 7 heads, MLP
    ratio 3) behind the conv patchifier."""
    return LAUDViT(depth=14, dim=448, num_heads=7, mlp_ratio=3.0, **kwargs)


def laud_t2t_vit_19(**kwargs) -> LAUDViT:
    """Full LAUD-T2T-ViT-19: tokens-to-token performer stem + gated trunk."""
    return LAUDViT(depth=14, dim=448, num_heads=7, mlp_ratio=3.0,
                   stem="t2t", **kwargs)
