"""Fused ViT serving engine: the token prologue (conv patchify or the T2T
performer stem), then per layer the eval token gate and fixed-capacity
gather at block entry, the block kernels, and the final LayerNorm and
class head (counterpart of `laudnet_tpu/infer/fused_vit.py`).

The runs of layers between gathers go through one `fused_vit_segment`
(B2) each on the token-selection path, or one `fused_vit_block` (B1) per
layer on the dense path; with ``head_gating`` or ``int8`` every layer is
one `fused_vit_block` or `fused_vit_block_int8` (B6). The prologue, the
policy products and the head product stay stock PyTorch, as the JAX engine
leaves them to XLA. The engine reads its weights from a
`models.laud_vit.LAUDViT` (the single source of truth) and computes in
that model's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from laudnet_tpu_torch.models.t2t import t2t_stem_conv_apply
from laudnet_tpu_torch.ops.vit_block import (
    fused_vit_block, fused_vit_block_int8, fused_vit_block_int8_reference,
    fused_vit_block_reference, fused_vit_segment,
    fused_vit_segment_reference, layer_norm, quantize_block_params,
    token_logits)


def _ln(x, weight, bias):
    """LayerNorm in f32, cast back to x's dtype."""
    return layer_norm(x, weight, bias).to(x.dtype)


def _patchify(model, x):
    """The token prologue on NHWC images: patch embed (or, for
    ``stem='t2t'``, the conv-folded performer stem, which is dense and
    never gated), class-token concat and position embed. The bias is added
    after the convolution and the position embedding after the concat,
    each in the compute dtype, as the JAX prologue does. Returns
    ``(x, n)`` with x of shape (B, n+1, D)."""
    dt = model.cls_token.dtype
    b = x.shape[0]
    if model.stem == "t2t":
        y = t2t_stem_conv_apply(model.t2t_stem, x.to(dt))
    else:
        pe = model.patch_embed
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), pe.weight,
                     stride=model.patch_size)
        y = (y + pe.bias[:, None, None]).flatten(2).transpose(1, 2)
    n = y.shape[1]
    cls = model.cls_token.to(dt).expand(b, 1, -1)
    return torch.cat([cls, y], dim=1) + model.pos_embed.to(dt), n


def snap_capacity_to_tiles(k: int) -> int:
    """Snaps a capacity DOWN to the tile grid: a multiple of 8 always, and
    of 128 when that drops under 10% of the tokens (137 -> 128, 98 -> 96).
    The formula is the JAX engine's, chosen there for TPU tiles; whether
    the H100 kernels want another grid is still to be measured."""
    k8 = max(8, (k // 8) * 8)
    k128 = (k // 128) * 128
    if k128 >= 128 and (k8 - k128) / k8 < 0.10:
        return k128
    return k8


def _lin(m):
    return {"weight": m.weight, "bias": m.bias}


def block_params(blk, token_policy: bool = False) -> dict:
    """A `LAUDViTBlock`'s parameters in the block kernels' dict layout."""
    p = {"ln1": _lin(blk.norm1), "qkv": _lin(blk.qkv),
         "proj": _lin(blk.proj), "ln2": _lin(blk.norm2),
         "fc1": _lin(blk.fc1), "fc2": _lin(blk.fc2)}
    if token_policy:
        p["token_policy"] = _lin(blk.token_policy)
    return p


def gate_and_select(x, token_mask, policy, k: int):
    """A layer's eval token gate and fixed-capacity gather at block entry
    (`fused_vit.py:217-244`). The gate (``logit0 >= logit1`` on logits
    rounded to x's dtype, class token pinned) composes into ``token_mask``
    (B, L); if ``k < L`` the k best-ranked tokens are gathered. Returns
    ``(x, token_mask, idx)``, idx (B, k) or None."""
    keep, drop = token_logits(x, policy.weight, policy.bias).unbind(-1)
    tmask = (keep >= drop).float()
    tmask[:, 0] = 1.0
    token_mask = token_mask * tmask
    if k >= x.shape[1]:
        return x, token_mask, None
    # rank kept above dropped, ties by confidence, class token pinned.
    # lax.top_k orders by descending rank with ties to the lower index,
    # which a stable descending sort reproduces (torch.topk promises
    # neither on CUDA). sigmoid + 2 * mask rounds once, as 2 * mask +
    # sigmoid does.
    rank = torch.sigmoid((keep - drop).float()).add_(token_mask, alpha=2.0)
    rank[:, 0] += 4.0
    idx = torch.sort(rank, dim=1, descending=True, stable=True).indices[:, :k]
    x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return x, torch.gather(token_mask, 1, idx), idx


def build_fused_vit(model, *,
                    token_capacity: Optional[Sequence[float]] = None,
                    snap_capacities: bool = False,
                    head_gating: bool = False,
                    int8: bool = False,
                    segments=True,
                    fast_math: bool = True,
                    plain: bool = False):
    """Returns ``forward(x) -> logits`` for a `LAUDViT` ``model`` and NHWC
    images ``x`` (cast to the model's dtype).

    ``token_capacity`` enables the selection path (the model must carry
    ``token_policy`` heads); ``snap_capacities`` snaps each capacity with
    `snap_capacity_to_tiles`. ``segments`` (default on, selection paths
    only) runs the layers between gathers as one `fused_vit_segment`; an
    int caps the layers per segment and engages on dense paths too; False
    runs one `fused_vit_block` per layer. ``fast_math`` (the serving
    default) uses the kernels' fast forms. ``plain`` runs the plain
    PyTorch versions of B1/B2/B6 on any device: the kernels' oracle.
    After a call, ``forward.token_counts`` holds the token count each
    layer ran at and ``forward.segment_layers`` the layer count of each
    `fused_vit_segment` call, in order (empty where every layer ran
    alone).

    ``head_gating`` applies the model's eval per-head gates
    (``head_policy`` on the class token at block entry, ``on >= off``)
    inside the block kernel. ``int8`` serves the W8A8 block
    (`fused_vit_block_int8`): the four products of each layer are
    quantised per output channel here, once, from the model's weights as
    they are at build time; it is inexact, and callers report agreement
    with the float engine. Both run one kernel per layer (no segments) and
    ignore ``fast_math`` where the W8A8 block has no fast forms. A model
    with ``stem='t2t'`` gets the conv-folded performer stem as its
    prologue. Odd head counts (T2T's 7) need nothing: the attention kernel
    takes any number of heads of 64, so the zero fake head the TPU engine
    pads in stays behind, on the int8 path too. That head's columns
    quantise to 0 and its zero output does not move a row's abs-max, so
    the int8 codes are the same without it.

    Layer gates are not served: the engine's output equals ``LAUDViT``
    eval for models without layer gates (and, without ``head_gating``,
    without head gates; a model that carries them is served with those
    gates ignored, as the JAX engine does)."""
    if int8:
        block_fn = (fused_vit_block_int8_reference if plain
                    else fused_vit_block_int8)
    else:
        block_fn = fused_vit_block_reference if plain else fused_vit_block
    segment_fn = fused_vit_segment_reference if plain else fused_vit_segment
    depth, num_heads = model.depth, model.num_heads
    blocks = list(model.blocks)
    select = token_capacity is not None
    has_policy = [blk.token_policy is not None for blk in blocks]
    qblocks = ([quantize_block_params(block_params(blk)) for blk in blocks]
               if int8 else None)

    # Default True engages only on selection paths; an int engages
    # everywhere; never with head gates or int8. Segments are capped at 5
    # layers and at ~72 MiB of weights, the JAX engine's plan.
    seg_ok = (bool(segments) and not head_gating and not int8 and depth > 0
              and (select or segments is not True))
    if seg_ok:
        blk0 = blocks[0]
        itb = blk0.qkv.weight.element_size()
        wl_bytes = itb * sum(m.weight.numel() for m in
                             (blk0.qkv, blk0.proj, blk0.fc1, blk0.fc2))
        n_max = max(1, min(5, int((72 * 2 ** 20) // max(wl_bytes, 1))))
        if segments is not True:
            n_max = min(n_max, max(1, int(segments)))

    def capacity(i, n, cur):
        k = min(max(2, int(token_capacity[i] * (n + 1))), cur)
        if snap_capacities and k < cur:
            k = min(max(2, snap_capacity_to_tiles(k)), cur)
        return k

    def gathers_at(i, n, cur):
        return select and has_policy[i] and capacity(i, n, cur) < cur

    @torch.no_grad()
    def forward(x):
        x, n = _patchify(model, x)
        b = x.shape[0]
        token_mask = torch.ones((b, n + 1), dtype=torch.float32,
                                device=x.device)
        cur = n + 1
        counts = forward.token_counts = []
        seg_layers = forward.segment_layers = []

        def entry_policy(i, x, token_mask, cur):
            if not (select and has_policy[i]):
                return x, token_mask, cur
            k = capacity(i, n, cur)
            x, token_mask, _ = gate_and_select(
                x, token_mask, blocks[i].token_policy, k)
            return x, token_mask, k

        if seg_ok:
            i = 0
            while i < depth:
                # a gather ranks tokens here; a gate alone runs in the
                # segment's first LN1 launch, as every later layer's does
                gather = gathers_at(i, n, cur)
                if gather:
                    x, token_mask, cur = entry_policy(i, x, token_mask, cur)
                j = i + 1
                while j < depth and j - i < n_max and not gathers_at(
                        j, n, cur):
                    j += 1
                plist = [block_params(blocks[t], select and has_policy[t]
                                      and (t > i or not gather))
                         for t in range(i, j)]
                counts += [cur] * (j - i)
                seg_layers.append(j - i)
                x, token_mask = segment_fn(x.contiguous(), token_mask, plist,
                                           num_heads=num_heads,
                                           fast_math=fast_math)
                i = j
        else:
            for i in range(depth):
                x, token_mask, cur = entry_policy(i, x, token_mask, cur)
                counts.append(cur)
                kw = {} if int8 else {"fast_math": fast_math}
                if head_gating and blocks[i].head_policy is not None:
                    # eval head gate on the class token, which selection
                    # pins at index 0; logits round as the token policy's
                    hp = blocks[i].head_policy
                    hl = token_logits(x[:, 0], hp.weight, hp.bias)
                    hl = hl.reshape(b, 2, num_heads)
                    kw["head_gate"] = (hl[:, 0] >= hl[:, 1]).float()
                x = block_fn(x.contiguous(), token_mask.reshape(b, 1, cur),
                             token_mask.reshape(b, cur, 1),
                             qblocks[i] if int8 else block_params(blocks[i]),
                             num_heads=num_heads, **kw)
        x = _ln(x, model.norm.weight, model.norm.bias)
        return x[:, 0] @ model.head.weight.t().to(x.dtype) \
            + model.head.bias.to(x.dtype)

    return forward
