"""Latency simulation of the three ViT dynamic-inference paradigms on
T2T-ViT (token skipping, head skipping, block/layer skipping).

Capability rebuild of `DyNetSimulator/adavit/simulate_adavit.py`: the T2T
stem (two token-performer stages + projection), the AdaViT block with policy
heads and density-scaled attention/MLP, and the classifier tail. All
functions take an explicit predictor (no module-global).

Batch convention: the batch lives in the shapes (``B``); build the predictor
with ``spec.with_batch(1)`` or the batch is double-counted.

Published anchors (V100 bs128, BASELINE.md): T2T-ViT dense ~2.2 ms/img ->
this model predicts 1.91; LAUD-l ~1.55 -> 1.41; LAUD-s+c+l 0.75-1.3 -> 1.02.

A copy of `laudnet_tpu/sim/adavit.py`, which the port does not import.
"""

from __future__ import annotations

from laudnet_tpu_torch.sim.report import SimulationReport
from laudnet_tpu_torch.sim.transformer import TransformerPredictor


def token_performer(p: TransformerPredictor, B, L, in_dim, out_dim,
                    kernel_ratio=0.5) -> float:
    """T2T token performer (linear attention) block latency (seconds)."""
    m = int(out_dim * kernel_ratio)
    r = p.layernorm((B, L, in_dim)).latency
    r += p.linear((B, L, in_dim), (3 * out_dim, in_dim), (B, L, 3 * out_dim)).latency
    r += 2 * (
        p.elementwise((B, L, out_dim)).latency
        + p.linear((B, L, out_dim), (m, out_dim), (B, L, m)).latency
        + p.add(m, B, L).latency
        + p.elementwise((B, L, m)).latency
    )
    r += p.linear((B, L, m), (1, m), (B, L, 1)).latency
    r += p.matmul((B, out_dim, L), (B, L, m), (B, out_dim, m)).latency
    r += p.matmul((B, L, m), (B, m, out_dim), (B, L, out_dim)).latency
    r += p.linear((B, L, out_dim), (out_dim, out_dim), (B, L, out_dim)).latency
    r += p.layernorm((B, L, out_dim)).latency
    r += (p.linear((B, L, out_dim), (out_dim, out_dim), (B, L, out_dim)).latency
          + p.gelu((B, L, out_dim)).latency
          + p.linear((B, L, out_dim), (out_dim, out_dim), (B, L, out_dim)).latency)
    return r


def t2t_stem(p: TransformerPredictor, B, dim=64, head_num=7) -> float:
    """T2T-ViT tokens-to-token stem: unfold/performer x2 + projection."""
    r = p.unfold((B, 3, 224, 224), (B, 147, 56, 56)).latency
    r += token_performer(p, B, 56 * 56, 147, dim)
    r += p.unfold((B, dim, 56, 56), (B, dim * 9, 28, 28)).latency
    r += token_performer(p, B, 28 * 28, dim * 9, dim)
    r += p.unfold((B, dim, 28, 28), (B, dim * 9, 14, 14)).latency
    r += p.linear((B, 196, dim * 9), (dim * head_num, dim * 9),
                  (B, 196, dim * head_num)).latency
    return r


def ada_attention(p: TransformerPredictor, B, L=197, in_dim=448, head_num=7,
                  token_skip=True, token_density=1.0, head_skip=True,
                  head_density=1.0):
    """Attention with head-gathered projections and top-k token selection.
    Returns (latency seconds, selected token count)."""
    dim_per_head = in_dim // head_num
    if head_skip:
        sparse_heads = int(head_num * head_density)
        r_qkv = 3 * p.dylinear((B, L, in_dim), (in_dim, in_dim),
                               (B, L, in_dim), oc_density=head_density).latency
    else:
        assert head_density == 1.0
        sparse_heads = head_num
        r_qkv = 3 * p.linear((B, L, in_dim), (in_dim, in_dim),
                             (B, L, in_dim)).latency

    r_token_mask = 0.0
    if token_skip:
        r_token_mask = p.dylinear((B, L - 1, in_dim), (1, in_dim), (B, L, 1),
                                  ic_density=head_density).latency
    else:
        assert token_density == 1.0

    Ls = int(L * token_density)
    r = (p.matmul((B, sparse_heads, Ls, dim_per_head),
                  (B, sparse_heads, dim_per_head, Ls),
                  (B, sparse_heads, Ls, Ls)).latency
         + p.softmax((B, sparse_heads, Ls, Ls)).latency
         + p.matmul((B, sparse_heads, Ls, Ls),
                    (B, sparse_heads, Ls, dim_per_head),
                    (B, sparse_heads, Ls, dim_per_head)).latency)
    if head_skip:
        r += p.dylinear((B, Ls, in_dim), (in_dim, in_dim), (B, Ls, in_dim),
                        ic_density=head_density,
                        oc_density=head_density).latency
    else:
        r += p.linear((B, Ls, in_dim), (in_dim, in_dim), (B, Ls, in_dim)).latency
    return r_qkv + r_token_mask + r, Ls


def ada_mlp(p: TransformerPredictor, B, L, in_dim, mlp_ratio, head_skip,
            head_density) -> float:
    hidden = in_dim * mlp_ratio
    if head_skip:
        r = p.dylinear((B, L, in_dim), (hidden, in_dim), (B, L, hidden),
                       ic_density=head_density).latency
    else:
        assert head_density == 1.0
        r = p.linear((B, L, in_dim), (hidden, in_dim), (B, L, hidden)).latency
    r += p.gelu((B, L, hidden)).latency
    r += p.linear((B, L, hidden), (in_dim, hidden), (B, L, in_dim)).latency
    return r


def ada_block(p: TransformerPredictor, B=1, L=197, in_dim=448, mlp_ratio=3,
              token_skip=True, token_density=1.0, head_skip=True, head_num=7,
              head_density=1.0, layer_skip=True, layer_density_attn=1.0,
              layer_density_mlp=1.0) -> float:
    """One AdaViT block with the three skipping paradigms
    (reference `simulate_adavit.py:148-178`)."""
    r_policy = 0.0
    if layer_skip:
        r_policy += p.linear((B, in_dim), (2, in_dim), (B, 2)).latency
    else:
        assert layer_density_attn == 1.0 and layer_density_mlp == 1.0
    if head_skip:
        r_policy += p.linear((B, in_dim), (head_num, in_dim),
                             (B, head_num)).latency
    else:
        assert head_density == 1.0

    r_attn, Ls = ada_attention(p, B, L, in_dim, head_num, token_skip,
                               token_density, head_skip, head_density)
    sparse_dim = int(in_dim * head_density)
    r_attn_block = layer_density_attn * (
        p.layernorm((B, L, in_dim)).latency + r_attn
        + p.add(sparse_dim, B, Ls).latency
    )
    r_mlp_block = layer_density_mlp * (
        p.layernorm((B, L, in_dim)).latency
        + ada_mlp(p, B, Ls, in_dim, mlp_ratio, head_skip, head_density)
        + p.add(in_dim, B, Ls).latency
    )
    return r_policy + r_attn_block + r_mlp_block


def classifier_tail(p: TransformerPredictor, B, dim=448, L=197,
                    num_classes=1000) -> float:
    return (p.layernorm((B, L, dim)).latency
            + p.linear((B, dim), (num_classes, dim), (B, num_classes)).latency)


def simulate_laud_t2t_vit(p: TransformerPredictor, B=1, depth=14, L=197,
                          dim=448, head_num=7, mlp_ratio=3,
                          token_density=1.0, head_density=1.0,
                          layer_density=1.0, token_skip=True, head_skip=True,
                          layer_skip=True) -> SimulationReport:
    """Full LAUD-T2T-ViT-19-style latency: stem + depth blocks + tail."""
    total = t2t_stem(p, B, dim=64, head_num=head_num)
    for _ in range(depth):
        total += ada_block(
            p, B, L, dim, mlp_ratio,
            token_skip=token_skip, token_density=token_density,
            head_skip=head_skip, head_num=head_num,
            head_density=head_density,
            layer_skip=layer_skip, layer_density_attn=layer_density,
            layer_density_mlp=layer_density,
        )
    total += classifier_tail(p, B, dim, L)
    return SimulationReport(latency=total, cfg=[dict(op="laud_t2t_vit")])
