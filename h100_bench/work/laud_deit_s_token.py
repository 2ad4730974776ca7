"""Operations and bytes of LAUD-DeiT-S's work, at the token counts served.

Frozen copy of the arithmetic of ``chip_smoke.py::block_bound`` (with its
``attention_bound`` part) for one bf16 block layer on (B, l, d): the four
products, 2 * B * l * (3 d^2 + d^2 + 2 d * hidden) operations, and
attention, 4 * B * heads * l^2 * 64; bytes: the token stream read and
written once (bf16), the row masks (f32) read and written once, the
layer's weights read once (bf16) with its LayerNorm and bias vectors.
``forward_flop`` adds the patch embedding, the token gates and the head.
"""

from __future__ import annotations


def block_layers(cfg, info) -> list:
    """(operations, bytes) of each block layer for one batch whose
    reference facts are ``info`` (``tokens``: (B, depth) token counts)."""
    d, hid = cfg["hidden_size"], cfg["intermediate_size"]
    heads, dh = cfg["num_heads"], cfg["head_dim"]
    tokens = info["tokens"]
    b = tokens.shape[0]
    weights = (4 * d * d + 2 * d * hid) * 2
    small = (4 * d + 5 * d + hid) * 2
    out = []
    for l in tokens[0].tolist():
        l = int(l)
        m = b * l
        ops = 2 * m * (3 * d * d + d * d + 2 * d * hid) \
            + 4 * b * heads * l * l * dh
        moved = 2 * m * d * 2 + 2 * m * 4 + weights + small
        out.append((float(ops), float(moved)))
    return out


def forward_flop(cfg, info) -> float:
    """FLOPs of one batch's forward at the served token counts: patch
    embedding, the token gate of every layer, the blocks and the head."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    tokens = info["tokens"]
    b = tokens.shape[0]
    patches = (cfg["image_size"] // p) ** 2
    flop = 2 * b * patches * 3 * p * p * d
    flop += sum(ops for ops, _ in block_layers(cfg, info))
    flop += 2 * 2 * d * float(tokens.sum())
    flop += 2 * b * d * cfg["num_labels"]
    return float(flop)
