"""Masked multi-head attention over a packed qkv projection: the plain
reference (counterpart of
`laudnet_tpu/ops/pallas/vit_attention.py::reference_vit_attention`).

The fused forward and backward kernels of that module belong to the
training slice of the port.
"""

from __future__ import annotations

import torch

NEG = -1e9


def reference_vit_attention(qkv: torch.Tensor, key_mask: torch.Tensor,
                            head_mask, num_heads: int,
                            sm_scale: float) -> torch.Tensor:
    """``qkv``: (B, L, 3*D) in the feature layout (3, H, dh); ``key_mask``:
    (B, L) 1/0 over keys; ``head_mask``: optional (B, H) per-head output
    gate. Scores and softmax in f32 with an additive -1e9 key mask (no
    gradient flows into the mask). Returns (B, L, D) in qkv's dtype."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    x = qkv.reshape(b, l, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = x[0].float(), x[1].float(), x[2].float()  # (B, H, L, dh)
    s = (q @ k.transpose(-1, -2)) * sm_scale
    s = s + ((1.0 - key_mask.float()) * NEG)[:, None, None, :].detach()
    p = torch.softmax(s, dim=-1)
    o = p @ v
    if head_mask is not None:
        o = o * head_mask.float()[:, :, None, None]
    return o.permute(0, 2, 1, 3).reshape(b, l, d).to(qkv.dtype)
