"""Masked multi-head attention over a packed qkv projection (counterpart
of `laudnet_tpu/ops/pallas/vit_attention.py`): the fused forward
`fused_vit_attention` (kernels B4a and B4) and its plain version
`reference_vit_attention`.

The TPU module has two forward kernels, a whole-block one and one that
takes a head pair per grid step; they compute the same function and differ
only in how heads of 64 map onto 128-lane tiles. The port has one CUDA
kernel for both (`csrc/vit_block.cu::attention_kernel`, the block kernels'
attention in its exact form with the (B, H) head gate).

Forward only: the backward kernel (B5) belongs to the training slice of the
port, which wraps both in one ``torch.autograd.Function``.
"""

from __future__ import annotations

import torch

NEG = -1e9
DH = 64         # head width the kernel takes
MAX_LEN = 256   # a warp's score rows live in registers (ATT_MAX_L)


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


def fused_vit_attention(qkv: torch.Tensor, key_mask: torch.Tensor,
                        head_mask, num_heads: int,
                        sm_scale: float) -> torch.Tensor:
    """Fused masked multi-head attention forward (B4a/B4). Arguments and
    result as `reference_vit_attention`, which CPU tensors run. CUDA
    tensors launch the kernel: bf16 qkv, heads of 64, L <= 256; anything
    else raises. The kernel rounds where the TPU strip kernel does: p is
    rounded to bf16 before P.V, the head gate multiplies the f32 output,
    and the output is rounded once.

    Raises if ``qkv`` requires grad while grad mode is on: the backward
    belongs to the training slice."""
    if qkv.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "fused_vit_attention is forward only; its backward (kernel B5) "
            "belongs to the training slice of the port. Call it under "
            "torch.no_grad()")
    if qkv.device.type == "cpu":
        return reference_vit_attention(qkv, key_mask, head_mask, num_heads,
                                       sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    from laudnet_tpu_torch.ops._build import check, library

    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA attention kernel takes bf16, got "
                        f"{qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError("qkv must be a contiguous (B, L, 3D) tensor")
    b, l, d3 = qkv.shape
    d = d3 // 3
    if d3 != 3 * num_heads * DH or l > MAX_LEN:
        raise ValueError(f"kernel limits: heads of {DH}, L <= {MAX_LEN}; "
                         f"got 3D={d3}, num_heads={num_heads}, L={l}")
    if key_mask.device != qkv.device or tuple(key_mask.shape) != (b, l):
        raise ValueError(f"key_mask must be ({b}, {l}) on {qkv.device}, got "
                         f"{tuple(key_mask.shape)} on {key_mask.device}")
    if head_mask is not None and (
            head_mask.device != qkv.device
            or tuple(head_mask.shape) != (b, num_heads)):
        raise ValueError(f"head_mask must be ({b}, {num_heads}) on "
                         f"{qkv.device}, got {tuple(head_mask.shape)} on "
                         f"{head_mask.device}")
    gate = None if head_mask is None else head_mask.float().contiguous()
    kmask = key_mask.float().contiguous()
    out = torch.empty((b, l, d), dtype=torch.bfloat16, device=qkv.device)
    lib = library()
    check(lib, lib.lt_attention(
        qkv.data_ptr(), kmask.data_ptr(),
        None if gate is None else gate.data_ptr(), out.data_ptr(), b, l,
        num_heads, float(sm_scale), 0,
        torch.cuda.current_stream(qkv.device).cuda_stream),
        "attention kernel")
    fused_vit_attention.launches += 1
    return out


fused_vit_attention.launches = 0
