"""Masked multi-head attention over a packed qkv projection (counterpart
of `laudnet_tpu/ops/pallas/vit_attention.py`): the fused
`fused_vit_attention` (forward kernels B4a and B4, backward kernel B5) and
its plain versions `reference_vit_attention` and
`reference_vit_attention_bwd`.

The TPU module has two forward kernels, a whole-block one and one that
takes a head pair per grid step; they compute the same function and differ
only in how heads of 64 map onto 128-lane tiles. The port has one CUDA
kernel for both (`csrc/vit_block.cu::attention_kernel`, the block kernels'
attention in its exact form with the (B, H) head gate), and one for the
backward (`csrc/vit_attention_bwd.cu::attention_bwd_kernel`), which takes
any head count as it is. Forward and backward are one
``torch.autograd.Function``; on CPU tensors it runs the plain forward and
the plain backward.
"""

from __future__ import annotations

import torch

NEG = -1e9
DH = 64         # head width the kernels take
MAX_LEN = 256   # a warp's score rows live in registers (ATT_MAX_L)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*dh) -> (B, H, L, dh)."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, dh) -> (B, L, H*dh)."""
    b, h, l, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, l, h * dh)

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


def reference_vit_attention_bwd(qkv: torch.Tensor, key_mask: torch.Tensor,
                                head_mask, g: torch.Tensor, num_heads: int,
                                sm_scale: float):
    """Plain version of the backward kernel (B5): the cotangent ``g``
    (B, L, D) of `fused_vit_attention`'s output to ``(dqkv, dhead)``;
    ``dhead`` is None without a head mask. The softmax is recomputed in f32
    and the intermediates round to qkv's dtype where the kernel rounds
    them (no-ops at f32): ``dO * gate`` once, P before dV and dgate, dS
    before dQ and dK; dS itself uses the unrounded P, and dgate the ungated
    dO. The key mask gets no gradient."""
    cdt = qkv.dtype
    d = qkv.shape[-1] // 3
    rnd = lambda t: t.to(cdt).float()
    q, k, v = (_split_heads(qkv[..., i * d:(i + 1) * d], num_heads).float()
               for i in range(3))
    do = _split_heads(g, num_heads).float()
    s = (q @ k.transpose(-1, -2)) * sm_scale
    s = s + ((1.0 - key_mask.float()) * NEG)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    pc = rnd(p)
    dhead = None
    do_eff = do
    if head_mask is not None:
        do_eff = rnd(do * head_mask.float()[:, :, None, None])
        dhead = ((pc @ v) * do).sum(dim=(2, 3)).to(head_mask.dtype)
    dv = pc.transpose(-1, -2) @ do_eff
    dp = do_eff @ v.transpose(-1, -2)
    ds = rnd(p * (dp - (dp * p).sum(dim=-1, keepdim=True)))
    dq = (ds @ k) * sm_scale
    dk = (ds.transpose(-1, -2) @ q) * sm_scale
    dqkv = torch.cat([_merge_heads(t) for t in (dq, dk, dv)], dim=-1)
    return dqkv.to(cdt), dhead


def _check_cuda(qkv, key_mask, head_mask, num_heads):
    """What the CUDA kernels take: bf16 contiguous (B, L, 3D) qkv, heads of
    64, L <= 256, masks on qkv's device. Returns the f32 contiguous masks."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA attention kernels take bf16, got "
                        f"{qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError("qkv must be a contiguous (B, L, 3D) tensor")
    b, l, d3 = qkv.shape
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
    return key_mask.float().contiguous(), gate


def _launch_fwd(qkv, key_mask, head_mask, num_heads, sm_scale):
    from laudnet_tpu_torch.ops._build import check, library

    kmask, gate = _check_cuda(qkv, key_mask, head_mask, num_heads)
    b, l, d3 = qkv.shape
    out = torch.empty((b, l, d3 // 3), dtype=torch.bfloat16,
                      device=qkv.device)
    lib = library()
    check(lib, lib.lt_attention(
        qkv.data_ptr(), kmask.data_ptr(),
        None if gate is None else gate.data_ptr(), out.data_ptr(), b, l,
        num_heads, float(sm_scale), 0,
        torch.cuda.current_stream(qkv.device).cuda_stream),
        "attention kernel")
    fused_vit_attention.launches += 1
    return out


def _launch_bwd(qkv, key_mask, head_mask, g, num_heads, sm_scale):
    from laudnet_tpu_torch.ops._build import check, library

    kmask, gate = _check_cuda(qkv, key_mask, head_mask, num_heads)
    b, l, d3 = qkv.shape
    if g.dtype != torch.bfloat16 or tuple(g.shape) != (b, l, d3 // 3):
        raise TypeError(f"the output cotangent must be bf16 ({b}, {l}, "
                        f"{d3 // 3}), got {g.dtype} {tuple(g.shape)}")
    g = g.contiguous()  # autograd may hand over a strided view
    dqkv = torch.empty_like(qkv)
    dhead = (None if gate is None else
             torch.empty((b, num_heads), dtype=torch.float32,
                         device=qkv.device))
    lib = library()
    check(lib, lib.lt_attention_bwd(
        qkv.data_ptr(), kmask.data_ptr(),
        None if gate is None else gate.data_ptr(), g.data_ptr(),
        dqkv.data_ptr(), None if dhead is None else dhead.data_ptr(), b, l,
        num_heads, float(sm_scale),
        torch.cuda.current_stream(qkv.device).cuda_stream),
        "attention backward kernel")
    fused_vit_attention.bwd_launches += 1
    if dhead is not None:
        dhead = dhead.to(head_mask.dtype)
    return dqkv, dhead


class _FusedViTAttention(torch.autograd.Function):
    """Forward B4, backward B5; the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, qkv, key_mask, head_mask, num_heads, sm_scale):
        ctx.save_for_backward(qkv, key_mask, head_mask)
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        if qkv.device.type == "cpu":
            return reference_vit_attention(qkv, key_mask, head_mask,
                                           num_heads, sm_scale)
        return _launch_fwd(qkv, key_mask, head_mask, num_heads, sm_scale)

    @staticmethod
    def backward(ctx, g):
        qkv, key_mask, head_mask = ctx.saved_tensors
        run = (reference_vit_attention_bwd if qkv.device.type == "cpu"
               else _launch_bwd)
        dqkv, dhead = run(qkv, key_mask, head_mask, g, ctx.num_heads,
                          ctx.sm_scale)
        # the additive key mask removes keys; it is no differentiable gate
        return dqkv, None, dhead, None, None


def fused_vit_attention(qkv: torch.Tensor, key_mask: torch.Tensor,
                        head_mask, num_heads: int,
                        sm_scale: float) -> torch.Tensor:
    """Fused masked multi-head attention (B4a/B4 forward, B5 backward).
    Arguments and result as `reference_vit_attention`, which CPU tensors
    run, with `reference_vit_attention_bwd` as their backward. CUDA tensors
    launch the kernels: bf16 qkv, heads of 64, L <= 256; anything else
    raises. The forward rounds where the TPU strip kernel does: p is
    rounded to bf16 before P.V, the head gate multiplies the f32 output,
    and the output is rounded once. Gradients flow to ``qkv`` and
    ``head_mask``; ``key_mask`` gets none."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {qkv.device}")
    return _FusedViTAttention.apply(qkv, key_mask, head_mask, num_heads,
                                    sm_scale)


fused_vit_attention.launches = 0
fused_vit_attention.bwd_launches = 0
