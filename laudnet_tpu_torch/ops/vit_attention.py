"""Masked multi-head attention over a packed qkv projection (counterpart
of `laudnet_tpu/ops/pallas/vit_attention.py`): the fused
`fused_vit_attention` (forward kernel B4a/B4, backward kernel B5) and its
plain versions `reference_vit_attention` and
`reference_vit_attention_bwd`.

The TPU module has two forward kernels, a whole-block one and one that
takes a head pair per grid step; they compute the same function and differ
only in how heads of 64 map onto 128-lane tiles. The port has one CUDA
forward for both and one backward (`csrc/attention.cu`: ``lt_attn_fwd``,
``lt_attn_bwd``), for any head count of 64, any L, bf16 or f32. Forward
and backward are one ``torch.autograd.Function``: when autograd needs the
result's gradient, the forward kernel also writes the softmax's row
statistics (`stats`), which the backward kernel reads instead of
recomputing them. On CPU tensors it runs the plain forward and the plain
backward, which recomputes the softmax. The forward and the backward are
the registered ops ``laudnet::vit_attention`` and
``laudnet::vit_attention_bwd`` (`ops/library.py`), the second the first's
autograd formula, so that `torch.export` records each as one node.

Row statistics (``stats``): f32 (B, H, 2, L), ``[:, :, 0]`` the row max m
of the scaled, masked scores and ``[:, :, 1]`` the row sum
l = sum(exp(s - m)); the softmax is exp(s - m) / l.
"""

from __future__ import annotations

import torch

from laudnet_tpu_torch.ops.library import LIB, register

NEG = -1e9
DH = 64         # head width the kernels take


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*dh) -> (B, H, L, dh)."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, dh) -> (B, L, H*dh)."""
    b, h, l, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, l, h * dh)


def _scores(qkv, key_mask, num_heads, sm_scale):
    """(q, k, v) in f32, (B, H, L, dh), and the scaled, masked f32 scores
    (B, H, L, L) (no gradient into the mask)."""
    d = qkv.shape[-1] // 3
    q, k, v = (_split_heads(qkv[..., i * d:(i + 1) * d], num_heads).float()
               for i in range(3))
    s = (q @ k.transpose(-1, -2)) * sm_scale
    s = s + ((1.0 - key_mask.float()) * NEG)[:, None, None, :].detach()
    return q, k, v, s


def _row_stats(s):
    """The row statistics (B, H, 2, L) of scores ``s``."""
    m = s.amax(dim=-1)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(dim=-1)], dim=2)


def reference_vit_attention(qkv: torch.Tensor, key_mask: torch.Tensor,
                            head_mask, num_heads: int, sm_scale: float,
                            return_stats: bool = False):
    """``qkv``: (B, L, 3*D) in the feature layout (3, H, dh); ``key_mask``:
    (B, L) 1/0 over keys; ``head_mask``: optional (B, H) per-head output
    gate. Scores and softmax in f32 with an additive -1e9 key mask (no
    gradient flows into the mask). Returns (B, L, D) in qkv's dtype, and
    with ``return_stats`` also the row statistics (module docstring)."""
    _, _, v, s = _scores(qkv, key_mask, num_heads, sm_scale)
    p = torch.softmax(s, dim=-1)
    o = p @ v
    if head_mask is not None:
        o = o * head_mask.float()[:, :, None, None]
    out = _merge_heads(o).to(qkv.dtype)
    if return_stats:
        return out, _row_stats(s.detach())
    return out


def reference_vit_attention_bwd(qkv: torch.Tensor, key_mask: torch.Tensor,
                                head_mask, g: torch.Tensor, num_heads: int,
                                sm_scale: float, stats=None):
    """Plain version of the backward kernel (B5): the cotangent ``g``
    (B, L, D) of `fused_vit_attention`'s output to ``(dqkv, dhead)``;
    ``dhead`` is None without a head mask. The softmax is recomputed in f32
    (``stats`` None), or formed from the forward's row statistics as the
    kernel forms it, P = exp(s - m) / l; the intermediates round to qkv's
    dtype where the kernel rounds them (no-ops at f32): ``dO * gate`` once,
    P before dV and dgate, dS before dQ and dK; dS itself uses the
    unrounded P, and dgate the ungated dO. The key mask gets no
    gradient."""
    cdt = qkv.dtype
    rnd = lambda t: t.to(cdt).float()
    q, k, v, s = _scores(qkv, key_mask, num_heads, sm_scale)
    do = _split_heads(g, num_heads).float()
    if stats is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = (torch.exp(s - stats[:, :, 0, :, None])
             / stats[:, :, 1, :, None])
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
    """What the CUDA kernels take: bf16 or f32 contiguous (B, L, 3D) qkv,
    heads of 64, masks on qkv's device. Returns the f32 contiguous
    masks."""
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA attention kernels take bf16 or f32, got "
                        f"{qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError("qkv must be a contiguous (B, L, 3D) tensor")
    b, l, d3 = qkv.shape
    if d3 != 3 * num_heads * DH:
        raise ValueError(f"the kernels take heads of {DH}: got "
                         f"3D={d3}, num_heads={num_heads}")
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(qkv, key_mask, head_mask, num_heads, sm_scale,
                return_stats=False):
    """The forward kernel; with ``return_stats`` also the row statistics
    it writes (as `reference_vit_attention`)."""
    from laudnet_tpu_torch.ops._build import check, library

    kmask, gate = _check_cuda(qkv, key_mask, head_mask, num_heads)
    b, l, d3 = qkv.shape
    out = torch.empty((b, l, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    stats = (torch.empty((b, num_heads, 2, l), dtype=torch.float32,
                         device=qkv.device) if return_stats else None)
    lib = library()
    check(lib, lib.lt_attn_fwd(
        qkv.data_ptr(), kmask.data_ptr(), _ptr(gate), out.data_ptr(),
        _ptr(stats), b, l, num_heads, float(sm_scale), 0,
        int(qkv.dtype == torch.float32),
        torch.cuda.current_stream(qkv.device).cuda_stream),
        "attention kernel")
    fused_vit_attention.launches += 1
    return (out, stats) if return_stats else out


def _launch_bwd(qkv, key_mask, head_mask, g, num_heads, sm_scale, stats):
    """The backward kernel, fed the forward's row statistics."""
    from laudnet_tpu_torch.ops._build import check, library

    kmask, gate = _check_cuda(qkv, key_mask, head_mask, num_heads)
    b, l, d3 = qkv.shape
    if g.dtype != qkv.dtype or tuple(g.shape) != (b, l, d3 // 3):
        raise TypeError(f"the output cotangent must be {qkv.dtype} ({b}, "
                        f"{l}, {d3 // 3}), got {g.dtype} {tuple(g.shape)}")
    if (stats is None or stats.dtype != torch.float32
            or tuple(stats.shape) != (b, num_heads, 2, l)
            or stats.device != qkv.device):
        raise ValueError(f"the backward kernel needs the forward's f32 row "
                         f"statistics ({b}, {num_heads}, 2, {l}) on "
                         f"{qkv.device}")
    g = g.contiguous()  # autograd may hand over a strided view
    stats = stats.contiguous()
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, num_heads, l), dtype=torch.float32,
                        device=qkv.device)
    dhead = dgate_part = None
    if gate is not None:
        dhead = torch.empty((b, num_heads), dtype=torch.float32,
                            device=qkv.device)
        dgate_part = torch.empty((b, num_heads, -(-l // 64)),
                                 dtype=torch.float32, device=qkv.device)
    lib = library()
    check(lib, lib.lt_attn_bwd(
        qkv.data_ptr(), kmask.data_ptr(), _ptr(gate), g.data_ptr(),
        stats.data_ptr(), dqkv.data_ptr(), _ptr(dhead), delta.data_ptr(),
        _ptr(dgate_part), b, l, num_heads, float(sm_scale),
        int(qkv.dtype == torch.float32),
        torch.cuda.current_stream(qkv.device).cuda_stream),
        "attention backward kernel")
    fused_vit_attention.bwd_launches += 1
    if dhead is not None:
        dhead = dhead.to(head_mask.dtype)
    return dqkv, dhead


def _no_stats(qkv):
    return qkv.new_empty((0,), dtype=torch.float32)


def _attention_cpu(qkv, key_mask, head_mask, num_heads, sm_scale,
                   with_stats):
    # the plain backward recomputes the softmax: no row statistics
    return (reference_vit_attention(qkv, key_mask, head_mask, num_heads,
                                    sm_scale), _no_stats(qkv))


def _attention_cuda(qkv, key_mask, head_mask, num_heads, sm_scale,
                    with_stats):
    if with_stats:
        return _launch_fwd(qkv, key_mask, head_mask, num_heads, sm_scale,
                           return_stats=True)
    return (_launch_fwd(qkv, key_mask, head_mask, num_heads, sm_scale),
            _no_stats(qkv))


def _attention_fake(qkv, key_mask, head_mask, num_heads, sm_scale,
                    with_stats):
    b, l, d3 = qkv.shape
    stats = ((b, num_heads, 2, l) if with_stats and qkv.device.type != "cpu"
             else (0,))
    return (qkv.new_empty((b, l, d3 // 3)),
            qkv.new_empty(stats, dtype=torch.float32))


def _attention_bwd_cpu(qkv, key_mask, head_mask, g, stats, num_heads,
                       sm_scale):
    dqkv, dhead = reference_vit_attention_bwd(qkv, key_mask, head_mask, g,
                                              num_heads, sm_scale)
    return dqkv, _no_stats(qkv) if dhead is None else dhead


def _attention_bwd_cuda(qkv, key_mask, head_mask, g, stats, num_heads,
                        sm_scale):
    dqkv, dhead = _launch_bwd(qkv, key_mask, head_mask, g, num_heads,
                              sm_scale, stats)
    return dqkv, _no_stats(qkv) if dhead is None else dhead


def _attention_bwd_fake(qkv, key_mask, head_mask, g, stats, num_heads,
                        sm_scale):
    return qkv.new_empty(qkv.shape), (
        _no_stats(qkv) if head_mask is None
        else head_mask.new_empty(head_mask.shape))


# B4 is the op ``laudnet::vit_attention`` (`ops/library.py`): ``(out,
# stats)``, ``stats`` the row statistics where ``with_stats`` asks for them
# and an empty f32 tensor otherwise (always on the CPU). B5 is the op
# ``laudnet::vit_attention_bwd``: ``(dqkv, dhead)``, ``dhead`` empty without
# a head mask; it is B4's autograd formula, fed B4's row statistics.
_attention_op = register(
    "vit_attention(Tensor qkv, Tensor key_mask, Tensor? head_mask, "
    "int num_heads, float sm_scale, bool with_stats) -> (Tensor, Tensor)",
    _attention_cpu, _attention_cuda, _attention_fake)
_attention_bwd_op = register(
    "vit_attention_bwd(Tensor qkv, Tensor key_mask, Tensor? head_mask, "
    "Tensor g, Tensor? stats, int num_heads, float sm_scale) -> "
    "(Tensor, Tensor)", _attention_bwd_cpu, _attention_bwd_cuda,
    _attention_bwd_fake)


def _attention_setup(ctx, inputs, output):
    qkv, key_mask, head_mask, num_heads, sm_scale, with_stats = inputs
    ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
    stats = output[1]
    ctx.mark_non_differentiable(stats)
    ctx.save_for_backward(qkv, key_mask, head_mask,
                          stats if stats.numel() else None)


def _attention_backward(ctx, g, _):
    qkv, key_mask, head_mask, stats = ctx.saved_tensors
    dqkv, dhead = _attention_bwd_op(qkv, key_mask, head_mask, g, stats,
                                    ctx.num_heads, ctx.sm_scale)
    # the additive key mask removes keys; it is no differentiable gate
    return dqkv, None, None if head_mask is None else dhead, None, None, None


torch.library.register_autograd("laudnet::vit_attention", _attention_backward,
                                setup_context=_attention_setup, lib=LIB)


def fused_vit_attention(qkv: torch.Tensor, key_mask: torch.Tensor,
                        head_mask, num_heads: int,
                        sm_scale: float) -> torch.Tensor:
    """Fused masked multi-head attention (B4a/B4 forward, B5 backward), the
    registered op ``laudnet::vit_attention`` with B5 as its autograd.
    Arguments and result as `reference_vit_attention`, which CPU tensors
    run, with `reference_vit_attention_bwd` as their backward. CUDA tensors
    launch the kernels: bf16 or f32 qkv, heads of 64, any L; anything else
    raises. The forward rounds where the TPU strip kernel does: p is
    rounded to qkv's dtype before P.V, the head gate multiplies the f32
    output, and the output is rounded once. Gradients flow to ``qkv`` and
    ``head_mask``; ``key_mask`` gets none."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {qkv.device}")
    needs_grad = torch.is_grad_enabled() and (
        qkv.requires_grad
        or (head_mask is not None and head_mask.requires_grad))
    return _attention_op(qkv, key_mask, head_mask, num_heads, sm_scale,
                         needs_grad)[0]


fused_vit_attention.launches = 0
fused_vit_attention.bwd_launches = 0
