"""Fused pre-norm ViT block (B1), layer segment (B2) and W8A8 block (B6).

Counterparts of `laudnet_tpu/ops/pallas/vit_block.py::fused_vit_block`,
`::fused_vit_segment` and `::fused_vit_block_int8`. One layer computes

    x2  = x + proj(MHA(LN1(x))) * row_mask
    out = x2 + fc2(GELU(fc1(LN2(x2)))) * row_mask

with an additive -1e9 key mask in the attention and an optional (B, H) 0/1
head gate on each head's attention output. ``fast_math`` swaps in one-pass
LayerNorm, tanh GELU and softmax normalised after P.V. The W8A8 block runs
the four weight products on per-row s8 activations and per-channel s8
weights with exact integer sums; everything else stays float.

Each wrapper takes the plain PyTorch version below only for tensors on the
CPU. For CUDA tensors it launches the hand-written kernels of
``csrc/vit_block.cu`` (bf16 only) or raises; it never falls back. Each
wrapper counts its kernel launches in ``<wrapper>.launches``. The four
weight products of a layer run on the GEMM core of ``csrc/gemm_sm90.cuh``
(TMA and wgmma, bf16 or s8); `block_gemm` launches one of them alone, with
its epilogue, beside its plain version `block_gemm_reference`.

A layer's parameters are a dict in torch.nn.Linear layout:
``{"ln1", "qkv", "proj", "ln2", "fc1", "fc2"}``, each ``{"weight",
"bias"}`` (Linear weights are (out, in)); a segment layer may also carry
``"token_policy"`` {weight (2, D), bias (2,)}. The W8A8 block's products
are ``{"weight_q": int8 (out, in), "scale": f32 (out,), "bias"}``
(`quantize_block_params`). The TPU kernels take the head gate expanded to
feature lanes, (B, 1, D); that is a layout of theirs, and the port keeps
(B, H).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from laudnet_tpu_torch.ops.library import register
from laudnet_tpu_torch.ops.quant import (int8_linear, int_matmul,
                                        quantize_rows, quantize_weight)

NEG = -1e9
DH = 64            # head width the attention kernel takes
MAX_DIM = 1024     # LayerNorm kernel: 32 values per lane
MAX_HIDDEN_INT8 = 4096  # row-quantise kernel: 128 values per lane
# the attention ablations of the block-budget probe keep their score rows
# in registers (csrc/vit_block.cu::attention_kernel); the production forms
# take any L (longer rows go to csrc/attention.cu's streaming forward)
MAX_LEN_ABLATION = 256
EPI_QKV, EPI_PROJ, EPI_FC1, EPI_FC2 = 0, 1, 2, 3  # csrc/vit_block.cu
# the body variants' codes in csrc/vit_block.cu (LnForm, Act, Softmax, VAR_*)
LN_FORMS = ("twopass", "onepass", "scale")
ACTS = ("erf", "tanh", "silu", "none")
SOFTMAXES = ("exact", "deferred", "linear", "nomax")
VAR_NO_ROWMASK, VAR_BF16_RES = 4, 8


@dataclasses.dataclass(frozen=True)
class BlockVariant:
    """A layer body: the production one (`EXACT`, `FAST`) or an ablation of
    the block-budget probe (P1, `tools/probe_block_budget.py`).

    ``ln``: 'twopass', 'onepass' or 'scale' (x * weight: no statistics, no
    bias); ``act`` (fc1): 'erf', 'tanh', 'silu' (x * sigmoid(1.702 x)) or
    'none'; ``softmax``: 'exact', 'deferred' (normalised after P.V),
    'linear' (p = s * 1e-4, never normalised) or 'nomax' (exp(s) without
    the row max, normalised after P.V); ``row_mask``: the proj and fc2
    outputs are multiplied by the row mask; ``bf16_residual``: x2 =
    bf16(x + bf16(proj * row_mask)) instead of f32."""
    ln: str = "twopass"
    act: str = "erf"
    softmax: str = "exact"
    row_mask: bool = True
    bf16_residual: bool = False

    def codes(self):
        """(LayerNorm form, lt_gemm variant, softmax) as the kernels take
        them."""
        var = ACTS.index(self.act)
        if not self.row_mask:
            var |= VAR_NO_ROWMASK
        if self.bf16_residual:
            var |= VAR_BF16_RES
        return LN_FORMS.index(self.ln), var, SOFTMAXES.index(self.softmax)


EXACT = BlockVariant()
FAST = BlockVariant(ln="onepass", act="tanh", softmax="deferred")


# --- plain block math ------------------------------------------------------

def layer_norm(x, weight, bias, eps=1e-6):
    """Two-pass LayerNorm in f32 (`vit_block.py::_ln`); eps is flax's."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y * weight.float() + bias.float()


def layer_norm_onepass(x, weight, bias, eps=1e-6):
    """One-pass LayerNorm, var = E[x^2] - mu^2 (`vit_block.py::_ln_onepass`)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var.clamp_min(0.0) + eps)
    return y * weight.float() + bias.float()


def gelu_exact(x):
    """Erf GELU (the TPU kernel's A-S polynomial is within 1.5e-7 of it)."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def gelu_tanh(x):
    """The tanh GELU approximation (`vit_block.py::_gelu_tanh`)."""
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x * x * x)))


def layer_norm_scale(x, weight, bias, eps=1e-6):
    """The probe's "no LayerNorm": x * weight in f32, bias unused
    (`probe_block_budget.py::_ln_scale_only`)."""
    return x.float() * weight.float()


def silu_gelu(x):
    """x * sigmoid(1.702 x), a cheap GELU (`probe_block_budget.py::_silu_gelu`)."""
    return x * torch.sigmoid(1.702 * x)


_LN = {"twopass": layer_norm, "onepass": layer_norm_onepass,
       "scale": layer_norm_scale}
_ACT = {"erf": gelu_exact, "tanh": gelu_tanh, "silu": silu_gelu,
        "none": lambda u: u}


def _mm(a, weight, bias):
    """a @ weight.T + bias with f32 accumulation: bf16 products are exact in
    f32, so this is the TPU kernel's bf16-operand, f32-accumulate product."""
    return a.float() @ weight.float().t() + bias.float()


def attention(qkv, neg, num_heads, sm_scale, fast=False, head_gate=None,
              softmax=None):
    """Masked MHA over packed (B, L, 3D) qkv in the compute dtype, heads
    merged, rounded to that dtype per head (`vit_block.py::_pair_attention`
    without the TPU lane pairing). ``neg``: (B, L) additive key mask.
    Exact normalises p before P.V; ``fast`` uses p = exp(s - max) rounded
    for P.V and divides by the unrounded f32 row sum afterwards.
    ``softmax`` names the form instead of ``fast`` (`BlockVariant`):
    'linear' is p = s * 1e-4 with no normalisation, 'nomax' exp(s)
    normalised after P.V. ``head_gate``: (B, H) 0/1, multiplied into the
    rounded output in the compute dtype (`vit_block.py:428-430`)."""
    cdt = qkv.dtype
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    x = qkv.reshape(b, l, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = x[0].float(), x[1].float(), x[2].float()
    s = (q @ k.transpose(-1, -2)) * sm_scale + neg[:, None, None, :]
    softmax = softmax or ("deferred" if fast else "exact")
    if softmax == "deferred":
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = (p.to(cdt).float() @ v) / p.sum(-1, keepdim=True)
    elif softmax == "nomax":
        p = torch.exp(s)
        o = (p.to(cdt).float() @ v) / p.sum(-1, keepdim=True)
    elif softmax == "linear":
        o = (s * 1e-4).to(cdt).float() @ v
    else:
        o = torch.softmax(s, dim=-1).to(cdt).float() @ v
    o = o.to(cdt)
    if head_gate is not None:
        o = o * head_gate.to(cdt)[:, :, None, None]
    return o.permute(0, 2, 1, 3).reshape(b, l, d)


def token_logits(x, weight, bias):
    """Eval token-policy logits (B, L, 2): ``x @ k`` accumulated in f32 and
    rounded to x's dtype BEFORE the bias add, the bias added in that dtype
    (`infer/fused_vit.py:224-225`, `vit_block.py:589-591`). A bf16 tie must
    decide as it does there."""
    return (x.float() @ weight.float().t()).to(x.dtype) + bias.to(x.dtype)


def token_gate(x, weight, bias):
    """0/1 f32 keep gate (B, L): ``logit0 >= logit1``, class token pinned."""
    tl = token_logits(x, weight, bias)
    gate = (tl[..., 0] >= tl[..., 1]).float()
    gate[:, 0] = 1.0
    return gate


def _layer_plain(x, kmask, rmask, p, num_heads, ln_eps, fast_math,
                 head_gate=None, variant=None):
    """One layer on (B, L, D) x; ``kmask`` (B, L), ``rmask`` (B, L, 1) f32.
    Rounding points: `vit_block.py:421-442`. ``variant`` (a `BlockVariant`)
    replaces the body that ``fast_math`` picks."""
    cdt = x.dtype
    v = variant or (FAST if fast_math else EXACT)
    ln, gelu = _LN[v.ln], _ACT[v.act]
    neg = (1.0 - kmask) * NEG
    h1 = ln(x, p["ln1"]["weight"], p["ln1"]["bias"], ln_eps).to(cdt)
    qkv = _mm(h1, p["qkv"]["weight"], p["qkv"]["bias"]).to(cdt)
    attn = attention(qkv, neg, num_heads, (x.shape[-1] // num_heads) ** -0.5,
                     softmax=v.softmax, head_gate=head_gate)
    proj = _mm(attn, p["proj"]["weight"], p["proj"]["bias"])
    if v.bf16_residual:
        x2 = (x + (proj * rmask).to(cdt)).float()
    else:
        x2 = x.float() + (proj * rmask if v.row_mask else proj)
    # LN2's input is rounded BEFORE the LayerNorm (`vit_block.py:436`)
    h2 = ln(x2.to(cdt), p["ln2"]["weight"], p["ln2"]["bias"], ln_eps).to(cdt)
    u = gelu(_mm(h2, p["fc1"]["weight"], p["fc1"]["bias"])).to(cdt)
    y = _mm(u, p["fc2"]["weight"], p["fc2"]["bias"])
    return (x2 + (y * rmask if v.row_mask else y)).to(cdt)


def fused_vit_block_reference(x, key_mask, row_mask, params, *,
                              num_heads: int, head_gate=None,
                              ln_eps: float = 1e-6, fast_math: bool = False,
                              variant=None):
    """Plain PyTorch version of `fused_vit_block`, on any device."""
    b, l, _ = x.shape
    return _layer_plain(x, key_mask.reshape(b, l).float(),
                        row_mask.reshape(b, l, 1).float(), params,
                        num_heads, ln_eps, fast_math, head_gate=head_gate,
                        variant=variant)


def quantize_block_params(params: dict) -> dict:
    """A layer's parameter dict with its four products quantised per
    output channel (`ops/quant.py::quantize_weight`): the W8A8 block's
    ``qparams``. LayerNorms, biases and a token policy stay as they are."""
    q = dict(params)
    for name in ("qkv", "proj", "fc1", "fc2"):
        wq, ws = quantize_weight(params[name]["weight"])
        q[name] = {"weight_q": wq, "scale": ws, "bias": params[name]["bias"]}
    return q


def fused_vit_block_int8_reference(x, key_mask, row_mask, qparams, *,
                                   num_heads: int, head_gate=None,
                                   ln_eps: float = 1e-6):
    """Plain PyTorch version of `fused_vit_block_int8`, on any device, with
    exact integer products. Where it rounds differently from
    `fused_vit_block` (`vit_block.py:272-287`): LN1's output and x2 go
    into the quantiser and LN2 as f32, unrounded; LayerNorm is two-pass
    and GELU the erf form; GELU's f32 output is quantised from f32; the
    proj input is the attention output in the compute dtype, upcast."""
    cdt = x.dtype
    b, l, d = x.shape
    rmask = row_mask.reshape(b, l, 1).float()
    neg = (1.0 - key_mask.reshape(b, l).float()) * NEG
    p = qparams

    def qmm(a, name):
        return int8_linear(a, p[name]["weight_q"], p[name]["scale"],
                           p[name]["bias"])

    h1 = layer_norm(x, p["ln1"]["weight"], p["ln1"]["bias"], ln_eps)
    qkv = qmm(h1, "qkv").to(cdt)
    attn = attention(qkv, neg, num_heads, (d // num_heads) ** -0.5,
                     head_gate=head_gate)
    x2 = x.float() + qmm(attn.float(), "proj") * rmask
    h2 = layer_norm(x2, p["ln2"]["weight"], p["ln2"]["bias"], ln_eps)
    u = gelu_exact(qmm(h2, "fc1"))
    return (x2 + qmm(u, "fc2") * rmask).to(cdt)


def fused_vit_segment_reference(x, token_mask, params_list, *,
                                num_heads: int, ln_eps: float = 1e-6,
                                fast_math: bool = False):
    """Plain PyTorch version of `fused_vit_segment`, on any device."""
    mask = token_mask.float()
    for p in params_list:
        if "token_policy" in p:
            tp = p["token_policy"]
            mask = mask * token_gate(x, tp["weight"], tp["bias"])
        x = _layer_plain(x, mask, mask[..., None], p, num_heads, ln_eps,
                         fast_math)
    return x, mask


# --- kernels -----------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(x, masks, params_list, num_heads, head_gate=None,
                int8=False):
    """Raises on what the kernels do not take: they read raw pointers, so
    dtype, device, shape and contiguity are checked here. ``int8``: the
    four products are W8A8 ones (``weight_q`` int8 codes, ``scale`` f32)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA block kernels take bf16, got x {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, L, D) tensor")
    b, l, d = x.shape
    if d != num_heads * DH:
        raise ValueError(f"the attention kernel takes heads of {DH}: "
                         f"D={d}, num_heads={num_heads}")
    if d > MAX_DIM:
        raise ValueError(f"kernel limits: D <= {MAX_DIM}; got D={d}")
    for m in masks:
        if m.device != x.device or m.numel() != b * l:
            raise ValueError(f"masks must hold B*L={b * l} values on "
                             f"{x.device}, got {tuple(m.shape)} on {m.device}")
    if head_gate is not None and (
            head_gate.device != x.device
            or tuple(head_gate.shape) != (b, num_heads)):
        raise ValueError(f"head_gate must be ({b}, {num_heads}) on "
                         f"{x.device}, got {tuple(head_gate.shape)} on "
                         f"{head_gate.device}")
    dtypes = {"weight": torch.bfloat16, "bias": torch.bfloat16,
              "weight_q": torch.int8, "scale": torch.float32}
    kinds = {"weight_q", "scale", "bias"} if int8 else {"weight", "bias"}
    step = 16 if int8 else 8  # K of 16 bytes: TMA's row stride
    for p in params_list:
        for name in ("qkv", "proj", "fc1", "fc2"):
            if set(p[name]) != kinds:
                raise TypeError(f"{name} must hold {sorted(kinds)}, got "
                                f"{sorted(p[name])}")
        hidden = p["fc1"]["weight_q" if int8 else "weight"].shape[0]
        if hidden % step:
            raise ValueError(f"the GEMM kernel needs K % {step} == 0 (rows "
                             f"of 16-byte multiples): hidden={hidden}")
        if int8 and hidden > MAX_HIDDEN_INT8:
            raise ValueError(f"the row-quantise kernel takes hidden <= "
                             f"{MAX_HIDDEN_INT8}, got {hidden}")
        weight_shapes = {"ln1": (d,), "ln2": (d,), "qkv": (3 * d, d),
                         "proj": (d, d), "fc1": (hidden, d),
                         "fc2": (d, hidden), "token_policy": (2, d)}
        for name, sub in p.items():
            shape = weight_shapes[name]
            want = {"weight": shape, "weight_q": shape, "bias": shape[:1],
                    "scale": shape[:1]}
            for kind, t in sub.items():
                if t.dtype != dtypes[kind] or t.device != x.device:
                    raise TypeError(f"{name}.{kind} must be {dtypes[kind]} "
                                    f"on {x.device}, got {t.dtype} on "
                                    f"{t.device}")
                if tuple(t.shape) != want[kind] or not t.is_contiguous():
                    raise ValueError(f"{name}.{kind} must be a contiguous "
                                     f"{want[kind]}, got {tuple(t.shape)}")


def _f32(t):
    """A mask or gate as the contiguous f32 the kernels read (or None)."""
    return None if t is None else t.float().contiguous()


def row_cluster(n, *, wide=True, fc1=False):
    """The blocks of a cluster that holds whole rows of a product N wide, or
    0 where the GEMM core's row epilogues do not take N
    (`csrc/vit_block_rows.cu::row_cluster`). The D-wide products (proj,
    and fc2 inside a segment) take CN = 2 tiles of the core's width (224
    where it divides N and 192 does not and ``wide``, else 192): DeiT-S's
    384, T2T-ViT-19's 448 (P1's ablated bodies, ``wide`` off, at 192
    only). The s8 fc1 (``fc1``) takes tiles of 192 and CN = 2, 7 or 8
    (hidden 384, T2T-ViT-19's 1344, DeiT-S's 1536). Other widths run the
    product and its row pass as separate launches."""
    if fc1:
        return n // 192 if n % 192 == 0 and n // 192 in (2, 7, 8) else 0
    bn = 224 if wide and n % 224 == 0 and n % 192 else 192
    return 2 if n == 2 * bn else 0


def _gemm(lib, a, w, n, k, epi, out, resid=None, rmask=None, variant=0):
    """One bf16 product of the layer (``lt_gemm``): ``a`` (M, k), ``w``
    {weight (n, k), bias (n,)}, epilogue ``epi`` (EPI_*), into ``out``."""
    from laudnet_tpu_torch.ops._build import check

    check(lib, lib.lt_gemm(
        _ptr(a), _ptr(w["weight"]), _ptr(w["bias"]), a.numel() // k, n, k,
        epi, _ptr(resid), _ptr(rmask), variant, _ptr(out),
        torch.cuda.current_stream(a.device).cuda_stream), "gemm kernel")
    return out


def _gemm_rows(lib, a, w, n, k, epi, out, out2, resid, rmask, ln, ln_eps,
               variant=0, ln_form=0, policy=None, mask=None, seq_len=1):
    """A bf16 product with its row pass on a cluster (``lt_gemm_rows``):
    EPI_PROJ writes x2 to ``out`` and bf16(LN2(bf16(x2))) (``ln``
    {weight, bias}) to ``out2``; EPI_FC2 writes out and the next layer's
    bf16(LN1(out)), composing its token ``policy`` into ``mask`` in
    place."""
    from laudnet_tpu_torch.ops._build import check

    tp = policy or {}
    check(lib, lib.lt_gemm_rows(
        _ptr(a), _ptr(w["weight"]), _ptr(w["bias"]), a.numel() // k, n, k,
        epi, _ptr(resid), _ptr(rmask), variant, _ptr(out), ln_form,
        _ptr(ln["weight"]), _ptr(ln["bias"]), ln_eps, _ptr(out2),
        _ptr(tp.get("weight")), _ptr(tp.get("bias")), _ptr(mask), seq_len,
        torch.cuda.current_stream(a.device).cuda_stream),
        "gemm kernel with its row pass")
    return out, out2


def _gemm_s8(lib, a, w, n, k, epi, out, resid=None, rmask=None):
    """One s8 product of the W8A8 layer (``lt_gemm_s8``): ``a`` = (codes
    (M, k) int8, scales (M,) f32), ``w`` {weight_q (n, k), scale (n,),
    bias (n,)}, into ``out``."""
    from laudnet_tpu_torch.ops._build import check

    q, qs = a
    check(lib, lib.lt_gemm_s8(
        _ptr(q), _ptr(qs), _ptr(w["weight_q"]), _ptr(w["scale"]),
        _ptr(w["bias"]), q.numel() // k, n, k, epi, _ptr(resid), _ptr(rmask),
        _ptr(out), torch.cuda.current_stream(q.device).cuda_stream),
        "s8 gemm kernel")
    return out


def _gemm_s8_rows(lib, a, w, n, k, epi, codes, out=None, resid=None,
                  rmask=None, ln=None, ln_eps=1e-6):
    """An s8 product with its row quantiser on a cluster
    (``lt_gemm_s8_rows``): EPI_PROJ writes x2 (f32) to ``out`` and the
    codes of LN2(x2) (``ln``) to ``codes`` = (int8 (M, n), f32 (M,));
    EPI_FC1 writes only the codes of its erf GELU output."""
    from laudnet_tpu_torch.ops._build import check

    q, qs = a
    ln = ln or {}
    check(lib, lib.lt_gemm_s8_rows(
        _ptr(q), _ptr(qs), _ptr(w["weight_q"]), _ptr(w["scale"]),
        _ptr(w["bias"]), q.numel() // k, n, k, epi, _ptr(resid), _ptr(rmask),
        _ptr(out), _ptr(ln.get("weight")), _ptr(ln.get("bias")), ln_eps,
        _ptr(codes[0]), _ptr(codes[1]),
        torch.cuda.current_stream(q.device).cuda_stream),
        "s8 gemm kernel with its row quantiser")
    return codes


@functools.lru_cache(maxsize=64)
def _layer_workspace(m, d, hidden, segment=False):
    """Byte offsets of the scratch buffers of `lt_vit_layer` (h1, qkv,
    attn, x2 in f32, h2, u) and, for `lt_vit_segment`, of two (M, D)
    bf16 buffers the layers' outputs alternate in and two their h1s
    alternate in, inside one allocation, each 256-byte aligned; and the
    allocation's size."""
    sizes = [m * d * 2, m * 3 * d * 2, m * d * 2, m * d * 4, m * d * 2,
             m * hidden * 2] + [m * d * 2] * (4 if segment else 0)
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // 256) * 256
    return tuple(offsets), total


def _layer_cuda(lib, x, kmask, rmask, p, num_heads, ln_eps, fast_math,
                policy=None, head_gate=None, variant=None, fuse=True,
                stream=None):
    """One bf16 layer (B1). Six launches: LN1 (+ the token gate of
    ``policy``, updating ``kmask`` in place), qkv, attention, proj with LN2
    in its epilogue, fc1, fc2. Widths the row epilogues do not take
    (`row_cluster`) run LN2 as a launch of its own. One host call,
    ``lt_vit_layer``, issues the launches into scratch buffers of one
    allocation (a launch a call from here cost the host about twice as
    much). ``fuse=False`` runs the seven launches of earlier builds from
    here, one call each, through the C entry points that earlier builds
    have too (`tools/compare_b1_build.py` runs another build so).
    ``kmask`` and ``rmask`` are contiguous (B, L) f32, ``head_gate``
    contiguous (B, H) f32 or None; ``variant`` as `_layer_plain`;
    ``stream`` the current stream's handle (looked up if None). Returns
    the layer's output."""
    from laudnet_tpu_torch.ops._build import check

    b, l, d = x.shape
    m = b * l
    hidden = p["fc1"]["weight"].shape[0]
    if stream is None:
        stream = torch.cuda.current_stream(x.device).cuda_stream
    v = variant or (FAST if fast_math else EXACT)
    ln_form, gemm_var, softmax = v.codes()
    bf16 = dict(dtype=torch.bfloat16, device=x.device)
    if fuse:
        offsets, size = _layer_workspace(m, d, hidden)
        base = torch.empty(size, dtype=torch.uint8, device=x.device)
        out = torch.empty((b, l, d), **bf16)
        tp = policy or {}
        params = (ctypes.c_void_p * len(LAYER_KEYS))(
            *[p[name][kind].data_ptr() for name, kind in LAYER_KEYS])
        ws = base.data_ptr()
        check(lib, lib.lt_vit_layer(
            _ptr(x), _ptr(kmask), _ptr(rmask), _ptr(head_gate), None,
            ctypes.addressof(params), _ptr(tp.get("weight")),
            _ptr(tp.get("bias")), None, None, None, None, b, l, d, hidden,
            num_heads, DH ** -0.5, ln_eps, ln_form, gemm_var, softmax,
            _proj_rows(d, v), *[ws + o for o in offsets], _ptr(out), None,
            stream), "layer kernels")
        return out

    def ln(inp, is_f32, w, tp=None, mask=None):
        out = torch.empty((m, d), **bf16)
        tp = tp or {}
        check(lib, lib.lt_layernorm(
            _ptr(inp), is_f32, _ptr(out), _ptr(w["weight"]), _ptr(w["bias"]),
            m, d, ln_eps, ln_form, _ptr(tp.get("weight")),
            _ptr(tp.get("bias")), _ptr(mask), l, stream), "layernorm kernel")
        return out

    def gemm(a, w, n, k, epi, out, resid=None):
        return _gemm(lib, a, w, n, k, epi, out, resid, rmask, gemm_var)

    h1 = ln(x, 0, p["ln1"], policy, kmask if policy else None)
    qkv = gemm(h1, p["qkv"], 3 * d, d, EPI_QKV, torch.empty((m, 3 * d), **bf16))
    attn = torch.empty((m, d), **bf16)
    check(lib, lib.lt_attention(_ptr(qkv), _ptr(kmask), _ptr(head_gate),
                                _ptr(attn), b, l, num_heads, DH ** -0.5,
                                softmax, stream), "attention kernel")
    x2 = torch.empty((m, d), dtype=torch.float32, device=x.device)
    h2 = ln(gemm(attn, p["proj"], d, d, EPI_PROJ, x2, resid=x), 1, p["ln2"])
    u = gemm(h2, p["fc1"], hidden, d, EPI_FC1, torch.empty((m, hidden), **bf16))
    out = torch.empty((b, l, d), **bf16)
    return gemm(u, p["fc2"], d, hidden, EPI_FC2, out, resid=x2)


def _proj_rows(d, v):
    """1 where proj of width ``d`` runs with LN2 in its epilogue for the
    body ``v`` (a `BlockVariant`), else 0."""
    wide = v.row_mask and not v.bf16_residual and v.ln != "scale"
    return int(row_cluster(d, wide=wide) > 0)


def _layer_int8_cuda(lib, x, kmask, rmask, p, num_heads, ln_eps,
                     head_gate=None, fuse=True):
    """Seven launches: LN1 + row quantise, s8 qkv, attention (exact form,
    head gate), row quantise, s8 proj (+residual, f32 x2) with LN2 + row
    quantise of the unrounded x2 in its epilogue, s8 fc1 with erf GELU +
    row quantise in its epilogue (u never leaves the SM), s8 fc2
    (+residual). Widths the row epilogues do not take (`row_cluster`) and
    ``fuse=False`` (the launches of earlier builds) run the LN2 quantiser
    and fc1's f32 output with its quantiser as launches of their own: nine.
    Masks and gate as `_layer_cuda` takes them."""
    from laudnet_tpu_torch.ops._build import check

    b, l, d = x.shape
    m = b * l
    hidden = p["fc1"]["weight_q"].shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dev = x.device

    def codes(k):
        return (torch.empty((m, k), dtype=torch.int8, device=dev),
                torch.empty((m,), dtype=torch.float32, device=dev))

    def ln_quant(inp, is_f32, w):
        q, qs = codes(d)
        check(lib, lib.lt_layernorm_quant(
            _ptr(inp), is_f32, _ptr(q), _ptr(qs), _ptr(w["weight"]),
            _ptr(w["bias"]), m, d, ln_eps, stream),
            "layernorm-quantise kernel")
        return q, qs

    def rowquant(inp, is_f32, k):
        q, qs = codes(k)
        check(lib, lib.lt_rowquant(_ptr(inp), is_f32, _ptr(q), _ptr(qs), m,
                                   k, stream), "row-quantise kernel")
        return q, qs

    def gemm(a, w, n, k, epi, out, resid=None):
        return _gemm_s8(lib, a, w, n, k, epi, out, resid, rmask)

    qkv = gemm(ln_quant(x, 0, p["ln1"]), p["qkv"], 3 * d, d, EPI_QKV,
               torch.empty((m, 3 * d), dtype=torch.bfloat16, device=dev))
    attn = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    check(lib, lib.lt_attention(_ptr(qkv), _ptr(kmask), _ptr(head_gate),
                                _ptr(attn), b, l, num_heads, DH ** -0.5, 0,
                                stream), "attention kernel")
    x2 = torch.empty((m, d), dtype=torch.float32, device=dev)
    if fuse and row_cluster(d):
        h2 = _gemm_s8_rows(lib, rowquant(attn, 0, d), p["proj"], d, d,
                           EPI_PROJ, codes(d), x2, x, rmask, p["ln2"], ln_eps)
    else:
        h2 = ln_quant(gemm(rowquant(attn, 0, d), p["proj"], d, d, EPI_PROJ,
                           x2, resid=x), 1, p["ln2"])
    if fuse and row_cluster(hidden, wide=False, fc1=True):
        u = _gemm_s8_rows(lib, h2, p["fc1"], hidden, d, EPI_FC1,
                          codes(hidden))
    else:
        u = rowquant(gemm(h2, p["fc1"], hidden, d, EPI_FC1, torch.empty(
            (m, hidden), dtype=torch.float32, device=dev)), 1, hidden)
    return gemm(u, p["fc2"], d, hidden, EPI_FC2,
                torch.empty((b, l, d), dtype=torch.bfloat16, device=dev),
                resid=x2)


def _route(x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


# --- the registered ops ------------------------------------------------------
# B1, B6 and B2 are ops of the ``laudnet`` namespace (`ops/library.py`). An
# op's schema takes tensors, lists of tensors and scalars: a layer's
# parameter dict travels as a flat list in the fixed key order below.

LAYER_KEYS = tuple((m, k) for m in ("ln1", "qkv", "proj", "ln2", "fc1", "fc2")
                   for k in ("weight", "bias"))
INT8_LAYER_KEYS = tuple(
    (m, k) for m in ("ln1", "qkv", "proj", "ln2", "fc1", "fc2")
    for k in (("weight", "bias") if m.startswith("ln")
              else ("weight_q", "scale", "bias")))
POLICY_KEYS = (("token_policy", "weight"), ("token_policy", "bias"))


def flatten_layer(p: dict, int8: bool = False) -> list:
    """A layer's parameter dict as the ops' flat tensor list; raises on a
    product whose keys are not the float (or, ``int8``, the W8A8) ones."""
    keys = INT8_LAYER_KEYS if int8 else LAYER_KEYS
    kinds = {"weight_q", "scale", "bias"} if int8 else {"weight", "bias"}
    for name in ("qkv", "proj", "fc1", "fc2"):
        if set(p[name]) != kinds:
            raise TypeError(f"{name} must hold {sorted(kinds)}, got "
                            f"{sorted(p[name])}")
    flat = [p[m][k] for m, k in keys]
    if "token_policy" in p:
        flat += [p[m][k] for m, k in POLICY_KEYS]
    return flat


def unflatten_layer(flat, int8: bool = False) -> dict:
    """The inverse of `flatten_layer` (a token policy where the list holds
    its two tensors)."""
    keys = INT8_LAYER_KEYS if int8 else LAYER_KEYS
    if len(flat) > len(keys):
        keys = keys + POLICY_KEYS
    p: dict = {}
    for (m, k), t in zip(keys, flat):
        p.setdefault(m, {})[k] = t
    return p


def _segment_layers(flat, has_policy):
    layers, i = [], 0
    for policy in has_policy:
        n = len(LAYER_KEYS) + (len(POLICY_KEYS) if policy else 0)
        layers.append(unflatten_layer(flat[i:i + n]))
        i += n
    return layers


def _vit_block_cpu(x, key_mask, row_mask, params, num_heads, head_gate,
                   ln_eps, fast_math):
    return fused_vit_block_reference(
        x, key_mask, row_mask, unflatten_layer(params), num_heads=num_heads,
        head_gate=head_gate, ln_eps=ln_eps, fast_math=fast_math)


def _vit_block_cuda(x, key_mask, row_mask, params, num_heads, head_gate,
                    ln_eps, fast_math):
    from laudnet_tpu_torch.ops._build import library

    p = unflatten_layer(params)
    _check_cuda(x, (key_mask, row_mask), [p], num_heads, head_gate)
    b, l, _ = x.shape
    out = _layer_cuda(library(), x, _f32(key_mask.reshape(b, l)),
                      _f32(row_mask.reshape(b, l)), p, num_heads, ln_eps,
                      fast_math, head_gate=_f32(head_gate))
    fused_vit_block.launches += 1
    return out


def _vit_block_int8_cpu(x, key_mask, row_mask, qparams, num_heads,
                        head_gate, ln_eps):
    return fused_vit_block_int8_reference(
        x, key_mask, row_mask, unflatten_layer(qparams, int8=True),
        num_heads=num_heads, head_gate=head_gate, ln_eps=ln_eps)


def _vit_block_int8_cuda(x, key_mask, row_mask, qparams, num_heads,
                         head_gate, ln_eps):
    from laudnet_tpu_torch.ops._build import library

    p = unflatten_layer(qparams, int8=True)
    _check_cuda(x, (key_mask, row_mask), [p], num_heads, head_gate,
                int8=True)
    b, l, _ = x.shape
    out = _layer_int8_cuda(library(), x, _f32(key_mask.reshape(b, l)),
                           _f32(row_mask.reshape(b, l)), p, num_heads,
                           ln_eps, head_gate=_f32(head_gate))
    fused_vit_block_int8.launches += 1
    return out


def _vit_segment_cpu(x, token_mask, params, has_policy, num_heads, ln_eps,
                     fast_math):
    out, mask = fused_vit_segment_reference(
        x, token_mask, _segment_layers(params, has_policy),
        num_heads=num_heads, ln_eps=ln_eps, fast_math=fast_math)
    # an op's outputs may not alias its inputs (no layers, a f32 mask)
    return (out.clone() if out is x else out,
            mask.clone() if mask is token_mask else mask)


def _vit_segment_cuda(x, token_mask, params, has_policy, num_heads, ln_eps,
                      fast_math):
    from laudnet_tpu_torch.ops._build import library

    layers = _segment_layers(params, has_policy)
    _check_cuda(x, (token_mask,), layers, num_heads)
    out = _segment_cuda(library(), x, token_mask, layers, num_heads, ln_eps,
                        fast_math)
    fused_vit_segment.launches += 1
    return out


_vit_block_op = register(
    "vit_block(Tensor x, Tensor key_mask, Tensor row_mask, Tensor[] params, "
    "int num_heads, Tensor? head_gate, float ln_eps, bool fast_math) -> "
    "Tensor", _vit_block_cpu, _vit_block_cuda,
    lambda x, *_: x.new_empty(x.shape))
_vit_block_int8_op = register(
    "vit_block_int8(Tensor x, Tensor key_mask, Tensor row_mask, "
    "Tensor[] qparams, int num_heads, Tensor? head_gate, float ln_eps) -> "
    "Tensor", _vit_block_int8_cpu, _vit_block_int8_cuda,
    lambda x, *_: x.new_empty(x.shape))
_vit_segment_op = register(
    "vit_segment(Tensor x, Tensor token_mask, Tensor[] params, "
    "bool[] has_policy, int num_heads, float ln_eps, bool fast_math) -> "
    "(Tensor, Tensor)", _vit_segment_cpu, _vit_segment_cuda,
    lambda x, token_mask, *_: (x.new_empty(x.shape), token_mask.new_empty(
        token_mask.shape, dtype=torch.float32)))


def fused_vit_block(x, key_mask, row_mask, params, *, num_heads: int,
                    head_gate=None, ln_eps: float = 1e-6,
                    fast_math: bool = False, variant=None):
    """One pre-norm transformer layer (B1). ``x``: (B, L, D); ``key_mask``:
    (B, 1, L) 1/0 over keys; ``row_mask``: (B, L, 1) 1/0 over rows (both
    branch outputs are multiplied by it); ``head_gate``: optional (B, H)
    0/1 gate on each head's attention output. Returns (B, L, D) in x's
    dtype. The op ``laudnet::vit_block``: CPU tensors run
    `fused_vit_block_reference`; CUDA tensors run the kernels (bf16).
    ``variant`` (a `BlockVariant`) replaces the body ``fast_math`` picks:
    the block-budget probe's layer (P1,
    `tools/probe_block_budget.py::build_block`), a plain call that is never
    exported, whose launches count in ``fused_vit_block.variant_launches``
    instead of ``.launches``."""
    on_card = _route(x)
    if variant is None:
        return _vit_block_op(x, key_mask, row_mask, flatten_layer(params),
                             num_heads, head_gate, ln_eps, fast_math)
    if not on_card:
        return fused_vit_block_reference(x, key_mask, row_mask, params,
                                         num_heads=num_heads,
                                         head_gate=head_gate, ln_eps=ln_eps,
                                         fast_math=fast_math, variant=variant)
    from laudnet_tpu_torch.ops._build import library

    _check_cuda(x, (key_mask, row_mask), [params], num_heads, head_gate)
    b, l, _ = x.shape
    if variant.softmax in ("linear", "nomax") and l > MAX_LEN_ABLATION:
        raise ValueError(f"the {variant.softmax!r} softmax ablation takes "
                         f"L <= {MAX_LEN_ABLATION}, got L={l}")
    out = _layer_cuda(library(), x, _f32(key_mask.reshape(b, l)),
                      _f32(row_mask.reshape(b, l)), params, num_heads, ln_eps,
                      fast_math, head_gate=_f32(head_gate), variant=variant)
    fused_vit_block.variant_launches += 1
    return out


fused_vit_block.launches = 0
fused_vit_block.variant_launches = 0


def fused_vit_block_int8(x, key_mask, row_mask, qparams, *, num_heads: int,
                         head_gate=None, ln_eps: float = 1e-6):
    """One W8A8 pre-norm transformer layer (B6): qkv, proj, fc1 and fc2 run
    s8 x s8 -> s32 on the tensor cores with per-output-channel weight
    scales (``qparams``, from `quantize_block_params`) and per-token
    dynamic activation scales computed right before each product;
    attention, LayerNorm, residuals and GELU stay float. Inexact against
    `fused_vit_block` by the quantisation of the products' operands.
    Arguments otherwise as `fused_vit_block`. The op
    ``laudnet::vit_block_int8``: CPU tensors run
    `fused_vit_block_int8_reference`; CUDA tensors run the kernels
    (bf16)."""
    _route(x)
    return _vit_block_int8_op(x, key_mask, row_mask,
                              flatten_layer(qparams, int8=True), num_heads,
                              head_gate, ln_eps)


fused_vit_block_int8.launches = 0


def fused_vit_segment(x, token_mask, params_list, *, num_heads: int,
                      ln_eps: float = 1e-6, fast_math: bool = False):
    """A run of layers between gather points (B2). ``token_mask``: (B, L)
    composed 0/1 gate state at segment entry. A layer carrying
    ``token_policy`` computes its eval gate from its entry x (``logit0 >=
    logit1`` on bf16-rounded logits, class token pinned) and composes it
    into the running mask before its attention. Returns ``(out,
    token_mask_out)``. The op ``laudnet::vit_segment``: CPU tensors run
    `fused_vit_segment_reference`. On CUDA the first layer's gate runs in
    its LN1 launch and every later layer's gate and LN1 in the epilogue of
    the fc2 before it: 1 + 5n launches for n layers (`_layer_cuda`); x is
    rounded to x's dtype after every layer (`vit_block.py:617`)."""
    _route(x)
    flat = [t for p in params_list for t in flatten_layer(p)]
    return _vit_segment_op(x, token_mask, flat,
                           ["token_policy" in p for p in params_list],
                           num_heads, ln_eps, fast_math)


def _segment_cuda(lib, x, token_mask, params_list, num_heads, ln_eps,
                  fast_math, fuse=True):
    """B2's launches on ``lib``: one host call, ``lt_vit_segment``, issues
    every layer's (`_layer_cuda`'s) into scratch buffers of one
    allocation; each layer's h1 (with its token gate) comes from the fc2
    before it where the row epilogues take the width. ``fuse=False``
    runs the layers one `_layer_cuda` call each, as earlier builds launch
    them. Returns ``(out, token_mask_out)``."""
    from laudnet_tpu_torch.ops._build import check

    mask = token_mask.to(torch.float32, copy=True).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if not fuse:
        for p in params_list:
            x = _layer_cuda(lib, x, mask, mask, p, num_heads, ln_eps,
                            fast_math, policy=p.get("token_policy"),
                            fuse=False, stream=stream)
        return x, mask
    if not params_list:
        return x, mask
    b, l, d = x.shape
    m = b * l
    n = len(params_list)
    hidden = params_list[0]["fc1"]["weight"].shape[0]
    v = FAST if fast_math else EXACT
    ln_form, gemm_var, softmax = v.codes()
    offsets, size = _layer_workspace(m, d, hidden, segment=True)
    base = torch.empty(size, dtype=torch.uint8, device=x.device)
    out = torch.empty((b, l, d), dtype=torch.bfloat16, device=x.device)
    params = (ctypes.c_void_p * (len(LAYER_KEYS) * n))(
        *[p[name][kind].data_ptr() for p in params_list
          for name, kind in LAYER_KEYS])
    policies = (ctypes.c_void_p * (2 * n))(
        *[_ptr((p.get("token_policy") or {}).get(kind))
          for p in params_list for kind in ("weight", "bias")])
    ws = base.data_ptr()
    scratch = (ctypes.c_void_p * len(offsets))(*[ws + o for o in offsets])
    check(lib, lib.lt_vit_segment(
        _ptr(x), _ptr(mask), n, ctypes.addressof(params),
        ctypes.addressof(policies), b, l, d, hidden, num_heads, DH ** -0.5,
        ln_eps, ln_form, gemm_var, softmax, _proj_rows(d, v),
        int(row_cluster(d) > 0), ctypes.addressof(scratch), _ptr(out),
        stream), "segment kernels")
    return out, mask


fused_vit_segment.launches = 0


# --- one product alone -------------------------------------------------------

GEMM_EPILOGUES = ("qkv", "proj", "fc1", "fc2")
# the products with a row pass in their epilogue (`row_cluster`'s widths),
# each with its product: proj + LN2 (bf16: h2; s8: LN2's codes), fc2 + the
# next layer's token gate and LN1 (bf16, inside a segment), fc1 + GELU +
# row quantiser (s8)
ROW_PRODUCT = {"proj_ln": "proj", "fc2_ln": "fc2", "fc1_q": "fc1"}
ROW_EPILOGUES = tuple(ROW_PRODUCT)


def _flat_gate(out, policy, seq_len):
    """`token_gate` of (M, D) rows, images of ``seq_len`` rows."""
    g = token_gate(out.reshape(-1, seq_len, out.shape[-1]), policy["weight"],
                   policy["bias"])
    return g.reshape(-1)


def block_gemm_reference(a, w, epilogue, *, resid=None, row_mask=None,
                         variant=None, a_scale=None, ln=None, policy=None,
                         seq_len=None, ln_eps=1e-6):
    """Plain PyTorch version of `block_gemm`, on any device: the epilogue's
    arithmetic as `_layer_plain` (bf16) and `fused_vit_block_int8_reference`
    (s8) apply it, rounded at the same points as the kernel; the row
    epilogues add the row pass that follows the product there."""
    v = variant or EXACT
    mask = row_mask.float()[:, None] if row_mask is not None else None
    if epilogue in ROW_EPILOGUES:
        y = block_gemm_reference(a, w, ROW_PRODUCT[epilogue], resid=resid,
                                 row_mask=row_mask, variant=variant,
                                 a_scale=a_scale)
        if a_scale is not None:
            if epilogue == "fc1_q":
                q, qs = quantize_rows(y)
                return q, qs.reshape(-1)
            q, qs = quantize_rows(layer_norm(y, ln["weight"], ln["bias"],
                                             ln_eps))
            return y, q, qs.reshape(-1)
        h = _LN[v.ln](y.to(torch.bfloat16), ln["weight"], ln["bias"],
                      ln_eps).to(torch.bfloat16)
        if epilogue == "proj_ln":
            return y, h
        keep = row_mask.float()
        if policy is not None:
            keep = keep * _flat_gate(y, policy, seq_len)
        return y, h, keep
    if a_scale is None:
        y = _mm(a, w["weight"], w["bias"])
    else:
        y = (int_matmul(a, w["weight_q"]) * a_scale.float()[:, None]
             * w["scale"] + w["bias"].float())
    if epilogue == "qkv":
        return y.to(torch.bfloat16)
    if epilogue == "fc1":
        return gelu_exact(y) if a_scale is not None else (
            _ACT[v.act](y).to(torch.bfloat16))
    row = mask is not None and (a_scale is not None or v.row_mask)
    if epilogue == "proj":
        if a_scale is None and v.bf16_residual:
            return (resid + (y * mask).to(resid.dtype)).float()
        return resid.float() + (y * mask if row else y)
    return (resid.float() + (y * mask if row else y)).to(torch.bfloat16)


def block_gemm(a, w, epilogue, *, resid=None, row_mask=None, variant=None,
               a_scale=None, ln=None, policy=None, seq_len=None,
               ln_eps=1e-6):
    """One of a layer's four weight products with its epilogue, as B1, B2
    and P1 (bf16) or B6 (s8) launch it: the GEMM core of
    ``csrc/gemm_sm90.cuh``.

    bf16: ``a`` (M, K) bf16, ``w`` {weight (N, K) bf16, bias (N,) bf16}.
    s8 (``a_scale`` given): ``a`` (M, K) int8 codes, ``a_scale`` (M,) f32,
    ``w`` {weight_q (N, K) int8, scale (N,) f32, bias (N,) bf16}.
    ``epilogue``: 'qkv' -> bf16(acc + b); 'proj' -> f32 resid + (acc + b) *
    row_mask (resid bf16 (M, N)); 'fc1' -> bf16(GELU(acc + b)) (s8: f32 erf
    GELU); 'fc2' -> bf16(resid + (acc + b) * row_mask) (resid f32 (M, N)).
    ``row_mask``: (M,) f32, for proj and fc2. ``variant`` (bf16 only, a
    `BlockVariant`): its fc1 activation, row mask and proj residual.

    The row epilogues (`ROW_EPILOGUES`, at the widths of `row_cluster`:
    a cluster of blocks holds whole rows) run the next row pass too, with
    ``ln`` {weight, bias} (N,) bf16 and ``ln_eps``: 'proj_ln' -> (x2, h2 =
    bf16(LN(bf16(x2)))) in the variant's LayerNorm form, s8 -> (x2, codes,
    scales) of LN(x2) unrounded; 'fc2_ln' (bf16) -> (out, h1 = bf16(LN(out)),
    the row mask times the token gate of ``policy`` {weight (2, N), bias
    (2,)} or None on out, the first of every ``seq_len`` rows kept);
    'fc1_q' (s8) -> (codes, scales) of the erf GELU output. CPU tensors run
    `block_gemm_reference`; CUDA tensors launch the kernel, counted in
    ``block_gemm.launches``."""
    if epilogue not in GEMM_EPILOGUES + ROW_EPILOGUES:
        raise ValueError(f"epilogue must be one of "
                         f"{GEMM_EPILOGUES + ROW_EPILOGUES}")
    kw = dict(resid=resid, row_mask=row_mask, variant=variant,
              a_scale=a_scale)
    rows = dict(ln=ln, policy=policy, seq_len=seq_len, ln_eps=ln_eps)
    if not _route(a):
        return block_gemm_reference(a, w, epilogue, **kw, **rows)
    from laudnet_tpu_torch.ops._build import library

    s8 = a_scale is not None
    weight = w["weight_q" if s8 else "weight"]
    want = torch.int8 if s8 else torch.bfloat16
    if a.dtype != want or weight.dtype != want:
        raise TypeError(f"block_gemm takes {want} operands, got {a.dtype} "
                        f"and {weight.dtype}")
    if a.dim() != 2 or weight.dim() != 2 or a.shape[1] != weight.shape[1]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(weight.shape)}")
    m, k = a.shape
    n = weight.shape[0]
    if k % (16 if s8 else 8) or n % 8:
        raise ValueError(f"the GEMM kernel needs rows of 16-byte multiples "
                         f"and N % 8 == 0: K={k}, N={n}")
    epi = GEMM_EPILOGUES.index(ROW_PRODUCT.get(epilogue, epilogue))
    if epi in (EPI_PROJ, EPI_FC2):
        rdt = torch.bfloat16 if epi == EPI_PROJ else torch.float32
        if (resid is None or row_mask is None or resid.dtype != rdt
                or tuple(resid.shape) != (m, n) or row_mask.numel() != m):
            raise ValueError(f"{epilogue} takes resid {rdt} ({m}, {n}) and "
                             f"row_mask ({m},)")
    if epilogue in ROW_EPILOGUES:
        v = variant or EXACT
        if (epilogue == "fc1_q" and not s8) or (epilogue == "fc2_ln" and s8):
            raise TypeError(f"{epilogue} takes "
                            f"{'bf16' if s8 else 's8'} operands")
        wide = s8 or (v.row_mask and not v.bf16_residual and v.ln != "scale")
        if not row_cluster(n, wide=wide, fc1=epilogue == "fc1_q"):
            raise ValueError(f"{epilogue}: no cluster of the GEMM core holds "
                             f"rows of N={n} (row_cluster)")
        if epilogue != "fc1_q" and (ln is None or any(
                t.shape != (n,) or t.dtype != torch.bfloat16
                for t in (ln["weight"], ln["bias"]))):
            raise ValueError(f"{epilogue} takes ln weight and bias bf16 "
                             f"({n},)")
        if epilogue == "fc2_ln" and (
                seq_len is None or m % seq_len or (policy is not None and (
                    tuple(policy["weight"].shape) != (2, n)
                    or policy["weight"].dtype != torch.bfloat16
                    or policy["bias"].dtype != torch.bfloat16))):
            raise ValueError("fc2_ln takes seq_len dividing M and a bf16 "
                             f"policy (2, {n})")
    tensors = [a, weight, w["bias"], resid, row_mask, a_scale,
               w.get("scale")]
    for sub in (ln, policy):
        if sub is not None and epilogue in ROW_EPILOGUES:
            tensors += [sub["weight"], sub["bias"]]
    for t in tensors:
        if t is not None and (t.device != a.device or not t.is_contiguous()):
            raise ValueError("block_gemm takes contiguous tensors on one "
                             "device")
    f32_out = epi == EPI_PROJ or (s8 and epi == EPI_FC1)
    out = None if epilogue == "fc1_q" else torch.empty(
        (m, n), device=a.device,
        dtype=torch.float32 if f32_out else torch.bfloat16)
    rmask = None if row_mask is None else _f32(row_mask)
    lib = library()
    if epilogue in ROW_EPILOGUES:
        ln_form, var, _ = (variant or EXACT).codes()
        if s8:
            codes = (torch.empty((m, n), dtype=torch.int8, device=a.device),
                     torch.empty((m,), dtype=torch.float32, device=a.device))
            _gemm_s8_rows(lib, (a, a_scale), w, n, k, epi, codes, out, resid,
                          rmask, ln, ln_eps)
            result = codes if epi == EPI_FC1 else (out, *codes)
        else:
            h = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
            mask = row_mask.to(torch.float32, copy=True).contiguous()
            _gemm_rows(lib, a, w, n, k, epi, out, h, resid,
                       rmask if epi == EPI_PROJ else mask, ln, ln_eps, var,
                       ln_form, policy, mask, seq_len or 1)
            result = (out, h) if epi == EPI_PROJ else (out, h, mask)
    elif s8:
        result = _gemm_s8(lib, (a, a_scale), w, n, k, epi, out, resid, rmask)
    else:
        result = _gemm(lib, a, w, n, k, epi, out, resid, rmask,
                       (variant or EXACT).codes()[1])
    block_gemm.launches += 1
    return result


block_gemm.launches = 0
