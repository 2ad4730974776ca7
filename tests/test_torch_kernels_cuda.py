"""The CUDA kernels (`laudnet_tpu_torch/csrc/vit_block.cu`: the block B1,
the segment B2 and the W8A8 block B6; `csrc/attention.cu`: the attention
forward B4 and backward B5, bf16 and f32, any L;
`csrc/masked_block.cu`: the block-sparse bottleneck tail B3; the probes'
kernels, P1 = B1 with its body variants and P2 = `csrc/probe_int8.cu`'s s8
GEMM) against their plain PyTorch versions, in bf16 (P2: int8) on the card.
Marked ``cuda``; skips without a card.

Imports no JAX, so it runs on a machine that has none; there, skip the
JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Both sides round to bf16 at the same points and differ only in f32
summation order, which flips single bf16 roundings: the tolerance is four
bf16 ulps of the largest output magnitude. Token gates read feature 0,
which the input sets to +-8 per token, so no gate sits near a tie and the
masks must be equal exactly. The W8A8 block's integer sums are exact on
both sides, so the same bound holds for it (a code that flips at a rounding
tie moves an output by far less than an ulp); the attention forward differs
from its plain version by the bf16 rounding of p, averaged over the keys.
The attention backward rounds where its plain version rounds (P, dS and the
gated dO), so the same four ulps of the largest gradient hold for dqkv; its
dhead is an f32 sum of B*L*64 products and is held to 2e-3 of the largest
entry. The bottleneck tail rounds where its plain version rounds (the ReLU
output, the second affine and the residual add), so the four ulps hold for
it too, and the cells it does not select are ``relu(identity)`` bit for
bit. P1's variants (B1's wrapper with a ``variant``) round where their plain
versions round and hold the same four ulps.
P2's integer sums are exact on both sides: equal bit for bit. The GEMM
core (`csrc/gemm_sm90.cuh`) that B1, B2, B6 and P1 run their four products
on is also held product by product (`vit_block.block_gemm`, each epilogue
and variant, bf16 and s8) to the same four ulps; its s8 sums are exact,
so its s8 epilogues differ from their plain versions only where an f32
rounding does (the erf, a contracted multiply-add). The attention
kernels in f32 sum in full f32 (FFMA) against f32 plain versions: 1e-4 of
the largest entry (`_f32_tol`). Each registered op (`ops/library.py`) is
held to its CUDA implementation called directly (the same kernels, bit for
bit) and passes `torch.library.opcheck`. QAT on the card: the fake-quant
products against the W8A8 ones in f32 with TF32 off, within the summation
bound of `tools/qat_fidelity.py`, and a QAT step's B5 gradients against
the plain backward's behind the same forward (cosine 0.999).
"""

import pytest
import torch

from laudnet_tpu_torch.ops import (masked_block, s8_gemm, vit_attention,
                                   vit_block)
from laudnet_tpu_torch.tools.probe_block_budget import MODES

pytestmark = pytest.mark.cuda
ULPS = 4


def _tol(ref):
    """ULPS bf16 ulps (8 significant bits) of ref's largest magnitude."""
    top = ref.float().abs().max().item()
    return ULPS * 2.0 ** (torch.tensor(top).log2().floor().item() - 7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _layer(g, d, hidden, dev, policy=False):
    def w(*shape, scale=0.05):
        return (torch.randn(*shape, generator=g) * scale).to(
            dev, torch.bfloat16)

    p = {"ln1": {"weight": 1.0 + w(d), "bias": w(d)},
         "ln2": {"weight": 1.0 + w(d), "bias": w(d)},
         "qkv": {"weight": w(3 * d, d), "bias": w(3 * d)},
         "proj": {"weight": w(d, d), "bias": w(d)},
         "fc1": {"weight": w(hidden, d), "bias": w(hidden)},
         "fc2": {"weight": w(d, hidden), "bias": w(d)}}
    if policy:
        pw = torch.zeros(2, d)
        pw[0, 0], pw[1, 0] = 1.0, -1.0  # keep iff feature 0 >= 0
        p["token_policy"] = {"weight": pw.to(dev, torch.bfloat16),
                             "bias": torch.zeros(2, device=dev,
                                                 dtype=torch.bfloat16)}
    return p


def _inputs(g, b, l, d, dev):
    x = torch.randn(b, l, d, generator=g)
    x[:, :, 0] = torch.where(torch.rand(b, l, generator=g) > 0.5, 8.0, -8.0)
    mask = (torch.rand(b, l, generator=g) > 0.3).float()
    mask[:, 0] = 1.0
    return x.to(dev, torch.bfloat16), mask.to(dev)


@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("d,heads,l", [(256, 4, 37), (192, 3, 131)])
def test_block_kernel_matches_plain(card, d, heads, l, fast_math):
    g = torch.Generator().manual_seed(l)
    b = 4
    p = _layer(g, d, 2 * d, card)
    x, mask = _inputs(g, b, l, d, card)
    km, rm = mask.reshape(b, 1, l), mask.reshape(b, l, 1)
    before = vit_block.fused_vit_block.launches
    out = vit_block.fused_vit_block(x, km, rm, p, num_heads=heads,
                                    fast_math=fast_math)
    ref = vit_block.fused_vit_block_reference(x, km, rm, p, num_heads=heads,
                                              fast_math=fast_math)
    torch.cuda.synchronize()
    assert vit_block.fused_vit_block.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)


@pytest.mark.parametrize("fast_math", [False, True])
def test_segment_kernel_matches_plain(card, fast_math):
    g = torch.Generator().manual_seed(1)
    b, l, d, h = 4, 50, 256, 4
    layers = [_layer(g, d, 512, card, policy=i > 0) for i in range(3)]
    x, mask = _inputs(g, b, l, d, card)
    out, out_mask = vit_block.fused_vit_segment(x, mask, layers,
                                                num_heads=h,
                                                fast_math=fast_math)
    ref, ref_mask = vit_block.fused_vit_segment_reference(
        x, mask, layers, num_heads=h, fast_math=fast_math)
    torch.cuda.synchronize()
    assert ref_mask.sum() < mask.sum()  # the interior gates dropped tokens
    assert torch.equal(out_mask, ref_mask)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)


def test_kernels_refuse_other_dtypes(card):
    g = torch.Generator().manual_seed(2)
    p = _layer(g, 128, 256, card)
    x, mask = _inputs(g, 2, 9, 128, card)
    with pytest.raises(TypeError, match="bf16"):
        vit_block.fused_vit_block(x.float(), mask, mask, p, num_heads=2)


def _gate(g, b, heads, dev):
    gate = (torch.rand(b, heads, generator=g) > 0.4).float()
    gate[0, 0], gate[1, 0] = 0.0, 1.0
    return gate.to(dev)


@pytest.mark.parametrize("fast_math", [False, True])
def test_block_kernel_head_gate_matches_plain(card, fast_math):
    g = torch.Generator().manual_seed(3)
    b, l, d, heads = 4, 70, 192, 3
    p = _layer(g, d, 2 * d, card)
    x, mask = _inputs(g, b, l, d, card)
    km, rm = mask.reshape(b, 1, l), mask.reshape(b, l, 1)
    kw = dict(num_heads=heads, fast_math=fast_math,
              head_gate=_gate(g, b, heads, card))
    out = vit_block.fused_vit_block(x, km, rm, p, **kw)
    ref = vit_block.fused_vit_block_reference(x, km, rm, p, **kw)
    ungated = vit_block.fused_vit_block(x, km, rm, p, num_heads=heads,
                                        fast_math=fast_math)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)
    assert not torch.equal(out, ungated)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("b,d,heads,hidden,l", [
    (4, 256, 4, 512, 37), (4, 192, 3, 448, 131),    # small, odd heads
    (128, 384, 6, 1536, 197),                       # DeiT-S serving shape
    (32, 448, 7, 1344, 96)])                        # T2T widths
def test_int8_block_kernel_matches_plain(card, b, d, heads, hidden, l,
                                         gated):
    g = torch.Generator().manual_seed(l)
    qp = vit_block.quantize_block_params(_layer(g, d, hidden, card))
    x, mask = _inputs(g, b, l, d, card)
    km, rm = mask.reshape(b, 1, l), mask.reshape(b, l, 1)
    kw = dict(num_heads=heads,
              head_gate=_gate(g, b, heads, card) if gated else None)
    before = vit_block.fused_vit_block_int8.launches
    out = vit_block.fused_vit_block_int8(x, km, rm, qp, **kw)
    ref = vit_block.fused_vit_block_int8_reference(x, km, rm, qp, **kw)
    torch.cuda.synchronize()
    assert vit_block.fused_vit_block_int8.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("b,heads,l", [(4, 2, 23), (4, 3, 131), (2, 7, 256),
                                       (128, 6, 197)])
def test_attention_kernel_matches_plain(card, b, heads, l, gated):
    g = torch.Generator().manual_seed(l)
    d = heads * 64
    qkv = torch.randn(b, l, 3 * d, generator=g).to(card, torch.bfloat16)
    mask = (torch.rand(b, l, generator=g) > 0.3).float().to(card)
    mask[:, 0] = 1.0
    gate = _gate(g, b, heads, card) if gated else None
    before = vit_attention.fused_vit_attention.launches
    out = vit_attention.fused_vit_attention(qkv, mask, gate, heads, 0.125)
    ref = vit_attention.reference_vit_attention(qkv, mask, gate, heads,
                                                0.125)
    torch.cuda.synchronize()
    assert vit_attention.fused_vit_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (b, l, d)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)
    if gated:
        assert not out[0, :, :64].any()      # a closed head is exactly zero


def test_new_kernels_refuse_what_they_do_not_take(card):
    g = torch.Generator().manual_seed(4)
    qp = vit_block.quantize_block_params(_layer(g, 128, 256, card))
    x, mask = _inputs(g, 2, 9, 128, card)
    with pytest.raises(TypeError, match="bf16"):
        vit_block.fused_vit_block_int8(x.float(), mask, mask, qp,
                                       num_heads=2)
    with pytest.raises(TypeError, match="must hold"):
        vit_block.fused_vit_block_int8(x, mask, mask,
                                       _layer(g, 128, 256, card),
                                       num_heads=2)
    qkv = torch.randn(2, 9, 384, generator=g).to(card, torch.bfloat16)
    # f32 and any L are taken now; heads other than 64 wide are not
    with pytest.raises(ValueError, match="heads of 64"):
        vit_attention.fused_vit_attention(qkv, mask, None, 4, 0.125)
    with pytest.raises(ValueError, match="heads of 64"):
        vit_attention.fused_vit_attention(qkv.float(), mask, None, 4, 0.125)
    with pytest.raises(TypeError, match="cotangent"):
        vit_attention._launch_bwd(qkv, mask, None,
                                  torch.ones(2, 9, 128, device=card), 2,
                                  0.125, None)                  # f32


def _f32_tol(ref):
    """f32 kernels against f32 plain versions: full f32 sums on both sides
    in other orders, 1e-4 of the largest entry (TF32's 10-bit mantissa
    would miss it by an order of magnitude)."""
    return 1e-4 * ref.float().abs().max().item()


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype,b,heads,l", [
    (torch.bfloat16, 16, 6, 257), (torch.bfloat16, 8, 6, 577),
    (torch.float32, 4, 3, 23), (torch.float32, 32, 6, 197),
    (torch.float32, 8, 6, 257)])
def test_attention_kernels_any_length_and_f32_match_plain(card, dtype, b,
                                                          heads, l, gated):
    """The forward and backward past the old 256-token limit (DeiT-S at
    256^2 and 384^2) and in f32, through the Function, against the plain
    versions: bf16 four ulps, f32 `_f32_tol`."""
    g = torch.Generator().manual_seed(l + heads)
    d = heads * 64
    qkv = torch.randn(b, l, 3 * d, generator=g).to(card, dtype)
    mask = (torch.rand(b, l, generator=g) > 0.3).float().to(card)
    mask[:, 0] = 1.0
    gate = _gate(g, b, heads, card) if gated else None
    cot = torch.randn(b, l, d, generator=g).to(card, dtype)
    tol = _tol if dtype == torch.bfloat16 else _f32_tol
    qkv.requires_grad_()
    before = (vit_attention.fused_vit_attention.launches,
              vit_attention.fused_vit_attention.bwd_launches)
    out = vit_attention.fused_vit_attention(qkv, mask, gate, heads, 0.125)
    dqkv, = torch.autograd.grad(out, (qkv,), cot)
    ref = vit_attention.reference_vit_attention(qkv.detach(), mask, gate,
                                                heads, 0.125)
    ref_dqkv, _ = vit_attention.reference_vit_attention_bwd(
        qkv.detach(), mask, gate, cot, heads, 0.125)
    torch.cuda.synchronize()
    assert (vit_attention.fused_vit_attention.launches,
            vit_attention.fused_vit_attention.bwd_launches) == (
                before[0] + 1, before[1] + 1)
    assert out.dtype == dqkv.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol(ref)
    err = (dqkv.float() - ref_dqkv.float()).abs().max().item()
    assert err <= tol(ref_dqkv), (err, tol(ref_dqkv))
    if gated:
        assert not out[0, :, :64].any()


@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("l", [257, 577])
def test_block_kernel_long_sequences_match_plain(card, l, fast_math):
    """B1 at 257 and 577 tokens: its attention launch goes to the
    streaming forward, exact or deferred, with the head gate."""
    g = torch.Generator().manual_seed(l)
    b, d, heads = 4, 384, 6
    p = _layer(g, d, 4 * d, card)
    x, mask = _inputs(g, b, l, d, card)
    km, rm = mask.reshape(b, 1, l), mask.reshape(b, l, 1)
    kw = dict(num_heads=heads, fast_math=fast_math,
              head_gate=_gate(g, b, heads, card))
    out = vit_block.fused_vit_block(x, km, rm, p, **kw)
    ref = vit_block.fused_vit_block_reference(x, km, rm, p, **kw)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)


def test_masked_cnn_forwards_do_not_sync_the_host(card):
    """The flagship's dense-masked forward (f32 and bf16), a channel-mode
    and a layer-mode LAUD-ResNet-50 run without one host synchronisation
    (`torch.cuda.set_sync_debug_mode("error")` raises on any)."""
    from laudnet_tpu_torch.entry import flagship
    from laudnet_tpu_torch.models import uni_resnet50

    x = torch.randn(2, 224, 224, 3, device=card,
                    generator=torch.Generator(card).manual_seed(0))
    models = [flagship(card).eval(),
              flagship(card, compute_dtype=torch.bfloat16).eval(),
              uni_resnet50(dyn_mode=("channel",) * 4,
                           channel_dyn_granularity=(2, 2, 2, 2),
                           channel_masker=("MLP",) * 4,
                           channel_masker_layers=(1, 1, 1, 1),
                           device=card).eval(),
              uni_resnet50(dyn_mode=("layer",) * 4,
                           channel_masker=("MLP",) * 4,
                           channel_masker_layers=(1, 1, 1, 1),
                           device=card).eval()]
    with torch.no_grad():
        for model in models:
            model(x, 0.1)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = model(x, 0.1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert out.logits.shape == (2, 1000)
            assert out.flops.device.type == "cuda"


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("b,heads,l", [(4, 2, 23), (4, 3, 131), (2, 7, 256),
                                       (128, 6, 197), (128, 7, 197)])
def test_attention_backward_kernel_matches_plain(card, b, heads, l, gated):
    """B5 through the Function's backward, at small shapes, the longest L,
    and the DeiT-S and T2T training shapes."""
    g = torch.Generator().manual_seed(l + heads)
    d = heads * 64
    qkv = torch.randn(b, l, 3 * d, generator=g).to(card, torch.bfloat16)
    mask = (torch.rand(b, l, generator=g) > 0.3).float().to(card)
    mask[:, 0] = 1.0
    gate = _gate(g, b, heads, card) if gated else None
    cot = torch.randn(b, l, d, generator=g).to(card, torch.bfloat16)
    qkv.requires_grad_()
    if gated:
        gate.requires_grad_()
    before = vit_attention.fused_vit_attention.bwd_launches
    out = vit_attention.fused_vit_attention(qkv, mask, gate, heads, 0.125)
    # a strided cotangent, as autograd hands over the gradient of a view
    wide = torch.zeros(b, l, 2 * d, device=card, dtype=torch.bfloat16)
    wide[..., :d] = cot
    grads = torch.autograd.grad(out, (qkv, gate) if gated else (qkv,),
                                wide[..., :d])
    ref_dqkv, ref_dhead = vit_attention.reference_vit_attention_bwd(
        qkv.detach(), mask, None if gate is None else gate.detach(), cot,
        heads, 0.125)
    torch.cuda.synchronize()
    assert vit_attention.fused_vit_attention.bwd_launches == before + 1
    assert grads[0].dtype == torch.bfloat16 and grads[0].shape == qkv.shape
    err = (grads[0].float() - ref_dqkv.float()).abs().max().item()
    assert err <= _tol(ref_dqkv), (err, _tol(ref_dqkv))
    if gated:
        assert grads[1].shape == (b, heads)
        derr = (grads[1] - ref_dhead).abs().max().item()
        assert derr <= 2e-3 * ref_dhead.abs().max().item()
        # a closed head: zero dq, dk, dv, and a dgate that is not zero
        closed = grads[0][0].reshape(l, 3, heads, 64)[:, :, 0]
        assert not closed.any() and grads[1][0, 0] != 0


def _tail_inputs(seed, b, hw, c, co, patch, density, dev,
                 dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=g) * scale
    hm = hw // patch
    bf = lambda t: t.to(dev, dtype)
    mask = (torch.rand(b, hm, hm, generator=g) < density).float().to(dev)
    return dict(
        x1=bf(rn(b, hw, hw, c).relu()), identity=bf(rn(b, hw, hw, co)),
        mask_cells=mask, w2=bf(rn(3, 3, c, c, scale=(9 * c) ** -0.5)),
        a2=(1.0 + rn(c, scale=0.1)).to(dev), b2=rn(c, scale=0.1).to(dev),
        w3=bf(rn(c, co, scale=c ** -0.5)),
        a3=(1.0 + rn(co, scale=0.1)).to(dev), b3=rn(co, scale=0.1).to(dev))


def _f32_tol(ref):
    """The f32 kernels against their f32 plain versions: full f32 sums in
    other orders, 1e-4 of the largest entry (TF32 would miss it)."""
    return 1e-4 * ref.float().abs().max().item()


def _check_tail(t, patch, capacity):
    before = masked_block.masked_bottleneck_tail.launches
    got = masked_block.masked_bottleneck_tail(**t, patch=patch,
                                              capacity=capacity)
    torch.cuda.synchronize()
    assert masked_block.masked_bottleneck_tail.launches == before + 1
    want = masked_block.reference_masked_bottleneck_tail(
        **t, patch=patch, capacity=capacity)
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    tol = _f32_tol(want) if got.dtype == torch.float32 else _tol(want)
    assert err <= tol, (err, tol)
    # cells that were not selected: relu(identity), bit for bit
    b, hm = t["mask_cells"].shape[:2]
    active = t["mask_cells"].reshape(b, -1) > 0.5
    chosen = (active & (active.cumsum(1) <= capacity)).reshape(b, hm, -1)
    pix = chosen.repeat_interleave(patch, 1).repeat_interleave(patch, 2)
    rest = torch.relu(t["identity"])[~pix]
    assert torch.equal(got[~pix], rest)
    return got


# B, H = W, C, Co, patch: the bench shape (narrowed batch), the flagship's
# four stride-1 block shapes (batch 8), and widths off the tile multiples
TAIL_SHAPES = [(4, 28, 1024, 2048, 7), (8, 56, 64, 256, 4),
               (8, 28, 128, 512, 4), (8, 14, 256, 1024, 2),
               (8, 7, 512, 2048, 1), (3, 8, 72, 88, 2)]


@pytest.mark.parametrize("density", [0.5, 0.25])
@pytest.mark.parametrize("b,hw,c,co,patch", TAIL_SHAPES)
def test_bottleneck_tail_matches_plain(card, b, hw, c, co, patch, density):
    t = _tail_inputs(hw + c, b, hw, c, co, patch, density, card)
    n_cells = (hw // patch) ** 2
    _check_tail(t, patch, max(1, -(-int(density * n_cells * 100) // 100)))
    _check_tail(t, patch, n_cells)


@pytest.mark.parametrize("kind", ["all_active", "all_zero", "binding"])
def test_bottleneck_tail_mask_extremes(card, kind):
    b, hw, c, co, patch = 4, 28, 128, 512, 4
    t = _tail_inputs(7, b, hw, c, co, patch, 0.6, card)
    capacity = 49
    if kind == "all_active":
        t["mask_cells"] = torch.ones_like(t["mask_cells"])
    elif kind == "all_zero":
        t["mask_cells"] = torch.zeros_like(t["mask_cells"])
    else:
        capacity = 5  # far fewer slots than active cells
    got = _check_tail(t, patch, capacity)
    if kind == "all_zero":
        assert torch.equal(got, torch.relu(t["identity"]))


# f32 at a fused width and above it; ragged widths (padded to 8 by the
# wrapper), a width above 2048, patches outside {1, 2, 4, 7}, capacity 1
# and a batch of one: B, H = W, C, Co, patch, dtype, capacity
TAIL_CASES = [(2, 14, 64, 256, 2, "f32", None),
              (2, 14, 512, 1024, 7, "f32", None),
              (2, 8, 24, 20, 2, "bf16", None),
              (2, 8, 200, 88, 4, "bf16", None),
              (2, 8, 24, 88, 2, "f32", None),
              (1, 7, 2560, 256, 1, "bf16", None),
              (2, 12, 64, 256, 3, "bf16", None),
              (2, 28, 128, 512, 14, "bf16", None),
              (3, 28, 128, 512, 4, "bf16", 1),
              (1, 28, 64, 256, 4, "bf16", None)]


@pytest.mark.parametrize("b,hw,c,co,patch,dtype,capacity", TAIL_CASES)
def test_bottleneck_tail_any_shape_and_f32_match_plain(card, b, hw, c, co,
                                                       patch, dtype,
                                                       capacity):
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    t = _tail_inputs(b + hw + c + co, b, hw, c, co, patch, 0.5, card, dt)
    n_cells = (hw // patch) ** 2
    got = _check_tail(t, patch, capacity or n_cells)
    assert got.shape == t["identity"].shape
    if capacity is None:
        _check_tail(t, patch, max(1, n_cells // 3))


@pytest.mark.parametrize("b,hm,density,capacity", [
    (128, 14, 0.5, 98), (16, 4, 0.5, 8), (3, 9, 0.3, 81), (2, 5, 1.0, 7),
    (1, 7, 0.0, 49), (1, 1, 1.0, 1), (1100, 3, 0.6, 4)])
def test_selection_kernel_bit_equal_to_plain(card, b, hm, density, capacity):
    g = torch.Generator().manual_seed(b + hm)
    mask = (torch.rand(b, hm, hm, generator=g) < density).float().to(card)
    for m in (mask, mask.to(torch.bfloat16)):
        got = masked_block.select_cells(m, capacity)
        want = masked_block.reference_select_cells(m, capacity)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("b,hw,c,co,patch", [TAIL_SHAPES[0], TAIL_SHAPES[1],
                                             TAIL_SHAPES[4]])
def test_bottleneck_tail_launches_twice_without_a_host_sync(card, b, hw, c,
                                                            co, patch):
    """A call is the selection and the tail: two kernels on the card and
    nothing else (no weight repack, no selection ops), and no host sync."""
    t = _tail_inputs(5, b, hw, c, co, patch, 0.5, card)
    n_cells = (hw // patch) ** 2
    call = lambda: masked_block.masked_bottleneck_tail(
        **t, patch=patch, capacity=n_cells // 2)
    assert _kernel_launches(call) == 2
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_bottleneck_tail_refuses_what_it_does_not_take(card):
    """Only what the JAX kernel refuses too, or cannot mean, is refused:
    f32, ragged widths and any patch that tiles are taken."""
    t = _tail_inputs(1, 2, 8, 64, 64, 2, 0.5, card)
    with pytest.raises(TypeError):  # integer inputs
        masked_block.masked_bottleneck_tail(
            **dict(t, x1=t["x1"].to(torch.int32)), patch=2, capacity=4)
    with pytest.raises(TypeError):  # one working type for x1 and the rest
        masked_block.masked_bottleneck_tail(
            **dict(t, w3=t["w3"].float()), patch=2, capacity=4)
    for capacity in (0, 17):
        with pytest.raises(ValueError):
            masked_block.masked_bottleneck_tail(**t, patch=2,
                                                capacity=capacity)
    with pytest.raises(ValueError):  # a patch that does not tile
        masked_block.masked_bottleneck_tail(**t, patch=3, capacity=4)
    with pytest.raises(ValueError):  # mismatched shapes
        masked_block.masked_bottleneck_tail(
            **dict(t, identity=t["identity"][:, :4]), patch=2, capacity=4)
    with pytest.raises(ValueError):  # another device
        masked_block.masked_bottleneck_tail(
            **dict(t, w2=t["w2"].cpu()), patch=2, capacity=4)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_block_variant_kernel_matches_plain(card, mode):
    g = torch.Generator().manual_seed(11)
    b, l, d, heads, hidden = 4, 131, 192, 3, 384
    x, mask = _inputs(g, b, l, d, card)
    p = _layer(g, d, hidden, card)
    args = (x, mask.reshape(b, 1, l), mask.reshape(b, l, 1), p)
    v = MODES[mode]
    before = vit_block.fused_vit_block.variant_launches
    out = vit_block.fused_vit_block(*args, num_heads=heads, variant=v)
    assert vit_block.fused_vit_block.variant_launches == before + 1
    ref = vit_block.fused_vit_block(*(t.cpu() if torch.is_tensor(t) else t
                                      for t in args[:3]),
                                    {k: {n: t.cpu() for n, t in w.items()}
                                     for k, w in p.items()},
                                    num_heads=heads, variant=v)
    assert (out.float().cpu() - ref.float()).abs().max().item() <= _tol(ref)


# The GEMM core, one product at a time: (M, K of qkv/proj/fc1, hidden) --
# DeiT-S and T2T-ViT-19 widths at an M that is no multiple of the 128-row
# tile, B2's L = 98 segments at bs128, a hidden of 208 (16-byte rows, no
# multiple of 32), DeiT-S at the serving M (bs128, L = 197), and DeiT-B's
# width (D = 768, hidden 3,072: no row epilogue takes it) at M = 1000 and
# at B2's L = 98.
GEMM_GEOMS = {"deit_m1000": (1000, 384, 1536), "t2t_m1000": (1000, 448, 1344),
              "deit_b2_l98": (128 * 98, 384, 1536),
              "hidden208_m300": (300, 192, 208),
              "deit_serving": (128 * 197, 384, 1536),
              "deitb_m1000": (1000, 768, 3072),
              "deitb_b2_l98": (128 * 98, 768, 3072)}


def _gemm_case(g, geom, epilogue, s8, dev):
    """Inputs of one product: (a, w, kwargs) with the epilogue's residual
    and row mask (a quarter of the rows masked)."""
    m, d, hidden = GEMM_GEOMS[geom]
    n, k = {"qkv": (3 * d, d), "proj": (d, d), "fc1": (hidden, d),
            "fc2": (d, hidden)}[epilogue]
    layer = {"weight": (torch.randn(n, k, generator=g) * k ** -0.5).to(
        dev, torch.bfloat16),
             "bias": (0.1 * torch.randn(n, generator=g)).to(dev, torch.bfloat16)}
    a = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
    kw = {}
    if epilogue in ("proj", "fc2"):
        kw["row_mask"] = (torch.rand(m, generator=g) > 0.25).float().to(dev)
        kw["resid"] = torch.randn(m, n, generator=g).to(
            dev, torch.bfloat16 if epilogue == "proj" else torch.float32)
    if not s8:
        return a, layer, kw
    from laudnet_tpu_torch.ops.quant import quantize_rows, quantize_weight

    wq, ws = quantize_weight(layer["weight"])
    q, qs = quantize_rows(a)
    kw["a_scale"] = qs.reshape(-1).contiguous()
    return q, {"weight_q": wq, "scale": ws, "bias": layer["bias"]}, kw


@pytest.mark.parametrize("s8", [False, True])
@pytest.mark.parametrize("epilogue", vit_block.GEMM_EPILOGUES)
@pytest.mark.parametrize("geom", sorted(GEMM_GEOMS))
def test_gemm_core_matches_plain(card, geom, epilogue, s8):
    g = torch.Generator().manual_seed(len(geom) + len(epilogue) + s8)
    a, w, kw = _gemm_case(g, geom, epilogue, s8, card)
    before = vit_block.block_gemm.launches
    out = vit_block.block_gemm(a, w, epilogue, **kw)
    ref = vit_block.block_gemm_reference(a, w, epilogue, **kw)
    torch.cuda.synchronize()
    assert vit_block.block_gemm.launches == before + 1
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)


@pytest.mark.parametrize("variant", [
    ("fc1", vit_block.BlockVariant(act="tanh")),
    ("fc1", vit_block.BlockVariant(act="silu")),
    ("fc1", vit_block.BlockVariant(act="none")),
    ("proj", vit_block.BlockVariant(row_mask=False)),
    ("proj", vit_block.BlockVariant(bf16_residual=True)),
    ("fc2", vit_block.BlockVariant(row_mask=False))],
    ids=lambda v: f"{v[0]}-{v[1].act}-{v[1].row_mask}-{v[1].bf16_residual}")
@pytest.mark.parametrize("geom", ["deit_m1000", "t2t_m1000"])
def test_gemm_core_body_variants_match_plain(card, geom, variant):
    """P1's ablated epilogues (tile width 192 at every N, T2T's too)."""
    epilogue, v = variant
    g = torch.Generator().manual_seed(7)
    a, w, kw = _gemm_case(g, geom, epilogue, False, card)
    out = vit_block.block_gemm(a, w, epilogue, variant=v, **kw)
    ref = vit_block.block_gemm_reference(a, w, epilogue, variant=v, **kw)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)


def test_gemm_core_refuses_what_it_does_not_take(card):
    g = torch.Generator().manual_seed(3)
    a, w, kw = _gemm_case(g, "deit_m1000", "fc2", False, card)
    with pytest.raises(ValueError):  # the residual missing
        vit_block.block_gemm(a, w, "fc2")
    with pytest.raises(TypeError):  # f32 operands
        vit_block.block_gemm(a.float(), w, "qkv")
    with pytest.raises(ValueError):  # K = 12: rows of 24 bytes
        vit_block.block_gemm(a[:, :12].contiguous(),
                             {"weight": w["weight"][:, :12].contiguous(),
                              "bias": w["bias"]}, "qkv")


@pytest.mark.parametrize("m,k,n", [(4096, 4096, 4096), (1000, 1040, 776),
                                   (37, 16, 5), (300, 208, 1000),
                                   (129, 4112, 257)])
def test_s8_gemm_kernel_bit_equal(card, m, k, n):
    g = torch.Generator().manual_seed(12)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    a, w = a.to(card), w.to(card)
    before = s8_gemm.s8_gemm.launches
    out = s8_gemm.s8_gemm(a, w.t())
    assert s8_gemm.s8_gemm.launches == before + 1
    assert torch.equal(out, s8_gemm.s8_gemm_reference(a, w.t()))


def test_s8_gemm_refuses_what_it_does_not_take(card):
    a = torch.zeros(64, 40, dtype=torch.int8, device=card)
    w = torch.zeros(64, 40, dtype=torch.int8, device=card)
    with pytest.raises(ValueError):
        s8_gemm.s8_gemm(a, w.t())  # K % 16
    a = torch.zeros(64, 64, dtype=torch.int8, device=card)
    with pytest.raises(ValueError):
        s8_gemm.s8_gemm(a, a)  # b not column-major
    with pytest.raises(TypeError):
        s8_gemm.s8_gemm(a.float(), a.t())


# --- the row epilogues: the GEMM core's cluster form (a cluster of blocks
# holds whole rows and exchanges row statistics in distributed shared
# memory), each fused product against its plain version ---------------------

ROW_CASES = [("proj_ln", False), ("proj_ln", True), ("fc2_ln", False),
             ("fc1_q", True)]
SEQ = {"deit_m1000": 100, "t2t_m1000": 100, "deit_b2_l98": 98}


def _row_case(g, geom, epilogue, s8, dev):
    a, w, kw = _gemm_case(g, geom, vit_block.ROW_PRODUCT[epilogue], s8, dev)
    n = (w["weight_q"] if s8 else w["weight"]).shape[0]
    if epilogue != "fc1_q":
        kw["ln"] = {"weight": (1.0 + 0.05 * torch.randn(n, generator=g)).to(
            dev, torch.bfloat16),
            "bias": (0.05 * torch.randn(n, generator=g)).to(dev,
                                                           torch.bfloat16)}
    if epilogue == "fc2_ln":
        pw = torch.zeros(2, n)
        pw[0, 0], pw[1, 0] = 1.0, -1.0  # keep iff feature 0 >= 0: no ties
        kw["policy"] = {"weight": pw.to(dev, torch.bfloat16),
                        "bias": torch.zeros(2, dtype=torch.bfloat16,
                                            device=dev)}
        kw["seq_len"] = SEQ[geom]
    return a, w, kw


def _close_codes(q, qs, ref_q, ref_qs):
    """s8 codes of rows whose f32 inputs differ from the plain version's by
    a summation order (LN2's statistics) or libdevice's erf against
    PyTorch's: scales within 1e-5 relative, codes within 1 and at most one
    in a thousand moved."""
    rel = ((qs - ref_qs).abs() / ref_qs.abs()).max().item()
    moved = (q.int() - ref_q.int()).abs()
    assert rel <= 1e-5 and moved.max().item() <= 1
    assert moved.float().mean().item() <= 1e-3


@pytest.mark.parametrize("epilogue,s8", ROW_CASES,
                         ids=[f"{e}-{'s8' if s else 'bf16'}"
                              for e, s in ROW_CASES])
@pytest.mark.parametrize("geom", sorted(SEQ))
def test_row_epilogue_matches_plain(card, geom, epilogue, s8):
    g = torch.Generator().manual_seed(len(geom) + len(epilogue) + s8)
    a, w, kw = _row_case(g, geom, epilogue, s8, card)
    before = vit_block.block_gemm.launches
    out = vit_block.block_gemm(a, w, epilogue, **kw)
    ref = vit_block.block_gemm_reference(a, w, epilogue, **kw)
    torch.cuda.synchronize()
    assert vit_block.block_gemm.launches == before + 1
    if epilogue == "fc1_q":
        _close_codes(*out, *ref)
        return
    x, rx = out[0], ref[0]
    assert x.dtype == rx.dtype and x.shape == rx.shape
    assert (x.float() - rx.float()).abs().max().item() <= _tol(rx)
    if s8:
        _close_codes(*out[1:], *ref[1:])
        return
    assert (out[1].float() - ref[1].float()).abs().max().item() <= _tol(ref[1])
    if epilogue == "fc2_ln":
        assert torch.equal(out[2], ref[2])
        assert 0 < ref[2].sum().item() < ref[2].numel()  # the gate bit


@pytest.mark.parametrize("geom", ["deit_m1000", "t2t_m1000"])
def test_fc1_codes_bit_equal_to_rowquant(card, geom):
    """The fused s8 fc1 (erf GELU and the row quantiser in its epilogue)
    against the unfused pair, fc1 with its f32 output and then the
    row-quantise kernel: a max does not depend on order, so bit for bit."""
    from laudnet_tpu_torch.ops._build import library

    g = torch.Generator().manual_seed(5)
    a, w, kw = _row_case(g, geom, "fc1_q", True, card)
    q, qs = vit_block.block_gemm(a, w, "fc1_q", **kw)
    u = vit_block.block_gemm(a, w, "fc1", **kw)
    m, n = u.shape
    ref_q = torch.empty_like(q)
    ref_qs = torch.empty_like(qs)
    lib = library()
    assert lib.lt_rowquant(u.data_ptr(), 1, ref_q.data_ptr(),
                           ref_qs.data_ptr(), m, n,
                           torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(q, ref_q) and torch.equal(qs, ref_qs)


def _kernel_launches(fn):
    """Kernels one call of ``fn`` runs on the card (`torch.profiler`),
    copies aside. The profiler can drop events (a whole buffer, or one
    kernel of a trace), so the count is taken again until two traces
    agree; a launch count is deterministic."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type.name == "CUDA"
                          and not e.key.startswith(("Memcpy", "Memset"))))
        if len(counts) > 1 and counts[-1] == counts[-2] > 0:
            break
        time.sleep(0.1 * (attempt + 1))
    return counts[-1]


# B1, B2 (3 layers) and B6 at widths the clusters take (DeiT-S, T2T-ViT-19)
# and at widths they do not (D = 192, hidden 208, and DeiT-B's D = 768,
# hidden 3,072: the separate launches)
LAYER_GEOMS = {"deit": (384, 6, 1536, 64), "t2t": (448, 7, 1344, 40),
               "narrow": (192, 3, 208, 50), "deit_b": (768, 12, 3072, 50)}


@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("geom", sorted(LAYER_GEOMS))
def test_layers_match_plain_and_launch_as_designed(card, geom, fast_math):
    d, heads, hidden, l = LAYER_GEOMS[geom]
    fused = vit_block.row_cluster(d) > 0
    fused_fc1 = vit_block.row_cluster(hidden, wide=False, fc1=True) > 0
    assert fused == fused_fc1 == (geom in ("deit", "t2t"))
    g = torch.Generator().manual_seed(d + fast_math)
    b = 4
    p = _layer(g, d, hidden, card)
    seg = [p] + [_layer(g, d, hidden, card, policy=True) for _ in range(2)]
    x, mask = _inputs(g, b, l, d, card)
    km, rm = mask.reshape(b, 1, l), mask.reshape(b, l, 1)
    kw = dict(num_heads=heads, fast_math=fast_math)
    out = vit_block.fused_vit_block(x, km, rm, p, **kw)
    ref = vit_block.fused_vit_block_reference(x, km, rm, p, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)
    out, out_mask = vit_block.fused_vit_segment(x, mask, seg, **kw)
    ref, ref_mask = vit_block.fused_vit_segment_reference(x, mask, seg, **kw)
    torch.cuda.synchronize()
    assert ref_mask.sum() < mask.sum()  # the interior gates dropped tokens
    assert torch.equal(out_mask, ref_mask)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)
    assert _kernel_launches(lambda: vit_block.fused_vit_block(
        x, km, rm, p, **kw)) == (6 if fused else 7)
    assert _kernel_launches(lambda: vit_block.fused_vit_segment(
        x, mask, seg, **kw)) == (1 + 5 * 3 if fused else 7 * 3)
    if fast_math:
        return
    qp = vit_block.quantize_block_params(p)
    out = vit_block.fused_vit_block_int8(x, km, rm, qp, num_heads=heads)
    ref = vit_block.fused_vit_block_int8_reference(x, km, rm, qp,
                                                   num_heads=heads)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref)
    assert _kernel_launches(lambda: vit_block.fused_vit_block_int8(
        x, km, rm, qp, num_heads=heads)) == (7 if fused else 9)


def test_row_epilogues_refuse_what_they_do_not_take(card):
    g = torch.Generator().manual_seed(4)
    a, w, kw = _row_case(g, "deit_m1000", "proj_ln", False, card)
    with pytest.raises(ValueError):  # the LayerNorm missing
        vit_block.block_gemm(a, w, "proj_ln", resid=kw["resid"],
                             row_mask=kw["row_mask"])
    with pytest.raises(TypeError):  # fc1_q is s8 only
        vit_block.block_gemm(a[:, :384].contiguous(), {
            "weight": torch.zeros(1536, 384, dtype=torch.bfloat16,
                                  device=card),
            "bias": torch.zeros(1536, dtype=torch.bfloat16, device=card)},
            "fc1_q")
    a, w, kw = _gemm_case(g, "hidden208_m300", "proj", False, card)
    kw["ln"] = {"weight": torch.ones(192, dtype=torch.bfloat16, device=card),
                "bias": torch.zeros(192, dtype=torch.bfloat16, device=card)}
    with pytest.raises(ValueError, match="row_cluster"):  # N = 192: CN = 1
        vit_block.block_gemm(a, w, "proj_ln", **kw)


# --- the registered ops (`torch.library`, namespace ``laudnet``) -------------

def _op_cases(card):
    """Each registered op at a small shape: (op, its arguments, its CUDA
    implementation called directly, the plain version's output and the
    bound it is held to)."""
    g = torch.Generator().manual_seed(11)
    b, l, d, heads = 4, 37, 384, 6
    p = _layer(g, d, 1536, card)
    seg = [p] + [_layer(g, d, 1536, card, policy=True) for _ in range(2)]
    x, mask = _inputs(g, b, l, d, card)
    km, rm = mask.reshape(b, 1, l), mask.reshape(b, l, 1)
    qp = vit_block.quantize_block_params(p)
    flat = vit_block.flatten_layer(p)
    qflat = vit_block.flatten_layer(qp, int8=True)
    sflat = [t for q in seg for t in vit_block.flatten_layer(q)]
    has = ["token_policy" in q for q in seg]
    qkv = (torch.randn(b, l, 3 * d, generator=g) * 0.5).to(card,
                                                          torch.bfloat16)
    gate = _gate(g, b, heads, card)
    t = _tail_inputs(3, 2, 16, 64, 256, 4, 0.5, card)
    ops = torch.ops.laudnet
    _, stats = ops.vit_attention.default(qkv, mask, gate, heads, 0.125, True)
    dout = (torch.randn(b, l, d, generator=g) * 0.5).to(card, torch.bfloat16)
    return {
        "vit_block": (
            ops.vit_block.default, (x, km, rm, flat, heads, None, 1e-6, True),
            vit_block._vit_block_cuda,
            lambda: vit_block.fused_vit_block_reference(
                x, km, rm, p, num_heads=heads, fast_math=True)),
        "vit_block_int8": (
            ops.vit_block_int8.default, (x, km, rm, qflat, heads, gate, 1e-6),
            vit_block._vit_block_int8_cuda,
            lambda: vit_block.fused_vit_block_int8_reference(
                x, km, rm, qp, num_heads=heads, head_gate=gate)),
        "vit_segment": (
            ops.vit_segment.default, (x, mask, sflat, has, heads, 1e-6, False),
            vit_block._vit_segment_cuda,
            lambda: vit_block.fused_vit_segment_reference(
                x, mask, seg, num_heads=heads)),
        "vit_attention": (
            ops.vit_attention.default, (qkv, mask, gate, heads, 0.125, True),
            vit_attention._attention_cuda,
            lambda: vit_attention.reference_vit_attention(
                qkv, mask, gate, heads, 0.125, return_stats=True)),
        "vit_attention_bwd": (
            ops.vit_attention_bwd.default,
            (qkv, mask, gate, dout, stats, heads, 0.125),
            vit_attention._attention_bwd_cuda,
            lambda: vit_attention.reference_vit_attention_bwd(
                qkv, mask, gate, dout, heads, 0.125, stats=stats)),
        "masked_bottleneck_tail": (
            ops.masked_bottleneck_tail.default, (*t.values(), 4, 8),
            masked_block._tail_cuda,
            lambda: masked_block.reference_masked_bottleneck_tail(
                **t, patch=4, capacity=8)),
    }


OPS = ("vit_block", "vit_block_int8", "vit_segment", "vit_attention",
       "vit_attention_bwd", "masked_bottleneck_tail")


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", OPS)
def test_registered_op_launches_what_its_implementation_does(card, name):
    """The op through the dispatcher against its CUDA implementation called
    directly (the ctypes launch of earlier builds): the same kernels by
    count (`torch.profiler`), the same results bit for bit, and the plain
    version's within the existing bounds (B5's dhead: 2e-3 of its largest
    entry, as in the B5 tests above)."""
    op, args, direct, plain = _op_cases(card)[name]
    got = _as_tuple(op(*args))
    same = _as_tuple(direct(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, same))
    assert _kernel_launches(lambda: op(*args)) == _kernel_launches(
        lambda: direct(*args))
    want = _as_tuple(plain())
    out = got[0]
    assert out.shape == want[0].shape and out.dtype == want[0].dtype
    assert (out.float() - want[0].float()).abs().max().item() <= _tol(want[0])
    if name == "vit_segment":
        assert torch.equal(got[1], want[1])
    if name == "vit_attention_bwd":
        err = (got[1] - want[1]).abs().max().item()
        assert err <= 2e-3 * want[1].abs().max().item()


@pytest.mark.parametrize("name", OPS)
def test_registered_op_passes_opcheck(card, name):
    """`torch.library.opcheck`: the schema, the fake (meta) implementation
    against the real one, and the autograd registration (B4's, with B5's
    op as its backward, on inputs that need a gradient)."""
    op, args, _, _ = _op_cases(card)[name]
    if name == "vit_attention":
        args = (args[0].float().requires_grad_(), args[1],
                args[2].clone().requires_grad_(), *args[3:])
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_regnet_forward_runs_without_a_host_sync(card, dtype):
    """LAUD-RegNetY-400MF at full width, every gate kind (channel, spatial,
    both) in eval, under ``set_sync_debug_mode("error")``: finite logits."""
    from laudnet_tpu_torch.models import lad_regnet_y_400mf

    kw = dict(dyn_mode=("channel", "spatial", "both", "both"),
              mask_spatial_granularity=(4, 4, 2, 1),
              channel_dyn_granularity=(2, 2, 2, 2), num_classes=10)
    model = lad_regnet_y_400mf(
        **kw, compute_dtype=dtype,
        generator=torch.Generator(card).manual_seed(0)).eval()
    xc = torch.randn(2, 224, 224, 3,
                     generator=torch.Generator().manual_seed(1)).to(card)
    with torch.no_grad():
        model(xc, 0.1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = model(xc, 0.1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert out.logits.shape == (2, 10)
    assert torch.isfinite(out.logits.float()).all()


def test_probe_segments_forms_launch_as_checked(card):
    """The segment probe's checked forwards
    (`tools/probe_segments.py::check_forms`) on the card at a small
    geometry, default mode and sweep: every ``seg`` form launches B2 once
    for each segment the engine planned and no B1, every ``blk`` form one
    B1 a layer and no B2, and ``seg`` logits are within 4 bf16 ulps of the
    ``blk`` form's largest logit for each segment (`check_forms` raises
    otherwise)."""
    from laudnet_tpu_torch.models import LAUDViT
    from laudnet_tpu_torch.tools import probe_segments as probe

    geom = dict(depth=4, dim=128, num_heads=2, img_size=32, patch_size=8,
                device=card)
    off = dict(token_skip=False, head_skip=False, layer_skip=False)
    models = {name: LAUDViT(**geom, **kw, generator=torch.Generator(
        card).manual_seed(seed)).to(torch.bfloat16).eval()
        for seed, (name, kw) in enumerate((("plain_s", off), ("laud_s", {}),
                                           ("plain_b", off)))}
    images = torch.randn(4, 32, 32, 3, generator=torch.Generator(
        ).manual_seed(0)).to(card, torch.bfloat16)
    blk_forms = probe.build_forms(models)
    for sweep in (False, True):
        readings = probe.check_forms(probe.build_forms(models, sweep=sweep),
                                     images, blk_forms)
        for key, r in readings.items():
            if "_seg" in key:
                assert r["launches"]["segment"] == len(r["segments"]) > 0
                assert r["max_diff"] <= r["bound"]
            else:
                assert r["launches"] == {"segment": 0, "block": 4}


# --- QAT: the fake-quant products against W8A8, the QAT step through B5 ------

@pytest.mark.parametrize("k,n", [(384, 1152), (384, 384), (384, 1536),
                                 (1536, 384)],
                         ids=["qkv", "proj", "fc1", "fc2"])
def test_fake_quant_linear_is_the_w8a8_product(card, k, n):
    """`fake_quant_linear` against `int8_linear` at DeiT-S's four products
    (two images' 197 tokens), f32 with TF32 off: within the summation bound
    of `tools/qat_fidelity.py` (the same codes and scales; only f32's order
    differs)."""
    from laudnet_tpu_torch.tools.qat_fidelity import linear_gap

    g = torch.Generator(card).manual_seed(k + n)
    x = torch.randn(2 * 197, k, generator=g, device=card)
    w = torch.randn(n, k, generator=g, device=card) * k ** -0.5
    assert linear_gap(x, w)["ratio"] <= 1.0


@pytest.mark.parametrize("hw,c,co", [(56, 64, 256), (28, 128, 512),
                                     (14, 256, 1024), (7, 512, 2048)],
                         ids=["stage1", "stage2", "stage3", "stage4"])
def test_fake_quant_conv_is_the_w8a8_conv(card, hw, c, co):
    """``QuantConv(fake=True)`` against ``fake=False`` at the flagship's
    stride-1 conv2 (3x3) and conv3 (1x1) of each stage, batch 2, f32 with
    TF32 off: within the summation bound of `tools/qat_fidelity.py`."""
    from laudnet_tpu_torch.ops.quant import QuantConv
    from laudnet_tpu_torch.tools.qat_fidelity import conv_gap

    g = torch.Generator(card).manual_seed(hw)
    x = torch.relu(torch.randn(2, hw, hw, c, generator=g, device=card))
    for conv in (QuantConv(c, c, 3, padding=1, device=card),
                 QuantConv(c, co, 1, device=card)):
        assert conv_gap(conv, x)["ratio"] <= 1.0


def test_qat_vit_step_through_b5_matches_the_plain_backward(card):
    """A ``linear_impl='int8_qat'`` LAUD-ViT at DeiT-S width (2 layers,
    bf16 compute, B4 forward) trained one step at bs8: the gradients of
    the qkv products through B5 against the same step with the plain
    backward behind the same forward. Cosine similarity at least 0.999,
    as `chip_smoke.py` holds the dense step."""
    import torch.nn.functional as F

    from laudnet_tpu_torch.models import LAUDViT
    from laudnet_tpu_torch.ops.gating import GumbelNoise

    images = torch.randn(8, 224, 224, 3, generator=torch.Generator(
        card).manual_seed(1), device=card)
    labels = torch.arange(8, device=card)

    def qkv_grads():
        model = LAUDViT(depth=2, dim=384, num_heads=6, num_classes=10,
                        attn_impl="fused", linear_impl="int8_qat",
                        compute_dtype=torch.bfloat16, device=card,
                        generator=torch.Generator(card).manual_seed(0))
        out = model(images, 1.0, training=True,
                    noise=GumbelNoise.seeded(2, card))
        loss = F.cross_entropy(out.logits.float(), labels) + (
            out.flops_perc.mean() - 0.5) ** 2
        loss.backward()
        return torch.cat([b.qkv.weight.grad.flatten()
                          for b in model.blocks]).float()

    vit_attention.fused_vit_attention.bwd_launches = 0
    kernel = qkv_grads()
    assert vit_attention.fused_vit_attention.bwd_launches == 2
    saved = vit_attention._launch_bwd
    vit_attention._launch_bwd = vit_attention.reference_vit_attention_bwd
    try:
        plain = qkv_grads()
    finally:
        vit_attention._launch_bwd = saved
    assert F.cosine_similarity(kernel, plain, dim=0).item() >= 0.999
