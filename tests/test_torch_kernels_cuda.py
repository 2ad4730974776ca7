"""The CUDA kernels (`laudnet_tpu_torch/csrc/vit_block.cu`: the block B1,
the segment B2, the W8A8 block B6 and the attention forward B4;
`csrc/vit_attention_bwd.cu`: the attention backward B5;
`csrc/masked_block.cu`: the block-sparse bottleneck tail B3) against their
plain PyTorch versions, in bf16 on the card. Marked ``cuda``; skips
without a card.

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
bit.
"""

import pytest
import torch

from laudnet_tpu_torch.ops import masked_block, vit_attention, vit_block

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
    with pytest.raises(TypeError, match="bf16"):
        vit_attention.fused_vit_attention(qkv.float(), mask, None, 2, 0.125)
    with pytest.raises(ValueError, match="L <= 256"):
        vit_attention.fused_vit_attention(
            torch.zeros(1, 300, 384, device=card, dtype=torch.bfloat16),
            torch.ones(1, 300, device=card), None, 2, 0.125)
    with pytest.raises(TypeError, match="cotangent"):
        vit_attention._launch_bwd(qkv, mask, None,
                                  torch.ones(2, 9, 128, device=card), 2,
                                  0.125)                        # f32


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


def _tail_inputs(seed, b, hw, c, co, patch, density, dev):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=g) * scale
    hm = hw // patch
    bf = lambda t: t.to(dev, torch.bfloat16)
    mask = (torch.rand(b, hm, hm, generator=g) < density).float().to(dev)
    return dict(
        x1=bf(rn(b, hw, hw, c).relu()), identity=bf(rn(b, hw, hw, co)),
        mask_cells=mask, w2=bf(rn(3, 3, c, c, scale=(9 * c) ** -0.5)),
        a2=(1.0 + rn(c, scale=0.1)).to(dev), b2=rn(c, scale=0.1).to(dev),
        w3=bf(rn(c, co, scale=c ** -0.5)),
        a3=(1.0 + rn(co, scale=0.1)).to(dev), b3=rn(co, scale=0.1).to(dev))


def _check_tail(t, patch, capacity):
    before = masked_block.masked_bottleneck_tail.launches
    got = masked_block.masked_bottleneck_tail(**t, patch=patch,
                                              capacity=capacity)
    torch.cuda.synchronize()
    assert masked_block.masked_bottleneck_tail.launches == before + 1
    want = masked_block.reference_masked_bottleneck_tail(
        **t, patch=patch, capacity=capacity)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), (err, _tol(want))
    # cells that were not selected: relu(identity), bit for bit
    b, hm = t["mask_cells"].shape[:2]
    active = t["mask_cells"].reshape(b, -1) > 0.5
    chosen = (active & (active.cumsum(1) <= capacity)).reshape(b, hm, hm)
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


def test_bottleneck_tail_refuses_what_it_does_not_take(card):
    t = _tail_inputs(1, 2, 8, 64, 64, 2, 0.5, card)
    f32 = {k: (v.float() if v.dtype == torch.bfloat16 else v)
           for k, v in t.items()}
    with pytest.raises(TypeError):
        masked_block.masked_bottleneck_tail(**f32, patch=2, capacity=4)
    with pytest.raises(ValueError):
        masked_block.masked_bottleneck_tail(**t, patch=2, capacity=0)
    narrow = _tail_inputs(1, 2, 8, 32, 64, 2, 0.5, card)
    with pytest.raises(ValueError):
        masked_block.masked_bottleneck_tail(**narrow, patch=2, capacity=4)
