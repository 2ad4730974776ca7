"""The CUDA kernels (`laudnet_tpu_torch/csrc/vit_block.cu`: the block B1,
the segment B2, the W8A8 block B6 and the attention forward B4) against
their plain PyTorch versions, in bf16 on the card. Marked ``cuda``; skips
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
"""

import pytest
import torch

from laudnet_tpu_torch.ops import vit_attention, vit_block

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
    with pytest.raises(NotImplementedError, match="training slice"):
        vit_attention.fused_vit_attention(qkv.requires_grad_(), mask, None,
                                          2, 0.125)
