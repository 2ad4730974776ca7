"""The CUDA block kernels (`laudnet_tpu_torch/csrc/vit_block.cu`) against
their plain PyTorch versions, in bf16 on the card. Marked ``cuda``; skips
without a card.

Imports no JAX, so it runs on a machine that has none; there, skip the
JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Both sides round to bf16 at the same points and differ only in f32
summation order, which flips single bf16 roundings: the tolerance is four
bf16 ulps of the largest output magnitude. Token gates read feature 0,
which the input sets to +-8 per token, so no gate sits near a tie and the
masks must be equal exactly.
"""

import pytest
import torch

from laudnet_tpu_torch.ops import vit_block

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
