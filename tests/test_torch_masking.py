"""Port parity for the mask algebra (`laudnet_tpu_torch/ops/masking.py`)
against `laudnet_tpu/ops/masking.py` on the same numpy inputs, every
function and both branches of the two resizers. Masks and their dilations
are 0/1 and must be equal; the multiplications are one f32 product each
and must be equal too; the poolings sum in another order than XLA and are
held to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.ops import masking as jm
from laudnet_tpu_torch.ops import masking as tm

RNG = np.random.default_rng(0)


def _x(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _mask(*shape, p=0.5):
    return (RNG.random(shape) < p).astype(np.float32)


@pytest.mark.parametrize("groups", [1, 4, 8])
def test_apply_channel_mask(groups):
    x, m = _x(2, 5, 5, 8), _mask(2, groups)
    got = tm.apply_channel_mask(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.apply_channel_mask(x, jnp.asarray(m))))


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_apply_spatial_mask(groups):
    x, m = _x(2, 6, 6, 8), _mask(2, 6, 6, groups)
    got = tm.apply_spatial_mask(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.apply_spatial_mask(x, jnp.asarray(m))))


@pytest.mark.parametrize("shape,size", [((4, 4), 16), ((7, 7), 7),
                                        ((4, 4), (8, 12)), ((3, 5), (7, 9)),
                                        ((7, 7), 10)])
def test_upsample_mask_nearest(shape, size):
    m = _mask(2, *shape, 2)
    got = tm.upsample_mask_nearest(torch.from_numpy(m), size)
    ref = np.asarray(jm.upsample_mask_nearest(jnp.asarray(m), size))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("stride,padding,groups", [(1, 0, 1), (1, 1, 1),
                                                   (2, 1, 1), (2, 1, 3),
                                                   (1, 2, 2)])
def test_expand_mask(stride, padding, groups):
    m = _mask(2, 6, 6, groups, p=0.2)
    got = tm.expand_mask(torch.from_numpy(m), stride=stride, padding=padding)
    ref = np.asarray(jm.expand_mask(jnp.asarray(m), stride=stride,
                                    padding=padding))
    assert got.dtype == torch.bool and ref.dtype == np.bool_
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # the densities the FLOPs bookkeeping takes from it
    assert float(got.float().mean()) == float(ref.astype(np.float32).mean())


@pytest.mark.parametrize("hw,out", [((16, 16), 4), ((8, 8), 8),
                                    ((8, 12), (4, 3)), ((7, 10), (3, 4)),
                                    ((7, 7), 2)])
def test_adaptive_avg_pool(hw, out):
    x = _x(2, *hw, 5)
    got = tm.adaptive_avg_pool(torch.from_numpy(x), out)
    ref = np.asarray(jm.adaptive_avg_pool(jnp.asarray(x), out))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    # the rule is F.adaptive_avg_pool2d's
    torch_ref = torch.nn.functional.adaptive_avg_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), torch_ref.numpy(), atol=1e-6)


def test_adaptive_avg_pool_accumulates_in_f32():
    x = torch.from_numpy(_x(1, 16, 16, 4)).to(torch.bfloat16)
    got = tm.adaptive_avg_pool(x, 2)
    ref = jm.adaptive_avg_pool(jnp.asarray(x.float().numpy(), jnp.bfloat16), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_global_avg_pool():
    x = _x(3, 5, 7, 6)
    np.testing.assert_allclose(
        tm.global_avg_pool(torch.from_numpy(x)).numpy(),
        np.asarray(jm.global_avg_pool(jnp.asarray(x))), atol=1e-6)
