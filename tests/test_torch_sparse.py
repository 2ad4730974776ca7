"""Port parity for the fixed-capacity sparse primitives
(`laudnet_tpu_torch/ops/sparse.py`) against `laudnet_tpu/ops/sparse.py`:
selection order, gathered windows and the scatter are index work on the
same numbers and must be equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.ops import sparse as js
from laudnet_tpu_torch.ops import sparse as ts


def _case(seed, b=3, hm=4, patch=2, c=5, density=0.5):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, hm, hm)) < density).astype(np.float32)
    x = rng.standard_normal((b, hm * patch, hm * patch, c)).astype(np.float32)
    return mask, x


@pytest.mark.parametrize("capacity", [1, 5, 16])
@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_select_patches_order(capacity, density):
    mask, _ = _case(capacity, density=density)
    idx, valid = ts.select_patches(torch.from_numpy(mask), capacity)
    jidx, jvalid = js.select_patches(jnp.asarray(mask), capacity)
    assert idx.dtype == torch.int32 and idx.shape == (3, capacity)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("patch,halo", [(2, 1), (4, 1), (1, 1), (2, 0)])
def test_gather_patches(patch, halo):
    mask, x = _case(patch, patch=patch)
    idx, _ = ts.select_patches(torch.from_numpy(mask), 6)
    got = ts.gather_patches(torch.from_numpy(x), idx, patch, halo)
    ref = js.gather_patches(jnp.asarray(x), jnp.asarray(idx.numpy()), patch,
                            halo)
    assert got.shape == (3, 6, patch + 2 * halo, patch + 2 * halo, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("patch,capacity", [(2, 16), (2, 5), (4, 3), (1, 9)])
def test_scatter_patches_add(patch, capacity):
    mask, base = _case(10 + capacity, patch=patch)
    rng = np.random.default_rng(capacity)
    patches = rng.standard_normal(
        (3, capacity, patch, patch, 5)).astype(np.float32)
    idx, valid = ts.select_patches(torch.from_numpy(mask), capacity)
    got = ts.scatter_patches_add(torch.from_numpy(base),
                                 torch.from_numpy(patches), idx, valid, patch)
    ref = js.scatter_patches_add(
        jnp.asarray(base), jnp.asarray(patches), jnp.asarray(idx.numpy()),
        jnp.asarray(valid.numpy()), patch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a cell that was not selected keeps the base
    chosen = np.zeros((3, 16), bool)
    np.put_along_axis(chosen, idx.numpy().astype(np.int64),
                      valid.numpy() > 0.5, axis=1)
    pix = np.repeat(np.repeat(chosen.reshape(3, 4, 4), patch, 1), patch, 2)
    np.testing.assert_array_equal(got.numpy()[~pix], base[~pix])
