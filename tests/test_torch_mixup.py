"""`laudnet_tpu_torch/utils/mixup.py` against `laudnet_tpu/utils/mixup.py`:
with JAX's λ and permutation (drawn from the key as JAX's `mixup_data`
draws them) the port's mix equals JAX's bit for bit, the criterion agrees
to f32 rounding, and the properties of JAX's
`tests/test_utils_misc.py::test_mixup_properties` hold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.utils.mixup import mixup_criterion as j_criterion
from laudnet_tpu.utils.mixup import mixup_data as j_mixup
from laudnet_tpu_torch.utils.mixup import mix, mixup_criterion, mixup_data


@pytest.mark.parametrize("alpha", [1.0, 0.4])
def test_mix_equals_jax_for_the_same_lambda_and_permutation(alpha):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 5, (6,)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)         # as JAX's mixup_data draws them
    lam = np.array(jax.random.beta(k1, alpha, alpha))
    perm = np.array(jax.random.permutation(k2, x.shape[0]))
    mixed_j, soft_j = j_mixup(key, jnp.asarray(x), jnp.asarray(y),
                              alpha=alpha, num_classes=5)
    mixed, soft = mix(torch.from_numpy(x), torch.from_numpy(y),
                      torch.from_numpy(lam), torch.from_numpy(perm), 5)
    np.testing.assert_array_equal(mixed.numpy(), np.asarray(mixed_j))
    np.testing.assert_array_equal(soft.numpy(), np.asarray(soft_j))
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    np.testing.assert_allclose(
        float(mixup_criterion(torch.from_numpy(logits), soft)),
        float(j_criterion(jnp.asarray(logits), soft_j)), rtol=1e-6)


def test_mixup_properties():
    x = torch.arange(24.0).reshape(4, 2, 3, 1)
    y = torch.tensor([0, 1, 2, 3])
    mixed, soft = mixup_data(torch.Generator().manual_seed(0), x, y,
                             alpha=1.0, num_classes=4)
    assert mixed.shape == x.shape and soft.shape == (4, 4)
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-6)
    again = mixup_data(torch.Generator().manual_seed(0), x, y, alpha=1.0,
                       num_classes=4)
    assert torch.equal(again[0], mixed) and torch.equal(again[1], soft)
    # alpha=0 -> identity mix
    mixed0, soft0 = mixup_data(torch.Generator().manual_seed(0), x, y,
                               alpha=0.0, num_classes=4)
    np.testing.assert_allclose(mixed0.numpy(), x.numpy())
    assert torch.equal(soft0, torch.eye(4))
