"""The port's calibrators (`laudnet_tpu_torch/infer/calibrate.py`) against
the JAX package's on the same models and images: the weights are drawn by
the port's initialiser and carried to flax (`to_flax_tree`,
`to_flax_batch_stats`), the JAX side runs jitted, once per model
(module-scoped fixtures). Both sides read the same per-image densities and
masks (f32 at these seeds, no gate at a tie) and take numpy's quantiles of
them, so keeps, capacities, masks and fidelities are equal exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.infer import calibrate as jcal
from laudnet_tpu.models import laud_resnet as jlr
from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu_torch.convert.from_jax import (to_flax_batch_stats,
                                                to_flax_tree)
from laudnet_tpu_torch.infer import calibrate as tcal
from laudnet_tpu_torch.models import laud_resnet as tlr
from laudnet_tpu_torch.models import laud_vit as tlv

torch.set_num_threads(1)
VIT = dict(depth=3, dim=64, num_heads=4, mlp_ratio=2.0, patch_size=8,
           num_classes=10, head_skip=False, layer_skip=False)
CNN = dict(layers=(1, 1, 1, 1), num_classes=10, input_size=64,
           width_mult=0.25, channel_masker=("MLP",) * 4,
           channel_masker_layers=(1, 1, 1, 1))
CHANNEL = dict(CNN, dyn_mode=("channel",) * 4,
               channel_dyn_granularity=(2, 2, 2, 2))
SPATIAL = dict(CNN, dyn_mode=("spatial",) * 4,
               mask_spatial_granularity=(4, 4, 2, 1))


def _batches(shape, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def vit():
    model = tlv.LAUDViT(**VIT, img_size=32, device="cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for blk in model.blocks:  # the policy drops tokens
            blk.token_policy.bias.copy_(torch.tensor([0.0, 0.3]))
    jm = jlv.LAUDViT(**VIT)
    params = to_flax_tree(model)
    apply = jax.jit(lambda x: jm.apply({"params": params}, x, 0.1,
                                       training=False))
    return model, apply


def _cnn(kw, seed, kernel_scale=30.0):
    """A LAUD CNN with zeroed masker biases and sharpened masker kernels
    (input-dependent masks), its flax twin and the twin's variables."""
    model = tlr.LAUDResNet(**kw, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "masker" in name:
                if name.endswith("bias"):
                    p.zero_()
                else:
                    p.mul_(kernel_scale)
    model.eval()
    jm = jlr.LAUDResNet(**kw)
    variables = {"params": to_flax_tree(model),
                 "batch_stats": to_flax_batch_stats(model)}
    return model, jm, variables


@pytest.fixture(scope="module")
def channel():
    return _cnn(CHANNEL, 1)


@pytest.fixture(scope="module")
def spatial():
    model, jm, variables = _cnn(SPATIAL, 2, kernel_scale=1.0)
    apply = jax.jit(lambda x: jm.apply(variables, x, 0.1, training=False))
    return model, apply


@pytest.mark.parametrize("quantile,margin", [(0.99, 0.05), (1.0, 1e-6),
                                             (0.5, 0.0)])
def test_token_capacity_matches_jax(vit, quantile, margin):
    model, apply = vit
    batches = _batches((4, 32, 32, 3))
    want = jcal.calibrate_token_capacity(
        lambda x: apply(jnp.asarray(x)), batches, quantile, margin)
    got = tcal.calibrate_token_capacity(
        lambda x: model(torch.from_numpy(x)), batches, quantile, margin)
    assert got == want
    assert min(want) < 1.0  # the gates drop tokens


def test_channel_masks_and_fidelity_match_jax(channel):
    model, jm, variables = channel
    batches = _batches((3, 64, 64, 3), seed=1)
    jfn = jcal.make_channel_mask_fn(jm, variables, 0.1)
    tfn = tcal.make_channel_mask_fn(model, 0.1)
    for x in batches:
        for a, b in zip(tfn(torch.from_numpy(x)), jfn(jnp.asarray(x)),
                        strict=True):
            np.testing.assert_array_equal(a, b)
    tb = [torch.from_numpy(x) for x in batches]
    jb = [jnp.asarray(x) for x in batches]
    want = jcal.calibrate_channel_masks(jfn, jb)
    got = tcal.calibrate_channel_masks(tfn, tb)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    assert 0.0 < np.mean([m.mean() for m in want]) < 1.0
    assert (tcal.calibration_fidelity(tfn, got, tb)
            == jcal.calibration_fidelity(jfn, want, jb))


@pytest.mark.parametrize("quantile,margin", [(0.99, 0.05), (1.0, 0.0)])
def test_patch_capacity_matches_jax(spatial, quantile, margin):
    model, apply = spatial
    batches = _batches((3, 64, 64, 3), seed=2)
    want = jcal.calibrate_patch_capacity(
        lambda x: apply(jnp.asarray(x)), batches, quantile, margin)
    got = tcal.calibrate_patch_capacity(
        lambda x: model(torch.from_numpy(x)), batches, quantile, margin)
    assert got == want
    assert min(want) < 1.0


def test_calibrators_reject_empty_batches():
    with pytest.raises(ValueError, match="empty"):
        tcal.calibrate_token_capacity(lambda x: x, [])
    with pytest.raises(ValueError, match="empty"):
        tcal.calibrate_channel_masks(lambda x: x, [])
    with pytest.raises(ValueError, match="empty"):
        tcal.calibrate_patch_capacity(lambda x: x, [])
