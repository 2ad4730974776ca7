"""The port's static channel export (`laudnet_tpu_torch/infer/
export_pruned.py`) against the JAX package's, on the same channel-mode
LAUD-ResNet (weights drawn by the port's initialiser, BatchNorms moved off
identity, carried to flax) and the same masks, at the tolerances of
`tests/test_export_pruned.py`: the float export within rtol/atol 2e-4 of
JAX's export and of the port's own dynamic model under the same fixed
masks; the int8 export (dynamic and calibrated static activation scales)
within atol 0.05 of JAX's (both sum the s8 codes exactly; a code at a
rounding tie may flip between the frameworks) and within 6% of the float
export with the same argmax; the recorded activation scales equal to JAX's
to rtol 1e-5, and the export on them within atol 0.05 of the dynamic
one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.infer import export_pruned as jex
from laudnet_tpu.models import laud_resnet as jlr
from laudnet_tpu_torch.convert.from_jax import (to_flax_batch_stats,
                                                to_flax_tree)
from laudnet_tpu_torch.infer import export_pruned as tex
from laudnet_tpu_torch.models import laud_resnet as tlr

torch.set_num_threads(1)
LAYERS, GRAN = (1, 1, 1, 1), (2, 2, 2, 2)
KW = dict(layers=LAYERS, num_classes=10, input_size=64, width_mult=0.25,
          dyn_mode=("channel",) * 4, channel_dyn_granularity=GRAN,
          channel_masker=("MLP",) * 4, channel_masker_layers=(1, 1, 1, 1))
JKW = dict(layers=LAYERS, channel_dyn_granularity=GRAN, input_size=64)


@pytest.fixture(scope="module")
def setup():
    """The model with each masker forced to a fixed mask (zero kernel,
    paired biases +-20), BatchNorms off identity; flax variables; images."""
    model = tlr.LAUDResNet(**KW, device="cpu",
                           generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(3)
    masks = []
    with torch.no_grad():
        for names in model.block_names:
            for n in names:
                fc = getattr(model, n).masker_channel.fc
                g = fc.bias.shape[0] // 2
                m = (rng.random(g) > 0.4).astype(np.float32)
                m[0] = 1.0
                fc.weight.zero_()
                fc.bias.copy_(torch.from_numpy(np.concatenate(
                    [np.where(m > 0, 20.0, -20.0),
                     np.where(m > 0, -20.0, 20.0)]).astype(np.float32)))
                masks.append(m)
        for mod in model.modules():
            if hasattr(mod, "running_var"):
                mod.running_var.copy_(torch.from_numpy(
                    (rng.random(mod.running_var.shape) + 0.5)
                    .astype(np.float32)))
                mod.running_mean.copy_(torch.from_numpy(
                    (rng.standard_normal(mod.running_mean.shape) * 0.1)
                    .astype(np.float32)))
                mod.bias.copy_(torch.from_numpy(
                    (rng.standard_normal(mod.bias.shape) * 0.1)
                    .astype(np.float32)))
    variables = {"params": to_flax_tree(model),
                 "batch_stats": to_flax_batch_stats(model)}
    x = np.random.default_rng(0).standard_normal((4, 64, 64, 3)).astype(
        np.float32)
    return model, variables, masks, x


def _jax(variables, masks, x, **kw):
    """JAX's export built and run inside one jitted trace: built eagerly,
    its weight folding compiles operation by operation."""
    return np.asarray(jax.jit(lambda v, x: jex.export_pruned_resnet(
        v, masks, **JKW, **kw)(x))(variables, jnp.asarray(x)))


def test_float_export_matches_jax_and_the_model(setup):
    model, variables, masks, x = setup
    got = tex.export_pruned_resnet(model, masks)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax(variables, masks, x),
                               rtol=2e-4, atol=2e-4)
    with torch.no_grad():
        dyn = model(torch.from_numpy(x), 0.1)
    np.testing.assert_allclose(
        np.concatenate([c.numpy() for c in dyn.channel_s]),
        [m.mean() for m in masks], atol=1e-6)
    np.testing.assert_allclose(got, dyn.logits.numpy(), rtol=2e-4, atol=2e-4)


def test_int8_exports_match_jax(setup):
    model, variables, masks, x = setup
    xt = torch.from_numpy(x)
    f32 = tex.export_pruned_resnet(model, masks)(xt).numpy()
    q = tex.export_pruned_resnet(model, masks, int8=True)(xt).numpy()
    np.testing.assert_allclose(q, _jax(variables, masks, x, int8=True),
                               atol=0.05)
    assert np.linalg.norm(q - f32) / np.linalg.norm(f32) < 0.06
    assert (q.argmax(-1) == f32.argmax(-1)).all()

    scales = tex.calibrate_export_act_scales(model, masks, [xt])
    want = jex.calibrate_export_act_scales(variables, masks,
                                           [jnp.asarray(x)], **JKW)
    assert len(scales) == 1 + 4 * 4
    np.testing.assert_allclose(scales, want, rtol=1e-5)
    # calibrated on the same batch, static scales reproduce the dynamic
    # ones (what JAX's test holds its own static export to)
    qs = tex.export_pruned_resnet(model, masks, int8=True,
                                  act_scales=scales)(xt).numpy()
    np.testing.assert_allclose(qs, q, atol=0.05)


def test_export_rejects_mask_granularity_mismatch(setup):
    model, _, masks, _ = setup
    bad = [np.ones(len(m) // 2, np.float32) for m in masks]
    with pytest.raises(ValueError, match="granularity"):
        tex.export_pruned_resnet(model, bad)
