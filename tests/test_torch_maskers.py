"""Port parity for the gating heads (`laudnet_tpu_torch/models/maskers.py`)
against `laudnet_tpu/models/maskers.py`, weights through
`load_flax_variables`. The logits are a pooling and one or two f32
products. At eval the masks are 0/1 and must be equal. In training they
replay the Gumbel noise JAX drew; the straight-through forward
``y_hard + y_soft - stop_gradient(y_soft)`` is 1 - 2^-24 instead of 1 where
the soft sample's last bit says so, in both packages, and that bit may
differ between the frameworks' softmax: atol 1e-7 there. The density is a
mean of such values, summed in another order: rtol 1e-6. FLOPs are
integers and must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.models import maskers as jmk
from laudnet_tpu_torch.convert.from_jax import load_flax_variables
from laudnet_tpu_torch.models import maskers as tmk
from laudnet_tpu_torch.ops.gating import ReplayNoise

C = 32
HEADS = {
    "spatial": (lambda: jmk.SpatialMasker(1, 4),
                lambda: tmk.SpatialMasker(C, 1, 4, device="cpu")),
    "spatial_groups_rect": (
        lambda: jmk.SpatialMasker(2, (2, 4)),
        lambda: tmk.SpatialMasker(C, 2, (2, 4), device="cpu")),
    "layer": (lambda: jmk.SpatialMasker(1, 1),
              lambda: tmk.SpatialMasker(C, 1, 1, device="cpu")),
    "mlp1": (lambda: jmk.ChannelMaskerMLP(16, layers=1),
             lambda: tmk.ChannelMaskerMLP(C, 16, layers=1, device="cpu")),
    "mlp2": (lambda: jmk.ChannelMaskerMLP(16, layers=2),
             lambda: tmk.ChannelMaskerMLP(C, 16, layers=2, device="cpu")),
    "conv_linear": (
        lambda: jmk.ChannelMaskerConvLinear(8, reduction=4),
        lambda: tmk.ChannelMaskerConvLinear(C, 8, reduction=4, device="cpu")),
}


def _variables(jhead, x, seed):
    """Fresh flax variables with every bias zero and BN statistics moved, so
    that about half the gates close."""
    v = jhead.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), 1.0,
                   training=False)
    v = jax.tree_util.tree_map(np.array, dict(v))
    rng = np.random.default_rng(seed)

    def shake(tree):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                shake(leaf)
            elif k == "bias":
                tree[k] = np.zeros_like(leaf)
            elif k == "var":
                tree[k] = (rng.random(leaf.shape) + 0.5).astype(np.float32)
            elif k == "mean":
                tree[k] = (rng.standard_normal(leaf.shape) * 0.1).astype(
                    np.float32)
    shake(v)
    return v


@pytest.mark.parametrize("name,training", [(n, False) for n in sorted(HEADS)]
                         + [(n, True) for n in ("spatial_groups_rect", "mlp2",
                                                "conv_linear")])
def test_head_matches_flax(monkeypatch, name, training):
    jhead, thead = (f() for f in HEADS[name])
    x = np.random.default_rng(len(name)).standard_normal(
        (3, 8, 8, C)).astype(np.float32)
    v = _variables(jhead, x, seed=len(name))
    recorded = []
    original = jax.random.gumbel

    def recording(key, shape=(), dtype=float, **kw):
        out = original(key, shape, dtype, **kw)
        recorded.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "gumbel", recording)
    (jmask, jdens, jflops), mutated = jhead.apply(
        v, jnp.asarray(x), 0.7, training=training,
        rngs={"gumbel": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
    monkeypatch.setattr(jax.random, "gumbel", original)
    assert len(recorded) == int(training)

    load_flax_variables(thead, v)
    mask, dens, flops = thead(torch.from_numpy(x), 0.7, training=training,
                              noise=ReplayNoise(recorded))
    assert flops == jflops and isinstance(flops, int)
    assert mask.shape == jmask.shape
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(jmask),
                               rtol=0, atol=1e-7 if training else 0.0)
    np.testing.assert_allclose(float(dens.detach()), float(jdens), rtol=1e-6)
    assert 0.0 < float(dens.detach()) < 1.0
    if training and name == "conv_linear":
        got = dict(thead.bn.named_buffers())
        ref = mutated["batch_stats"]["bn"]
        for ours, theirs in (("running_mean", "mean"), ("running_var",
                                                        "var")):
            np.testing.assert_allclose(got[ours].numpy(),
                                       np.asarray(ref[theirs]), rtol=1e-5,
                                       atol=1e-7)


def test_heads_cast_their_input_to_f32():
    _, thead = (f() for f in HEADS["spatial"])
    thead.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 8, C)
    a, _, _ = thead(x.to(torch.bfloat16))
    b, _, _ = thead(x.to(torch.bfloat16).float())
    assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("name,leaf,group,open_value,close_value", [
    ("spatial_groups_rect", "conv", 2, 5.0, 0.0),
    ("mlp1", "fc", 16, 2.0, -2.0), ("mlp2", "fc2", 16, 2.0, -2.0),
    ("conv_linear", "linear", 8, 2.0, -2.0)])
def test_bias_layout_keeps_the_off_by_one(name, leaf, group, open_value,
                                          close_value):
    """[:G] open, [G] the default uniform draw, [G + 1:] close, as flax's
    `masker_bias_init` lays it out."""
    jhead, thead = (f() for f in HEADS[name])
    thead.init_weights(torch.Generator().manual_seed(3))
    bias = getattr(thead, leaf).bias.detach().numpy()
    x = np.zeros((1, 8, 8, C), np.float32)
    jbias = np.asarray(jhead.init({"params": jax.random.PRNGKey(0)}, x, 1.0,
                                  training=False)["params"][leaf]["bias"])
    for b in (bias, jbias):
        assert (b[:group] == open_value).all()
        assert (b[group + 1:] == close_value).all()
        assert b[group] not in (open_value, close_value)
    fan_in = getattr(thead, leaf).weight[0].numel()
    assert abs(bias[group]) <= fan_in ** -0.5
