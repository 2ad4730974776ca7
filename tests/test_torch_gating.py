"""Port parity for the training gates (`laudnet_tpu_torch/ops/gating.py`)
against `laudnet_tpu/ops/gating.py` under THE SAME Gumbel noise: the test
draws ``jax.random.gumbel(key, shape)``, the JAX function draws the same
from the same key, and the port replays it through `ReplayNoise`.

The decisions (the forward rounded to 0/1) are equal exactly; the raw
forward carries the straight-through residue ``(1 - s) + s``, one f32 ulp
of 1 that depends on the framework's softmax, so it is held to 2e-7.
Gradients with respect to the logits: 1e-6 of the largest gradient (f32
softmax; at tau 0.1 gradients reach ~30)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.ops import gating as jg
from laudnet_tpu_torch.ops import gating as tg

torch.set_num_threads(1)
SHAPES = {"layer": (4, 2, 2), "head": (4, 2, 6), "token": (3, 17, 2, 1)}


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32) * 2.0
    weight = rng.standard_normal(shape[:-2] + shape[-1:]).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    noise = np.asarray(jax.random.gumbel(key, shape, dtype=jnp.float32))
    return logits, weight, key, noise


@pytest.mark.parametrize("tau", [5.0, 0.7, 0.1])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_binary_gate_training_matches_jax(name, tau):
    logits, weight, key, noise = _case(SHAPES[name], seed=len(name))

    def f(l):
        m = jg.binary_gate(l, tau, training=True, key=key)
        return (m * weight).sum(), m

    (_, ref), ref_grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    out = tg.binary_gate(t, tau, training=True, noise=tg.ReplayNoise([noise]))
    (out * torch.from_numpy(weight)).sum().backward()
    vals = out.detach().numpy()
    np.testing.assert_array_equal(np.round(vals), np.round(np.asarray(ref)))
    np.testing.assert_allclose(vals, np.asarray(ref), atol=2e-7, rtol=0)
    top = max(1.0, float(np.abs(np.asarray(ref_grad)).max()))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_grad),
                               atol=1e-6 * top, rtol=0)
    # straight-through: the forward is 0/1, the gradient is not zero
    assert np.allclose(vals, np.round(vals), atol=1e-6)
    assert np.abs(t.grad.numpy()).sum() > 0


@pytest.mark.parametrize("hard", [True, False])
def test_gumbel_softmax_matches_jax(hard):
    logits, _, key, noise = _case((5, 2, 4), seed=3)
    ref = jg.gumbel_softmax(key, jnp.asarray(logits), 0.9, axis=-2, hard=hard)
    out = tg.gumbel_softmax(tg.ReplayNoise([noise]),
                            torch.from_numpy(logits), 0.9, dim=-2, hard=hard)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7,
                               rtol=0)
    np.testing.assert_allclose(out.sum(dim=-2).numpy(), 1.0, atol=1e-6)
    if hard:   # the gradient of the hard sample is the soft sample's
        t = torch.from_numpy(logits).requires_grad_()
        w = torch.arange(40.0).reshape(5, 2, 4)
        (tg.gumbel_softmax(tg.ReplayNoise([noise]), t, 0.9, dim=-2) * w
         ).sum().backward()
        t2 = torch.from_numpy(logits).requires_grad_()
        (tg.gumbel_softmax(tg.ReplayNoise([noise]), t2, 0.9, dim=-2,
                           hard=False) * w).sum().backward()
        assert torch.equal(t.grad, t2.grad)


def test_training_gate_needs_a_noise_source_and_eval_does_not():
    logits = torch.tensor([[[1.0, 0.5], [0.5, 0.5]],
                           [[0.2, 0.7], [-1.0, 2.0]]])
    with pytest.raises(ValueError, match="noise source"):
        tg.binary_gate(logits, 1.0, training=True)
    # eval: on >= off, ties keep
    assert tg.binary_gate(logits).tolist() == [[1.0, 1.0], [1.0, 0.0]]


def test_generator_noise_is_seeded_gumbel():
    """`GumbelNoise` draws from its own generator (never the global RNG),
    repeats under the same seed, and has Gumbel(0, 1) moments: mean
    0.5772, variance pi^2 / 6 (20,000 draws: within 0.05)."""
    a = tg.GumbelNoise.seeded(7).gumbel((20000,))
    state = torch.random.get_rng_state()
    b = tg.GumbelNoise.seeded(7).gumbel((20000,))
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert abs(a.mean().item() - 0.5772) < 0.05
    assert abs(a.var().item() - np.pi ** 2 / 6) < 0.05
    src = tg.GumbelNoise.seeded(7)
    src.gumbel((3,))
    src.reseed(7)
    assert torch.equal(src.gumbel((20000,)), a)


def test_replay_noise_checks_shapes():
    src = tg.ReplayNoise([np.zeros((2, 3), np.float32)])
    with pytest.raises(ValueError, match="asked for"):
        src.gumbel((3, 2))
