"""Port parity for the training losses (`laudnet_tpu_torch/train/losses.py`)
against `laudnet_tpu/train/losses.py` on random inputs: all seven sparsity
criteria, both cross-entropy forms, KD and the total. Values and the
gradients with respect to the densities or logits: rtol 1e-5, atol 1e-6
(f32 on both sides; the port computes the bound schedule in Python
floats)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.train import losses as jl
from laudnet_tpu_torch.train import losses as tl

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
COMMON = dict(target=0.45, num_epochs=20, full_flops=4.1e9)
DYN = ("both", "channel", "spatial", "both")


def _densities(seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return dict(
        flops_perc=f32(rng.uniform(0.05, 1.0, 16)),
        flops=np.float32(rng.uniform(1e9, 4e9)),
        channel_s=[f32(rng.uniform(0, 1, n)) for n in (3, 4, 6, 3)],
        spatial_s=[f32(rng.uniform(0, 1, n)) for n in (3, 4, 6, 3)])


CRITERIA = {
    "bounds": lambda m, e, d, cat: m.sparsity_bounds(
        e, d["flops_perc"], d["flops"], **COMMON),
    "basic": lambda m, e, d, cat: m.sparsity_basic(
        e, cat(d["channel_s"]), d["flops_perc"], d["flops"], **COMMON),
    "channel_factor": lambda m, e, d, cat: m.sparsity_channel_factor(
        e, d["channel_s"], d["flops_perc"], d["flops"], dyn_mode=DYN,
        channel_loss_factor=2.0, **COMMON),
    "cs": lambda m, e, d, cat: m.sparsity_cs(
        e, d["channel_s"], d["spatial_s"], d["flops_perc"], d["flops"],
        dyn_mode=DYN, cs_loss_factor=0.5, **COMMON),
    "cs_v2": lambda m, e, d, cat: m.sparsity_cs_v2(
        e, d["channel_s"], d["spatial_s"], d["flops_perc"], d["flops"],
        dyn_mode=DYN, channel_target=0.6, **COMMON),
    "channel_bounds": lambda m, e, d, cat: m.sparsity_channel_bounds(
        e, cat(d["channel_s"]), d["flops_perc"], d["flops"], **COMMON),
    "channel_bounds_v2": lambda m, e, d, cat: m.sparsity_channel_bounds_v2(
        e, cat(d["channel_s"]), d["flops_perc"], d["flops"], **COMMON),
}


@pytest.mark.parametrize("epoch", [0.0, 2.5, 6.6, 19.0])
@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_sparsity_criterion_matches_jax(name, epoch):
    d = _densities(seed=len(name))
    fn = CRITERIA[name]

    def jloss(fp):
        dj = {k: (jnp.asarray(v) if not isinstance(v, list)
                  else [jnp.asarray(a) for a in v]) for k, v in d.items()}
        dj["flops_perc"] = fp
        return fn(jl, jnp.float32(epoch), dj, jnp.concatenate)

    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(d["flops_perc"]))
    dt = {k: (torch.tensor(v) if not isinstance(v, list)
              else [torch.tensor(a) for a in v]) for k, v in d.items()}
    dt["flops_perc"].requires_grad_()
    out = fn(tl, epoch, dt, torch.cat)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), **TOL)
    np.testing.assert_allclose(dt["flops_perc"].grad.numpy(),
                               np.asarray(ref_grad), **TOL)


def test_bounds_pin_at_the_target_then_relax():
    for epoch in (0.0, 3.0, 6.6, 7.0, 50.0):
        up, lo = tl._bounds(epoch, 20, 0.45)
        jup, jlo = jl._bounds(jnp.float32(epoch), 20, 0.45)
        np.testing.assert_allclose([up, lo], [float(jup), float(jlo)],
                                   atol=1e-6)
    assert tl._bounds(0.0, 20, 0.45) == (pytest.approx(0.45),
                                         pytest.approx(0.45))
    assert tl._bounds(7.0, 20, 0.45) == (pytest.approx(1.0),
                                         pytest.approx(0.0, abs=1e-12))


def _logits(seed, b=6, c=11):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, c)) * 3).astype(np.float32),
            (rng.standard_normal((b, c)) * 3).astype(np.float32),
            rng.integers(0, c, (b,)).astype(np.int32))


def _check(jfn, tfn, s, *rest_j, rest_t=None):
    ref, ref_grad = jax.value_and_grad(lambda a: jfn(a, *rest_j))(
        jnp.asarray(s))
    t = torch.from_numpy(s).requires_grad_()
    out = tfn(t, *(rest_t if rest_t is not None else rest_j))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_grad), **TOL)


def test_cross_entropy_matches_jax():
    s, _, y = _logits(1)
    _check(jl.cross_entropy, tl.cross_entropy, s, jnp.asarray(y),
           rest_t=(torch.from_numpy(y),))


@pytest.mark.parametrize("eps", [0.1, 0.3])
def test_cross_entropy_label_smooth_matches_jax(eps):
    """``sum(mean(-t * logp, axis=0))``: the mean runs over the batch."""
    s, _, y = _logits(2)
    _check(jl.cross_entropy_label_smooth, tl.cross_entropy_label_smooth, s,
           jnp.asarray(y), eps, rest_t=(torch.from_numpy(y), eps))


@pytest.mark.parametrize("temp", [1.0, 4.0])
def test_kd_loss_matches_jax_and_detaches_the_teacher(temp):
    s, t, _ = _logits(3)
    _check(jl.kd_loss, tl.kd_loss, s, jnp.asarray(t), temp,
           rest_t=(torch.from_numpy(t), temp))
    teacher = torch.from_numpy(t).requires_grad_()
    tl.kd_loss(torch.from_numpy(s).requires_grad_(), teacher, temp).backward()
    assert teacher.grad is None
    same = tl.kd_loss(torch.from_numpy(t), torch.from_numpy(t), temp)
    assert abs(same.item()) < 1e-6


@pytest.mark.parametrize("label_smooth", [0.0, 0.1])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_total_train_loss_matches_jax(dt, label_smooth):
    """The total and its parts; bf16 logits are promoted to f32 first on
    both sides, so the same tolerance holds."""
    s, t, y = _logits(4)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    kw = dict(lambda_act=10.0, alpha_kd=0.5, t_kd=4.0,
              label_smooth=label_smooth)
    ref, parts = jl.total_train_loss(
        jnp.asarray(s, jdt), jnp.asarray(t, jdt), jnp.asarray(y),
        jnp.float32(0.3), **kw)
    out, tparts = tl.total_train_loss(
        torch.from_numpy(s).to(tdt), torch.from_numpy(t).to(tdt),
        torch.from_numpy(y), torch.tensor(0.3), **kw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.item(), float(ref), **TOL)
    assert sorted(tparts) == sorted(parts)
    for k in parts:
        np.testing.assert_allclose(float(tparts[k]), float(parts[k]), **TOL)
