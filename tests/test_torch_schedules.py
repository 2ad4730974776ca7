"""Port parity for the schedules (`laudnet_tpu_torch/train/schedules.py`,
Python floats) against `laudnet_tpu/train/schedules.py` (f32 arrays): every
learning-rate scheduler with and without warm-up, at several steps
including the warm-up edge and ``step >= total``, and the three temperature
schedules. rtol 2e-6 and atol 1e-8: the JAX side computes in f32."""

import numpy as np
import pytest

from laudnet_tpu.train import schedules as js
from laudnet_tpu_torch.train import schedules as ts

TOL = dict(rtol=2e-6, atol=1e-8)
STEPS = (0, 1, 49, 50, 51, 299, 300, 301, 999, 1000, 1500)


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("scheduler", [
    "cosine", "linear", "multistep", "uneven_multistep", "rmsprop_step",
    "exponential"])
def test_lr_matches_jax(scheduler, warmup):
    kw = dict(base_lr=0.08, total_epochs=10, steps_per_epoch=100,
              scheduler=scheduler, warmup_epochs=warmup, lr_min=1e-4,
              lr_decay_rate=0.3, lr_decay_step=2, milestones=(2, 5, 9))
    for step in STEPS:
        out = ts.lr_at(step, **kw)
        assert isinstance(out, float)
        np.testing.assert_allclose(out, float(js.lr_at(step, **kw)), **TOL,
                                   err_msg=f"step {step}")


def test_lr_warmup_edge_and_custom_warmup_lr():
    kw = dict(base_lr=0.04, total_epochs=4, steps_per_epoch=10,
              warmup_epochs=1, warmup_lr=0.001)
    assert ts.lr_at(0, **kw) == pytest.approx(0.001)
    assert ts.lr_at(9, **kw) < 0.04 and ts.lr_at(10, **kw) == 0.04
    for step in (0, 5, 9, 10, 11):
        np.testing.assert_allclose(ts.lr_at(step, **kw),
                                   float(js.lr_at(step, **kw)), **TOL)
    with pytest.raises(NotImplementedError):
        ts.lr_at(0, base_lr=0.1, total_epochs=1, steps_per_epoch=1,
                 scheduler="step")


@pytest.mark.parametrize("temp_scheduler", ["exp", "linear", "cosine"])
def test_temperature_matches_jax(temp_scheduler):
    kw = dict(t0=5.0, t_last=0.1, t_last_epoch=3, steps_per_epoch=100,
              temp_scheduler=temp_scheduler)
    for step in STEPS:
        out = ts.gumbel_temperature_at(step, **kw)
        assert isinstance(out, float)
        np.testing.assert_allclose(
            out, float(js.gumbel_temperature_at(step, **kw)), **TOL,
            err_msg=f"step {step}")
    assert ts.gumbel_temperature_at(0, **kw) == pytest.approx(5.0)
    assert ts.gumbel_temperature_at(300, **kw) == 0.1     # held from total on
