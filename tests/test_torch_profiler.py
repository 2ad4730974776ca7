"""The port's profiling helpers (`laudnet_tpu_torch/utils/profiler.py`)
beside the JAX package's (`tests/test_profiler.py`): the same operation
count for a matrix product (two per multiply-add on both sides), bounds on
the H100 preset, and a trace written on the CPU."""

import os

import jax.numpy as jnp
import torch

from laudnet_tpu.utils.profiler import compiled_cost as jcost
from laudnet_tpu_torch.sim.hardware import HOPPER_PRESETS
from laudnet_tpu_torch.utils import profiler


def test_compiled_cost_counts_what_xla_counts():
    a = torch.ones(256, 256)
    cost = profiler.compiled_cost(lambda x, y: x @ y, a, a)
    assert cost["flops"] == 2 * 256 ** 3 == jcost(
        lambda x, y: x @ y, jnp.ones((256, 256)), jnp.ones((256, 256)))[
        "flops"]
    assert cost["bytes accessed"] == 3 * 256 * 256 * 4


def test_roofline_summary_bounds_on_the_h100():
    a = torch.ones(512, 512)
    s = profiler.roofline_summary(lambda x, y: x @ y, a, a)
    spec = HOPPER_PRESETS["h100"]
    assert s["compute_bound_s"] == 2 * 512 ** 3 / spec.matmul_rate
    assert s["memory_bound_s"] == 3 * 512 * 512 * 4 / spec.mem_bandwidth
    assert s["roofline_s"] == max(s["compute_bound_s"], s["memory_bound_s"])
    # 85 operations a byte in f32: under the H100's ridge, memory-bound
    assert s["arithmetic_intensity"] == 2 * 512 / 12
    assert s["bound"] == "memory"


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "tb")
    with profiler.trace(d) as prof:
        torch.ones(16).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
    assert any("sum" in e.key for e in prof.key_averages())
