"""Profiling helpers (counterpart of `laudnet_tpu/utils/profiler.py`).

* :func:`trace` — a context manager around `torch.profiler`: host and, on
  a card, device activity of everything run inside, written as a Chrome
  trace (``trace.json``) into a directory.
* :func:`compiled_cost` — the operations of a call as PyTorch's
  `torch.utils.flop_counter.FlopCounterMode` counts them (matrix products
  and convolutions, two per multiply-add, as XLA's cost analysis counts
  them), and the bytes it must move at the least: each tensor argument
  read once and each tensor result written once.
* :func:`roofline_summary` — both as latency bounds on a
  `sim.hardware.HopperSpec` (default: the H100): the operations over the
  measured bf16 matrix-product rate (``matmul_rate``, what the JAX
  function's ``peak_bf16 * sustained_frac`` stands for), the bytes over
  the HBM bandwidth.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/tb") as prof: fn(...)`` profiles the block (the
    card too when there is one) and writes ``<log_dir>/trace.json``;
    ``prof.key_averages()`` sums the time by operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _nbytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))


def compiled_cost(fn: Callable, *args, **kwargs) -> dict:
    """Runs ``fn(*args, **kwargs)`` once and returns ``{"flops", "bytes
    accessed"}``: the operations FlopCounterMode counts and the bytes of
    the tensor arguments and results."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()),
            "bytes accessed": _nbytes((args, kwargs)) + _nbytes(out)}


def roofline_summary(fn: Callable, *args, spec: Optional[Any] = None,
                     **kwargs) -> dict:
    """`compiled_cost` of ``fn`` and its latency bounds on ``spec`` (a
    `HopperSpec`; the H100 preset by default). ``bound`` names the
    limiting resource."""
    if spec is None:
        from laudnet_tpu_torch.sim.hardware import HOPPER_PRESETS

        spec = HOPPER_PRESETS["h100"]
    cost = compiled_cost(fn, *args, **kwargs)
    flops, in_bytes = cost["flops"], cost["bytes accessed"]
    t_compute = flops / spec.matmul_rate
    t_memory = in_bytes / spec.mem_bandwidth
    return {
        "flops": flops,
        "bytes_accessed": in_bytes,
        "compute_bound_s": t_compute,
        "memory_bound_s": t_memory,
        "roofline_s": max(t_compute, t_memory),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "arithmetic_intensity": flops / max(in_bytes, 1.0),
    }
