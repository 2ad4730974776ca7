"""Chained CUDA-event timing (the probes and `chip_smoke.py`).

A chain of ``chain`` calls runs between two CUDA events after a warm-up,
``repeats`` times; the best chain, divided by its length, is the time of
one call (the counterpart of `bench.py::_chain_time`, which chains calls
inside one jitted loop because the TPU's host round trip is slow). Calls
are queued back to back on one stream, so a call's launch overhead hides
under the previous call's work unless the call is shorter than it.
"""

from __future__ import annotations

import statistics

import torch


def chain_times(fn, chain: int = 1, repeats: int = 20,
                warmup: int = 3) -> list[float]:
    """Milliseconds per call of ``fn()`` in each of ``repeats`` chains."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / chain)
    return times


def chain_ms(fn, chain: int = 20, repeats: int = 3, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()``: the best of ``repeats`` chains."""
    return min(chain_times(fn, chain, repeats, warmup))


def in_turns(first, second, chain: int = 10, rounds: int = 3,
             repeats: int = 10, warmup: int = 2):
    """Readings of two callables timed in rounds of first, second, second,
    first, so that a slow spell of the host falls on both: a reading is
    the median of ``repeats`` chains of ``chain`` calls (ms a call).
    Returns the two lists of readings."""
    a, b = [], []
    for _ in range(rounds):
        for side, fn in ((a, first), (b, second), (b, second), (a, first)):
            side.append(statistics.median(chain_times(fn, chain, repeats,
                                                      warmup)))
    return a, b
