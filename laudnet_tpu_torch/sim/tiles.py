"""Tile-search spaces and efficiency models for the roofline predictor.

Same capability as the reference's search utilities
(`DyNetSimulator/hardware_models/utils.py:7-77`): candidate tile sizes
(powers of two + divisors + small ints), quantization-loss efficiencies, the
coalesced-sector memory model, and the Monte-Carlo estimate of the *maximum*
per-tile channel density (the straggler tile bounds dynamic-conv latency).
Our MC estimate is seeded per configuration so predictions are reproducible.
A copy of `laudnet_tpu/sim/tiles.py`, which the port does not import.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def tile_candidates(n: int, max_div: int = 8, pow2_upper: int = 8):
    """Candidate tile sizes for a dimension of size ``n``: powers of two up
    to 2n, ceil-divisors n/1..n/max_div, and small integers."""
    cands = {1 << i for i in range(pow2_upper) if (1 << i) <= n * 2}
    cands |= {math.ceil(n / d) for d in range(1, min(n, max_div))}
    cands |= set(range(2, min(n, max_div)))
    cands.add(n)
    return sorted(c for c in cands if c >= 1)


def ceil_eff(x: float, quantum: float) -> float:
    """Fraction of useful work when x is padded up to a multiple of quantum."""
    if x <= 0:
        return 1.0
    return x / (math.ceil(x / quantum) * quantum)


def coalesce_eff(n: float, interval: float, concurrent: float) -> float:
    """Efficiency of coalesced memory requests reading runs of ``n`` words
    separated by ``interval`` wasted words, with sectors of ``concurrent``."""
    interval = max(interval, 0)
    if n > concurrent:
        return ceil_eff(n, concurrent)
    if n + interval > concurrent:
        return n / concurrent
    return n / (n + interval)


@lru_cache(maxsize=4096)
def expected_max_tile_density(n_tiles: int, tile: int, density: float,
                              group: int, n_samples: int = 100) -> float:
    """E[max over tiles of realized channel density] for random group masks.

    When channels are gated in groups of ``group`` at probability ``density``,
    the slowest of ``n_tiles`` tiles (each covering ``tile`` channels)
    dominates latency. Seeded MC; never below ``density``.
    """
    if density >= 1.0:
        return 1.0
    n_groups = math.ceil(n_tiles * tile / group)
    rng = np.random.default_rng(
        abs(hash((n_tiles, tile, round(density, 6), group))) % (2**32)
    )
    keep = rng.random((n_samples, n_groups)) < density
    per_channel = np.repeat(keep, group, axis=1)[:, : n_tiles * tile]
    per_tile = per_channel.reshape(n_samples, n_tiles, tile).sum(axis=2)
    est = float(per_tile.max(axis=1).mean() / tile)
    return max(est, density)
