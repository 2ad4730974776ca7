"""Multi-core roofline latency predictor with exhaustive tile search.

The static-op engine: each operator enumerates tile configurations, models
per-tile compute (lane quantization, pipeline slots) and memory traffic
(weights/input/output through an L2-like cache with coalescing efficiency +
a fused HBM term), schedules tiles onto cores in waves, and keeps the best
configuration. Same modeling capability as the reference predictor
(`DyNetSimulator/hardware_models/static_predictor.py`), rebuilt around one
generic search loop instead of per-op copies.

All sizes are per-image; ``spec.batch_size`` scales activation traffic and
compute (weights are amortized across the batch, except batch-1 dynamic
cases where masked weights are skipped).

A copy of `laudnet_tpu/sim/roofline.py`, which the port does not import.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

from laudnet_tpu_torch.sim.hardware import DeviceSpec
from laudnet_tpu_torch.sim.report import SimulationReport
from laudnet_tpu_torch.sim.tiles import (
    ceil_eff,
    coalesce_eff,
    expected_max_tile_density,
    tile_candidates,
)


class Predictor:
    """Static-network latency predictor for a :class:`DeviceSpec`."""

    def __init__(self, spec: DeviceSpec, verbose: bool = False):
        self.spec = spec
        self.verbose = verbose

    # --- shared machinery -------------------------------------------------

    def _memory_latency(self, per_core_traffic: float, fused_traffic: float,
                        req_size: float, req_interval: float) -> float:
        """HBM pass for the fused working set + L2 pass for per-core reads,
        derated by sector coalescing."""
        s = self.spec
        hbm = fused_traffic / s.mem_fp32_bandwidth
        l2_eff = coalesce_eff(req_size, req_interval, s.mem_concurrent)
        l2 = per_core_traffic / s.cache_fp32_bandwidth / l2_eff
        return hbm + l2

    def _combine(self, compute: float, memory: float) -> float:
        if self.spec.latency_mode == "add":
            return compute + memory
        return max(compute, memory)

    def _report(self, compute: float, memory: float, cfg: dict,
                launches: int = 1) -> SimulationReport:
        return SimulationReport(
            latency=self._combine(compute, memory)
            + launches * self.spec.launch_time,
            compute_latency=compute,
            memory_latency=memory,
            cfg=[cfg],
        )

    def _tree_reduce_latency(self, width: float, n_elements: float) -> float:
        """log2-tree reduction of ``n_elements`` per each of ``width``
        parallel lanes (e.g. global pooling)."""
        s = self.spec
        n = math.ceil(n_elements / 2)
        latency = 0.0
        while n > 1:
            eff = ceil_eff(n * width, s.peak_parallelism)
            latency += math.ceil(n * width / s.lanes) / eff / s.frequency
            n = math.ceil(n / 2)
        return latency * s.batch_size

    # --- operators ---------------------------------------------------------

    def conv(self, cin: int, cout: int, inh: int, inw: int, ks: int,
             groups: int = 1, stride: int = 1, ic_density: float = 1.0,
             oc_density: float = 1.0, c_group: int = 1) -> SimulationReport:
        """Dense (optionally channel-density-scaled) convolution."""
        s = self.spec
        outh, outw = inh // stride, inw // stride
        best: Optional[Tuple[float, float, float, dict]] = None
        for c_t in tile_candidates(cout):
            n_c = math.ceil(cout / c_t)
            for h_t in tile_candidates(outh):
                n_h = math.ceil(outh / h_t)
                for w_t in tile_candidates(outw):
                    n_w = math.ceil(outw / w_t)
                    n_tiles = n_c * n_h * n_w

                    # Per-core traffic (through L2): weights + haloed input
                    # + output for one tile, times all tiles.
                    wpc = c_t * (cin // groups) * ks * ks
                    gpc = math.ceil(c_t / max(cout // groups, 1))
                    ipc = (gpc * (cin // groups)
                           * (h_t + ks - 1) * stride
                           * (w_t + ks - 1) * stride)
                    opc = c_t * h_t * w_t
                    if s.batch_size == 1:
                        wpc *= ic_density * oc_density
                    per_core = (wpc + ipc * ic_density * s.batch_size
                                + opc * oc_density * s.batch_size) * n_tiles

                    # Fused HBM working set (each tensor read/written once).
                    w_all = cout * (cin // groups) * ks * ks
                    if s.batch_size == 1:
                        w_all *= oc_density
                    fused = (w_all
                             + cin * inh * inw * s.batch_size * ic_density
                             + cout * outh * outw * s.batch_size * oc_density)
                    mem = self._memory_latency(
                        per_core, fused, req_size=w_t, req_interval=outw - w_t
                    )

                    # Straggler tile dominates under random channel masks.
                    max_oc = expected_max_tile_density(
                        n_c, c_t, ic_density * oc_density, c_group
                    )
                    flops = (c_t * h_t * w_t * (cin // groups) * ks * ks
                             * s.batch_size)
                    pe_compute = (flops / s.frequency / s.lanes
                                  * ic_density * max_oc)
                    tile_sz = c_t * h_t * w_t
                    pe_eff = ceil_eff(tile_sz, s.peak_parallelism)
                    compute = (pe_compute / pe_eff
                               * math.ceil(n_tiles / s.n_cores))

                    lat = self._combine(compute, mem)
                    if best is None or lat < best[0]:
                        best = (lat, compute, mem,
                                dict(op="conv", c_tile=c_t, h_tile=h_t,
                                     w_tile=w_t, n_tiles=n_tiles, cin=cin,
                                     cout=cout, ks=ks, stride=stride))
        _, compute, mem, cfg = best
        return self._report(compute, mem, cfg)

    def fc(self, cin: int, cout: int, ic_density: float = 1.0,
           oc_density: float = 1.0) -> SimulationReport:
        """Fully connected layer = 1x1 conv on a 1x1 map."""
        return self.conv(cin, cout, 1, 1, 1,
                         ic_density=ic_density, oc_density=oc_density)

    def _elementwise(self, volume: float, n_inputs: int = 2,
                     flops_per_elem: float = 1.0) -> SimulationReport:
        """Generic elementwise op over ``volume`` fp32 elements/image."""
        s = self.spec
        v = volume * s.batch_size
        traffic = v * (n_inputs + 1)
        mem = self._memory_latency(traffic, traffic, req_size=s.mem_concurrent,
                                   req_interval=0)
        eff = ceil_eff(v, s.peak_parallelism * s.n_cores)
        compute = (v * flops_per_elem / (s.lanes * s.n_cores) / eff
                   / s.frequency)
        return self._report(compute, mem, dict(op="elementwise", volume=volume))

    def add(self, c: int, h: int, w: int,
            density: float = 1.0) -> SimulationReport:
        """Residual add (`static_predictor.py:224-316` capability)."""
        return self._elementwise(c * h * w * density, n_inputs=2)

    def relu(self, c: int, h: int, w: int) -> SimulationReport:
        return self._elementwise(c * h * w, n_inputs=1)

    def avg_pool(self, c: int, inh: int, inw: int, ks: int,
                 stride: int) -> SimulationReport:
        outh, outw = inh // stride, inw // stride
        vol = c * outh * outw
        rep = self._elementwise(vol, n_inputs=1, flops_per_elem=ks * ks)
        return rep

    def global_avg_pool(self, c: int, h: int, w: int) -> SimulationReport:
        """GAP as a log2 tree reduce (`static_predictor.py:318-395`)."""
        s = self.spec
        compute = self._tree_reduce_latency(c, h * w)
        traffic = (c * h * w + c) * s.batch_size
        mem = self._memory_latency(traffic, traffic,
                                   req_size=s.mem_concurrent, req_interval=0)
        return self._report(compute, mem, dict(op="gap", c=c, h=h, w=w))

    def spatial_broadcast_mult(self, c: int, h: int, w: int) -> SimulationReport:
        """x * per-channel scalar (SE excitation apply,
        `static_predictor.py:397-465`)."""
        return self._elementwise(c * h * w, n_inputs=2)

    def se(self, c: int, h: int, w: int, reduction: int = 4) -> SimulationReport:
        """Squeeze-and-excitation: GAP + 2 FCs + broadcast multiply
        (`static_predictor.py:528-554`)."""
        mid = max(c // reduction, 1)
        rep = self.global_avg_pool(c, h, w)
        rep = rep + self.fc(c, mid) + self.fc(mid, c)
        rep = rep + self.spatial_broadcast_mult(c, h, w)
        return rep
