"""Dynamic-operator latency models: gather/scatter, patch-sparse conv,
fused masker+conv1, dynamic SE, channel-masker predictor.

Capability-equivalent rebuild of the reference's GPU dynamic predictor
(`DyNetSimulator/hardware_models/{multi_cores,dynamic_conv}.py`): dynamic
convolutions execute as patch batches (``n_patches_parallel`` patches per
wave), latency is bounded by the straggler channel tile under random masks,
gather/scatter are pure memory ops with coalescing losses, and the
masker+conv1 stage picks min(fused widened conv, separate masker + dynamic
conv). Expected patch count is ``ceil(density * total_patches)`` — a
deliberate deviation from the reference's density-independent
``mean_n_patches = (1+..+N)/N`` (`multi_cores.py:392`): the rebuild's
predictions are driven by the caller's activation rate, which is what the
paradigm-selection loop actually knows.

A copy of `laudnet_tpu/sim/dynamic.py`, which the port does not import.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from laudnet_tpu_torch.sim.report import SimulationReport
from laudnet_tpu_torch.sim.roofline import Predictor
from laudnet_tpu_torch.sim.tiles import (
    ceil_eff,
    coalesce_eff,
    expected_max_tile_density,
    tile_candidates,
)


class DynamicPredictor(Predictor):
    """GPU predictor extended with dynamic (mask-dependent) operators."""

    # --- pure-memory patch movement ------------------------------------

    def gather(self, c, h, w, granul_size, density, pad=0) -> SimulationReport:
        """Copy active patches (with halo ``pad``) into a compact buffer."""
        s = self.spec
        n_patches = math.ceil(
            density * math.ceil(h / granul_size) * math.ceil(w / granul_size)
        )
        size = granul_size + 2 * pad
        moved = c * n_patches * size * size
        eff = coalesce_eff(size, max(0, w - size), s.mem_concurrent)
        mem = ((c * h * w + moved) / s.mem_fp32_bandwidth
               + moved / s.cache_fp32_bandwidth / eff
               + moved / s.cache_fp32_bandwidth)
        mem *= max(s.batch_size, 1)
        return SimulationReport(latency=mem + s.launch_time,
                                compute_latency=0.0, memory_latency=mem,
                                cfg=[dict(op="gather", n_patches=n_patches)])

    def scatter(self, c, h, w, granul_size, density) -> SimulationReport:
        """Write compact patches back to the spatial layout."""
        rep = self.gather(c, h, w, granul_size, density, pad=0)
        rep.cfg = [dict(rep.cfg[0], op="scatter")]
        return rep

    def scatter_add(self, c, h, w, granul_size, density) -> SimulationReport:
        """Scatter + residual add: same traffic plus the full-map read and
        one add per active element."""
        s = self.spec
        base = self.scatter(c, h, w, granul_size, density)
        n_patches = base.cfg[0]["n_patches"]
        active = c * n_patches * granul_size * granul_size
        extra_mem = c * h * w * s.batch_size / s.mem_fp32_bandwidth
        eff = ceil_eff(active * s.batch_size, s.peak_parallelism * s.n_cores)
        compute = (active * s.batch_size / (s.lanes * s.n_cores) / eff
                   / s.frequency)
        return SimulationReport(
            latency=base.latency + extra_mem + compute,
            compute_latency=compute,
            memory_latency=base.memory_latency + extra_mem,
            cfg=[dict(op="scatter_add", n_patches=n_patches)],
        )

    # --- patch-sparse convolution ---------------------------------------

    def dynamic_conv(self, cin, cout, outh, outw, ks, granul_size,
                     density=1.0, groups=1, stride=1, input_gathered=True,
                     ic_density=1.0, oc_density=1.0,
                     c_group=1) -> SimulationReport:
        """Convolution over gathered active patches.

        Tiles (c, h, w within a patch) x ``n_patches_parallel`` per wave;
        expected #patches = ``ceil(density * total)`` (see module docstring
        for the deliberate deviation from the reference's mean); memory
        includes the gathered-vs-strided input tradeoff."""
        s = self.spec
        n_h = math.ceil(outh / granul_size)
        n_w = math.ceil(outw / granul_size)
        total_patches = n_h * n_w
        n_patches = max(1, math.ceil(density * total_patches))
        best: Optional[tuple] = None

        for npp in tile_candidates(256):
            for c_t in tile_candidates(cout):
                n_c = math.ceil(cout / c_t)
                for h_t in tile_candidates(granul_size):
                    n_ht = math.ceil(granul_size / h_t)
                    for w_t in tile_candidates(granul_size):
                        n_wt = math.ceil(granul_size / w_t)
                        n_tiles = n_c * n_ht * n_wt

                        # memory
                        wpc = c_t * (cin // groups) * ks * ks
                        # a channel tile spanning several conv groups reads
                        # each group's input slice (reference
                        # `dynamic_conv.py` pe_input n_groups factor)
                        gpc = math.ceil(c_t / max(cout // groups, 1))
                        ipc = (gpc * (cin // groups)
                               * (h_t + ks - 1) * stride
                               * (w_t + ks - 1) * stride * n_patches)
                        opc = c_t * h_t * w_t * n_patches
                        if s.batch_size == 1:
                            wpc *= ic_density * oc_density
                        per_core = (wpc + ipc * ic_density * s.batch_size
                                    + opc * oc_density * s.batch_size) * n_tiles
                        w_all = cout * (cin // groups) * ks * ks
                        if input_gathered:
                            in_all = (n_patches * cin
                                      * (granul_size + ks - 1) * stride
                                      * (granul_size + ks - 1) * stride)
                        else:
                            in_all = cin * outh * stride * outw * stride
                        out_all = n_patches * cout * granul_size * granul_size
                        fused = (w_all + in_all * ic_density * s.batch_size
                                 + out_all * oc_density * s.batch_size)
                        mem = (fused / s.mem_fp32_bandwidth
                               + per_core / s.cache_fp32_bandwidth)

                        # compute: patch waves with straggler density
                        flops_wave = (c_t * h_t * w_t * (cin // groups)
                                      * ks * ks * npp)
                        pe_eff = ceil_eff(
                            c_t * h_t * w_t * npp * s.batch_size,
                            s.peak_parallelism,
                        )
                        wave_lat = flops_wave / s.frequency / s.lanes / pe_eff
                        waves = math.ceil(n_patches / npp)
                        max_oc = expected_max_tile_density(
                            n_c, c_t, ic_density * oc_density, c_group
                        )
                        compute = (wave_lat * waves * ic_density * max_oc
                                   * max(s.batch_size, 1)
                                   * math.ceil(n_tiles / s.n_cores))

                        lat = self._combine(compute, mem)
                        if best is None or lat < best[0]:
                            best = (lat, compute, mem,
                                    dict(op="dynamic_conv", c_tile=c_t,
                                         h_tile=h_t, w_tile=w_t,
                                         n_patches_parallel=npp,
                                         n_patches=n_patches, ks=ks))
        _, compute, mem, cfg = best
        return self._report(compute, mem, cfg)

    # --- fused masker + conv1 -------------------------------------------

    def masker_conv1(self, cin, cout, h, w, granul_size, density,
                     channel_masker=True, channel_masker_hid=32,
                     spatial_masker=False, c_group=1) -> SimulationReport:
        """First 1x1 conv of a dynamic block + its gating head.

        Evaluates both realizations and returns the cheaper (reference
        `multi_cores.py:67-179`): (a) a fused conv with widened output
        (masker logits ride along as extra channels) followed by the tiny
        pool/FC tail; (b) separate masker then density-scaled dynamic conv.
        """
        c_n_groups = max(cin // c_group, 1) if c_group > 1 else cin

        # (a) fused
        extra = (channel_masker_hid if channel_masker else 0) + (
            1 if spatial_masker else 0
        )
        fused = self.conv(cin, cout + extra, h, w, 1)
        if channel_masker:
            fused = fused + self.global_avg_pool(channel_masker_hid, h, w)
            fused = fused + self.fc(channel_masker_hid, c_n_groups)

        # (b) separate masker + sparse conv1
        sep = SimulationReport()
        if channel_masker:
            sep = sep + self.global_avg_pool(cin, h, w)
            sep = sep + self.fc(cin, channel_masker_hid)
            sep = sep + self.fc(channel_masker_hid, c_n_groups)
        if spatial_masker:
            sep = sep + self.conv(cin, 1, h, w, 1)
        sep = sep + self.dynamic_conv(
            cin, cout, h, w, 1, granul_size, density,
            input_gathered=False,
        )
        return fused if fused.latency <= sep.latency else sep

    # --- dynamic tails ----------------------------------------------------

    def dynamic_se(self, c, h, w, granul_size, density,
                   reduction=4) -> SimulationReport:
        """SE over gathered patches: pooled squeeze reads only active
        patches; FCs are dense; excitation applies to active elements."""
        n_patches = math.ceil(
            density * math.ceil(h / granul_size) * math.ceil(w / granul_size)
        )
        active_hw = n_patches * granul_size * granul_size
        mid = max(c // reduction, 1)
        rep = self.global_avg_pool(c, granul_size * n_patches, granul_size)
        rep = rep + self.fc(c, mid) + self.fc(mid, c)
        rep = rep + self._elementwise(c * active_hw, n_inputs=2)
        return rep

    def channel_masker_predictor(self, cin, hid, n_groups, h,
                                 w) -> SimulationReport:
        """Standalone channel gating head: GAP + fc1 + fc2. At eval the
        2-logit comparison folds into one logit (XW1 >= XW2 <=>
        X(W1-W2) >= 0), halving fc2 (`multi_cores.py:701-744`)."""
        rep = self.global_avg_pool(cin, h, w)
        rep = rep + self.fc(cin, hid)
        rep = rep + self.fc(hid, n_groups)
        return rep

    def dynamic_elementwise(self, c, h, w, granul_size,
                            density) -> SimulationReport:
        n_patches = math.ceil(
            density * math.ceil(h / granul_size) * math.ceil(w / granul_size)
        )
        return self._elementwise(
            c * n_patches * granul_size * granul_size, n_inputs=2
        )
