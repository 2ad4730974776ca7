"""Transformer operator latency models (ViT support for the predictor).

Capability-equivalent rebuild of the reference
(`DyNetSimulator/hardware_models/predictor_transformer.py`): matmul reshaped
onto the conv tile search, linear, softmax/layernorm composed from reductions
and elementwise passes (fused into one kernel launch), GELU, unfold, and the
density-scaled ``dylinear`` used by head/channel skipping.

A copy of `laudnet_tpu/sim/transformer.py`, which the port does not import.
"""

from __future__ import annotations

import math

import numpy as np

from laudnet_tpu_torch.sim.dynamic import DynamicPredictor
from laudnet_tpu_torch.sim.report import SimulationReport


class TransformerPredictor(DynamicPredictor):
    """GPU predictor extended with transformer ops."""

    def unfold(self, in_shape, out_shape) -> SimulationReport:
        """Patch extraction (im2col): pure memory movement."""
        s = self.spec
        all_in = float(np.prod(in_shape))
        all_out = float(np.prod(out_shape))
        mem = ((all_in + all_out) / s.mem_fp32_bandwidth
               + 2 * all_out / s.cache_fp32_bandwidth)
        return SimulationReport(latency=mem + s.launch_time,
                                memory_latency=mem, compute_latency=0.0,
                                cfg=[dict(op="unfold")])

    def matmul(self, a_shape, b_shape, out_shape) -> SimulationReport:
        """Batched matmul mapped onto the conv tile search: contraction dim
        is the input channels, the flattened leading dims the spatial grid."""
        assert a_shape[-1] == b_shape[-2], (a_shape, b_shape)
        cin, cout = b_shape[-2], b_shape[-1]
        rows = float(np.prod(out_shape[:-1]))
        h = max(1, round(math.sqrt(rows)))
        w = max(1, round(rows / h))
        return self.conv(cin, cout, h, w, 1)

    def linear(self, x_shape, w_shape, out_shape) -> SimulationReport:
        """torch Linear: weight (out, in) used transposed."""
        b_shape = list(w_shape[:-2]) + [w_shape[-1], w_shape[-2]]
        return self.matmul(x_shape, b_shape, out_shape)

    def dylinear(self, x_shape, w_shape, out_shape, ic_density=1.0,
                 oc_density=1.0) -> SimulationReport:
        """Density-scaled linear for head/channel skipping: gathered weight
        rows/cols shrink the matmul (`predictor_transformer.py:97-106`)."""
        a = list(x_shape)
        b = list(w_shape[:-2]) + [w_shape[-1], w_shape[-2]]
        o = list(out_shape)
        if ic_density < 1:
            a[-1] = round(a[-1] * ic_density)
            b[-2] = round(b[-2] * ic_density)
        if oc_density < 1:
            b[-1] = round(b[-1] * oc_density)
            o[-1] = round(o[-1] * oc_density)
        return self.matmul(a, b, o)

    def elementwise(self, shape) -> SimulationReport:
        h = float(np.prod(shape[:-2])) if len(shape) > 2 else 1.0
        return self.add(shape[-1], int(h), shape[-2])

    def reduce(self, shape, reduce_dims=(-1,)) -> SimulationReport:
        n = 1
        for d in reduce_dims:
            n *= shape[d]
        h = math.ceil(n**0.5)
        c = int(np.prod(shape) / n)
        return self.global_avg_pool(c, h, h)

    def softmax(self, shape) -> SimulationReport:
        """max + sub/exp + sum + div, fused into one launch
        (`predictor_transformer.py:70-80`)."""
        rep = (self.reduce(shape) + self.elementwise(shape)
               + self.reduce(shape) + self.elementwise(shape))
        rep.latency -= self.spec.launch_time * 3
        return rep

    def layernorm(self, shape) -> SimulationReport:
        rep = (self.reduce(shape) + self.reduce(shape)
               + self.elementwise(shape) + self.elementwise(shape))
        rep.latency -= self.spec.launch_time * 3
        return rep

    def gelu(self, shape) -> SimulationReport:
        return self.elementwise(shape)
