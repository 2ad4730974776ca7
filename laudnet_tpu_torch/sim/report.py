"""Latency simulation record (reference `DyNetSimulator/report.py:5-44`); a
copy of `laudnet_tpu/sim/report.py`, which the port does not import."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SimulationReport:
    """Accumulating latency record.

    ``latency`` is the total predicted seconds; compute/memory components are
    tracked separately so roofline balance is inspectable. ``cfg`` holds the
    winning tile configuration per op (kept as a list when reports add).
    """

    latency: float = 0.0
    compute_latency: float = 0.0
    memory_latency: float = 0.0
    cfg: list = field(default_factory=list)

    def __add__(self, other: "SimulationReport") -> "SimulationReport":
        return SimulationReport(
            latency=self.latency + other.latency,
            compute_latency=self.compute_latency + other.compute_latency,
            memory_latency=self.memory_latency + other.memory_latency,
            cfg=self.cfg + other.cfg,
        )

    def __radd__(self, other):
        # Allow sum() starting from 0.
        if other == 0:
            return self
        return self.__add__(other)

    def scaled(self, factor: float) -> "SimulationReport":
        return SimulationReport(
            latency=self.latency * factor,
            compute_latency=self.compute_latency * factor,
            memory_latency=self.memory_latency * factor,
            cfg=list(self.cfg),
        )

    def print_cfg(self, out=None) -> str:
        """Dump the winning per-op configurations as ``#define`` lines —
        the reference emits tile configs for its external CUDA kernels this
        way (`DyNetSimulator/report.py:60-64`); here the consumer is the
        Pallas kernel / capacity planner (patch size, static capacity,
        tile choices). Returns the dump; optionally writes it to ``out``.
        """
        lines = []
        for i, cfg in enumerate(self.cfg):
            if not cfg:
                continue
            op = cfg.get("op", f"op{i}")
            for k, v in cfg.items():
                if k == "op":
                    continue
                if isinstance(v, float):
                    v = f"{v:g}"
                lines.append(f"#define {op.upper()}_{i}_{k.upper()} {v}")
        dump = "\n".join(lines)
        if out is not None:
            out.write(dump + "\n")
        return dump
