"""Runs one cell of the benchmark once and prints its result line.

    python -m h100_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout: a configuration and a traffic mix. Everything else is found
by those names under this directory, so a new cell, configuration, mix or
per-layer metric is a new file and never an edit:

- ``configs/<config>.json``: the model's sizes, the weight recipe and the
  limits of the output check;
- ``traffic/<mix>.json``: the mix's parameters, and its ``mode``, which
  names the timed loop ``drivers/<mode>.py``;
- ``programs/<config>.py``: the weights made from the seed, and the port's
  entry built on them;
- ``reference/<config>.py``: the plain PyTorch forward the outputs are
  judged against;
- ``work/<config>.py``: the operations and bytes of the configuration's
  work;
- ``metrics/<metric>.py``: one reader per per-layer metric.

The run makes the weights and inputs on the card from ``--seed``, warms up
the cell's shapes (set-up, ``setup_s``), measures for ``--seconds``, and,
with ``--trace 1``, traces a further stretch of the same loop under
``torch.profiler`` for the per-layer metrics. Then it frees the program,
runs the reference over the window's inputs and compares. The last line of
standard output is one JSON object; the numbers compared, each with its
limit, are the last lines of standard error and the last key of that
object. Without a CUDA card, or with fewer cards than the cell asks for,
it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from the process's start

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
# the JAX package and its libraries: none may be loaded in the process that
# prints a result (compared by whole top-level module names, since the
# port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "laudnet_tpu")


def forbidden_modules(modules=None) -> list:
    """The top-level names in ``modules`` (default ``sys.modules``) that are
    the JAX package or one of its libraries."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names.intersection(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = HERE):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Run:
    """One run of one cell: what the driver, the program, the reference and
    the metric readers share. ``config`` and ``traffic`` are the parsed
    files; a test may hand in smaller ones."""

    def __init__(self, bench: dict, cell: dict, config: dict, traffic: dict,
                 *, seed: int, seconds: float, trace: bool, device,
                 root: Path = HERE, t_start: float = T_START):
        self.bench, self.cell = bench, cell
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.root, self.t_start = device, root, t_start
        self.program = load_module("programs", cell["config"], root)
        self.reference = load_module("reference", cell["config"], root)
        self.work = load_module("work", cell["config"], root)
        self.metrics = {}      # name -> {"value", "unit"}
        self.checks = {}       # name -> {"value", "limit"}
        self.attempted = self.failed = 0
        self.memory_peak = 0
        self.window = {}       # what the timed loop recorded
        self.traced = None     # trace.Trace of the traced stretch
        self.breakdown = None
        self.facts = {}        # what the reference worked out (work inputs)

    def sub_seed(self, salt: int) -> int:
        """A seed for one of the run's draws, a function of --seed alone."""
        return (self.seed * 1_000_003 + salt) % (2 ** 63)

    def report(self, name: str, value: float) -> None:
        """Records an end-to-end or per-layer metric of this cell."""
        spec = next(m for m in self.bench["end_to_end"] + self.bench[
            "per_layer"] if m["name"] == name)
        self.metrics[name] = {"value": float(value), "unit": spec["unit"]}

    def check(self, name: str, value: float, limit: float) -> None:
        """Records a number the output check compares, with its limit (the
        number passes at or under its limit)."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())

    def metrics_of(self, kind: str) -> list:
        """The cell's metrics of ``end_to_end`` or ``per_layer``."""
        name = self.cell["name"]
        return [m for m in self.bench[kind]
                if name in m.get("workloads", [name])]

    def read_per_layer(self) -> None:
        """Each per-layer metric of the cell, from its reader; a reader
        that finds nothing to read returns None and the metric is left
        out."""
        for spec in self.metrics_of("per_layer"):
            reader = load_module("metrics", spec["name"], self.root)
            value = reader.read(self)
            if value is not None:
                self.report(spec["name"], value)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in {BENCHMARK}")


def make_run(workload: str, *, seed: int, seconds: float, trace: bool,
             device, root: Path = HERE, bench: dict | None = None,
             config: dict | None = None, traffic: dict | None = None,
             t_start: float = T_START) -> Run:
    bench = bench or load_json(root.parent / "BENCHMARK.json")
    cell = find_cell(bench, workload)
    config = config or load_json(root / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(root / "traffic"
                                   / f"{cell['traffic']}.json")
    return Run(bench, cell, config, traffic, seed=seed, seconds=seconds,
               trace=trace, device=device, root=root, t_start=t_start)


def execute(run: Run) -> dict:
    """Drives the run through its mode's timed loop, the output check and
    the metric readers; returns the result object."""
    driver = load_module("drivers", run.traffic["mode"], run.root)
    driver.drive(run)
    if run.trace:  # a traced run reports the per-layer metrics alone
        run.metrics = {}
        run.read_per_layer()
    result = {
        "correct": run.correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": run.metrics,
        "device": device_facts(run),
    }
    if run.breakdown is not None:
        result["breakdown"] = run.breakdown
    result["checks"] = run.checks
    return result


def device_facts(run: Run) -> dict:
    """The result's ``device``: the card, the count of cards the cell uses
    and the process's peak of device memory; with a trace, the traced
    stretch's busy seconds and length."""
    import torch

    dev = torch.device(run.device)
    facts = {"platform": "gpu" if dev.type == "cuda" else dev.type,
             "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
             "count": int(run.cell["chips"]),
             "memory_peak_bytes": int(run.memory_peak)}
    if run.traced is not None:
        facts["busy_s"] = run.traced.busy_s
        facts["window_s"] = run.traced.window_s
    if run.facts.get("power_limit"):
        facts["power_limit"] = run.facts["power_limit"]
    return facts


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them (a
    card set under 700 W runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def print_result(result: dict, facts: dict) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    if "checked" in facts:
        print(f"h100_bench: {facts['checked'][0]} of {facts['checked'][1]} "
              f"images served were checked (a sample drawn from the seed)",
              file=sys.stderr)
    if "decision_sets" in facts:
        print(f"h100_bench: {facts['decision_sets']} distinct sets of gate "
              f"decisions judged (one a pool batch where the entry decides "
              f"alike on every call)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    bench = load_json(BENCHMARK)
    cell = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        print(f"h100_bench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" (torch.cuda.is_available() = "
              f"{torch.cuda.is_available()})", file=sys.stderr)
        return 2
    limit = power_limit()
    print(f"h100_bench: card and power limit: {limit}", file=sys.stderr,
          flush=True)
    run = make_run(args.workload, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", bench=bench)
    run.facts["power_limit"] = limit
    result = execute(run)
    found = forbidden_modules()
    if found:
        print(f"h100_bench: the process loaded {found}, which the port must "
              f"never load; no result", file=sys.stderr)
        return 3
    print_result(result, run.facts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
