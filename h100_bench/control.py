"""Readings that the limits of the output check are set from, on the card
at a cell's own sizes: for each seed, the numbers the check compares for
the port's entry (sound runs), for the control (the reference computed in
the precision below the configuration's, put in the program's place), and
for the faults planted in the program's outputs (`faults.py`).

    python -m h100_bench.control --workload <cell> --seeds 12 \
        --first-seed 1000 [--steps 8] [--controls 4]

Each seed makes the cell's weights and pool as a run does, serves
``--steps`` batches through the port's entry in the cell's closed loop, and
compares every batch served. Prints one JSON line a seed and a summary:
the largest reading of the program, the smallest of the control and of
each fault. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from h100_bench import compare, faults
from h100_bench.run import (BENCHMARK, find_cell, forbidden_modules,
                            load_json, load_module, make_run)


def readings(run, steps: int) -> dict:
    """The check's numbers for the program, the control and each fault on
    one seed."""
    serve_mod = load_module("drivers", "serve", run.root)
    weights = run.program.make_weights(run)
    pool = serve_mod.make_pool(run)
    serve = run.program.build_serve(run, weights)
    serve_mod.serve_loop(run, serve, pool, steps=len(pool), salt=7)
    outputs = serve_mod.serve_loop(run, serve, pool, steps=steps,
                                 every=1)["outputs"]
    del serve
    gc.collect()
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    out = {}

    def read(tag, outs):
        out[tag] = compare.judge_served(run, weights, pool, outs)[0]

    read("program", outputs)
    for name, fault in faults.SERVED.items():
        read(name, [(p, fault(o.clone()), s) for p, o, s in outputs])
    # the control: the reference in the precision below, in the program's
    # place, judged as the program is (following its decisions)
    control = []
    for p, x in enumerate(pool):
        logits, info = run.reference.forward(weights, x, run.config,
                                             precision="fp8")
        follows = outputs[0][2] is not None
        control.append((p, logits, info["state"] if follows else None))
    read("control", control)
    return out


def train_readings(run, controls=True) -> dict:
    """The training cell's numbers for the program on one seed (the checked
    steps of a run's set-up), and with ``controls`` for each planted fault
    and the control."""
    train = load_module("drivers", "train", run.root)
    cfg, k = run.config, run.traffic["checked_steps"]
    weights = run.program.make_weights(run)
    teacher = run.program.make_teacher_weights(run)
    xs, ys = train.make_data(run)

    def served_by(wrap=None):
        noise = train.Noise(run.device, run.sub_seed(4))
        step, state = run.program.build_train(run, weights, teacher, noise)
        out = train.checked_steps(run, wrap(step) if wrap else step, state,
                                  xs, ys, noise)
        del step, state
        gc.collect()
        return out

    def judged(served):
        if not compare.rows_fit(served, list(zip(xs[:k], ys[:k]))):
            return dict(compare.INFINITE)
        ref = run.reference.train_steps(
            weights, teacher, list(zip(xs[:k], ys[:k], served["noise"])),
            cfg, cfg["train"], state=served["masks"])
        return compare.train_numbers(served, ref)

    served = served_by()
    out = {"program": judged(served)}
    if not controls:
        return out
    for name, wrap in faults.TRAIN.items():
        out[name] = judged(served_by(wrap))
    noise = served["noise"]
    control = run.reference.train_steps(
        weights, teacher, list(zip(xs[:k], ys[:k], noise)), cfg,
        cfg["train"], precision="fp8")
    before = {n: w.float() for n, w in weights.items()
              if not n.endswith(("running_mean", "running_var"))}
    out["control"] = judged({**control, "before": before, "noise": noise})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=1)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--controls", type=int, default=None,
                   help="read the control and the faults on the first "
                        "so many seeds only (default: every seed)")
    args = p.parse_args(argv)
    bench = load_json(BENCHMARK)
    find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("h100_bench.control: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        run = make_run(args.workload, seed=seed, seconds=0.0, trace=False,
                       device="cuda", bench=bench)
        controls = args.controls is None or i < args.controls
        read = (train_readings(run, controls)
                if run.traffic["mode"] == "train"
                else readings(run, args.steps))
        row = {"seed": seed, **read,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    tags = [t for t in rows[0] if t not in ("seed", "seconds")]
    summary = {}
    for tag in tags:
        pick = max if tag == "program" else min
        summary[tag] = {k: pick(r[tag][k] for r in rows if tag in r)
                        for k in rows[0][tag]}
    print(json.dumps({"summary": summary, "seeds": len(rows),
                      "device": torch.cuda.get_device_name(0),
                      "forbidden_loaded": forbidden_modules()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
