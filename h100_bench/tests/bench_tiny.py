"""Tiny configurations that the CPU runs in seconds, and runs of cells at
those sizes, for the benchmark's tests.

    python -m pytest h100_bench/tests -q            # CPU; card tests skip
    python -m pytest h100_bench/tests -q -m cuda    # on a machine with a card
"""

from __future__ import annotations

import json
import time

from h100_bench import run as R

DEIT = "laud_deit_s_token.serve_bs256"
RESNET = "laud_resnet50_spatial_4421.serve_bs512"
TRAIN = "laud_resnet50_spatial_4421.train_bs128"
TINY_TRAFFIC = dict(mode="serve", batch=4, pool=2, in_flight=2,
                    warmup_rounds=1, trace_steps=2)


def tiny_config(config: str) -> dict:
    """The configuration's file with its sizes cut to what the CPU runs in
    a second (widths and depths small; the mechanisms all present)."""
    cfg = R.load_json(R.HERE / "configs" / f"{config}.json")
    if config == "laud_deit_s_token":
        # heads of 64, gathers at blocks 1 and 3; the model's own graph
        # serves on the CPU, which does not snap capacities
        cfg.update(num_hidden_layers=4, hidden_size=128, num_heads=2,
                   intermediate_size=256, image_size=64, num_labels=10,
                   token_capacity=[1.0, 0.7, 0.7, 0.5],
                   snap_capacities=False, gated_layers=[1, 3])
    else:
        cfg.update(image_size=64, depths=[1, 1, 1, 1], num_labels=10)
        cfg["weights"] = dict(cfg["weights"], centre_images=4)
    return cfg


def tiny_run(workload: str, *, seed: int = 2 ** 33 + 7, trace=False,
             seconds=0.3, root=R.HERE, bench=None, dtype=None):
    cell = R.find_cell(bench or R.load_json(root.parent / "BENCHMARK.json"),
                       workload)
    cfg = tiny_config(cell["config"])
    if dtype is not None:
        cfg["dtype" if "dtype" in cfg else "compute_dtype"] = dtype
    return R.make_run(workload, seed=seed, seconds=seconds, trace=trace,
                      device="cpu", root=root, bench=bench, config=cfg,
                      traffic=dict(TINY_TRAFFIC), t_start=time.perf_counter())


def with_train_cell(bench: dict) -> dict:
    """``bench`` with the training cell and its end-to-end metric: the
    entries that ``BENCHMARK.json`` takes once the cell's check is proven
    on the card (PERF.md says why it is not yet)."""
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({
        "name": TRAIN, "config": "laud_resnet50_spatial_4421",
        "traffic": "train_bs128", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({
        "name": "train_img_per_s", "unit": "img/s", "better": "higher",
        "bound": 0.12, "source": "host_clock", "workloads": [TRAIN]})
    return bench
