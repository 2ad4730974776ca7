"""Serving: batches of seeded images from a pool on the card, handed to the
port's entry in a closed loop with a fixed number of batches in flight.

The traffic file gives ``batch`` (images a batch), ``pool`` (distinct
batches, cycled), ``in_flight`` (batches handed over before the host waits
for the oldest: with 2, the host issues batch k + 1 while the card runs
batch k), ``image`` (how the images are made, `images.py`),
``warmup_rounds`` (passes over the pool in set-up), ``check_every``
(about one batch in so many is checked) and ``trace_steps`` (batches in the traced stretch of a ``--trace 1`` run).

End-to-end metrics, on the host's clock over the window of ``--seconds``:
``serve_img_per_s``, every image whose logits were complete on the card
inside the window over the window's length, and ``batch_ms_p95``, the 95th
percentile over those batches of the time from handing a batch to the
engine until its logits were complete. The loop records besides the host's
time inside each call (``issue``), and the logits of a sample of the
batches, drawn from the seed (one in ``check_every``), which the output
check compares. ``attempted`` counts every image handed to the entry;
``failed``, the checked images whose answer is wrong.
"""

from __future__ import annotations

import contextlib
import gc
import random
import time

import numpy as np
import torch

from h100_bench import compare, images
from h100_bench.loop import closed_loop
from h100_bench.trace import Trace, profiled


def make_pool(run) -> list:
    t = run.traffic
    g = torch.Generator(run.device).manual_seed(run.sub_seed(1))
    return [images.make(t.get("image", {}), run.config["image_size"],
                        t["batch"], g, run.device) for _ in range(t["pool"])]


def sampler(run, every: int, salt: int):
    """Which calls' outputs the output check keeps: about one in ``every``,
    at places drawn from the seed (gaps uniform on 1 .. 2 every - 1)."""
    rng = random.Random(run.sub_seed(salt))
    nxt = [rng.randrange(every)]

    def keep(k: int) -> bool:
        if k < nxt[0]:
            return False
        nxt[0] = k + rng.randint(1, 2 * every - 1)
        return True

    return keep


def serve_loop(run, serve, pool, *, seconds=None, steps=None, every=None,
               salt=5):
    """The closed loop over the pool. The logits of a sample of the calls
    (one in ``every``, by default the traffic's ``check_every``, at places
    drawn from the seed) are kept, as (pool index, logits, state): where
    the configuration's reference follows the served run's decisions (its
    program has ``decisions``), the state is what the call decided, read
    as it ran; else None. The other calls' outputs are dropped as they
    come, so that the card's memory stays flat through the window."""
    keep = sampler(run, every or run.traffic.get("check_every", 1), salt)
    reading = getattr(run.program, "decisions", None)
    kept = []
    with (reading(serve) if reading else contextlib.nullcontext()) as sink:
        def call(k):
            at = len(sink) if sink is not None else 0
            out = serve(pool[k % len(pool)])
            if keep(k):
                kept.append((k % len(pool), out,
                             None if sink is None else sink[at:]))
            if sink is not None:
                del sink[at:]

        rec = closed_loop(run, call, len(pool), seconds=seconds, steps=steps)
    rec["outputs"] = kept
    return rec


def drive(run) -> None:
    t = run.traffic
    weights = run.program.make_weights(run)
    pool = make_pool(run)
    serve = run.program.build_serve(run, weights)
    serve_loop(run, serve, pool, steps=t["warmup_rounds"] * len(pool),
               salt=7)  # the window's own call path, every pool batch
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    run.report("setup_s", time.perf_counter() - run.t_start)

    rec = serve_loop(run, serve, pool, seconds=run.seconds)
    run.window = rec
    if "serve_img_per_s" in [m["name"] for m in run.metrics_of(
            "end_to_end")]:
        run.report("serve_img_per_s",
                   len(rec["latency"]) * t["batch"] / run.seconds)
        run.report("batch_ms_p95",
                   float(np.percentile(rec["latency"], 95)) * 1e3
                   if rec["latency"] else float("inf"))
    outputs = list(rec["outputs"])
    served = len(rec["issue"]) * t["batch"]
    if run.trace:
        with profiled(run.device) as events:
            traced = serve_loop(run, serve, pool, steps=t["trace_steps"],
                                salt=6)
        run.traced = Trace(events, images=len(traced["latency"])
                           * t["batch"], steps=len(traced["latency"]))
        run.traced.pool_counts = np.bincount(traced["done_pool"],
                                             minlength=len(pool))
        run.breakdown = run.traced.breakdown()
        outputs += traced["outputs"]
        served += len(traced["issue"]) * t["batch"]
    if torch.device(run.device).type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated()
    rec["pool_counts"] = np.bincount(rec["done_pool"], minlength=len(pool))

    # the program's state goes before the reference runs
    del serve, rec["outputs"]
    gc.collect()
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, per_image, checked, infos = compare.judge_served(
        run, weights, pool, outputs)
    run.facts["info"] = infos
    compare.check_served(run, numbers, per_image)
    run.facts["checked"] = (checked, served)
    run.attempted = served
