"""Training: steps of seeded images and labels from a pool on the card,
handed to the port's training step in a closed loop with a fixed number of
steps in flight.

The traffic file gives ``batch`` (images a step), ``pool`` (distinct
batches, cycled), ``in_flight`` (steps handed over before the host waits
for the oldest), ``image`` (`images.py`), ``checked_steps`` (the first
steps, which the reference follows), ``warmup_steps`` (more steps in
set-up) and ``trace_steps``.

Set-up builds one training step with its model and optimizer state
(`programs/<config>.py::build_train`), drives it from the seed through its
first ``checked_steps`` steps, on distinct batches, through the same call
and feed as the window, and hands that object to the window. Over those
steps it keeps what the reference is compared on: each step's loss, the
first gradient as SGD takes it (its momentum buffer after one step), the
parameters before and after, the Gumbel noise drawn and the gates'
decisions. ``train_img_per_s``: the images of every step complete on the
card inside the window of ``--seconds``, over the window's length.
"""

from __future__ import annotations

import gc
import time

import torch

from h100_bench import compare, images
from h100_bench.loop import closed_loop
from h100_bench.trace import Trace, profiled


class Noise:
    """Gumbel(0, 1) noise for the gates, drawn on the card from the run's
    seed; while ``record`` is a list, every draw is kept in it, so that the
    reference is handed the same noise."""

    def __init__(self, device, seed):
        self.generator = torch.Generator(device).manual_seed(seed)
        self.record = None

    def gumbel(self, shape, dtype=torch.float32, device=None):
        u = torch.rand(tuple(shape), generator=self.generator,
                       device=self.generator.device)
        tiny = torch.finfo(torch.float32).tiny
        g = -torch.log((-torch.log(u.clamp_min(tiny))).clamp_min(tiny))
        if self.record is not None:
            self.record.append(g)
        return g.to(dtype=dtype, device=device or g.device)


def make_data(run):
    """The pool: ``pool`` batches of images and of labels."""
    t, cfg = run.traffic, run.config
    g = torch.Generator(run.device).manual_seed(run.sub_seed(1))
    xs = [images.make(t.get("image", {}), cfg["image_size"], t["batch"], g,
                      run.device) for _ in range(t["pool"])]
    ys = [torch.randint(0, cfg["num_labels"], (t["batch"],), generator=g,
                        device=run.device) for _ in range(t["pool"])]
    return xs, ys


def _params(model):
    return {k: p.detach().float().clone()
            for k, p in model.named_parameters()}


def checked_steps(run, step, state, xs, ys, noise):
    """The first ``checked_steps`` steps, and what they are compared on."""
    k = run.traffic["checked_steps"]
    if k > len(xs):
        raise ValueError("the checked steps need distinct batches")
    before = _params(state.model)
    names = {id(p): n for n, p in state.model.named_parameters()}
    losses, draws, masks, first = [], [], [], None
    for i in range(k):
        noise.record = []
        with run.program.gate_decisions(state.model) as taken:
            metrics = step(state, xs[i], ys[i])
        losses.append(metrics["loss"])
        draws.append(noise.record)
        masks.append(list(taken))
        if i == 0:
            first = {names[id(p)]: s["momentum_buffer"].detach().clone()
                     for p, s in state.optimizer.state.items()}
    noise.record = None
    return {"losses": [float(v) for v in losses], "first_grad": first,
            "before": before, "after": _params(state.model),
            "noise": draws, "masks": masks}


def drive(run) -> None:
    t = run.traffic
    weights = run.program.make_weights(run)
    teacher = run.program.make_teacher_weights(run)
    xs, ys = make_data(run)
    noise = Noise(run.device, run.sub_seed(4))
    step, state = run.program.build_train(run, weights, teacher, noise)
    served = checked_steps(run, step, state, xs, ys, noise)
    p = len(xs)
    for i in range(t["warmup_steps"]):
        step(state, xs[i % p], ys[i % p])
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    run.report("setup_s", time.perf_counter() - run.t_start)

    call = lambda k: step(state, xs[k % p], ys[k % p])
    rec = closed_loop(run, call, p, seconds=run.seconds)
    run.window = rec
    run.report("train_img_per_s", len(rec["latency"]) * t["batch"]
               / run.seconds)
    if run.trace:
        with profiled(run.device) as events:
            traced = closed_loop(run, call, p, steps=t["trace_steps"])
        run.traced = Trace(events, images=len(traced["latency"])
                           * t["batch"], steps=len(traced["latency"]))
        run.breakdown = run.traced.breakdown()
    if torch.device(run.device).type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated()

    # the program's state goes before the reference runs
    del step, state, call
    gc.collect()
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    k = t["checked_steps"]
    numbers = compare.INFINITE
    if compare.rows_fit(served, list(zip(xs[:k], ys[:k]))):
        ref = run.reference.train_steps(
            weights, teacher, list(zip(xs[:k], ys[:k], served["noise"])),
            run.config, run.config["train"], state=served["masks"])
        run.facts["train_info"] = ref["info"]
        numbers = compare.train_numbers(served, ref)
    compare.check_trained(run, numbers, k)

