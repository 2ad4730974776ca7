"""The timed loop of every mode: a closed loop with a fixed number of
calls in flight, each timed on the host's clock from its issue until its
work is complete on the card."""

from __future__ import annotations

import time
from collections import deque

import torch


class Done:
    """A marker of the work issued so far: a CUDA event on a card; on the
    CPU the work is done when the call returns."""

    def __init__(self, device):
        self.event = None
        if torch.device(device).type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


def closed_loop(run, call, pool: int, *, seconds=None, steps=None):
    """Calls ``call(k)`` for k = 0, 1, ... for ``seconds`` or ``steps``
    calls, with the traffic's ``in_flight`` calls handed over before the
    host waits for the oldest. Records, per call complete inside the
    window, its latency and pool index (``k % pool``), and per call issued
    the host's time inside it."""
    depth = run.traffic["in_flight"]
    rec = {"latency": [], "done_pool": [], "issue": []}
    inflight = deque()
    start = time.perf_counter()
    end = start + seconds if seconds is not None else None

    def retire():
        t_issue, done, p = inflight.popleft()
        done.wait()
        t_done = time.perf_counter()
        if end is None or t_done <= end:
            rec["latency"].append(t_done - t_issue)
            rec["done_pool"].append(p)

    k = 0
    while True:
        now = time.perf_counter()
        if (end is not None and now >= end) or (steps is not None
                                                and k >= steps):
            break
        call(k)
        rec["issue"].append(time.perf_counter() - now)
        inflight.append((now, Done(run.device), k % pool))
        k += 1
        if len(inflight) >= depth:
            retire()
    while inflight:
        retire()
    return rec
