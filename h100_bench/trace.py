"""The traced stretch of a run: `torch.profiler` around a number of the
timed loop's steps, reduced in memory to what the per-layer metrics read.

The stretch begins and ends with the card idle (a synchronise on each
side), inside a ``record_function`` span named `WINDOW`, whose length on
the profiler's clock is ``window_s``. ``busy_s`` is the union of the
device's operation intervals (kernels, copies, sets) inside it, so
operations that overlap count once; the profiler's mirrors of host spans
on the device's timeline (user annotations) are no operations.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

WINDOW = "h100_bench.window"
TOP = 10           # entries of each list of the breakdown
NAME_CHARS = 160   # a kernel's templated name is cut to this length


class Trace:
    """Device intervals and host operations of one profiled stretch."""

    def __init__(self, events, images: int = 0, steps: int = 0):
        cuda = torch.autograd.DeviceType.CUDA
        self.device_ops = []   # (name, start_us, end_us)
        self.host_ops = []     # (name, start_us, end_us, event)
        window = None
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                # a host span's mirror on the device's timeline is no
                # operation of the device
                if not (getattr(e, "is_user_annotation", False)
                        or e.name == WINDOW):
                    self.device_ops.append((e.name, start, end))
            elif e.name == WINDOW:
                window = (start, end)
            else:
                self.host_ops.append((e.name, start, end, e))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        self.start, self.end = window
        self.images, self.steps = images, steps
        self.window_s = (self.end - self.start) * 1e-6
        self.busy = self._union()
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6

    def _union(self):
        spans = sorted((max(a, self.start), min(b, self.end))
                       for _, a, b in self.device_ops)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def device_time_under(self, names) -> float:
        """Seconds of device time of the operations that the host
        operations named ``names`` launched (their ``device_time_total``,
        children included; an operation nested in one of the same name is
        not counted again)."""
        names = set(names)
        total, last_end = 0.0, {}
        for name, start, end, e in sorted(
                (h for h in self.host_ops if h[0] in names),
                key=lambda h: (h[1], -h[2])):
            if start < last_end.get((name, e.thread), -1):
                continue  # inside an outer call of the same name
            last_end[(name, e.thread)] = end
            total += e.device_time_total
        return total * 1e-6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by what the host was doing in them (the outermost and
        innermost host operations that cover the gap's middle)."""
        by_name = defaultdict(float)
        for name, a, b in self.device_ops:
            by_name[name[:NAME_CHARS]] += (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        edges = [self.start] + [x for ab in self.busy for x in ab] + [self.end]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:TOP]
        idle = []
        for length, a, b in gaps:
            mid = 0.5 * (a + b)
            cover = [(e - s, n) for n, s, e, _ in self.host_ops
                     if s <= mid <= e]
            if cover:
                outer, inner = max(cover)[1], min(cover)[1]
                label = outer if outer == inner else f"{outer} > {inner}"
            else:
                label = "no host operation"
            idle.append([label[:NAME_CHARS], length * 1e-6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


@contextlib.contextmanager
def profiled(device):
    """Profiles the block on the host and, on a card, the device; yields a
    list that holds the `Trace`'s events once the block has ended."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    out = []
    with profile(activities=activities) as prof:
        # the profiler's first device operation asks for its buffers: that
        # wait falls before the stretch
        torch.zeros(1, device=device).add_(1)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        with record_function(WINDOW):
            yield out
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    out.extend(prof.events())
