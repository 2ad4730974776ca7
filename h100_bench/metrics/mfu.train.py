"""``mfu.train``: the FLOPs a training step's math needs, over the window
and the H100's bf16 peak, in percent: the dense teacher's forward and
three times the student's (forward, and the backward's two products a
convolution), by the configuration's work file (``forward_flop``), the
student at the densities its gates took over the checked steps. The
card's power limit is printed on an earlier line and in ``device``."""

import torch

from h100_bench.peaks import PEAK_BF16


def step_flop(run):
    infos = run.facts.get("train_info")
    if not infos:
        return None
    b = infos[0]["s3"].shape[0]
    dense = {k: torch.ones_like(v) for k, v in infos[0].items()}
    student = sum(run.work.forward_flop(run.config, i) for i in infos)
    return (run.work.forward_flop(run.config, dense)
            + 3 * student / len(infos)), b


def read(run):
    got = step_flop(run)
    steps = run.window.get("latency")
    if got is None or not steps:
        return None
    return 100.0 * got[0] * len(steps) / (run.seconds * PEAK_BF16)
