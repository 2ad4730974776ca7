"""``conv_roofline.train``: the least time a training step's convolutions
need, over the device time of the kernels under ``aten::convolution`` and
``aten::convolution_backward`` in the traced stretch, in percent. Per step:
the dense teacher's forward convolutions, and the student's three times
(the forward, and the backward's input and weight gradients), each at the
larger of its operations over the bf16 peak and its bytes over the HBM
rate, the student's counted by the configuration's work file
(``convolutions``) at the densities its gates took over the checked
steps."""

import torch

from h100_bench.peaks import least_seconds

OPS = ("aten::convolution", "aten::convolution_backward")


def read(run):
    tr, infos = run.traced, run.facts.get("train_info")
    if tr is None or not infos or not tr.steps:
        return None
    device = tr.device_time_under(OPS)
    if device <= 0:
        return None
    dense = {k: torch.ones_like(v) for k, v in infos[0].items()}

    def least(info):
        return sum(least_seconds(o, b) for o, b in
                   run.work.convolutions(run.config, info))

    step = least(dense) + 3 * sum(least(i) for i in infos) / len(infos)
    return 100.0 * step * tr.steps / device
