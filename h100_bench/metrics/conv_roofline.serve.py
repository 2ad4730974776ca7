"""``conv_roofline.serve``: the least time the convolutions' work needs,
over the device time of the kernels under ``aten::convolution`` in the
traced stretch of serving, in percent. The least time of a convolution is
the larger of its operations over the bf16 peak and its bytes over the HBM
rate, counted by the configuration's work file (``convolutions``) at the
densities these inputs need: the masked work, not the dense work a
dense-masked forward does."""

from h100_bench.peaks import least_seconds

OPS = ("aten::convolution",)


def read(run):
    tr, infos = run.traced, run.facts.get("info")
    if tr is None or not infos or not hasattr(run.work, "convolutions"):
        return None
    device = tr.device_time_under(OPS)
    if device <= 0:
        return None
    least = sum(int(c) * sum(least_seconds(o, b) for o, b in
                             run.work.convolutions(run.config, info))
                for c, info in zip(tr.pool_counts, infos))
    return 100.0 * least / device if least > 0 else None
