"""``vit_blocks_roofline``: the least time the transformer blocks' work
needs, over the device time of the kernels that the port's block ops
(``laudnet::vit_block``, ``laudnet::vit_segment``) launched in the traced
stretch, in percent. The least time of a layer is the larger of its
operations over the bf16 peak and its bytes over the HBM rate, counted by
the configuration's work file (``block_layers``) at the token counts
served, whatever implements them."""

from h100_bench.peaks import least_seconds

OPS = ("laudnet::vit_block", "laudnet::vit_segment")


def read(run):
    tr, infos = run.traced, run.facts.get("info")
    if tr is None or not infos or not hasattr(run.work, "block_layers"):
        return None
    device = tr.device_time_under(OPS)
    if device <= 0:
        return None
    least = sum(int(c) * sum(least_seconds(o, b) for o, b in
                             run.work.block_layers(run.config, info))
                for c, info in zip(tr.pool_counts, infos))
    return 100.0 * least / device if least > 0 else None
