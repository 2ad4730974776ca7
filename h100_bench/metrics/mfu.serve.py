"""``mfu.serve``: the FLOPs the served images' math needs, over the window
and the H100's bf16 peak, in percent. The work file of the configuration
counts them (``forward_flop``): the token counts served for a ViT, the
masked FLOPs of the model's accounting for a gated CNN. The card's power
limit is printed on an earlier line and in ``device``."""

from h100_bench.peaks import PEAK_BF16


def read(run):
    counts, infos = run.window.get("pool_counts"), run.facts.get("info")
    if counts is None or not infos:
        return None
    flop = sum(int(c) * run.work.forward_flop(run.config, info)
               for c, info in zip(counts, infos))
    return 100.0 * flop / (run.seconds * PEAK_BF16) if flop > 0 else None
