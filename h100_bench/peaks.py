"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): what every roofline share and every
``mfu`` of the benchmark is held against."""

PEAK_BF16 = 989e12   # FLOP/s, bf16 and fp16 on the tensor cores
PEAK_F32 = 67e12     # FLOP/s, float32 outside the tensor cores
PEAK_HBM = 3.35e12   # bytes/s, HBM3


def least_seconds(ops: float, nbytes: float, peak: float = PEAK_BF16):
    """The least time the card could take for ``ops`` operations and
    ``nbytes`` bytes moved: the larger of the two bounds."""
    return max(ops / peak, nbytes / PEAK_HBM)
