"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W limit) and the bound of one launch's work."""

PEAK_FP32 = 67e12      # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # bytes/s of HBM3


def launch_s(flops: float, nbytes: float) -> float:
    """The least time a launch of this work could take: the larger of its
    operations over the FP32 peak and its bytes over the HBM rate."""
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)
