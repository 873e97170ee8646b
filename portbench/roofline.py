"""The card's published peaks and a kernel's least time.

NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3, and 67 TFLOP/s in float32
outside the tensor cores (a fused multiply-add counted as two).  A kernel's
least time is the larger of its minimal bytes (each input byte read once,
each output byte written once) over the memory rate and its operations over
the operation rate; its roofline share is that least time over its measured
device time.  The peaks assume the card's full power limit: the result line
gives the limit of the card that ran.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def share_pct(nbytes: float, ops: float, seconds: float) -> float | None:
    """100 x least time / measured time; None without a measured time."""
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(nbytes, ops) / seconds
