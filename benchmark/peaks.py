"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the denominators of every
roofline.  A run prints the card's power limit beside its numbers."""

HBM_BYTES_PER_S = 3.35e12        # HBM3 bandwidth
FP32_FLOPS = 67e12               # float32 outside the tensor cores


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the chip could take for this work: the larger of
    the bytes over the bandwidth and the operations over the float32
    peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)
