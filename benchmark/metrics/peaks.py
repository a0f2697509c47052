"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full power limit of 700 W)."""

BF16_FLOPS = 989e12  # and fp16, on the tensor cores
FP32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES = 3.35e12  # bytes per second of HBM3


def bound_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the peak bandwidth."""
    return max(flops / peak, nbytes / HBM_BYTES)
