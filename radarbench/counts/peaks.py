"""NVIDIA H100 SXM data-sheet peaks at 700 W (as ``chip_smoke.py`` holds
them): HBM3 bytes/s and float32 FLOP/s outside the tensor cores."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time of a call: its bytes over the memory rate or its
    float32 operations over the float32 peak, the larger."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S)
