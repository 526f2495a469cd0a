"""K1 x B, the batched cen2019 score map (``csrc/cen_peaks.cu``,
``cen2019_scores_batched_cuda``): ``chip_smoke.py``'s count, frozen.  Each
scan's (NA, NBp) float32 power is read once and its float32 score map
written once (8 bytes a bin); each bin takes 2 x taps + 17 float32
operations (the range smoothing, the gradient and its azimuth smoothing,
the statistics and the gates)."""

from radarbench.counts.peaks import bound_s

#: the range-smoothing taps of the 2-bin sigma
TAPS = 13
#: names of the kernels of one K1 x B launch (streamed, resident design)
KERNELS = ("cen2019_stream_kernel", "cen2019_kernel")


def bytes_moved(scans: int, na: int, nbp: int) -> float:
    return 8.0 * scans * na * nbp


def operations(scans: int, na: int, nbp: int) -> float:
    return float(scans) * na * nbp * (2 * TAPS + 17)


def bound(scans: int, na: int, nbp: int) -> float:
    """Seconds: the least time of one launch over ``scans`` scans."""
    return bound_s(bytes_moved(scans, na, nbp), operations(scans, na, nbp))
