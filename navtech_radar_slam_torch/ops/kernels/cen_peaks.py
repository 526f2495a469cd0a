"""Kernel K1: the cen2019 score map as a CUDA kernel (csrc/cen_peaks.cu),
for one scan (``cen2019_scores_cuda``) and for a batch of scans in one
launch (K1 x B, ``cen2019_scores_batched_cuda``).

Replaces the TPU kernel ``navtech_radar_slam_tpu/ops/pallas/cen_peaks.py::
cen2019_scores_pallas`` and its ``jax.vmap`` in the batched odometry step;
the plain PyTorch twins are ``navtech_radar_slam_torch.ops.cen2019.
cen2019_scores`` and ``cen2019_scores_batched``.  The design note (what
bounds it on the card, the resident design's one cooperative launch with a
block per row, and the streamed design that a batch of ``STREAM_MIN_SCANS``
scans or more takes) is at the top of the CUDA source; ``smem_bytes``,
``max_row_bins``, ``design_for`` and ``stream_buffers`` are the host side
of it.

Built at first use by ``ops.kernels.build.KernelLibrary`` (nvcc, sm_90a,
a plain C interface loaded with ctypes); a failed build raises, nothing
falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from navtech_radar_slam_torch.config import FeatureConfig, RadarConfig
from navtech_radar_slam_torch.ops.kernels.build import KernelLibrary

#: kernel launches by ``cen2019_scores_cuda`` in this process (one per call)
launch_count = 0
#: kernel launches by ``cen2019_scores_batched_cuda`` in this process (one
#: per call, whatever the batch)
batched_launch_count = 0

#: threads per block, one block per azimuth row (kThreads in the source)
THREADS = 256
#: shared memory per range bin: the rows ``a`` and ``w``, float32 each
SMEM_PER_BIN = 8
#: taps whose count the source knows at compile time (the 2-bin sigma)
FIXED_TAPS = 13
#: the static reduction scratch of a block, one float per thread
SMEM_STATIC = 4 * THREADS
#: cudaErrorCooperativeLaunchTooLarge: the card cannot hold every row at once
_TOO_LARGE = 720

#: fewest scans that take the streamed design (the crossover; fewer take the
#: resident design, one scan among them).  Measured on an H100 (PERF.md):
#: streamed / resident 1.45 at B = 1, 1.22 at B = 2, 0.99 at B = 5 (within
#: 2 %, either way), 0.93 at B = 8, 0.88-0.89 at B = 32 and 64
STREAM_MIN_SCANS = 8
#: scratch slots of the streamed design (kRingScans): scan s takes slot
#: s % RING_SCANS, which scan s + RING_SCANS refills only once scan s is done
RING_SCANS = 3
#: threads of a streamed block: each keeps two of K1's 256 partial sums
#: (kSThreads)
STREAM_THREADS = 128
#: per row of the streamed design: four row statistics and a flag; per scan
#: three counts (cen2019_stream_words_per_row, _per_scan)
STREAM_WORDS_PER_ROW = 5
STREAM_WORDS_PER_SCAN = 3


def design_for(nscans: int) -> str:
    """The design a launch of ``nscans`` scans takes: "resident" (every row
    of a scan resident, the scans in turn; K1) below ``STREAM_MIN_SCANS``,
    "streamed" (rows in flight from several scans, no scan resident) from
    there."""
    return "streamed" if nscans >= STREAM_MIN_SCANS else "resident"


def stream_buffers(nscans: int, na: int, nbp: int) -> tuple:
    """(scratch floats, stats words) of a streamed launch: sm and |grad| in
    ``RING_SCANS`` slots, the row statistics, flags and counts."""
    return (2 * RING_SCANS * na * nbp,
            nscans * (STREAM_WORDS_PER_ROW * na + STREAM_WORDS_PER_SCAN))


def smem_bytes(nbp: int, ntaps: int = FIXED_TAPS) -> int:
    """Shared memory of one block (dynamic and static) for rows of ``nbp``
    bins smoothed by ``ntaps`` taps: the two rows, ``ntaps // 2`` zeros on
    each side of one of them, and the reduction scratch."""
    return SMEM_PER_BIN * nbp + 4 * (ntaps - 1) + SMEM_STATIC


def stream_smem_bytes(nbp: int, ntaps: int = FIXED_TAPS) -> int:
    """Shared memory of one block of the streamed design: the two rows, the
    band-masked one padded on each side to a multiple of 4 past ``ntaps //
    2`` (and rounded up to 4, plus 8, for its 16-byte loads), and the
    reduction scratch (a float a thread)."""
    pad = (ntaps // 2 + 3) & ~3
    return 4 * (2 * pad + ((nbp + 3) & ~3) + 8 + nbp) + 4 * STREAM_THREADS


def max_row_bins(na: int, ntaps: int, sms: int, smem_per_sm: int, reserved_per_block: int,
                 optin_per_block: int, threads_per_sm: int) -> int:
    """Longest row the one-launch layout takes for ``na`` rows on a card
    with these limits: one block per row and every block resident at once,
    so each SM holds ceil(na / sms) blocks and splits its shared memory among
    them.  Registers are not counted here; the launch's occupancy check has
    the last word."""
    per_sm = -(-na // sms)
    if per_sm * THREADS > threads_per_sm:
        return 0
    per_block = min(smem_per_sm // per_sm - reserved_per_block, optin_per_block)
    return max((per_block - smem_bytes(0, ntaps)) // SMEM_PER_BIN, 0)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.cen2019_scores_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cen2019_device_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.cen2019_device_limits.restype = ctypes.c_int
    for name in ("cen2019_threads", "cen2019_stream_threads", "cen2019_stream_words_per_row",
                 "cen2019_stream_words_per_scan", "cen2019_stream_ring_scans"):
        getattr(lib, name).argtypes, getattr(lib, name).restype = [], ctypes.c_int
    for name in ("cen2019_smem_bytes", "cen2019_stream_smem_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_longlong
    if (lib.cen2019_threads() != THREADS or lib.cen2019_stream_threads() != STREAM_THREADS
            or any(lib.cen2019_smem_bytes(n, k) != smem_bytes(n, k)
                   or lib.cen2019_stream_smem_bytes(n, k) != stream_smem_bytes(n, k)
                   for n in (3456, 3457) for k in (FIXED_TAPS, 7))
            or lib.cen2019_stream_words_per_row() != STREAM_WORDS_PER_ROW
            or lib.cen2019_stream_words_per_scan() != STREAM_WORDS_PER_SCAN
            or lib.cen2019_stream_ring_scans() != RING_SCANS):
        raise RuntimeError("cen_peaks: the source's launch constants differ from the wrapper's")


LIBRARY = KernelLibrary("cen_peaks", _bind)


@functools.lru_cache(maxsize=None)
def _taps(fcfg: FeatureConfig) -> tuple:
    """The smoothing taps of ``fcfg`` as a ctypes array and their count."""
    # the taps live beside the twin; imported here because ops.cen2019
    # imports this module
    from navtech_radar_slam_torch.ops.cen2019 import smoothing_taps

    taps = smoothing_taps(fcfg).tolist()
    return (ctypes.c_float * len(taps))(*taps), len(taps)


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> tuple:
    """``max_row_bins``'s card limits of device ``index`` (the current
    device when called)."""
    out = (ctypes.c_int * 5)()
    err = LIBRARY.load().cen2019_device_limits(out)
    if err != 0:
        raise RuntimeError(f"cen2019_scores_cuda: device query failed, CUDA error {err}")
    return tuple(out)


def _check(power: torch.Tensor, name: str, dims: str) -> None:
    """Refuse what the kernel does not take: a float32 tensor of the
    ``dims`` layout that is contiguous and on the card."""
    if power.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {power.dtype}")
    if power.dim() != len(dims.split(",")) or not power.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dims} tensor, got shape "
                         f"{tuple(power.shape)}")
    if power.dim() == 3 and power.shape[0] == 0:
        raise ValueError(f"{name}: needs at least one scan, got B = 0")
    if power.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got {power.device}")


def _launch(batch: torch.Tensor, fcfg: FeatureConfig, rcfg: RadarConfig, name: str,
            design: Optional[str] = None) -> torch.Tensor:
    """The one cooperative launch for a checked (B, NA, NBp) batch, B >= 1,
    on the current stream of its device (K1 is B = 1), in ``design``
    (``design_for(B)`` when None; the tests and timings force either, and
    both give the same maps).  Counts nothing: the wrappers do."""
    lib = LIBRARY.load()
    dev = batch.device
    nscans, na, nbp = batch.shape
    design = design_for(nscans) if design is None else design
    if design not in ("resident", "streamed"):
        raise ValueError(f"{name}: no design {design!r}")
    same = dev.index == torch.cuda.current_device()
    taps, ntaps = _taps(fcfg)
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        limits = _device_limits(dev.index)
        # the rows K1 takes, whichever design: scan b's map is K1's
        limit = max_row_bins(na, ntaps, *limits)
        if nbp > limit:
            raise ValueError(f"{name}: {na} rows of {nbp} bins; this card "
                             f"holds every row at once only up to {limit} bins")
        out = torch.empty_like(batch)
        if design == "resident":
            stats = torch.empty(2 * na * nscans, dtype=torch.float32, device=dev)
            scratch = None
        else:
            n_scratch, n_stats = stream_buffers(nscans, na, nbp)
            scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
            stats = torch.empty(n_stats, dtype=torch.float32, device=dev)
        err = lib.cen2019_scores_launch(
            batch.data_ptr(), out.data_ptr(), stats.data_ptr(),
            None if scratch is None else scratch.data_ptr(), nscans, int(design == "streamed"),
            na, nbp,
            fcfg.min_range_bins, rcfg.num_range_bins, taps, ntaps, float(fcfg.peak_zq),
            torch.cuda.current_stream().cuda_stream)
    if err == _TOO_LARGE:
        raise RuntimeError(f"{name}: the card cannot hold all {na} row blocks "
                           f"of {nbp} bins at once (cooperative launch too large)")
    if err != 0:
        raise RuntimeError(f"{name}: launch failed, CUDA error {err}")
    return out


def cen2019_scores_cuda(power: torch.Tensor, fcfg: FeatureConfig,
                        rcfg: RadarConfig) -> torch.Tensor:
    """(NA, NBp) float32 CUDA power -> (NA, NBp) score map: s_smooth at run
    peaks, -inf elsewhere (the contract of ``ops.cen2019.cen2019_scores``).

    Launches on the current stream and does not synchronise.  Raises on any
    input the kernel does not take and on any launch error."""
    global launch_count
    _check(power, "cen2019_scores_cuda", "(NA, NBp)")
    out = _launch(power[None], fcfg, rcfg, "cen2019_scores_cuda")[0]
    launch_count += 1
    return out


def cen2019_scores_batched_cuda(power: torch.Tensor, fcfg: FeatureConfig,
                                rcfg: RadarConfig) -> torch.Tensor:
    """K1 x B: (B, NA, NBp) float32 CUDA power, B >= 1 -> (B, NA, NBp) score
    maps, scan b's exactly ``cen2019_scores_cuda`` of scan b (the contract of
    ``ops.cen2019.cen2019_scores_batched``), in one launch, in the design
    ``design_for(B)``.

    Launches on the current stream and does not synchronise.  Raises on any
    input the kernel does not take (rows longer than K1 takes, in either
    design) and on any launch error; there is no plain fallback."""
    global batched_launch_count
    _check(power, "cen2019_scores_batched_cuda", "(B, NA, NBp)")
    out = _launch(power, fcfg, rcfg, "cen2019_scores_batched_cuda")
    batched_launch_count += 1
    return out
