"""Kernel K1: the cen2019 score map as a CUDA kernel (csrc/cen_peaks.cu),
for one scan (``cen2019_scores_cuda``) and for a batch of scans in one
launch (K1 x B, ``cen2019_scores_batched_cuda``).

Replaces the TPU kernel ``navtech_radar_slam_tpu/ops/pallas/cen_peaks.py::
cen2019_scores_pallas`` and its ``jax.vmap`` in the batched odometry step;
the plain PyTorch twins are ``navtech_radar_slam_torch.ops.cen2019.
cen2019_scores`` and ``cen2019_scores_batched``.  The design note (what
bounds it on the card, the one cooperative launch with a block per row,
and the loop over the scans of a batch) is at the top of the CUDA source;
``smem_bytes`` and ``max_row_bins`` are the host side of it.

Built at first use by ``ops.kernels.build.KernelLibrary`` (nvcc, sm_90a,
a plain C interface loaded with ctypes); a failed build raises, nothing
falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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


def smem_bytes(nbp: int, ntaps: int = FIXED_TAPS) -> int:
    """Shared memory of one block (dynamic and static) for rows of ``nbp``
    bins smoothed by ``ntaps`` taps: the two rows, ``ntaps // 2`` zeros on
    each side of one of them, and the reduction scratch."""
    return SMEM_PER_BIN * nbp + 4 * (ntaps - 1) + SMEM_STATIC


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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cen2019_device_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.cen2019_device_limits.restype = ctypes.c_int
    lib.cen2019_threads.argtypes, lib.cen2019_threads.restype = [], ctypes.c_int
    lib.cen2019_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cen2019_smem_bytes.restype = ctypes.c_longlong
    if (lib.cen2019_threads() != THREADS
            or lib.cen2019_smem_bytes(3456, FIXED_TAPS) != smem_bytes(3456, FIXED_TAPS)
            or lib.cen2019_smem_bytes(3456, 7) != smem_bytes(3456, 7)):
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


def _launch(batch: torch.Tensor, fcfg: FeatureConfig, rcfg: RadarConfig,
            name: str) -> torch.Tensor:
    """The one cooperative launch for a checked (B, NA, NBp) batch, B >= 1,
    on the current stream of its device (K1 is B = 1)."""
    lib = LIBRARY.load()
    dev = batch.device
    nscans, na, nbp = batch.shape
    same = dev.index == torch.cuda.current_device()
    taps, ntaps = _taps(fcfg)
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        limit = max_row_bins(na, ntaps, *_device_limits(dev.index))
        if nbp > limit:
            raise ValueError(f"{name}: {na} rows of {nbp} bins; this card "
                             f"holds every row at once only up to {limit} bins")
        out = torch.empty_like(batch)
        stats = torch.empty(2 * na * nscans, dtype=torch.float32, device=dev)
        err = lib.cen2019_scores_launch(
            batch.data_ptr(), out.data_ptr(), stats.data_ptr(), nscans, na, nbp,
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
    ``ops.cen2019.cen2019_scores_batched``), in one launch.

    Launches on the current stream and does not synchronise.  Raises on any
    input the kernel does not take (the rows of one scan must all be
    resident, as for one scan) and on any launch error; there is no plain
    fallback."""
    global batched_launch_count
    _check(power, "cen2019_scores_batched_cuda", "(B, NA, NBp)")
    out = _launch(power, fcfg, rcfg, "cen2019_scores_batched_cuda")
    batched_launch_count += 1
    return out
