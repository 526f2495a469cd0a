"""Kernel K1: the cen2019 score map as a CUDA kernel (csrc/cen_peaks.cu).

Replaces the TPU kernel ``navtech_radar_slam_tpu/ops/pallas/cen_peaks.py::
cen2019_scores_pallas``; its plain PyTorch twin is
``navtech_radar_slam_torch.ops.cen2019.cen2019_scores``.  The design note
(what bounds it on the card, and the four-launch layout) is at the top of the
CUDA source.

Built at first use by ``ops.kernels.build.KernelLibrary`` (nvcc, sm_90a,
a plain C interface loaded with ctypes); a failed build raises, nothing
falls back.
"""

from __future__ import annotations

import ctypes

import torch

from navtech_radar_slam_tpu.config import FeatureConfig, RadarConfig
from navtech_radar_slam_torch.ops.kernels.build import KernelLibrary

#: kernel launches by ``cen2019_scores_cuda`` in this process (one per call)
launch_count = 0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.cen2019_scores_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cen2019_max_row_bins.argtypes = []
    lib.cen2019_max_row_bins.restype = ctypes.c_int


LIBRARY = KernelLibrary("cen_peaks", _bind)


def cen2019_scores_cuda(power: torch.Tensor, fcfg: FeatureConfig,
                        rcfg: RadarConfig) -> torch.Tensor:
    """(NA, NBp) float32 CUDA power -> (NA, NBp) score map: s_smooth at run
    peaks, -inf elsewhere (the contract of ``ops.cen2019.cen2019_scores``).

    Launches on the current stream and does not synchronise.  Raises on any
    input the kernel does not take and on any launch error."""
    global launch_count
    # the taps live beside the twin; imported here because ops.cen2019
    # imports this module
    from navtech_radar_slam_torch.ops.cen2019 import smoothing_taps

    if power.device.type != "cuda":
        raise ValueError(f"cen2019_scores_cuda: needs a CUDA tensor, got {power.device}")
    if power.dtype != torch.float32:
        raise TypeError(f"cen2019_scores_cuda: needs float32, got {power.dtype}")
    if power.dim() != 2 or not power.is_contiguous():
        raise ValueError("cen2019_scores_cuda: needs a contiguous (NA, NBp) tensor, "
                         f"got shape {tuple(power.shape)}")
    lib = LIBRARY.load()
    na, nbp = power.shape
    if nbp > lib.cen2019_max_row_bins():
        raise ValueError(f"cen2019_scores_cuda: rows of {nbp} bins exceed "
                         f"{lib.cen2019_max_row_bins()}")
    taps = smoothing_taps(fcfg).tolist()
    taps_c = (ctypes.c_float * len(taps))(*taps)
    out = torch.empty_like(power)
    scratch = torch.empty((3, na, nbp), dtype=torch.float32, device=power.device)
    stats = torch.empty((4, na), dtype=torch.float32, device=power.device)
    with torch.cuda.device(power.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cen2019_scores_launch(
            power.data_ptr(), out.data_ptr(), scratch.data_ptr(), stats.data_ptr(),
            na, nbp, fcfg.min_range_bins, rcfg.num_range_bins,
            taps_c, len(taps), float(fcfg.peak_zq), stream,
        )
    if err != 0:
        raise RuntimeError(f"cen2019_scores_cuda: launch failed, CUDA error {err}")
    launch_count += 1
    return out
