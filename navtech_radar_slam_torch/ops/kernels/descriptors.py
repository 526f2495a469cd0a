"""Kernel K4: the constellation descriptors of a batch of scans as one CUDA
launch (csrc/descriptors.cu), for any B >= 1 (the per-scan path is B = 1).

Replaces no TPU kernel: the JAX package computes the descriptors as a
``jnp`` einsum over a separable hat basis, and the plain PyTorch twin
``navtech_radar_slam_torch.ops.features.constellation_descriptors_plain``
does the same with one batched matmul over two (K, K, P) hat tensors a
scan.  On the
card that form took 71 % of the batched odometry step's device time at B =
512 (PERF.md §5), for work that is small: ~1.1e10 pair operations and up to
5.4e8 ``expf`` a step at B = 512, ~0.55 GB of features in and descriptors
out.  The kernel tests every (centre, neighbour) pair and splats only those
inside the hat's support (~50 of 1,024 neighbours), one warp per centre,
eight centres of one scan per block; each cell adds its terms in ascending
neighbour index with no atomics, so a scan's descriptors depend on nothing
but its own features: not on B, not on its place in the batch, so
``models.odometry._descriptors_batched`` makes one launch of the whole
batch on the card and keeps its calls of ``DESC_STREAMS`` streams for the
CPU's matmul form only, where they bound the hat tensors' memory.  Each
pair is computed as the twin computes it,
the cells sum in the order of cuBLAS's FFMA product and the epilogue in
ATen's row-reduction order, so on the card the rows are the twin's bit for
bit (at P = 16 and every even P; at an odd P of 13 or more to a few ulp):
a matcher's near-ties then break as the plain form breaks them, which the
odometry benchmark's pose limits require (PERF.md §7: they fail a sound
reordering).  The design note is at the top of the CUDA source.

Built at first use by ``ops.kernels.build.KernelLibrary`` (nvcc, sm_90a, a
plain C interface loaded with ctypes); a failed build raises, nothing falls
back.  The wrapper takes CUDA tensors only;
``ops.features.constellation_descriptors`` gives CPU inputs to the twin.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from navtech_radar_slam_torch.config import FeatureConfig
from navtech_radar_slam_torch.ops.kernels.build import KernelLibrary

#: kernel launches by ``constellation_descriptors_cuda`` in this process (one
#: per call, whatever B)
launch_count = 0

#: most grid cells P * P a launch takes (kMaxCells: P <= 32)
MAX_CELLS = 1024


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.descriptors_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cells = lib.descriptors_max_cells
    cells.argtypes, cells.restype = [], ctypes.c_int
    if cells() != MAX_CELLS:
        raise RuntimeError(f"descriptors: descriptors_max_cells() is {cells()}, the wrapper "
                           f"expects {MAX_CELLS}")


LIBRARY = KernelLibrary("descriptors", _bind)


def reciprocal(d: float) -> float:
    """float32(1) / float32(d): the factor PyTorch's CUDA division by a
    Python scalar multiplies by, which the plain form's ``/ cell`` and ``/
    (window / 2)²`` are on the card."""
    return float(np.float32(1.0) / np.float32(d))


def check(xy: torch.Tensor, power: torch.Tensor, valid: torch.Tensor, grid: int) -> None:
    """Refuse what the kernel does not take: (B, K, 2) and (B, K) float32,
    (B, K) bool, contiguous, B >= 1, on one CUDA device, with ``grid`` ² at
    most ``MAX_CELLS`` cells."""
    name = "constellation_descriptors_cuda"
    if xy.dtype != torch.float32 or power.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: needs float32 xy and power and a bool mask, got "
                        f"{xy.dtype}, {power.dtype}, {valid.dtype}")
    if (xy.dim() != 3 or xy.shape[2] != 2 or tuple(power.shape) != tuple(xy.shape[:2])
            or tuple(valid.shape) != tuple(xy.shape[:2]) or not xy.is_contiguous()
            or not power.is_contiguous() or not valid.is_contiguous()):
        raise ValueError(f"{name}: needs contiguous (B, K, 2), (B, K) and (B, K) tensors, got "
                         f"{tuple(xy.shape)}, {tuple(power.shape)}, {tuple(valid.shape)}")
    if xy.shape[0] == 0:
        raise ValueError(f"{name}: needs at least one scan, got B = 0")
    if not 1 <= grid * grid <= MAX_CELLS:
        raise ValueError(f"{name}: a {grid} x {grid} grid; the kernel takes 1 to "
                         f"{MAX_CELLS} cells")
    dev = xy.device
    if dev.type != "cuda" or power.device != dev or valid.device != dev:
        raise ValueError(f"{name}: xy, power and valid must be CUDA tensors on one device, "
                         f"got {dev}, {power.device}, {valid.device}")


def constellation_descriptors_cuda(xy: torch.Tensor, power: torch.Tensor,
                                   valid: torch.Tensor, fcfg: FeatureConfig) -> torch.Tensor:
    """K4: (B, K, 2) float32 positions, (B, K) float32 power and (B, K) bool
    validity, all CUDA, B >= 1 -> (B, K, desc_grid²) unit-norm descriptors
    (the contract of ``ops.features.constellation_descriptors`` for each
    scan; an invalid feature's row is zeros), in one launch; scan b's rows
    are the same bits at any B and any place in the batch.

    Launches on the current stream and does not synchronise; K = 0 gives an
    empty result and no launch.  Raises on any input the kernel does not take
    and on any launch error; there is no plain fallback."""
    global launch_count
    p = fcfg.desc_grid
    check(xy, power, valid, p)
    nscans, k = xy.shape[:2]
    dev = xy.device
    out = torch.empty((nscans, k, p * p), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    lib = LIBRARY.load()
    inv_cell = reciprocal(fcfg.desc_window / p)
    inv_r2 = reciprocal((fcfg.desc_window * 0.5) ** 2)
    same = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        err = lib.descriptors_launch(xy.data_ptr(), power.data_ptr(), valid.data_ptr(),
                                     out.data_ptr(), nscans, k, p, inv_cell, inv_r2,
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"constellation_descriptors_cuda: launch failed, CUDA error {err}")
    launch_count += 1
    return out
