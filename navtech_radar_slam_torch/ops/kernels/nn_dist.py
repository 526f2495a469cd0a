"""Kernel K3: brute-force 2-D nearest neighbours as a CUDA kernel
(csrc/nn_dist.cu).

Replaces the TPU kernel ``navtech_radar_slam_tpu/ops/pallas/nn_dist.py::
nearest_neighbors_pallas``; its plain PyTorch version is
``navtech_radar_slam_torch.ops.icp.nearest_neighbors_plain``.  The design note
(query tiles x target chunks, one thread block cluster per query tile) is at
the top of the CUDA source; ``launch_geometry`` is the host side of it.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch

from navtech_radar_slam_torch.ops.kernels.build import KernelLibrary

#: kernel launches by ``nearest_neighbors_cuda`` in this process
launch_count = 0

#: queries per block (kTileQ in the source)
QUERY_TILE = 16
#: most target chunks per query tile: the blocks of one cluster (kMaxChunks)
MAX_CHUNKS = 8
#: fewest targets a chunk holds before the chunk count is cut
MIN_CHUNK = 256


def launch_geometry(nq: int, nt: int) -> Tuple[int, int, int]:
    """(query tiles, target chunks = blocks per cluster, targets per chunk)
    of one launch for ``nq`` queries and ``nt`` targets: as many chunks as
    keep each at ``MIN_CHUNK`` targets or more, at most ``MAX_CHUNKS``."""
    chunks = max(1, min(MAX_CHUNKS, -(-nt // MIN_CHUNK)))
    return -(-nq // QUERY_TILE), chunks, max(1, -(-nt // chunks))


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.nn_dist_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name, want in (("nn_dist_query_tile", QUERY_TILE),
                       ("nn_dist_max_chunks", MAX_CHUNKS)):
        f = getattr(lib, name)
        f.argtypes, f.restype = [], ctypes.c_int
        if f() != want:
            raise RuntimeError(f"nn_dist: {name}() is {f()}, the wrapper expects {want}")


LIBRARY = KernelLibrary("nn_dist", _bind)


def nearest_neighbors_cuda(src: torch.Tensor, tgt: torch.Tensor,
                           tgt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """src (Nq, 2), tgt (Nt, 2) float32 and tgt_valid (Nt,) bool, all CUDA ->
    (min squared distance (Nq,) float32, first argmin index (Nq,) int64).

    Launches on the current stream and does not synchronise.  Raises on any
    input the kernel does not take and on any launch error."""
    global launch_count
    dev = src.device
    if dev.type != "cuda" or tgt.device != dev or tgt_valid.device != dev:
        raise ValueError("nearest_neighbors_cuda: src, tgt and tgt_valid must be CUDA "
                         f"tensors on one device, got {dev}, {tgt.device}, "
                         f"{tgt_valid.device}")
    if src.dtype != torch.float32 or tgt.dtype != torch.float32 or tgt_valid.dtype != torch.bool:
        raise TypeError("nearest_neighbors_cuda: needs float32 src and tgt and a bool "
                        f"mask, got {src.dtype}, {tgt.dtype}, {tgt_valid.dtype}")
    if (src.dim() != 2 or src.shape[1] != 2 or tgt.dim() != 2 or tgt.shape[1] != 2
            or tuple(tgt_valid.shape) != (tgt.shape[0],) or not src.is_contiguous()
            or not tgt.is_contiguous() or not tgt_valid.is_contiguous()):
        raise ValueError("nearest_neighbors_cuda: needs contiguous (Nq, 2), (Nt, 2) and "
                         f"(Nt,) tensors, got {tuple(src.shape)}, {tuple(tgt.shape)}, "
                         f"{tuple(tgt_valid.shape)}")
    lib = LIBRARY.load()
    nq, nt = src.shape[0], tgt.shape[0]
    _, chunks, chunk_len = launch_geometry(nq, nt)
    dmin = torch.empty(nq, dtype=torch.float32, device=dev)
    idx = torch.empty(nq, dtype=torch.int64, device=dev)
    args = (src.data_ptr(), tgt.data_ptr(), tgt_valid.data_ptr(), dmin.data_ptr(),
            idx.data_ptr(), nq, nt, chunks, chunk_len)
    same = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        err = lib.nn_dist_launch(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nearest_neighbors_cuda: launch failed, CUDA error {err}")
    launch_count += 1
    return dmin, idx
