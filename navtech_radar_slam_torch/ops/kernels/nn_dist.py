"""Kernel K3: brute-force 2-D nearest neighbours as a CUDA kernel
(csrc/nn_dist.cu).

Replaces the TPU kernel ``navtech_radar_slam_tpu/ops/pallas/nn_dist.py::
nearest_neighbors_pallas``; its plain PyTorch version is
``navtech_radar_slam_torch.ops.icp.nearest_neighbors`` on a CPU tensor.  The
design note is at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from navtech_radar_slam_torch.ops.kernels.build import KernelLibrary

#: kernel launches by ``nearest_neighbors_cuda`` in this process
launch_count = 0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.nn_dist_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("nn_dist", _bind)


def nearest_neighbors_cuda(src: torch.Tensor, tgt: torch.Tensor,
                           tgt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """src (Nq, 2), tgt (Nt, 2) float32 and tgt_valid (Nt,) bool, all CUDA ->
    (min squared distance (Nq,) float32, first argmin index (Nq,) int64).

    Launches on the current stream and does not synchronise.  Raises on any
    input the kernel does not take and on any launch error."""
    global launch_count
    for name, x, dtype, shape in (("src", src, torch.float32, (src.shape[0], 2)),
                                  ("tgt", tgt, torch.float32, (tgt.shape[0], 2)),
                                  ("tgt_valid", tgt_valid, torch.bool, (tgt.shape[0],))):
        if x.device.type != "cuda" or x.device != src.device:
            raise ValueError(f"nearest_neighbors_cuda: {name} must be a CUDA tensor "
                             f"on {src.device}, got {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"nearest_neighbors_cuda: {name} must be {dtype}, "
                            f"got {x.dtype}")
        if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(f"nearest_neighbors_cuda: {name} must be a contiguous "
                             f"{tuple(shape)} tensor, got {tuple(x.shape)}")
    lib = LIBRARY.load()
    nq, nt = src.shape[0], tgt.shape[0]
    dmin = torch.empty(nq, dtype=torch.float32, device=src.device)
    idx = torch.empty(nq, dtype=torch.int64, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nn_dist_launch(src.data_ptr(), tgt.data_ptr(), tgt_valid.data_ptr(),
                                 dmin.data_ptr(), idx.data_ptr(), nq, nt, stream)
    if err != 0:
        raise RuntimeError(f"nearest_neighbors_cuda: launch failed, CUDA error {err}")
    launch_count += 1
    return dmin, idx
