"""Kernel K2: ScanContext all-shift distances as a CUDA kernel
(csrc/sc_corr.cu).

Replaces the TPU kernel ``navtech_radar_slam_tpu/ops/pallas/sc_corr.py::
sc_shift_distances_pallas``; its plain PyTorch version is
``navtech_radar_slam_torch.ops.scancontext.sc_shift_distance_matrix`` on a
CPU tensor.  The column normalisation runs inside the kernel.  The design
note is at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from navtech_radar_slam_torch.ops.kernels.build import KernelLibrary

#: kernel launches by ``sc_shift_distances_cuda`` in this process
launch_count = 0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.sc_corr_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("sc_corr_max_sectors", "sc_corr_max_cells"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int


LIBRARY = KernelLibrary("sc_corr", _bind)


def sc_shift_distances_cuda(query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(R, S) query vs (N, R, S) bank, float32 CUDA tensors -> (N, S)
    distance at every circular shift (the contract of the TPU kernel).

    Launches on the current stream and does not synchronise.  Raises on any
    input the kernel does not take and on any launch error."""
    global launch_count
    for name, x, dim in (("query", query, 2), ("bank", bank, 3)):
        if x.device.type != "cuda":
            raise ValueError(f"sc_shift_distances_cuda: {name} must be a CUDA "
                             f"tensor, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"sc_shift_distances_cuda: {name} must be float32, "
                            f"got {x.dtype}")
        if x.dim() != dim or not x.is_contiguous():
            raise ValueError(f"sc_shift_distances_cuda: {name} must be a "
                             f"contiguous {dim}-d tensor, got {tuple(x.shape)}")
    n, nr, ns = bank.shape
    if tuple(query.shape) != (nr, ns) or query.device != bank.device:
        raise ValueError(f"sc_shift_distances_cuda: query {tuple(query.shape)} "
                         f"on {query.device} does not match bank {tuple(bank.shape)} "
                         f"on {bank.device}")
    lib = LIBRARY.load()
    if ns > lib.sc_corr_max_sectors() or nr * ns > lib.sc_corr_max_cells():
        raise ValueError(f"sc_shift_distances_cuda: ({nr}, {ns}) descriptors exceed "
                         f"{lib.sc_corr_max_sectors()} sectors or "
                         f"{lib.sc_corr_max_cells()} cells")
    out = torch.empty((n, ns), dtype=torch.float32, device=bank.device)
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sc_corr_launch(query.data_ptr(), bank.data_ptr(), out.data_ptr(),
                                 n, nr, ns, stream)
    if err != 0:
        raise RuntimeError(f"sc_shift_distances_cuda: launch failed, CUDA error {err}")
    launch_count += 1
    return out
