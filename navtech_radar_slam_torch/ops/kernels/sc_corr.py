"""Kernel K2: ScanContext all-shift distances as a CUDA kernel
(csrc/sc_corr.cu).

Replaces the TPU kernel ``navtech_radar_slam_tpu/ops/pallas/sc_corr.py::
sc_shift_distances_pallas``; its plain PyTorch version is
``navtech_radar_slam_torch.ops.scancontext.sc_shift_distance_matrix_plain``.
The column normalisation runs inside the kernel, the contraction in fp32 on
the CUDA cores with one bank row x 12 shifts in each thread's registers,
and the column counts are popcounts of 64-bit column masks, so S <= 64.
The design note is at the top of the CUDA source; ``launch_geometry`` is the
host side of it: the split variant (2 rows a block, the rings split over 20
thread groups) for the few rows a loop search scores, the tile variant (16
rows a block, 4 groups, two blocks an SM) for a full bank.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch

from navtech_radar_slam_torch.ops.kernels.build import KernelLibrary

#: kernel launches by ``sc_shift_distances_cuda`` in this process
launch_count = 0

#: most columns (sectors): one bit each in a 64-bit mask (kMaxSectors)
MAX_SECTORS = 64
#: most rings x columns rounded up to 4 (kMaxCells)
MAX_CELLS = 2048
#: bank rows per block of the split and the tile variant (kSplitRows, kTileRows)
BLOCK_ROWS = (2, 16)
#: fewest bank rows that take the tile variant: 128 tile blocks, about one
#: per SM of an H100
TILE_MIN_ROWS = 2048


def launch_geometry(n: int) -> Tuple[int, int, int]:
    """(variant, bank rows per block, blocks) of one launch for ``n`` bank
    rows: the tile variant from ``TILE_MIN_ROWS`` rows, where its blocks
    fill the card, the split variant below, which spreads few rows over
    many short blocks."""
    variant = 1 if n >= TILE_MIN_ROWS else 0
    rows = BLOCK_ROWS[variant]
    return variant, rows, -(-n // rows)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.sc_corr_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sc_corr_block_rows.argtypes, lib.sc_corr_block_rows.restype = [ctypes.c_int], ctypes.c_int
    for name, want in (("sc_corr_max_sectors", MAX_SECTORS), ("sc_corr_max_cells", MAX_CELLS)):
        f = getattr(lib, name)
        f.argtypes, f.restype = [], ctypes.c_int
        if f() != want:
            raise RuntimeError(f"sc_corr: {name}() is {f()}, the wrapper expects {want}")
    for variant, want in enumerate(BLOCK_ROWS):
        if lib.sc_corr_block_rows(variant) != want:
            raise RuntimeError(f"sc_corr: sc_corr_block_rows({variant}) is "
                               f"{lib.sc_corr_block_rows(variant)}, the wrapper expects {want}")


LIBRARY = KernelLibrary("sc_corr", _bind)


def sc_shift_distances_cuda(query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(R, S) query vs (N, R, S) bank, float32 CUDA tensors -> (N, S)
    distance at every circular shift (the contract of the TPU kernel).

    Launches on the current stream and does not synchronise; an empty bank
    gives an empty (0, S) result and no launch.  Raises on any input the
    kernel does not take (S > 64 among them) and on any launch error."""
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
    dev = bank.device
    if tuple(query.shape) != (nr, ns) or query.device != dev:
        raise ValueError(f"sc_shift_distances_cuda: query {tuple(query.shape)} "
                         f"on {query.device} does not match bank {tuple(bank.shape)} "
                         f"on {dev}")
    if not 1 <= ns <= MAX_SECTORS or nr < 1 or nr * -(-ns // 4) * 4 > MAX_CELLS:
        raise ValueError(f"sc_shift_distances_cuda: ({nr}, {ns}) descriptors: needs "
                         f"1 to {MAX_SECTORS} sectors and rings x sectors (rounded up "
                         f"to 4) at most {MAX_CELLS}")
    out = torch.empty((n, ns), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = LIBRARY.load()
    variant, _, _ = launch_geometry(n)
    same = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        err = lib.sc_corr_launch(query.data_ptr(), bank.data_ptr(), out.data_ptr(),
                                 n, nr, ns, variant, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sc_shift_distances_cuda: launch failed, CUDA error {err}")
    launch_count += 1
    return out
