"""Kernel K2: ScanContext all-shift distances as a CUDA kernel
(csrc/sc_corr.cu), for one query (``sc_shift_distances_cuda``) and for T
query slots in one launch (K2-T, ``sc_shift_distances_multi_cuda``: the
``jax.vmap`` of the TPU kernel in the streaming engine's segment).

Replaces the TPU kernel ``navtech_radar_slam_tpu/ops/pallas/sc_corr.py::
sc_shift_distances_pallas``; its plain PyTorch version is
``navtech_radar_slam_torch.ops.scancontext.sc_shift_distance_matrix_plain``
(``..._multi_plain`` for K2-T).
The column normalisation runs inside the kernel, the contraction in fp32 on
the CUDA cores with one bank row x 12 shifts in each thread's registers,
and the column counts are popcounts of 64-bit column masks, so S <= 64.
The design note is at the top of the CUDA source; ``launch_geometry`` is the
host side of it: the split variant (2 rows a block, the rings split over 20
thread groups) for the few rows a loop search scores, the tile variant (16
rows a block, 4 groups, two blocks an SM) for a full bank.  K2-T with one
shared bank of ``SHARED_MIN_ROWS`` rows or more runs several query slots in
each block against the rows it staged once (``multi_geometry``), each slot
bit for bit K2's.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from navtech_radar_slam_torch.ops.kernels.build import KernelLibrary

#: kernel launches by ``sc_shift_distances_cuda`` in this process
launch_count = 0
#: kernel launches by ``sc_shift_distances_multi_cuda`` (K2-T) in this process
multi_launch_count = 0

#: most columns (sectors): one bit each in a 64-bit mask (kMaxSectors)
MAX_SECTORS = 64
#: most rings x columns rounded up to 4 (kMaxCells)
MAX_CELLS = 2048
#: most query slots of one K2-T launch: grid axis y (kMaxSlots)
MAX_SLOTS = 65535
#: bank rows per block of the split and the tile variant (kSplitRows, kTileRows)
BLOCK_ROWS = (2, 16)
#: fewest bank rows that take the tile variant: 128 tile blocks, about one
#: per SM of an H100
TILE_MIN_ROWS = 2048


#: fewest rows of a shared bank at which K2-T blocks run several query slots
#: each (the tile variant's); below, every block runs one slot, as K2's
#: does: a split block stages 2 rows, too few to pay for a longer chain
#: (16 x 400 rows: 0.064 ms with one slot a block, 0.068-0.097 with 2-16
#: on an H100, PERF.md)
SHARED_MIN_ROWS = 2048
#: fewest blocks a K2-T launch with query groups keeps: two tile blocks on
#: each of 128 SMs (measured best: 8 slots a block at 2048 rows, 16 at 4096
#: and 8192)
SHARED_TARGET_BLOCKS = 256


def multi_geometry(t: int, n: int, per_slot: bool) -> Tuple[int, int, int, int]:
    """(variant, query slots a block, blocks along the rows, blocks along
    the slots) of one K2-T launch of ``t`` slots on ``n`` bank rows.  The
    variant is K2's for ``n`` (``launch_geometry``), which fixes the order of
    every sum, so slot t is K2's result bit for bit.  Per-slot banks, and a
    shared bank under ``SHARED_MIN_ROWS`` rows, take one slot a block; a
    larger shared bank takes as many slots a block as keep
    ``SHARED_TARGET_BLOCKS`` blocks in the launch, split evenly."""
    variant, _, row_blocks = launch_geometry(n)
    qgroup = 1
    if not per_slot and n >= SHARED_MIN_ROWS and t > 1:
        groups = min(t, -(-SHARED_TARGET_BLOCKS // row_blocks))
        qgroup = -(-t // groups)
    return variant, qgroup, row_blocks, -(-t // qgroup)


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
    fn = lib.sc_corr_multi_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.sc_corr_block_rows.argtypes, lib.sc_corr_block_rows.restype = [ctypes.c_int], ctypes.c_int
    for name, want in (("sc_corr_max_sectors", MAX_SECTORS), ("sc_corr_max_cells", MAX_CELLS),
                       ("sc_corr_max_slots", MAX_SLOTS)):
        f = getattr(lib, name)
        f.argtypes, f.restype = [], ctypes.c_int
        if f() != want:
            raise RuntimeError(f"sc_corr: {name}() is {f()}, the wrapper expects {want}")
    for variant, want in enumerate(BLOCK_ROWS):
        if lib.sc_corr_block_rows(variant) != want:
            raise RuntimeError(f"sc_corr: sc_corr_block_rows({variant}) is "
                               f"{lib.sc_corr_block_rows(variant)}, the wrapper expects {want}")


LIBRARY = KernelLibrary("sc_corr", _bind)


def _check(fn: str, x: torch.Tensor, name: str, dim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: {name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be float32, got {x.dtype}")
    if x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {dim}-d tensor, "
                         f"got {tuple(x.shape)}")


def _check_descriptors(fn: str, nr: int, ns: int) -> None:
    if not 1 <= ns <= MAX_SECTORS or nr < 1 or nr * -(-ns // 4) * 4 > MAX_CELLS:
        raise ValueError(f"{fn}: ({nr}, {ns}) descriptors: needs 1 to {MAX_SECTORS} "
                         f"sectors and rings x sectors (rounded up to 4) at most "
                         f"{MAX_CELLS}")


def sc_shift_distances_cuda(query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(R, S) query vs (N, R, S) bank, float32 CUDA tensors -> (N, S)
    distance at every circular shift (the contract of the TPU kernel).

    Launches on the current stream and does not synchronise; an empty bank
    gives an empty (0, S) result and no launch.  Raises on any input the
    kernel does not take (S > 64 among them) and on any launch error."""
    global launch_count
    fn = "sc_shift_distances_cuda"
    _check(fn, query, "query", 2)
    _check(fn, bank, "bank", 3)
    n, nr, ns = bank.shape
    dev = bank.device
    if tuple(query.shape) != (nr, ns) or query.device != dev:
        raise ValueError(f"{fn}: query {tuple(query.shape)} on {query.device} does not "
                         f"match bank {tuple(bank.shape)} on {dev}")
    _check_descriptors(fn, nr, ns)
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


def sc_shift_distances_multi_cuda(queries: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """K2-T: (T, R, S) queries vs one (N, R, S) bank or per-slot (T, N, R, S)
    banks, float32 CUDA tensors -> (T, N, S); slot t is what
    ``sc_shift_distances_cuda(queries[t], bank or bank[t])`` gives, bit for
    bit, in one launch for all T slots (the variant is chosen per slot's N,
    as for one query; the query slots a block by ``multi_geometry``).

    Launches on the current stream and does not synchronise; no slot or an
    empty bank gives an empty result and no launch.  Raises on any input the
    kernel does not take (S > 64 among them) and on any launch error."""
    return _launch_multi(queries, bank, None)


def _launch_multi(queries: torch.Tensor, bank: torch.Tensor,
                  qgroup: Optional[int]) -> torch.Tensor:
    """``sc_shift_distances_multi_cuda`` with ``qgroup`` query slots a block
    on a shared bank (``multi_geometry``'s when None): a hook for the tests
    and timings of the query groups, which all give the same bits."""
    global multi_launch_count
    fn = "sc_shift_distances_multi_cuda"
    _check(fn, queries, "queries", 3)
    if bank.dim() not in (3, 4):
        raise ValueError(f"{fn}: bank must be (N, R, S) or (T, N, R, S), got "
                         f"{tuple(bank.shape)}")
    _check(fn, bank, "bank", bank.dim())
    t, nr, ns = queries.shape
    n = bank.shape[-3]
    dev = bank.device
    per_slot = bank.dim() == 4
    if (tuple(bank.shape[-2:]) != (nr, ns) or queries.device != dev
            or (per_slot and bank.shape[0] != t)):
        raise ValueError(f"{fn}: queries {tuple(queries.shape)} on {queries.device} "
                         f"do not match bank {tuple(bank.shape)} on {dev}")
    _check_descriptors(fn, nr, ns)
    if t > MAX_SLOTS:
        raise ValueError(f"{fn}: {t} slots, at most {MAX_SLOTS}")
    if qgroup is not None and (qgroup < 1 or (per_slot and qgroup > 1)):
        raise ValueError(f"{fn}: qgroup {qgroup}: needs >= 1, and 1 for per-slot banks")
    out = torch.empty((t, n, ns), dtype=torch.float32, device=dev)
    if n == 0 or t == 0:
        return out
    lib = LIBRARY.load()
    variant, group, _, _ = multi_geometry(t, n, per_slot)
    group = group if qgroup is None else min(qgroup, t)
    stride = n * nr * ns if per_slot else 0
    same = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        err = lib.sc_corr_multi_launch(queries.data_ptr(), bank.data_ptr(), out.data_ptr(),
                                       t, n, nr, ns, stride, variant, group,
                                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed, CUDA error {err}")
    multi_launch_count += 1
    return out
