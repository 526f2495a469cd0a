"""Kernel K3: brute-force 2-D nearest neighbours as a CUDA kernel
(csrc/nn_dist.cu), for one problem (``nearest_neighbors_cuda``) and for T
problems in one launch (K3-T, ``nearest_neighbors_multi_cuda``: the
``jax.vmap`` of the TPU kernel through the streaming segment's T-slot ICP),
with an optional device-side mask of the slots to compute.

Replaces the TPU kernel ``navtech_radar_slam_tpu/ops/pallas/nn_dist.py::
nearest_neighbors_pallas``; its plain PyTorch version is
``navtech_radar_slam_torch.ops.icp.nearest_neighbors_plain``, which takes K3-T's
slots as a leading dim and the same slot mask.  The design note (masked
slots leave at once, each block pairs only the valid targets of its chunk,
query tiles x target chunks, one thread block cluster per query tile) is at
the top of the CUDA source; ``launch_geometry`` is the host side of it.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from navtech_radar_slam_torch.ops.kernels.build import KernelLibrary

#: kernel launches by ``nearest_neighbors_cuda`` in this process
launch_count = 0
#: kernel launches by ``nearest_neighbors_multi_cuda`` (K3-T) in this process
multi_launch_count = 0

#: queries per block (kTileQ in the source)
QUERY_TILE = 32
#: most target chunks per query tile: the blocks of one cluster (kMaxChunks)
MAX_CHUNKS = 8
#: fewest targets a chunk holds before the chunk count is cut
MIN_CHUNK = 256
#: most problems of one K3-T launch: grid axis z (kMaxSlots)
MAX_SLOTS = 65535


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
    fn = lib.nn_dist_multi_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name, want in (("nn_dist_query_tile", QUERY_TILE),
                       ("nn_dist_max_chunks", MAX_CHUNKS),
                       ("nn_dist_max_slots", MAX_SLOTS)):
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


def nearest_neighbors_multi_cuda(src: torch.Tensor, tgt: torch.Tensor,
                                 tgt_valid: torch.Tensor,
                                 slot_mask: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3-T: src (T, Nq, 2), tgt (T, Nt, 2) float32 and tgt_valid (T, Nt)
    bool, all CUDA -> (min squared distance (T, Nq) float32, first argmin
    index within the slot's targets (T, Nq) int64); slot t is what
    ``nearest_neighbors_cuda(src[t], tgt[t], tgt_valid[t])`` gives, bit for
    bit, in one launch for all T problems.  ``slot_mask`` ((T,) bool on the
    same device, optional): a slot where it is False computes nothing and
    gets (+inf, 0) for every query, what a query with no valid target gets;
    the mask is read on the device only.

    Launches on the current stream and does not synchronise; no slot or no
    query gives an empty result and no launch.  Raises on any input the
    kernel does not take and on any launch error."""
    global multi_launch_count
    fn = "nearest_neighbors_multi_cuda"
    dev = src.device
    if dev.type != "cuda" or tgt.device != dev or tgt_valid.device != dev:
        raise ValueError(f"{fn}: src, tgt and tgt_valid must be CUDA tensors on one "
                         f"device, got {dev}, {tgt.device}, {tgt_valid.device}")
    if src.dtype != torch.float32 or tgt.dtype != torch.float32 or tgt_valid.dtype != torch.bool:
        raise TypeError(f"{fn}: needs float32 src and tgt and a bool mask, got "
                        f"{src.dtype}, {tgt.dtype}, {tgt_valid.dtype}")
    if (src.dim() != 3 or src.shape[2] != 2 or tgt.dim() != 3 or tgt.shape[2] != 2
            or tgt.shape[0] != src.shape[0] or tuple(tgt_valid.shape) != tgt.shape[:2]
            or not src.is_contiguous() or not tgt.is_contiguous()
            or not tgt_valid.is_contiguous()):
        raise ValueError(f"{fn}: needs contiguous (T, Nq, 2), (T, Nt, 2) and (T, Nt) "
                         f"tensors, got {tuple(src.shape)}, {tuple(tgt.shape)}, "
                         f"{tuple(tgt_valid.shape)}")
    t, nq, nt = src.shape[0], src.shape[1], tgt.shape[1]
    if slot_mask is not None:
        if slot_mask.device != dev or slot_mask.dtype != torch.bool:
            raise ValueError(f"{fn}: slot_mask must be a bool tensor on {dev}, got "
                             f"{slot_mask.dtype} on {slot_mask.device}")
        if tuple(slot_mask.shape) != (t,) or not slot_mask.is_contiguous():
            raise ValueError(f"{fn}: slot_mask must be contiguous ({t},), got "
                             f"{tuple(slot_mask.shape)}")
    if t > MAX_SLOTS:
        raise ValueError(f"{fn}: {t} slots, at most {MAX_SLOTS}")
    dmin = torch.empty((t, nq), dtype=torch.float32, device=dev)
    idx = torch.empty((t, nq), dtype=torch.int64, device=dev)
    if t == 0 or nq == 0:
        return dmin, idx
    lib = LIBRARY.load()
    _, chunks, chunk_len = launch_geometry(nq, nt)
    args = (src.data_ptr(), tgt.data_ptr(), tgt_valid.data_ptr(),
            None if slot_mask is None else slot_mask.data_ptr(), dmin.data_ptr(),
            idx.data_ptr(), t, nq, nt, chunks, chunk_len)
    same = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        err = lib.nn_dist_multi_launch(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed, CUDA error {err}")
    multi_launch_count += 1
    return dmin, idx
