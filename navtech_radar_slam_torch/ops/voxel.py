"""Voxel-grid downsampling as a static-shape mask.

Counterpart of ``navtech_radar_slam_tpu.ops.voxel``: keep exactly one
representative point per occupied cell (the lowest-index valid point),
leaving shapes untouched.  The JAX code sorts (cell_x, cell_y, index)
lexicographically with ``lax.sort``; here one stable sort of a combined
int64 cell key gives the same order, so the mask is identical.
"""

from __future__ import annotations

import torch

#: sentinel cell coordinate for invalid points (sorts after all real cells)
_SENTINEL = 1 << 30


def voxel_dedup_mask(pts: torch.Tensor, valid: torch.Tensor,
                     voxel: float) -> torch.Tensor:
    """(..., N) bool mask keeping one valid point per voxel cell.

    pts: (..., N, 2) float32; valid: (..., N) bool; voxel: cell edge in
    meters (<= 0 disables: returns ``valid`` unchanged).  Within a cell the
    valid point with the lowest index wins.  Leading dims are independent
    clouds (the segment's T slots, ``jax.vmap`` in the JAX code): each is
    sorted along its last axis and gets the mask it would get alone."""
    if voxel <= 0:
        return valid
    cx = torch.floor(pts[..., 0] / voxel).to(torch.int32)
    cy = torch.floor(pts[..., 1] / voxel).to(torch.int32)
    sentinel = torch.full_like(cx, _SENTINEL)
    cx = torch.where(valid, cx, sentinel).to(torch.int64)
    cy = torch.where(valid, cy, sentinel).to(torch.int64)
    # lexicographic (cx, cy) as one key; the stable sort keeps index order
    # within a cell
    key = cx * (1 << 32) + (cy + (1 << 31))
    skey, order = torch.sort(key, dim=-1, stable=True)
    first = torch.ones_like(valid)
    first[..., 1:] = skey[..., 1:] != skey[..., :-1]
    keep_sorted = first & (torch.div(skey, 1 << 32, rounding_mode="floor") != _SENTINEL)
    keep = torch.zeros_like(valid).scatter_(-1, order, keep_sorted)
    return keep & valid
