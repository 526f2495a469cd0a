"""Data-parallel radar odometry over the ranks of a ``Mesh``.

Counterpart of ``navtech_radar_slam_tpu/parallel/sharded_odometry.py``.
``models.odometry.make_batched_odometry_step`` advances B independent
streams in one call; here the batch axis is split across the ranks, rank r
advancing streams ``[r·B/d, (r+1)·B/d)`` through the same step (one
K1 × (B/d) launch per step on the card).  Streams share nothing, so the
steps need no collective; only the small result leaves are gathered
(``gather_results``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from navtech_radar_slam_torch.config import SlamConfig
from navtech_radar_slam_torch.models import odometry as odo_mod
from navtech_radar_slam_torch.parallel.mesh import Mesh


def _map_tensors(fn, tree):
    """``fn`` on each tensor of a tensor or a NamedTuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(None if v is None else fn(v) for v in tree))


def make_sharded_batched_odometry(mesh: Mesh, cfg: SlamConfig) -> Tuple[Callable, Callable]:
    """Returns (step, shard):

    step(powers (B/d, NA, NB), azimuths (NA,), carry, twists (B/d, 3),
         ray_valids=None, packed=False) -> (carry', results, features),
         every leaf this rank's B/d streams;
    shard(tree) -> this rank's block of the batch axis of a tensor or a
         NamedTuple of tensors with B leading, on the mesh's device (B must
         divide the mesh size)."""
    step = odo_mod.make_batched_odometry_step(cfg, device=mesh.device)

    def shard(tree):
        def block(x):
            lo, hi = mesh.block(x.shape[0])
            return x[lo:hi].to(mesh.device)
        return _map_tensors(block, tree)

    return step, shard


def make_sharded_extract(mesh: Mesh, cfg: SlamConfig) -> Callable:
    """``extract(powers (B/d, NA, NB), azimuths (NA,)) -> ScanFeatures`` of this
    rank's streams (seeds the carry of the sharded step)."""

    def extract(powers, azimuths, ray_valids=None, packed=False):
        return odo_mod.extract_scan_features_batched(powers, azimuths, cfg, ray_valids, packed)

    return extract


def gather_results(mesh: Mesh, results):
    """The whole batch of a NamedTuple of per-stream result leaves (each
    (B/d, ...) on this rank) on every rank: one ``all_gather`` per leaf."""
    return _map_tensors(mesh.gather_rows, results)
