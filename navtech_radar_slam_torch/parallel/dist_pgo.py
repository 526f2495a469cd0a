"""Distributed pose-graph Gauss-Newton over the ranks of a ``Mesh``.

Counterpart of ``navtech_radar_slam_tpu/parallel/dist_pgo.py``.  The
normal-equation matvec H v = Jᵀ (J v) decomposes over factors, so each rank
linearizes its own block of the factors once per GN step and one
``all_reduce(SUM)`` merges the partial matvecs (one more merges b):

  * odometry and GPS factors by node block, rank r the nodes
    ``[r·N/d, (r+1)·N/d)``;
  * loop factors by edge block when ``max_loop_edges % d == 0``; otherwise
    every loop factor is evaluated by rank 0 alone (JAX's replicated
    fallback, masked to shard 0).

The factor arrays are stored whole on every rank (``GraphArrays`` as the
single-device ``PoseGraph`` keeps them: 4096 × 21 floats of node arrays at
the default capacity); each rank evaluates only its block.  Poses are
replicated, and CG with its chain or Jacobi preconditioner runs replicated
on every rank.  The GN step is the single-device solver's
(``models/posegraph.py``: its per-factor Jacobian blocks and its chain
preconditioner) run with this rank's ``FactorShard``: JAX's
``_local_residuals`` and ``_sharded_gn_step`` are ``posegraph.residuals`` and
``posegraph._gn_step`` on that shard.

Rank agreement: every host read inside a solve reads a collective's
result.  b and each H p are all-reduced, so the CG state is the same on
every rank; CG's stop flag and GN's step size are agreed with
``all_reduce(MAX)``; the solved poses are broadcast from rank 0.
"""

from __future__ import annotations

from typing import Callable

import torch

from navtech_radar_slam_torch.config import PgoConfig
from navtech_radar_slam_torch.models import posegraph as pg
from navtech_radar_slam_torch.parallel.mesh import Mesh


def factor_shard(g: pg.GraphArrays, cfg: PgoConfig, mesh: Mesh) -> pg.FactorShard:
    """This rank's factors of ``g``: its node block, and its edge block of
    the loops when the loop capacity divides the mesh size (otherwise all of
    them on rank 0 and none elsewhere); merged by ``all_reduce(SUM)``, the
    flags agreed by ``all_reduce(MAX)``."""
    if cfg.max_loop_edges % mesh.size == 0:
        loops = slice(*mesh.block(g.loop_i.shape[0]))
    else:
        loops = slice(None) if mesh.rank == 0 else slice(0, 0)
    return pg.FactorShard(slice(*mesh.block(g.poses.shape[0])), loops, mesh.all_reduce_sum,
                          mesh.agree_max)


def make_distributed_solver(mesh: Mesh, cfg: PgoConfig) -> Callable:
    """``solve(g) -> poses (N, 4, 4)``: up to ``cfg.gn_iters`` distributed
    IRLS / GN steps with the single-device solver's early exit (the step
    size, agreed over the ranks), then rank 0's poses on every rank.  The
    node capacity must divide the mesh size."""

    def solve(g: pg.GraphArrays) -> torch.Tensor:
        return mesh.broadcast(pg.solve(g, cfg, factor_shard(g, cfg, mesh)).poses)

    return solve


def make_bucketed_distributed_solver(mesh: Mesh, cfg: PgoConfig) -> Callable:
    """``solver(g, num_nodes, num_loops) -> GraphArrays`` on the smallest
    power-of-two prefix of the node arrays that holds the active graph, at
    least the mesh size (``posegraph.make_bucketed_solver`` with JAX's mesh
    rule: a capacity or bucket the mesh size does not divide solves at full
    capacity).  Loop arrays stay at full padding."""
    return pg.make_bucketed_solver(cfg, make_distributed_solver(mesh, cfg), min_bucket=mesh.size)
