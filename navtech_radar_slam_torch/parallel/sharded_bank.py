"""ScanContext loop search over a descriptor bank split across the ranks.

Counterpart of ``navtech_radar_slam_tpu/parallel/sharded_bank.py``.  The
bank (N, R, S) is split in contiguous row blocks (rank r holds rows
``[r·N/d, (r+1)·N/d)``), the queries are replicated; each rank searches
its block and one ``all_gather`` of a (T, 3) [dist, global index, shift]
per rank gives every rank the global best, the first rank winning ties
(the lowest global index, as the single-device argmin).

Two shard-local modes, following ``ScanContextConfig.search_mode``:

  * "full": one K2-T call (``sc_shift_distance_matrix_multi``) on the
    rank's searchable local prefix, ``clip(bound − start, 0, n_local)``
    rows for the largest bound of the T queries (the single-device
    ``detect_loop`` rule, per shard), rows masked per slot by their global
    index.  A rank other than 0 with no searchable row launches nothing
    (its rows could not win); rank 0 keeps one row, so that with nothing
    searchable anywhere the candidate's yaw is shard 0's row-0 best shift,
    as JAX gives it.
  * "ringkey": JAX's shard-local two-stage search: the ring keys of the
    rank's block (recomputed per call), a prefilter of
    ``min(shard_top_k, n_local)`` rows per shard, then the shift distances
    on those rows (``ops.scancontext.ringkey_two_stage_best_multi``, one
    K2-T call).  The global candidate set is the union over shards, so the
    result depends on the mesh size, as JAX's does.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from navtech_radar_slam_torch.config import ScanContextConfig
from navtech_radar_slam_torch.ops import scancontext as sc_ops
from navtech_radar_slam_torch.parallel.mesh import Mesh


def _local_search(queries: torch.Tensor, bank_local: torch.Tensor,
                  num_valids: Sequence[int], cfg: ScanContextConfig, mesh: Mesh,
                  shard_top_k: int) -> torch.Tensor:
    """This rank's best (dist, global idx, shift) per query, (T, 3) float32.
    ``num_valids`` (host ints): keyframes stored when each query searches."""
    t = queries.shape[0]
    n_local = bank_local.shape[0]
    dev = bank_local.device
    start = mesh.rank * n_local
    ringkey = cfg.search_mode == "ringkey"
    if ringkey:
        bounds = [sc_ops.ringkey_searchable_bound(int(nv), cfg) for nv in num_valids]
    else:
        bounds = [int(nv) - cfg.num_exclude_recent for nv in num_valids]
    bound_t = torch.as_tensor(bounds, device=dev)
    if mesh.rank > 0 and max(bounds) <= start:
        # no searchable row here: rank 0's result is never worse
        nothing = torch.tensor([float("inf"), float(start), 0.0], device=dev)
        return nothing.repeat(t, 1)
    if ringkey:
        gidx = start + torch.arange(n_local, device=dev)
        searchable = gidx[None, :] < bound_t[:, None]
        best, dist, shift = sc_ops.ringkey_two_stage_best_multi(
            queries, bank_local, sc_ops.ring_key(bank_local), searchable,
            min(shard_top_k, n_local), cfg)
        return torch.stack([dist, (start + best).to(torch.float32),
                            shift.to(torch.float32)], dim=-1)
    n = min(max(max(bounds) - start, 0), n_local)
    if mesh.rank == 0:
        n = max(n, 1)
    dist, shift = sc_ops._best_shift(
        sc_ops.sc_shift_distance_matrix_multi(queries, bank_local[:n]))   # (T, n)
    gidx = start + torch.arange(n, device=dev)
    dist = torch.where(gidx[None, :] < bound_t[:, None], dist,
                       torch.full_like(dist, float("inf")))
    j = torch.argmin(dist, dim=-1)[:, None]
    return torch.stack([torch.gather(dist, 1, j)[:, 0], (start + j[:, 0]).to(torch.float32),
                        torch.gather(shift, 1, j)[:, 0].to(torch.float32)], dim=-1)


def _global_best(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The best of every rank's (T, 3) rows, the first rank on ties."""
    allbest = mesh.all_gather(local)                     # (d, T, 3)
    k = torch.argmin(allbest[:, :, 0], dim=0)            # (T,)
    return torch.gather(allbest, 0, k[None, :, None].expand(1, -1, 3))[0]


def _to_candidate(best: torch.Tensor, cfg: ScanContextConfig) -> sc_ops.LoopCandidate:
    dist = best[..., 0]
    found = dist < cfg.sc_dist_thres
    idx = best[..., 1].to(torch.int64)
    return sc_ops.LoopCandidate(idx=torch.where(found, idx, torch.full_like(idx, -1)),
                                dist=dist,
                                yaw=sc_ops.shift_to_yaw(best[..., 2].to(torch.int64), cfg),
                                found=found)


def make_sharded_loop_detector_batch(mesh: Mesh, cfg: ScanContextConfig,
                                     shard_top_k: int = 4) -> Callable:
    """``detect(queries (T, R, S), bank_local, num_valids) -> LoopCandidate``
    of (T,) leaves, the same on every rank: T queries against the bank whose
    block ``bank_local`` this rank holds, ``num_valids`` (T host ints) the
    keyframes stored at each query.  One K2-T call per rank and one
    ``all_gather`` for a whole segment's queries (the mesh engine's
    streaming path)."""

    def detect(queries, bank_local, num_valids):
        local = _local_search(queries, bank_local, num_valids, cfg, mesh, shard_top_k)
        return _to_candidate(_global_best(local, mesh), cfg)

    return detect


def make_sharded_loop_detector(mesh: Mesh, cfg: ScanContextConfig,
                               shard_top_k: int = 4) -> Callable:
    """``detect(query (R, S), bank_local, num_valid: int) -> LoopCandidate``
    with the semantics of ``ops.scancontext.detect_loop`` (or
    ``detect_loop_ringkey`` with the per-shard prefilter ``shard_top_k``)."""
    batch = make_sharded_loop_detector_batch(mesh, cfg, shard_top_k)

    def detect(query, bank_local, num_valid):
        cand = batch(query[None], bank_local, [int(num_valid)])
        return sc_ops.LoopCandidate(*(x[0] for x in cand))

    return detect
