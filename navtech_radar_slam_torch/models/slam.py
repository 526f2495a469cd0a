"""The full SLAM engine in PyTorch: odometry + keyframing + ScanContext loop
search + submap ICP verification + robust pose-graph refine + map output.

Counterpart of the single-device ``navtech_radar_slam_tpu.models.slam.
SlamEngine``, per scan and streamed:

  process(scan) -> RadarOdometry.process          (K1 on a CUDA tensor)
               -> keyframe gate (accumulated translation)
               -> _kf_step_body: voxel filter, ScanContext descriptor,
                  bank / cloud / graph-node insert, and on detecting
                  keyframes detect_loop (K2) + _verify_candidate
                  (submap build + icp_se2, K3 per iteration + both gates)
               -> deferred loop decisions, packed on the device and fetched
                  at a flush (loop_commit_defer) -> loop factors -> PGO
  begin_chunk(scans) -> make_odometry_sequence     (S scans, carry on the device)
  finish_chunk()     -> one packed fetch (odometry + pending decisions)
               -> keyframe gate per scan, GPS table association
               -> _process_keyframes: runs of keyframes as ONE segment
                  (_kf_segment_body: batched inserts, then T-slot detect,
                  K2-T once, and T-slot ICP, K3-T once per iteration),
                  the per-keyframe path where per-scan semantics need a
                  host step (drain, growth, add_gps, in-line refine)
  trajectory() / aggregate_map()                   (drain, then read out)
  attach_prior_session(ckpt) -> a prior session's keyframes and factors as
                  a searchable map; its first inter-session loop rebases
                  the current session into the prior's frame
  prewarm()        -> runs every program of the streamed path once on
                  scratch copies (kernel libraries loaded, solver buckets,
                  segment buckets), the engine state untouched

The engine keeps its banks and graph on ``device`` and writes them in place
(the JAX engine returns new arrays; in place saves copying the 4096-row
banks per keyframe).  ``dispatch_counts`` counts the JAX engine's sites
(``kf_step``, ``decision_fetch``, ``pgo_full``, ``pgo_fast``,
``pose_slice``; streamed also ``odometry_seq``, ``pack_odo_fetch`` and
``kf_segment``) at the same places.

Host reads per scan: the odometry result (one fetch), the pose estimate
after a keyframe, and on each detecting keyframe one read of the
candidate's ``found`` flag, so that no ICP runs without a candidate (the
JAX engine's ``lax.cond``).  Streamed: one fetch per chunk, and inside a
segment no read but the T-slot ICP's "every slot converged" check.

``timers`` (a ``utils.profiling.StageTimers``) times the JAX engine's
stages at the same sites; ``loop_debug_dir`` makes every loop decision
that found a candidate write ``loop_<k>_<accepted|rejected>.npz``.

``mesh`` (a ``parallel.mesh.Mesh`` of size > 1, one engine per rank) runs
the JAX engine's mesh paths: each rank holds only its block of descriptor
bank rows (a write lands on the rank that owns the row), the segments and
the per-keyframe path search the split bank with ``parallel.sharded_bank``
(the per-keyframe path inserts, then searches, as JAX's
``kf_insert_split``), and the solves run ``parallel.dist_pgo``'s bucketed
distributed solver.  Clouds, ring keys and the graph stay replicated, and
every rank runs the odometry and the loop verification.  The host reads
that steer collectives read rank 0's values: the odometry packet, the
chunk's packed fetch and the decision fetch are broadcast from rank 0, and
the solver agrees its stop flags and broadcasts its poses.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from navtech_radar_slam_torch.config import SlamConfig
from navtech_radar_slam_torch.models import posegraph as pg
from navtech_radar_slam_torch.models.odometry import (RadarOdometry, extract_scan_features,
                                                      make_odometry_sequence)
from navtech_radar_slam_torch.ops import icp as icp_ops
from navtech_radar_slam_torch.ops import scancontext as sc_ops
from navtech_radar_slam_torch.ops.kernels import cen_peaks, nn_dist, sc_corr
from navtech_radar_slam_torch.ops.voxel import voxel_dedup_mask
from navtech_radar_slam_torch.utils import geometry as geo
from navtech_radar_slam_torch.utils.device import DEFAULT_DEVICE, resolve_device


class LoopEvent(NamedTuple):
    """Record of one accepted loop closure."""

    prev_idx: int
    curr_idx: int
    sc_dist: float
    icp_fitness: float
    rel_pose: np.ndarray


def _build_submap(clouds: torch.Tensor, clouds_valid: torch.Tensor,
                  poses_se2: torch.Tensor, center, num_kf: int, half: int,
                  max_pts: int, voxel: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack keyframes center±half into the center keyframe's pose frame,
    voxel-filter the stack at ``voxel`` m, then pack ``max_pts`` points:
    valid first, then keyframes closest to the candidate.  The priority
    takes ~half+2 distinct values over W·K points, so which points fill the
    budget is decided by the tie order: lowest index first, as
    ``jax.lax.top_k``."""
    dev = clouds.device
    W = 2 * half + 1
    offsets = torch.arange(-half, half + 1, device=dev)
    idx = center + offsets
    ok = (idx >= 0) & (idx < num_kf)
    idxc = torch.clamp(idx, 0, clouds.shape[0] - 1)
    v = clouds_valid[idxc] & ok[:, None]                               # (W, K)
    rel = geo.se2_between(poses_se2[center].expand(W, 3), poses_se2[idxc])
    flat = geo.se2_apply(rel, clouds[idxc]).reshape(-1, 2)             # (W*K, 2)
    vflat = voxel_dedup_mask(flat, v.reshape(-1), voxel)
    prio = torch.where(vflat.reshape(W, -1),
                       (half + 1 - torch.abs(offsets)).to(torch.float32)[:, None],
                       torch.full((W, 1), -1.0, device=dev)).reshape(-1)
    _, take = sc_ops.top_k(prio, max_pts)
    return flat[take], vflat[take]


def _build_submap_multi(clouds: torch.Tensor, clouds_valid: torch.Tensor,
                        poses_se2: torch.Tensor, centers: torch.Tensor,
                        num_kfs: torch.Tensor, half: int, max_pts: int,
                        voxel: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_build_submap`` for T candidates at once (the vmapped JAX form):
    centers and num_kfs (T,) -> (T, max_pts, 2) points and (T, max_pts)
    mask, slot t being what ``_build_submap`` gives for its center."""
    dev = clouds.device
    t = centers.shape[0]
    offsets = torch.arange(-half, half + 1, device=dev)
    idx = centers[:, None] + offsets                                   # (T, W)
    ok = (idx >= 0) & (idx < num_kfs[:, None])
    idxc = torch.clamp(idx, 0, clouds.shape[0] - 1)
    v = clouds_valid[idxc] & ok[..., None]                             # (T, W, K)
    rel = geo.se2_between(poses_se2[centers][:, None].expand(idxc.shape + (3,)),
                          poses_se2[idxc])
    flat = geo.se2_apply(rel, clouds[idxc]).reshape(t, -1, 2)          # (T, W*K, 2)
    vflat = voxel_dedup_mask(flat, v.reshape(t, -1), voxel)
    prio = torch.where(vflat.reshape(v.shape),
                       (half + 1 - torch.abs(offsets)).to(torch.float32)[:, None],
                       torch.full((offsets.shape[0], 1), -1.0, device=dev)).reshape(t, -1)
    _, take = sc_ops.top_k(prio, max_pts)
    return (torch.gather(flat, 1, take[..., None].expand(-1, -1, 2)),
            torch.gather(vflat, 1, take))


def _empty_candidate(device, shape=()) -> sc_ops.LoopCandidate:
    """LoopCandidate of the given batch shape with found=False."""
    return sc_ops.LoopCandidate(
        idx=torch.full(shape, -1, dtype=torch.int64, device=device),
        dist=torch.full(shape, float("inf"), device=device),
        yaw=torch.zeros(shape, device=device),
        found=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def _empty_icp_result(device, shape=()) -> icp_ops.IcpResult:
    """IcpResult of the given batch shape with accepted=False."""
    return icp_ops.IcpResult(
        rel_pose=torch.zeros(shape + (3,), device=device),
        fitness=torch.full(shape, float("inf"), device=device),
        num_corr=torch.zeros(shape, dtype=torch.int64, device=device),
        converged=torch.zeros(shape, dtype=torch.bool, device=device),
        accepted=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def _odom_path_cum(g: pg.GraphArrays) -> torch.Tensor:
    """Cumulative odometry path length per node (for the loop
    odometry-consistency gate)."""
    steps = torch.linalg.norm(g.odom_meas[:, :2, 3], dim=-1) * g.odom_valid
    return torch.cumsum(steps, dim=0)


def _verify_candidate(cand: sc_ops.LoopCandidate, clouds, clouds_valid, poses_se2,
                      q_xy, q_valid, num_kf: int, cfg: SlamConfig, path_cum=None,
                      session_start: Optional[int] = None) -> icp_ops.IcpResult:
    """Submap build + ICP for a loop candidate, then (with ``path_cum``) the
    odometry-consistency gate: accept only if the ICP relative pose agrees
    with the graph's within odom_consistency_abs + frac * path length
    (pairs across ``session_start`` are exempt).

    Reads ``cand.found`` on the host once: without a candidate no ICP runs."""
    mq = cfg.icp.max_query_points
    k_feats = q_xy.shape[0]
    if mq < k_feats:
        # cap the ICP query cloud: valid points first, index order kept
        prio = (q_valid.to(torch.float32)
                - torch.arange(k_feats, device=q_xy.device) / (2.0 * k_feats))
        _, take = sc_ops.top_k(prio, mq)
        q_xy, q_valid = q_xy[take], q_valid[take]
    center = torch.clamp(cand.idx, min=0)
    if bool(cand.found):
        tgt, tgt_valid = _build_submap(
            clouds, clouds_valid, poses_se2, center, num_kf,
            cfg.icp.submap_half_size, cfg.icp.max_target_points,
            cfg.icp.submap_voxel_size)
        # query -> match starts at -yaw (SC yaw is "query rotated by yaw")
        zero = torch.zeros((), device=q_xy.device)
        init = (torch.stack([zero, zero, -cand.yaw]) if cfg.icp.use_yaw_init
                else torch.zeros(3, device=q_xy.device))
        res = icp_ops.icp_se2(q_xy, q_valid, tgt, tgt_valid, init, cfg.icp)
    else:
        res = _empty_icp_result(q_xy.device)
    if path_cum is not None and cfg.icp.odom_consistency_frac > 0:
        k = num_kf - 1
        rel_graph = geo.se2_between(poses_se2[center], poses_se2[k])
        disagree = torch.linalg.norm(res.rel_pose[:2] - rel_graph[:2])
        path = torch.abs(path_cum[k] - path_cum[center])
        allowed = cfg.icp.odom_consistency_abs + cfg.icp.odom_consistency_frac * path
        consistent = disagree <= allowed
        if session_start is not None:
            consistent = consistent | ((center < session_start) & (k >= session_start))
        res = res._replace(accepted=res.accepted & consistent)
    return res


def _verify_candidate_multi(cands: sc_ops.LoopCandidate, clouds, clouds_valid, poses_se2,
                            q_xy, q_valid, num_kfs: torch.Tensor, active: torch.Tensor,
                            cfg: SlamConfig, path_cum=None,
                            session_start: Optional[int] = None) -> icp_ops.IcpResult:
    """``_verify_candidate`` for T slots at once (the vmapped JAX form):
    cands of (T,) leaves, q_xy (T, K, 2), q_valid (T, K), num_kfs (T,),
    active (T,).  Every slot builds its submap and enters one T-slot ICP
    (``icp_se2_multi``); slots without a candidate, or inactive, start it
    converged and return the empty result by select, as the vmapped
    ``lax.cond`` does.  Makes no host read of ``found``."""
    mq = cfg.icp.max_query_points
    t, k_feats = q_xy.shape[:2]
    dev = q_xy.device
    if mq < k_feats:
        # cap the ICP query cloud: valid points first, index order kept
        prio = (q_valid.to(torch.float32)
                - torch.arange(k_feats, device=dev) / (2.0 * k_feats))
        _, take = sc_ops.top_k(prio, mq)
        q_xy = torch.gather(q_xy, 1, take[..., None].expand(-1, -1, 2))
        q_valid = torch.gather(q_valid, 1, take)
    center = torch.clamp(cands.idx, min=0)
    tgt, tgt_valid = _build_submap_multi(
        clouds, clouds_valid, poses_se2, center, num_kfs, cfg.icp.submap_half_size,
        cfg.icp.max_target_points, cfg.icp.submap_voxel_size)
    zero = torch.zeros(t, device=dev)
    init = (torch.stack([zero, zero, -cands.yaw], dim=-1) if cfg.icp.use_yaw_init
            else torch.zeros((t, 3), device=dev))
    run = cands.found & active
    res = icp_ops.icp_se2_multi(q_xy, q_valid, tgt, tgt_valid, init, cfg.icp, run)
    res = icp_ops.IcpResult(*(
        torch.where(run.reshape((t,) + (1,) * (a.dim() - 1)), a, b)
        for a, b in zip(res, _empty_icp_result(dev, (t,)))))
    if path_cum is not None and cfg.icp.odom_consistency_frac > 0:
        k = num_kfs - 1
        rel_graph = geo.se2_between(poses_se2[center], poses_se2[k])
        disagree = torch.linalg.norm(res.rel_pose[:, :2] - rel_graph[:, :2], dim=-1)
        path = torch.abs(path_cum[k] - path_cum[center])
        allowed = cfg.icp.odom_consistency_abs + cfg.icp.odom_consistency_frac * path
        consistent = disagree <= allowed
        if session_start is not None:
            consistent = consistent | ((center < session_start) & (k >= session_start))
        res = res._replace(accepted=res.accepted & consistent)
    return res


def _write_rows(bank: torch.Tensor, bank_start: int, k0: int, rows: torch.Tensor) -> None:
    """Write ``rows`` at global rows k0, k0 + 1, ... of a bank whose row 0 is
    global row ``bank_start`` (a mesh rank's block; 0 for the whole bank),
    keeping only the rows it holds."""
    lo = max(k0, bank_start)
    hi = min(k0 + rows.shape[0], bank_start + bank.shape[0])
    if lo < hi:
        bank[lo - bank_start:hi - bank_start] = rows[lo - k0:hi - k0]


def _kf_step_body(cfg: SlamConfig, clouds, clouds_valid, bank, ring_keys,
                  g: pg.GraphArrays, k: int, xy, valid, odo_pose_se2, prev_odo_se2,
                  has_odom: bool, do_detect: bool, session_start: int,
                  bank_start: int = 0, detect=None):
    """One keyframe: voxel filter, ScanContext descriptor, bank / cloud /
    graph insert (in place, at slot ``k``; the bank row only where
    ``bank`` holds it, its row 0 being global row ``bank_start``), then on
    ``do_detect`` loop detection and candidate verification.  ``detect``
    (desc, bank, num_kf) -> LoopCandidate replaces the whole-bank
    detectors (the mesh engine's sharded search).

    Returns (clouds, clouds_valid, bank, ring_keys, g, desc, cand, res)."""
    valid = voxel_dedup_mask(xy, valid, cfg.keyframes.keyframe_voxel_size)
    desc = sc_ops.make_scancontext(xy, torch.zeros(xy.shape[0], device=xy.device),
                                   valid, cfg.scancontext)
    clouds[k] = xy
    clouds_valid[k] = valid
    _write_rows(bank, bank_start, k, desc[None])
    ring_keys[k] = sc_ops.ring_key(desc)

    # iSAM2 init semantics: the optimized previous pose composed with the
    # odometry increment; node 0 / session starts take the absolute pose
    meas = geo.se2_to_se3(geo.se2_between(prev_odo_se2, odo_pose_se2))
    if has_odom:
        g.poses[k] = geo.se3_mul(g.poses[max(k - 1, 0)], meas)
        g.odom_meas[k] = meas
    else:
        g.poses[k] = geo.se2_to_se3(odo_pose_se2)
        g.odom_meas[k] = torch.eye(4, device=meas.device)
    g.odom_valid[k] = has_odom
    g = g._replace(num_nodes=torch.tensor(k + 1, device=g.poses.device))

    num_kf = k + 1
    dev = xy.device
    if not do_detect:
        return (clouds, clouds_valid, bank, ring_keys, g, desc,
                _empty_candidate(dev), _empty_icp_result(dev))
    poses_se2 = geo.se3_to_se2(g.poses)
    if detect is not None:
        cand = detect(desc, bank, num_kf)
    elif cfg.scancontext.search_mode == "ringkey":
        cand = sc_ops.detect_loop_ringkey(desc, bank, ring_keys, num_kf, cfg.scancontext)
    else:
        cand = sc_ops.detect_loop(desc, bank, num_kf, cfg.scancontext)
    res = _verify_candidate(cand, clouds, clouds_valid, poses_se2, xy, valid, num_kf,
                            cfg, path_cum=_odom_path_cum(g), session_start=session_start)
    return clouds, clouds_valid, bank, ring_keys, g, desc, cand, res


def _kf_segment_body(cfg: SlamConfig, T: int, with_detect: bool, clouds, clouds_valid,
                     bank, ring_keys, g: pg.GraphArrays, k0: int, m: int,
                     sel: torch.Tensor, xys: torch.Tensor, valids: torch.Tensor,
                     odo_poses: torch.Tensor, prev_odos: torch.Tensor, has_odoms: List[bool],
                     gps_alts: torch.Tensor, gps_has: torch.Tensor, session_start: int,
                     bank_start: int = 0, detect_multi=None):
    """One segment of T keyframe slots, k0 .. k0 + T - 1, of which the first
    ``m`` are real (counterpart of the program ``_make_kf_segment`` builds):
    batched inserts, then, with ``with_detect``, detection and verification
    of all T slots against the final banks, slot t seeing num_kf = k0 + t + 1
    (its sequential visibility; poses do not change inside a segment).

    The JAX ``dynamic_update_slice``s are slice assignments here, in place.
    sel (T,) picks each slot's scan of the chunk's xys (S, K, 2) / valids
    (S, K); odo_poses / prev_odos (T, 3), has_odoms (host bools), gps_alts
    (T,) datum-relative and gps_has (T,).  Inactive tail slots are masked
    all-invalid and write scratch rows past the real keyframes, which a
    later insert overwrites.  The pose inits chain slot by slot on the
    device, each from (3,)-shaped inputs as ``_kf_step_body`` takes them, so
    the rows are the per-scan path's bit for bit; the GPS rows take the
    shifted chain (slot t the pose of slot t - 1, slot 0 the last optimized
    pose before the segment), which is what the per-scan path reads as the
    last estimate.  One K2-T call for the segment, one K3-T call per ICP
    iteration plus the final fitness; no host read but the T-slot ICP's
    convergence check.

    On a mesh, ``bank`` is the rank's block (row 0 = global row
    ``bank_start``) and ``detect_multi`` (queries, bank, num_valids) ->
    LoopCandidate is the sharded search, given each active slot's
    keyframe count (the inactive tail repeats the last active slot's).

    Returns (clouds, clouds_valid, bank, ring_keys, g, cands, ress,
    last_pose), cands and ress with (T,) leaves."""
    dev = xys.device
    active = torch.arange(T, device=dev) < m
    q_xy = xys[sel]                                                    # (T, K, 2)
    q_valid = valids[sel] & active[:, None]
    q_valid = voxel_dedup_mask(q_xy, q_valid, cfg.keyframes.keyframe_voxel_size)
    descs = sc_ops.make_scancontext(q_xy, torch.zeros(q_xy.shape[1], device=dev), q_valid,
                                    cfg.scancontext)
    rows = slice(k0, k0 + T)
    clouds[rows] = q_xy
    clouds_valid[rows] = q_valid
    _write_rows(bank, bank_start, k0, descs)
    ring_keys[rows] = sc_ops.ring_key(descs)

    # graph rows: odometry measurements and chained pose inits
    prev0 = g.poses[max(k0 - 1, 0)]
    prev, inits, meas_rows = prev0, [], []
    eye = torch.eye(4, device=dev)
    for t in range(T):
        meas = geo.se2_to_se3(geo.se2_between(prev_odos[t], odo_poses[t]))
        if has_odoms[t]:
            prev = geo.se3_mul(prev, meas)
        else:
            prev, meas = geo.se2_to_se3(odo_poses[t]), eye
        inits.append(prev)
        meas_rows.append(meas)
    inits = torch.stack(inits)
    g.poses[rows] = inits
    g.odom_meas[rows] = torch.stack(meas_rows)
    g.odom_valid[rows] = torch.as_tensor(has_odoms, device=dev)
    prev_xys = torch.cat([prev0[None, :2, 3], inits[:-1, :2, 3]])
    gps_rows = torch.cat([prev_xys, gps_alts[:, None]], dim=1).to(g.gps_meas.dtype)
    g.gps_meas[rows] = torch.where(gps_has[:, None], gps_rows, g.gps_meas[rows])
    g.gps_valid[rows] |= gps_has
    g = g._replace(num_nodes=torch.tensor(k0 + m, device=dev))

    if with_detect:
        poses_se2 = geo.se3_to_se2(g.poses)
        num_kfs = k0 + 1 + torch.arange(T, device=dev)
        if detect_multi is not None:
            cands = detect_multi(descs, bank, [k0 + min(t, max(m, 1) - 1) + 1 for t in range(T)])
        elif cfg.scancontext.search_mode == "ringkey":
            cands = sc_ops.detect_loop_ringkey_multi(descs, bank, ring_keys, k0,
                                                     cfg.scancontext)
        else:
            cands = sc_ops.detect_loop_multi(descs, bank, k0, m, cfg.scancontext)
        ress = _verify_candidate_multi(cands, clouds, clouds_valid, poses_se2, q_xy, q_valid,
                                       num_kfs, active, cfg, path_cum=_odom_path_cum(g),
                                       session_start=session_start)
    else:
        cands, ress = _empty_candidate(dev, (T,)), _empty_icp_result(dev, (T,))
    last_pose = geo.se3_to_se2(g.poses[k0 + m - 1])
    return clouds, clouds_valid, bank, ring_keys, g, cands, ress, last_pose


def _debug_submap(cfg: SlamConfig, clouds, clouds_valid, poses_se3, center: int, num_kf: int,
                  k: int) -> torch.Tensor:
    """The loop-debug artifact's clouds as ONE float32 vector [query xy |
    query valid | submap xy | submap valid], so a dump reads the device
    once: keyframe k's cloud and the ±submap_half_size submap around
    ``center`` rendered from the given poses."""
    sub_xy, sub_valid = _build_submap(
        clouds, clouds_valid, geo.se3_to_se2(poses_se3), center, num_kf,
        cfg.icp.submap_half_size, cfg.icp.max_target_points, cfg.icp.submap_voxel_size)
    f32 = torch.float32
    return torch.cat([clouds[k].reshape(-1), clouds_valid[k].to(f32), sub_xy.reshape(-1),
                      sub_valid.to(f32)])


def _render_map(clouds, clouds_valid, poses_se3, num_kf: int, stride: int) -> torch.Tensor:
    """Every ``stride``-th of the first ``num_kf`` keyframe clouds in the
    world frame of its pose: the valid points, (P, 2)."""
    idx = torch.arange(0, num_kf, stride, device=clouds.device)
    pts = geo.se2_apply(geo.se3_to_se2(poses_se3[idx]), clouds[idx]).reshape(-1, 2)
    return pts[clouds_valid[idx].reshape(-1)]


def _pack_odo(rels: torch.Tensor, oks: torch.Tensor, coast: torch.Tensor) -> torch.Tensor:
    """A chunk's odometry results as one float32 vector [rels | oks | coast]
    on the device, fetched with the pending decisions in one read."""
    f32 = torch.float32
    return torch.cat([rels.reshape(-1).to(f32), oks.to(f32), coast.reshape(1).to(f32)])


def _pack_decision(cand: sc_ops.LoopCandidate, res: icp_ops.IcpResult) -> torch.Tensor:
    """One float32 vector [found, accepted, idx, dist, fitness, rel(3), yaw]
    on the device, each leaf raveled (T of each for a segment's (T,)
    leaves, slot-major rel), so a flush fetches every queued decision at
    once."""
    f32 = torch.float32
    return torch.cat([x.reshape(-1).to(f32) for x in (
        cand.found, res.accepted, cand.idx, cand.dist, res.fitness, res.rel_pose,
        cand.yaw)])


class SlamEngine:
    """Host orchestrator of the SLAM paths on one ``device``, or on one rank
    of a ``mesh`` (``parallel.mesh.Mesh``; its device unless ``device``
    names the same one).  A mesh of size > 1 needs ``max_keyframes`` to
    divide its size; a mesh of size 1 runs the single-device engine."""

    def __init__(self, cfg: Optional[SlamConfig] = None,
                 device: Optional[torch.device | str] = None, mesh=None):
        self.cfg = c = cfg or SlamConfig()
        if device is None:
            device = mesh.device if mesh is not None else DEFAULT_DEVICE
        self.device = dev = resolve_device(device)
        #: the mesh as given; ``_sharded``: a mesh of more than one rank
        self.mesh = mesh
        self._sharded = mesh is not None and mesh.size > 1
        if mesh is not None and torch.device(mesh.device) != dev:
            raise ValueError(f"SlamEngine: device {dev} is not the mesh's {mesh.device}")
        if self._sharded and c.keyframes.max_keyframes % mesh.size != 0:
            raise ValueError("max_keyframes must divide the mesh size")
        self.odometry = RadarOdometry(c, device=dev)
        if self._sharded:
            self.odometry.agree = mesh.broadcast

        K, M = c.features.max_features, c.keyframes.max_keyframes
        R, S = c.scancontext.num_ring, c.scancontext.num_sector
        self.clouds = torch.zeros((M, K, 2), device=dev)
        self.clouds_valid = torch.zeros((M, K), dtype=torch.bool, device=dev)
        #: the descriptor bank: on a mesh this rank's block of rows, global
        #: row ``_bank_start`` first
        self._bank_start = mesh.block(M)[0] if self._sharded else 0
        self.bank = torch.zeros((M // mesh.size if self._sharded else M, R, S), device=dev)
        self.ring_keys = torch.zeros((M, R), device=dev)
        self.kf_times: List[float] = []

        self.graph = pg.PoseGraph(c.pgo, dev)
        self._make_solvers()
        #: host cache of the latest optimized keyframe pose, and the device
        #: slice it is read from (lazily)
        self._cur_pose: Optional[np.ndarray] = None
        self._cur_pose_dev: Optional[torch.Tensor] = None
        #: device work and fetches by the JAX engine's site names
        self.dispatch_counts = collections.Counter()
        self.num_keyframes = 0
        self.movement_accum = 1e6      # the first frame is always a keyframe
        self.last_kf_pose = np.zeros(3)
        self.loops: List[LoopEvent] = []
        #: raw (pre-PGO) odometry pose per keyframe
        self.odom_poses: List[np.ndarray] = []
        self.num_scans = 0
        self._pending_gps: Optional[np.ndarray] = None
        #: first GPS-bearing keyframe's altitude, latched as the datum
        self.gps_alt_offset: Optional[float] = None
        #: deferred loop decisions, fetched and committed once
        #: loop_commit_defer are queued or an output consumer drains them.
        #: Entries are (ks, slots, packed): a keyframe's (k,), None and its
        #: packed vector; a segment's detecting keyframes, their slots and
        #: the packed (T,) leaves.  ``packed`` is a device tensor until a
        #: finish_chunk fetch brings it to the host with the odometry.
        self._pending_loops: List[Tuple[tuple, Optional[tuple], object]] = []
        #: queued decisions (a segment entry holds several)
        self._pending_count = 0
        #: (times, alts) of set_gps_table, for chunk mode; None: add_gps only
        self._gps_table: Optional[Tuple[np.ndarray, np.ndarray]] = None
        #: chunks begun but not finished, and the odometry twist and coast
        #: chained between them on the device
        self._inflight: collections.deque = collections.deque()
        self._twist_dev: Optional[torch.Tensor] = None
        self._coast_dev: Optional[torch.Tensor] = None
        self._seq = None
        #: first keyframe of the current session (>0 after a prior session
        #: was attached: the graph has no odometry factor across it)
        self.session_start = 0
        #: False while an attached prior session awaits the first
        #: inter-session loop, which rebases the current session
        self._rebased = True
        #: optional utils.profiling.StageTimers: the per-stage split the CLI
        #: reports, under the JAX engine's stage names
        self.timers = None
        #: when set, every fetched loop decision that found a candidate
        #: writes loop_<k>_<accepted|rejected>.npz here (_dump_loop_debug)
        self.loop_debug_dir: Optional[str] = None

    @contextlib.contextmanager
    def _stage(self, name: str):
        if self.timers is None:
            yield
        else:
            with self.timers.time(name):
                yield

    def _make_solvers(self):
        # fast per-keyframe refine (one GN iteration) vs full solve after
        # new loops: the iSAM2-like warm-started pattern
        fast = dataclasses.replace(self.cfg.pgo, gn_iters=1)
        if self._sharded:
            from navtech_radar_slam_torch.parallel import dist_pgo, sharded_bank

            self._solve_fast = dist_pgo.make_bucketed_distributed_solver(self.mesh, fast)
            self._solve_full = dist_pgo.make_bucketed_distributed_solver(self.mesh,
                                                                         self.cfg.pgo)
            args = (self.mesh, self.cfg.scancontext, self.cfg.parallel.shard_top_k)
            self._sharded_detect = sharded_bank.make_sharded_loop_detector(*args)
            self._sharded_detect_batch = sharded_bank.make_sharded_loop_detector_batch(*args)
        else:
            self._solve_fast = pg.make_bucketed_solver(fast)
            self._solve_full = pg.make_bucketed_solver(self.cfg.pgo)
            self._sharded_detect = self._sharded_detect_batch = None

    def _agree(self, x: torch.Tensor) -> torch.Tensor:
        """A packet the host is about to read: rank 0's on a mesh."""
        return self.mesh.broadcast(x) if self._sharded else x

    def bank_whole(self) -> torch.Tensor:
        """The whole descriptor bank (M, R, S); on a mesh gathered from every
        rank's block (a collective: every rank calls it)."""
        return self.mesh.gather_rows(self.bank) if self._sharded else self.bank

    def set_bank_whole(self, bank: torch.Tensor) -> None:
        """Hold ``bank`` (M, R, S) on the engine's device, or on a mesh this
        rank's block of it (a copy, so that the whole one is freed)."""
        bank = bank.to(self.device)
        if self._sharded:
            lo, hi = self.mesh.block(bank.shape[0])
            self._bank_start = lo
            bank = bank[lo:hi].clone()
        self.bank = bank

    # -- multi-session ------------------------------------------------------

    def attach_prior_session(self, checkpoint_path: str):
        """Load a previous session's checkpoint (``utils.checkpoint.
        save_engine``'s file, or the JAX package's) as a searchable prior
        map, before the first scan.

        The prior keyframes become graph nodes with their clouds, bank rows
        and ring keys; the odometry factors are derived again from the
        prior's optimised poses, and its loop and GPS factors (with its
        altitude datum) are carried over, so the prior stays rigid under the
        merged solve.  All of it is written with batched tensor ops.  The
        sessions are joined by the first accepted inter-session loop, which
        rebases the current session into the prior's frame
        (``_rebase_session``)."""
        if self.num_keyframes != 0:
            raise RuntimeError("attach_prior_session before processing scans")
        z = np.load(checkpoint_path, allow_pickle=False)
        n = int(z["num_keyframes"])
        cap = self.cfg.keyframes.max_keyframes
        if n >= cap:
            raise RuntimeError(f"prior session ({n} kf) exceeds capacity {cap}")
        n_loops = int(z["num_loops"]) if "num_loops" in z else 0
        if self.graph.num_loops + n_loops >= self.cfg.pgo.max_loop_edges:
            raise RuntimeError(f"prior session's {n_loops} loop factors exceed "
                               f"max_loop_edges {self.cfg.pgo.max_loop_edges}")

        def dev(name, rows, dtype=torch.float32):
            return torch.as_tensor(np.asarray(z[name][:rows]), dtype=dtype, device=self.device)

        self.clouds[:n] = dev("clouds", n)
        self.clouds_valid[:n] = dev("clouds_valid", n, torch.bool)
        _write_rows(self.bank, self._bank_start, 0, dev("bank", n))
        self.ring_keys[:n] = dev("ring_keys", n)
        self.kf_times = [float(x) for x in np.asarray(z["kf_times"][:n])]
        poses = dev("graph_poses", n)
        self.odom_poses = list(geo.se3_to_se2(poses).cpu().numpy().astype(np.float64))

        g = self.graph.g
        g.poses[:n] = poses
        g.odom_meas[1:n] = geo.se3_between(poses[:-1], poses[1:])
        g.odom_valid[1:n] = True
        if n_loops:
            # checkpoints from before loop-factor persistence carry no
            # graph_loop_* keys (num_loops is then absent too)
            g.loop_i[:n_loops] = dev("graph_loop_i", n_loops, torch.int64)
            g.loop_j[:n_loops] = dev("graph_loop_j", n_loops, torch.int64)
            g.loop_meas[:n_loops] = dev("graph_loop_meas", n_loops)
            g.loop_valid[:n_loops] = True
        if "graph_gps_valid" in z and np.asarray(z["graph_gps_valid"][:n]).any():
            g.gps_meas[:n] = dev("graph_gps_meas", n)
            g.gps_valid[:n] = dev("graph_gps_valid", n, torch.bool)
        self.graph.g = g._replace(num_nodes=torch.tensor(n, device=self.device))
        self.graph.num_nodes = n
        self.graph.num_loops = n_loops
        # the new session's fixes stay in the prior's relative-altitude frame
        if "gps_alt_offset" in z and not np.isnan(float(z["gps_alt_offset"])):
            self.gps_alt_offset = float(z["gps_alt_offset"])
        self.num_keyframes = n
        self.session_start = n
        self._rebased = False
        self._cur_pose = None
        self._cur_pose_dev = None

    def _rebase_session(self, prior_idx: int, curr_idx: int, loop_meas: np.ndarray):
        """The first inter-session loop: move the whole current session
        rigidly so that the loop's residual starts near zero (a robust solve
        cannot pull a chain across a frame-sized gap on its own)."""
        poses = self.graph.g.poses
        meas = torch.as_tensor(loop_meas, dtype=poses.dtype, device=poses.device)
        target = geo.se3_mul(poses[prior_idx], meas)
        align = geo.se3_mul(target, geo.se3_inv(poses[curr_idx]))
        s, n = self.session_start, self.num_keyframes
        poses[s:n] = geo.se3_mul(align, poses[s:n])
        self._rebased = True

    # -- per-scan entry -----------------------------------------------------

    def add_gps(self, xyz: np.ndarray):
        """Associate a GPS fix with the next keyframe.  Only xyz[2] (absolute
        altitude) is used: the first fix latches the datum and factors
        constrain altitude - datum, xy taken from the last optimized
        estimate."""
        self._pending_gps = np.asarray(xyz, np.float64)

    def set_gps_table(self, times: np.ndarray, alts: np.ndarray):
        """Register the run's GPS stream for chunk mode: each keyframe of a
        chunk takes the first fix within pgo.gps_time_window of its
        timestamp, and the segments write the factors on the device, the
        same as the per-scan add_gps() path writes them.  ``times``
        ascending; ``alts`` absolute (the first associated fix latches the
        datum, as in add_gps)."""
        self._gps_table = (np.asarray(times, np.float64), np.asarray(alts, np.float64))

    def _associate_gps(self, ts: float) -> Optional[float]:
        """First fix within gps_time_window of ``ts`` among the neighbours of
        its insertion point, or None."""
        times, alts = self._gps_table
        j = int(np.searchsorted(times, ts))
        for cand in (j - 1, j):
            if 0 <= cand < len(times) and abs(times[cand] - ts) < self.cfg.pgo.gps_time_window:
                return float(alts[cand])
        return None

    def process(self, power, azimuths=None, timestamp: float = 0.0, ray_valid=None,
                packed: bool = False) -> np.ndarray:
        """Feed one polar scan (float32, uint8, or with ``packed`` the 4-bit
        wire format); returns the current optimized pose [x, y, theta].

        ``ray_valid``: optional (NA,) per-azimuth validity; invalid rays are
        zeroed on the device before feature extraction.  Chunks still in
        flight are finished first; the step then advances the host carry,
        so the next chunk re-seeds its twist and coast from it."""
        if self._inflight:
            self.drain_chunks()
        self._twist_dev = None
        self._coast_dev = None
        c = self.cfg
        pose, feats = self.odometry.process(power, azimuths, ray_valid=ray_valid,
                                            packed=packed)
        self.num_scans += 1
        if self.num_scans == 1:
            self._add_keyframe(pose, feats.xy, feats.valid, timestamp)
            return self._pose_estimate()
        if self.odometry.last_result is None:
            # first scan after a resume: the odometry carry was re-seeded,
            # there is no relative motion yet
            return self._pose_estimate()
        # keyframe gate: integrate the increment applied to the odometry pose
        rel = self.odometry.last_applied_rel
        self.movement_accum += float(np.hypot(rel[0], rel[1]))
        if self.movement_accum > c.keyframes.keyframe_meter_gap:
            self._add_keyframe(pose, feats.xy, feats.valid, timestamp)
            self.movement_accum = 0.0
        return self._pose_estimate()

    # -- chunk (streaming) entry ---------------------------------------------

    def process_chunk(self, powers, azimuths=None, timestamps=None, ray_valids=None,
                      packed: bool = False) -> None:
        """Feed S consecutive scans (S, NA, NB) at once: ``begin_chunk`` and
        ``finish_chunk`` back to back.  Equivalent to S ``process`` calls
        (the same gate, coast fallback and keyframes); returns nothing, since
        a pose fetch would wait on the chunk's keyframe work: call
        ``current_pose()``.  GPS: ``set_gps_table``; a pending ``add_gps``
        fix attaches to the chunk's first keyframe."""
        self.begin_chunk(powers, azimuths, timestamps, ray_valids, packed)
        self.finish_chunk()

    @property
    def inflight_chunks(self) -> int:
        """Chunks begun but not yet finished."""
        return len(self._inflight)

    def begin_chunk(self, powers, azimuths=None, timestamps=None, ray_valids=None,
                    packed: bool = False) -> None:
        """Queue a chunk's odometry on the device without fetching its
        results; pair each call with one ``finish_chunk()`` (first in, first
        out).  The odometry carry (features, twist, coast) chains between
        chunks on the device, so chunk t + 1 can be queued before chunk t's
        results reach the host.

        ``azimuths``: (NA,) shared or (S, NA) per scan; ``ray_valids``:
        optional (S, NA) per-azimuth validity; ``packed``: the 4-bit wire
        format, as in ``process``."""
        if self._pending_gps is not None and self.cfg.pgo.use_gps:
            warnings.warn("chunk streaming with a pending GPS fix: it attaches to the "
                          "chunk's first keyframe (per-scan association needs "
                          "process(), chunked association set_gps_table())",
                          stacklevel=2)
        odo = self.odometry
        powers = odo._to_device(powers)
        n_scans = powers.shape[0]
        timestamps = [0.0] * n_scans if timestamps is None else list(timestamps)
        az = odo._az_dev if azimuths is None else odo._to_device(azimuths)
        if ray_valids is not None:
            ray_valids = odo._to_device(ray_valids)
        if self._seq is None:
            self._seq = make_odometry_sequence(self.cfg, return_features=True)
        # scan 0 seeds the carry when there is none, then registers against
        # itself inside the chunk; it is the first keyframe only at a fresh
        # start (no scan counted yet), after a resume it only re-seeds, as in
        # process()
        seeded = odo.prev is None
        fresh_start = seeded and self.num_scans == 0
        if seeded:
            odo.prev = extract_scan_features(
                powers[0], az[0] if az.dim() == 2 else az, self.cfg,
                None if ray_valids is None else ray_valids[0], packed)
        twist_in = self._twist_dev
        if twist_in is None:
            twist_in = torch.as_tensor(odo.last_rel, dtype=torch.float32, device=self.device)
        coast_in = self._coast_dev
        if coast_in is None:
            coast_in = torch.as_tensor(odo._coast, dtype=torch.int64, device=self.device)
        self.dispatch_counts["odometry_seq"] += 1
        with self._stage("odometry_seq"):
            (odo.prev, self._twist_dev, self._coast_dev, rels, oks, _, xys,
             valids) = self._seq(powers, az, odo.prev, twist_in, coast_in,
                                 ray_valids=ray_valids, packed=packed)
            # packed now, right behind the chunk's odometry on the stream
            packed_odo = _pack_odo(rels, oks, self._coast_dev)
        self._inflight.append((n_scans, timestamps, seeded, fresh_start, packed_odo,
                               xys, valids))

    def finish_chunk(self) -> int:
        """Fetch the oldest in-flight chunk's odometry results and run its
        keyframe work (gate, segments, loop commits).  Returns the number of
        scans it processed."""
        if not self._inflight:
            return 0
        (n_scans, timestamps, seeded, fresh_start, packed_odo, xys,
         valids) = self._inflight.popleft()
        c = self.cfg
        odo = self.odometry
        # ONE fetch: the odometry vector and every pending decision pack
        self.dispatch_counts["pack_odo_fetch"] += 1
        pend = [i for i, (_, _, pk) in enumerate(self._pending_loops)
                if isinstance(pk, torch.Tensor)]
        parts = [packed_odo] + [self._pending_loops[i][2] for i in pend]
        with self._stage("odo_fetch"):
            host = self._agree(torch.cat(parts)).cpu().numpy()
        sizes = np.cumsum([x.numel() for x in parts])[:-1]
        p, *decisions = np.split(host, sizes)
        for i, h in zip(pend, decisions):
            ks, slots, _ = self._pending_loops[i]
            self._pending_loops[i] = (ks, slots, h)
        rels = np.asarray(p[:3 * n_scans].reshape(n_scans, 3), np.float64)
        oks = p[3 * n_scans:4 * n_scans] > 0.5
        kfs = []   # (scan index, odometry pose after the scan, timestamp)
        for i in range(n_scans):
            odo.num_scans += 1
            self.num_scans += 1
            if seeded and i == 0:
                # scan 0 only (re)seeded the carry; at a fresh start it is
                # also the first keyframe (movement_accum stays 1e6, so the
                # next scan passes the gate too)
                if fresh_start:
                    kfs.append((0, odo.pose.copy(), timestamps[0]))
                continue
            ok = bool(oks[i])
            odo.last_ok = ok
            if not ok:
                odo.num_failures += 1
            rel = rels[i]
            odo.last_rel = rel.copy()
            odo.last_applied_rel = rel.copy()
            odo.pose = geo.se2_mul_np(odo.pose, rel)
            self.movement_accum += float(np.hypot(rel[0], rel[1]))
            if self.movement_accum > c.keyframes.keyframe_meter_gap:
                kfs.append((i, odo.pose.copy(), timestamps[i]))
                self.movement_accum = 0.0
        odo._coast = int(p[4 * n_scans])
        if kfs:
            gps_alts = None
            if self._gps_table is not None and c.pgo.use_gps:
                # per-keyframe association and the datum latch, in order
                gps_alts = []
                for _, _, ts in kfs:
                    alt = self._associate_gps(ts)
                    if alt is not None and self.gps_alt_offset is None:
                        self.gps_alt_offset = alt
                    gps_alts.append(alt)
            self._process_keyframes(kfs, xys, valids, gps_alts)
        return n_scans

    def drain_chunks(self) -> None:
        """Finish every in-flight chunk (output consumers call this)."""
        while self._inflight:
            self.finish_chunk()

    # -- keyframe path ------------------------------------------------------

    def _grow_capacity(self):
        """Double the keyframe and graph capacity, padding the banks."""
        c = self.cfg
        old_cap = c.keyframes.max_keyframes
        self.cfg = c = c.replace(
            keyframes=dataclasses.replace(c.keyframes, max_keyframes=2 * old_cap),
            pgo=dataclasses.replace(c.pgo, max_nodes=2 * c.pgo.max_nodes,
                                    max_loop_edges=2 * c.pgo.max_loop_edges),
        )
        # on a mesh every block boundary moves: the bank is gathered whole,
        # padded, and each rank keeps its new block
        for name in ("clouds", "clouds_valid", "bank", "ring_keys"):
            old = self.bank_whole() if name == "bank" else getattr(self, name)
            new = torch.zeros((2 * old_cap,) + old.shape[1:], dtype=old.dtype,
                              device=old.device)
            new[:old_cap] = old
            if name == "bank":
                self.set_bank_whole(new)
            else:
                setattr(self, name, new)
        self.graph.grow(c.pgo.max_nodes, c.pgo.max_loop_edges)
        self._make_solvers()

    def _process_keyframes(self, kfs, xys: torch.Tensor, valids: torch.Tensor,
                           gps_alts=None):
        """A chunk's keyframes with as few device programs as the per-scan
        semantics allow: runs of keyframes go to one segment each
        (``_dispatch_segment``); a keyframe takes the per-keyframe path
        (``_add_keyframe``) where the segment cannot reproduce the per-scan
        result: a pending add_gps() fix, a deferred drain due before it, a
        capacity flush or growth, an in-line fast refine.  The state is the
        per-keyframe path's.

        ``kfs``: [(scan index, odometry pose, timestamp)]; ``xys`` /
        ``valids``: the chunk's (S, K, 2) / (S, K) features on the device;
        ``gps_alts``: per keyframe an absolute altitude or None."""
        idx, n = 0, len(kfs)
        while idx < n:
            # re-read: a per-keyframe step below may have grown the capacity
            c = self.cfg
            det_n = c.scancontext.detect_every_n_keyframes
            i, odo_pose, ts = kfs[idx]
            if self._pending_gps is not None and c.pgo.use_gps:
                # the add_gps() fix goes with this keyframe; it wins over a
                # table fix (a node carries at most one GPS factor)
                self._add_keyframe(odo_pose, xys[i], valids[i], ts)
                idx += 1
                continue
            has_gps_here = gps_alts is not None and gps_alts[idx] is not None
            # grow the segment until the per-scan semantics need a host step
            t_max = self._segment_bucket(n - idx)
            seg = []   # (kfs index, do_detect)
            pend = self._pending_count
            k_sim = self.num_keyframes
            loops_now = self.graph.num_loops
            while idx + len(seg) < n and len(seg) < t_max:
                if pend >= c.pgo.loop_commit_defer:
                    break   # a drain must precede this keyframe
                if (k_sim >= c.keyframes.max_keyframes - 1
                        or loops_now + pend >= c.pgo.max_loop_edges - 2):
                    break   # capacity flush or growth: per-keyframe path
                do_det = bool(c.do_slam and (k_sim + 1) % det_n == 0
                              and (k_sim + 1) > c.scancontext.num_exclude_recent)
                if c.do_slam and (k_sim + 1) % det_n != 0 and loops_now > 0:
                    break   # in-line fast refine: per-keyframe path
                seg.append((idx + len(seg), do_det))
                pend += do_det
                k_sim += 1
            # the segment writes rows [k0, k0 + bucket): near capacity, shrink
            # it until its bucket fits
            cap_rows = min(c.keyframes.max_keyframes, c.pgo.max_nodes)
            while seg and self.num_keyframes + self._segment_bucket(len(seg)) > cap_rows:
                seg.pop()
            if not seg:
                if self._pending_count >= c.pgo.loop_commit_defer:
                    # drain where the per-scan path would, then retry
                    self._flush_pending_loop()
                    continue
                if has_gps_here:
                    # a table fix on a per-keyframe step: the per-scan attach
                    # (the datum is latched already)
                    self.add_gps(np.array([0.0, 0.0, gps_alts[idx]]))
                self._add_keyframe(odo_pose, xys[i], valids[i], ts)
                idx += 1
                continue
            self._dispatch_segment(seg, kfs, xys, valids, gps_alts)
            idx += len(seg)

    def prewarm(self, expected_keyframes: int, chunk: int = 16,
                per_scan_azimuths: bool = False, full: bool = True,
                live_outputs: bool = False, pack4: bool = False):
        """Run every program of the streamed path once before real scans
        arrive, one after another, leaving the engine state as it was bit
        for bit: the writes go to scratch copies of the banks and graph.

        Eager PyTorch compiles nothing, so what this warms is what a first
        call pays: on the card the three kernel libraries (built by nvcc on
        a cold ``_build/``, then loaded), the CUDA context, cuBLAS handles
        and the caching allocator's blocks.  It runs the odometry seed and
        chunk sequence on ``chunk`` zero scans (uint8, or the 4-bit wire
        format with ``pack4``; with ``per_scan_azimuths`` per-scan azimuths
        and ray validity, as the CLI feeds), and with ``full`` every solver
        bucket up to ``expected_keyframes + chunk`` nodes; the segment
        buckets up to ``chunk`` slots with no active slot, the packers, the
        per-keyframe step, the map render with ``live_outputs`` and the
        debug-submap render when ``loop_debug_dir`` is set.  ``full=False``
        runs only what depends on the chunk length (for a last, shorter
        chunk)."""
        c = self.cfg
        dev = self.device
        if dev.type == "cuda":
            for kern in (cen_peaks, sc_corr, nn_dist):
                kern.LIBRARY.start()   # nvcc for all three at once
            for kern in (cen_peaks, sc_corr, nn_dist):
                kern.LIBRARY.load()
        k_feats = c.features.max_features
        na, nb = c.radar.num_azimuths, c.radar.padded_range_bins
        if pack4:
            nb //= 2
        clouds, clouds_valid, bank, ring_keys = (
            x.clone() for x in (self.clouds, self.clouds_valid, self.bank, self.ring_keys))
        g = pg.GraphArrays(*(x.clone() for x in self.graph.g))

        if full:
            cap = min(expected_keyframes + chunk, c.pgo.max_nodes)
            nodes, n_loops = 64, max(self.graph.num_loops, 1)
            while True:
                for solver in (self._solve_fast, self._solve_full):
                    solver(g, nodes, n_loops)
                if nodes >= cap:
                    break
                nodes = min(2 * nodes, cap)

        powers = torch.zeros((chunk, na, nb), dtype=torch.uint8, device=dev)
        az = self.odometry._az_dev
        ray_valids = None
        if per_scan_azimuths:
            az = az.expand(chunk, na)
            ray_valids = torch.ones((chunk, na), dtype=torch.bool, device=dev)
        if self._seq is None:
            self._seq = make_odometry_sequence(c, return_features=True)
        carry = extract_scan_features(powers[0], az[0] if per_scan_azimuths else az, c,
                                      None if ray_valids is None else ray_valids[0], pack4)
        out = self._seq(powers, az, carry, torch.zeros(3, device=dev),
                        torch.zeros((), dtype=torch.int64, device=dev),
                        ray_valids=ray_valids, packed=pack4)
        _pack_odo(out[3], out[4], out[2])

        xys = torch.zeros((chunk, k_feats, 2), device=dev)
        valids = torch.zeros((chunk, k_feats), dtype=torch.bool, device=dev)
        cap_rows = min(c.keyframes.max_keyframes, c.pgo.max_nodes)
        top = self._segment_bucket(chunk)
        tp = 1
        while True:
            tp = min(tp, top)
            # no active slot: every row the segment writes is scratch
            k0 = min(self.num_keyframes, cap_rows - tp)
            zeros3 = torch.zeros((tp, 3), device=dev)
            for det in ((True, False) if c.do_slam else (False,)):
                self._get_segment(tp, det)(
                    clouds, clouds_valid, bank, ring_keys, g, k0, 0,
                    torch.zeros(tp, dtype=torch.int64, device=dev), xys, valids, zeros3,
                    zeros3, [False] * tp, torch.zeros(tp, device=dev),
                    torch.zeros(tp, dtype=torch.bool, device=dev), self.session_start,
                    self._bank_start, self._sharded_detect_batch)
            _pack_decision(_empty_candidate(dev, (tp,)), _empty_icp_result(dev, (tp,)))
            if tp >= top:
                break
            tp *= 2
        _pack_decision(_empty_candidate(dev), _empty_icp_result(dev))
        if full and self.loop_debug_dir is not None:
            _debug_submap(c, clouds, clouds_valid, g.poses, 0, 1, 0)
        if full and live_outputs:
            _render_map(clouds, clouds_valid, g.poses, 1, c.map.keyframe_stride)
        if full:
            # the per-keyframe path (first keyframe, GPS, growth); on a mesh
            # with its sharded search and verification (JAX's
            # warm_mesh_fallback)
            zero3 = torch.zeros(3, device=dev)
            _kf_step_body(c, clouds, clouds_valid, bank, ring_keys, g,
                          min(self.num_keyframes, cap_rows - 1), xys[0], valids[0], zero3,
                          zero3, False, self._sharded and c.do_slam, self.session_start,
                          self._bank_start, self._sharded_detect)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @staticmethod
    def _segment_bucket(m: int) -> int:
        """Segment slot counts: powers of two up to 16 (the JAX engine's
        compile buckets), inactive tail slots masked."""
        return min(16, 1 << (max(m, 1) - 1).bit_length())

    def _get_segment(self, Tp: int, with_detect: bool):
        """The segment program of ``Tp`` slots: with detection when a slot
        detects, insert-only otherwise (its slots' results would go unread).
        Nothing is compiled here, unlike the JAX engine."""
        return functools.partial(_kf_segment_body, self.cfg, Tp, with_detect)

    def _dispatch_segment(self, seg, kfs, xys, valids, gps_alts=None):
        """One segment for the keyframes ``seg`` [(kfs index, do_detect)],
        plus the host bookkeeping ``_add_keyframe`` does per keyframe."""
        m = len(seg)
        Tp = self._segment_bucket(m)
        k0 = self.num_keyframes
        sel = np.zeros(Tp, np.int64)
        odo_arr = np.zeros((Tp, 3), np.float32)
        prev_arr = np.zeros((Tp, 3), np.float32)
        has = [False] * Tp
        gps_arr = np.zeros(Tp, np.float32)
        gps_has = np.zeros(Tp, bool)
        prev_pose = self.last_kf_pose
        ks_det, slots_det = [], []
        for t, (j, do_det) in enumerate(seg):
            i, odo_pose, ts = kfs[j]
            sel[t] = i
            odo_arr[t] = odo_pose
            prev_arr[t] = prev_pose
            has[t] = not (k0 + t == 0 or k0 + t == self.session_start)
            if gps_alts is not None and gps_alts[j] is not None and k0 + t > 0:
                # node 0 carries no GPS factor; the datum is latched
                gps_arr[t] = np.float64(gps_alts[j]) - self.gps_alt_offset
                gps_has[t] = True
            if do_det:
                ks_det.append(k0 + t)
                slots_det.append(t)
            prev_pose = odo_pose
            self.kf_times.append(ts)
            self.odom_poses.append(odo_pose.copy())
        # the inactive tail: the last pose, an identity measurement
        odo_arr[m:] = prev_pose
        prev_arr[m:] = prev_pose
        prog = self._get_segment(Tp, bool(ks_det))
        self.dispatch_counts["kf_segment"] += 1

        def dev(x):
            return torch.as_tensor(x, device=self.device)

        with self._stage("kf_segment"):
            (self.clouds, self.clouds_valid, self.bank, self.ring_keys, self.graph.g, cands,
             ress, pose_dev) = prog(
                self.clouds, self.clouds_valid, self.bank, self.ring_keys, self.graph.g, k0,
                m, dev(sel), xys, valids, dev(odo_arr), dev(prev_arr), has, dev(gps_arr),
                dev(gps_has), self.session_start, self._bank_start,
                self._sharded_detect_batch)
        self.num_keyframes = k0 + m
        self.graph.num_nodes = k0 + m
        self.last_kf_pose = np.asarray(prev_pose, np.float64).copy()
        if ks_det:
            # packed now, right behind the segment on the stream
            self._pending_loops.append((tuple(ks_det), tuple(slots_det),
                                        _pack_decision(cands, ress)))
            self._pending_count += len(ks_det)
        self._cur_pose_dev = pose_dev
        self._cur_pose = None

    def _add_keyframe(self, odo_pose: np.ndarray, xy: torch.Tensor,
                      valid: torch.Tensor, timestamp: float):
        # drain deferred decisions once the queue reaches its depth
        if self._pending_count >= self.cfg.pgo.loop_commit_defer:
            self._flush_pending_loop()
        c = self.cfg
        k = self.num_keyframes
        # growth margin: every queued decision may commit one more loop
        if k >= c.keyframes.max_keyframes - 1 or (
                self.graph.num_loops + self._pending_count >= c.pgo.max_loop_edges - 2):
            self._flush_pending_loop()
            if (self.num_keyframes >= self.cfg.keyframes.max_keyframes - 1
                    or self.graph.num_loops >= self.cfg.pgo.max_loop_edges - 2):
                self._grow_capacity()
            c = self.cfg

        self.kf_times.append(timestamp)
        self.odom_poses.append(odo_pose.copy())
        has_odom = not (k == 0 or k == self.session_start)
        do_detect = bool(
            c.do_slam
            and (k + 1) % c.scancontext.detect_every_n_keyframes == 0
            and (k + 1) > c.scancontext.num_exclude_recent
        )
        if self._sharded:
            # JAX's mesh path: the insert (voxel mask, descriptor, insert),
            # then the sharded search and the verification
            self.dispatch_counts["kf_insert_split"] += 3
            if do_detect:
                self.dispatch_counts["sharded_detect"] += 1
                self.dispatch_counts["verify"] += 1
            self.dispatch_counts["pose_slice"] += 1
        else:
            self.dispatch_counts["kf_step"] += 1
        f32 = dict(dtype=torch.float32, device=self.device)
        with self._stage("kf_step"):
            (self.clouds, self.clouds_valid, self.bank, self.ring_keys, self.graph.g,
             _, cand, res) = _kf_step_body(
                c, self.clouds, self.clouds_valid, self.bank, self.ring_keys,
                self.graph.g, k, xy, valid, torch.tensor(odo_pose, **f32),
                torch.tensor(self.last_kf_pose, **f32), has_odom, do_detect,
                self.session_start, self._bank_start, self._sharded_detect)
            pose_dev = geo.se3_to_se2(self.graph.g.poses[k])
        self.graph.num_nodes = k + 1
        self.last_kf_pose = odo_pose.copy()
        if self._pending_gps is not None and c.pgo.use_gps:
            fix = self._pending_gps
            if self.gps_alt_offset is None:
                self.gps_alt_offset = float(fix[2])
            if k > 0:
                # node 0 carries no GPS factor (it is the gauge)
                xy_est = self._pose_estimate()[:2]
                self.graph.add_gps(k, np.array(
                    [xy_est[0], xy_est[1], float(fix[2]) - self.gps_alt_offset]))
            self._pending_gps = None
        self.num_keyframes = k + 1

        refined = False
        if c.do_slam:
            if do_detect:
                # defer the decision fetch to a flush
                self._pending_loops.append(((k,), None, _pack_decision(cand, res)))
                self._pending_count += 1
            elif (k + 1) % c.scancontext.detect_every_n_keyframes == 0:
                pass   # the exclude-recent window: no refine either
            else:
                self._refine_graph(full=False)
                refined = self.graph.num_loops > 0
        if refined:
            if not self._sharded:   # counted with the mesh path's insert
                self.dispatch_counts["pose_slice"] += 1
            pose_dev = geo.se3_to_se2(self.graph.g.poses[k])
        self._cur_pose_dev = pose_dev
        self._cur_pose = None

    def _dump_loop_debug(self, k: int, prev_idx: int, accepted: bool, sc_dist: float,
                         sc_yaw: float, fitness: float, rel2: np.ndarray):
        """Write loop_<k>_<verdict>.npz into ``loop_debug_dir``: keyframe k's
        cloud (the ICP query), the ±half submap around ``prev_idx``, and the
        decision scalars, with the JAX engine's fields (the offline form of
        the reference's /loop_scan_local and /loop_submap_local).  The
        submap is rendered from the current optimised poses."""
        p = _debug_submap(self.cfg, self.clouds, self.clouds_valid, self.graph.g.poses,
                          prev_idx, self.num_keyframes, k).cpu().numpy()
        n_feats = self.clouds.shape[1]
        n_sub = self.cfg.icp.max_target_points
        q_xy = p[:2 * n_feats].reshape(n_feats, 2)
        q_valid = p[2 * n_feats:3 * n_feats] > 0.5
        sub_xy = p[3 * n_feats:3 * n_feats + 2 * n_sub].reshape(n_sub, 2)
        sub_valid = p[3 * n_feats + 2 * n_sub:] > 0.5
        verdict = "accepted" if accepted else "rejected"
        np.savez(os.path.join(self.loop_debug_dir, f"loop_{k:05d}_{verdict}.npz"),
                 prev_idx=prev_idx, curr_idx=k, accepted=accepted, sc_dist=sc_dist,
                 sc_yaw_init=sc_yaw, icp_fitness=fitness, rel_pose=np.asarray(rel2),
                 query_xy=q_xy[q_valid], submap_xy=sub_xy[sub_valid])

    def _flush_pending_loop(self):
        """Drain the deferred decision queue in order: one fetch for every
        queued decision not fetched yet (a finish_chunk may have brought
        some), dump every decision that found a candidate when
        ``loop_debug_dir`` is set, add every accepted loop factor (the first
        inter-session one rebases the current session), then ONE full refine
        if any loop was added (a fast one otherwise)."""
        if not self._pending_loops:
            return
        pending, self._pending_loops = self._pending_loops, []
        self._pending_count = 0
        dev = [pk for _, _, pk in pending if isinstance(pk, torch.Tensor)]
        self.dispatch_counts["decision_fetch"] += len(dev)
        with self._stage("loop_fetch"):
            if dev:
                host = self._agree(torch.cat(dev)).cpu().numpy()
                fetched = iter(np.split(host, np.cumsum([pk.numel() for pk in dev])[:-1]))
        decisions = []   # (k, packed vector, slot)
        for ks, slots, pk in pending:
            p = next(fetched) if isinstance(pk, torch.Tensor) else pk
            for k, s in zip(ks, slots or (0,)):
                decisions.append((k, p, s))
        solved = False
        for k, p, s in decisions:
            t = len(p) // 9
            found, accepted, idx, dist, fitness = p[s:5 * t:t]
            if not found > 0.5:
                continue
            prev_idx = int(idx)
            rel2 = np.asarray(p[5 * t + 3 * s:5 * t + 3 * s + 3], np.float64)
            if self.loop_debug_dir is not None:
                with self._stage("loop_debug_dump"):
                    self._dump_loop_debug(k, prev_idx, bool(accepted > 0.5), float(dist),
                                          float(p[8 * t + s]), float(fitness), rel2)
            if not accepted > 0.5:
                continue
            meas = geo.se2_to_se3_np(rel2).astype(np.float32)
            if not self._rebased and prev_idx < self.session_start <= k:
                self._rebase_session(prev_idx, k, meas)
            self.graph.add_loop(prev_idx, k, meas)
            self.loops.append(LoopEvent(prev_idx, k, float(dist), float(fitness), rel2))
            solved = True
        self._refine_graph(full=solved)
        if self.graph.num_loops > 0:
            self._cur_pose_dev = geo.se3_to_se2(self.graph.g.poses[self.num_keyframes - 1])
            self._cur_pose = None

    def _refine_graph(self, full: bool):
        # odometry-only graphs are at their optimum (the chain): no solve
        # until the first loop factor exists
        if self.graph.num_loops == 0:
            return
        solver = self._solve_full if full else self._solve_fast
        self.dispatch_counts["pgo_full" if full else "pgo_fast"] += 1
        with self._stage("pgo_refine_full" if full else "pgo_refine_fast"):
            self.graph.g = solver(self.graph.g, self.graph.num_nodes, self.graph.num_loops)

    # -- outputs ------------------------------------------------------------

    def current_pose(self) -> np.ndarray:
        """Latest keyframe's optimized pose [x, y, theta], after finishing the
        in-flight chunks and draining the deferred loop commits."""
        self.drain_chunks()
        if self.num_keyframes == 0:
            return np.zeros(3)
        self._flush_pending_loop()
        return self._pose_estimate()

    def _pose_estimate(self) -> np.ndarray:
        """Latest optimized pose without draining the deferred commits (may
        lag current_pose() by up to loop_commit_defer keyframes' loops)."""
        if self.num_keyframes == 0:
            return np.zeros(3)
        if self._cur_pose is None:
            dev = self._cur_pose_dev
            if dev is None:   # after a state load
                dev = geo.se3_to_se2(self.graph.g.poses[self.num_keyframes - 1])
            self._cur_pose = dev.cpu().numpy().astype(np.float64)
        return self._cur_pose.copy()

    def trajectory(self, drain: bool = True) -> np.ndarray:
        """(N_kf, 4, 4) optimized keyframe poses; drain=False skips finishing
        the in-flight chunks and the deferred-loop drain (the snapshot may lag
        the newest scans and loops)."""
        if drain:
            self.drain_chunks()
            self._flush_pending_loop()
        with self._stage("path_render"):
            return self.graph.poses()

    def aggregate_map(self, voxel: Optional[float] = None, stride: Optional[int] = None,
                      drain: bool = True) -> np.ndarray:
        """Aggregated global feature map: every ``stride``-th keyframe cloud
        transformed by its optimized pose, voxel-deduplicated on the host at
        ``voxel`` m (first point per cell)."""
        c = self.cfg
        voxel = voxel if voxel is not None else c.map.map_voxel_size
        stride = stride if stride is not None else c.map.keyframe_stride
        if drain:
            self.drain_chunks()
        if self.num_keyframes == 0:
            return np.zeros((0, 2))
        if drain:
            self._flush_pending_loop()
        with self._stage("map_render"):
            pts = _render_map(self.clouds, self.clouds_valid, self.graph.g.poses,
                              self.num_keyframes, stride).cpu().numpy()
        if voxel > 0 and len(pts):
            keys = np.floor(pts / voxel).astype(np.int64)
            _, uniq = np.unique(keys, axis=0, return_index=True)
            pts = pts[np.sort(uniq)]
        return pts
