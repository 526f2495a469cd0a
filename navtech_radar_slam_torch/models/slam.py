"""The full SLAM engine in PyTorch: odometry + keyframing + ScanContext loop
search + submap ICP verification + robust pose-graph refine + map output.

Counterpart of the single-device, per-scan path of
``navtech_radar_slam_tpu.models.slam.SlamEngine``:

  process(scan) -> RadarOdometry.process          (K1 on a CUDA tensor)
               -> keyframe gate (accumulated translation)
               -> _kf_step_body: voxel filter, ScanContext descriptor,
                  bank / cloud / graph-node insert, and on detecting
                  keyframes detect_loop (K2) + _verify_candidate
                  (submap build + icp_se2, K3 per iteration + both gates)
               -> deferred loop decisions, packed on the device and fetched
                  at a flush (loop_commit_defer) -> loop factors -> PGO
  trajectory() / aggregate_map()                   (drain, then read out)

The engine keeps its banks and graph on ``device`` and writes them in place
(the JAX engine returns new arrays; in place saves copying the 4096-row
banks per keyframe).  ``dispatch_counts`` counts the JAX engine's sites on
this path (``kf_step``, ``decision_fetch``, ``pgo_full``, ``pgo_fast``,
``pose_slice``) at the same places.

Host reads per scan: the odometry result (one fetch), the pose estimate
after a keyframe, and on each detecting keyframe one read of the
candidate's ``found`` flag, so that no ICP runs without a candidate (the
JAX engine's ``lax.cond``).

Not ported yet: the streaming engine (process_chunk, begin/finish_chunk,
fused keyframe segments, prewarm), attach_prior_session / _rebase_session,
the loop-debug dumps, set_gps_table, the mesh paths and StageTimers.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from navtech_radar_slam_torch.config import SlamConfig
from navtech_radar_slam_torch.models import posegraph as pg
from navtech_radar_slam_torch.models.odometry import RadarOdometry
from navtech_radar_slam_torch.ops import icp as icp_ops
from navtech_radar_slam_torch.ops import scancontext as sc_ops
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


def _empty_candidate(device) -> sc_ops.LoopCandidate:
    """LoopCandidate with found=False."""
    return sc_ops.LoopCandidate(
        idx=torch.full((), -1, dtype=torch.int64, device=device),
        dist=torch.full((), float("inf"), device=device),
        yaw=torch.zeros((), device=device),
        found=torch.zeros((), dtype=torch.bool, device=device),
    )


def _empty_icp_result(device) -> icp_ops.IcpResult:
    """IcpResult with accepted=False."""
    return icp_ops.IcpResult(
        rel_pose=torch.zeros(3, device=device),
        fitness=torch.full((), float("inf"), device=device),
        num_corr=torch.zeros((), dtype=torch.int64, device=device),
        converged=torch.zeros((), dtype=torch.bool, device=device),
        accepted=torch.zeros((), dtype=torch.bool, device=device),
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


def _kf_step_body(cfg: SlamConfig, clouds, clouds_valid, bank, ring_keys,
                  g: pg.GraphArrays, k: int, xy, valid, odo_pose_se2, prev_odo_se2,
                  has_odom: bool, do_detect: bool, session_start: int):
    """One keyframe: voxel filter, ScanContext descriptor, bank / cloud /
    graph insert (in place, at slot ``k``), then on ``do_detect`` loop
    detection and candidate verification.

    Returns (clouds, clouds_valid, bank, ring_keys, g, desc, cand, res)."""
    valid = voxel_dedup_mask(xy, valid, cfg.keyframes.keyframe_voxel_size)
    desc = sc_ops.make_scancontext(xy, torch.zeros(xy.shape[0], device=xy.device),
                                   valid, cfg.scancontext)
    clouds[k] = xy
    clouds_valid[k] = valid
    bank[k] = desc
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
    if cfg.scancontext.search_mode == "ringkey":
        cand = sc_ops.detect_loop_ringkey(desc, bank, ring_keys, num_kf, cfg.scancontext)
    else:
        cand = sc_ops.detect_loop(desc, bank, num_kf, cfg.scancontext)
    res = _verify_candidate(cand, clouds, clouds_valid, poses_se2, xy, valid, num_kf,
                            cfg, path_cum=_odom_path_cum(g), session_start=session_start)
    return clouds, clouds_valid, bank, ring_keys, g, desc, cand, res


def _pack_decision(cand: sc_ops.LoopCandidate, res: icp_ops.IcpResult) -> torch.Tensor:
    """One float32 vector [found, accepted, idx, dist, fitness, rel(3), yaw]
    on the device, so a flush fetches every queued decision at once."""
    f32 = torch.float32
    return torch.cat([torch.stack([cand.found.to(f32), res.accepted.to(f32),
                                   cand.idx.to(f32), cand.dist.to(f32),
                                   res.fitness.to(f32)]),
                      res.rel_pose.to(f32), cand.yaw.to(f32)[None]])


class SlamEngine:
    """Host orchestrator of the per-scan SLAM path on one ``device``."""

    def __init__(self, cfg: Optional[SlamConfig] = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.cfg = c = cfg or SlamConfig()
        self.device = dev = resolve_device(device)
        self.odometry = RadarOdometry(c, device=dev)

        K, M = c.features.max_features, c.keyframes.max_keyframes
        R, S = c.scancontext.num_ring, c.scancontext.num_sector
        self.clouds = torch.zeros((M, K, 2), device=dev)
        self.clouds_valid = torch.zeros((M, K), dtype=torch.bool, device=dev)
        self.bank = torch.zeros((M, R, S), device=dev)
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
        #: deferred loop decisions (keyframe, packed vector on the device),
        #: fetched and committed once loop_commit_defer are queued or an
        #: output consumer drains them
        self._pending_loops: List[Tuple[int, torch.Tensor]] = []
        self._pending_count = 0
        #: first keyframe of the current session (0: single session)
        self.session_start = 0

    def _make_solvers(self):
        # fast per-keyframe refine (one GN iteration) vs full solve after
        # new loops: the iSAM2-like warm-started pattern
        self._solve_fast = pg.make_bucketed_solver(
            dataclasses.replace(self.cfg.pgo, gn_iters=1))
        self._solve_full = pg.make_bucketed_solver(self.cfg.pgo)

    # -- per-scan entry -----------------------------------------------------

    def add_gps(self, xyz: np.ndarray):
        """Associate a GPS fix with the next keyframe.  Only xyz[2] (absolute
        altitude) is used: the first fix latches the datum and factors
        constrain altitude - datum, xy taken from the last optimized
        estimate."""
        self._pending_gps = np.asarray(xyz, np.float64)

    def process(self, power, azimuths=None, timestamp: float = 0.0, ray_valid=None,
                packed: bool = False) -> np.ndarray:
        """Feed one polar scan (float32, uint8, or with ``packed`` the 4-bit
        wire format); returns the current optimized pose [x, y, theta].

        ``ray_valid``: optional (NA,) per-azimuth validity; invalid rays are
        zeroed on the device before feature extraction."""
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
        for name in ("clouds", "clouds_valid", "bank", "ring_keys"):
            old = getattr(self, name)
            new = torch.zeros((2 * old_cap,) + old.shape[1:], dtype=old.dtype,
                              device=old.device)
            new[:old_cap] = old
            setattr(self, name, new)
        self.graph.grow(c.pgo.max_nodes, c.pgo.max_loop_edges)
        self._make_solvers()

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
        self.dispatch_counts["kf_step"] += 1
        f32 = dict(dtype=torch.float32, device=self.device)
        (self.clouds, self.clouds_valid, self.bank, self.ring_keys, self.graph.g,
         _, cand, res) = _kf_step_body(
            c, self.clouds, self.clouds_valid, self.bank, self.ring_keys,
            self.graph.g, k, xy, valid, torch.tensor(odo_pose, **f32),
            torch.tensor(self.last_kf_pose, **f32), has_odom, do_detect,
            self.session_start)
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
                self._pending_loops.append((k, _pack_decision(cand, res)))
                self._pending_count += 1
            elif (k + 1) % c.scancontext.detect_every_n_keyframes == 0:
                pass   # the exclude-recent window: no refine either
            else:
                self._refine_graph(full=False)
                refined = self.graph.num_loops > 0
        if refined:
            self.dispatch_counts["pose_slice"] += 1
            pose_dev = geo.se3_to_se2(self.graph.g.poses[k])
        self._cur_pose_dev = pose_dev
        self._cur_pose = None

    def _flush_pending_loop(self):
        """Drain the deferred decision queue in order: one fetch for every
        queued decision, add every accepted loop factor, then ONE full
        refine if any loop was added (a fast one otherwise)."""
        if not self._pending_loops:
            return
        pending, self._pending_loops = self._pending_loops, []
        self._pending_count = 0
        self.dispatch_counts["decision_fetch"] += len(pending)
        fetched = torch.stack([pk for _, pk in pending]).cpu().numpy()
        solved = False
        for (k, _), p in zip(pending, fetched):
            found, accepted, idx, dist, fitness = p[:5]
            if not (found > 0.5 and accepted > 0.5):
                continue
            prev_idx = int(idx)
            rel2 = np.asarray(p[5:8], np.float64)
            self.graph.add_loop(prev_idx, k, geo.se2_to_se3_np(rel2).astype(np.float32))
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
        self.graph.g = solver(self.graph.g, self.graph.num_nodes, self.graph.num_loops)

    # -- outputs ------------------------------------------------------------

    def current_pose(self) -> np.ndarray:
        """Latest keyframe's optimized pose [x, y, theta], after draining the
        deferred loop commits."""
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
        """(N_kf, 4, 4) optimized keyframe poses; drain=False skips the
        deferred-loop drain (the snapshot may lag the newest loops)."""
        if drain:
            self._flush_pending_loop()
        return self.graph.poses()

    def aggregate_map(self, voxel: Optional[float] = None, stride: Optional[int] = None,
                      drain: bool = True) -> np.ndarray:
        """Aggregated global feature map: every ``stride``-th keyframe cloud
        transformed by its optimized pose, voxel-deduplicated on the host at
        ``voxel`` m (first point per cell)."""
        c = self.cfg
        voxel = voxel if voxel is not None else c.map.map_voxel_size
        stride = stride if stride is not None else c.map.keyframe_stride
        if self.num_keyframes == 0:
            return np.zeros((0, 2))
        if drain:
            self._flush_pending_loop()
        idx = torch.arange(0, self.num_keyframes, stride, device=self.device)
        se2 = geo.se3_to_se2(self.graph.g.poses[idx])
        pts = geo.se2_apply(se2, self.clouds[idx]).reshape(-1, 2)
        pts = pts[self.clouds_valid[idx].reshape(-1)].cpu().numpy()
        if voxel > 0 and len(pts):
            keys = np.floor(pts / voxel).astype(np.int64)
            _, uniq = np.unique(keys, axis=0, return_index=True)
            pts = pts[np.sort(uniq)]
        return pts
