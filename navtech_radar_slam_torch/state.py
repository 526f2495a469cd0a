"""Carrying the odometry and SLAM state across, as numpy.

The system has no learned weights.  What a run carries from scan to scan is
the odometry carry (the previous scan's ``ScanFeatures``, the last
increment, the accumulated pose and the coast count) and, for full SLAM,
the engine state: keyframe clouds, descriptor bank, ring keys, pose-graph
arrays and counters.  These functions move that state between numpy and the
port, so a run can resume from the JAX package's state (exported field by
field with ``np.asarray``) and both implementations can start from the same
state.

Layout of the carry dict::

    {"prev": {"xy", "desc", "power", "valid", "ranges", "ray_frac"} or None,
     "pose": (3,) f64, "last_rel": (3,) f64,
     "coast": int, "num_scans": int, "num_failures": int}

The engine state uses the key names and dtypes of the JAX checkpoint
(``navtech_radar_slam_tpu/utils/checkpoint.py``: ``clouds``, ``bank``,
``graph_poses``, ``num_loops``, ...) plus ``"odometry"``, the carry above.
A state without ``"odometry"`` (a checkpoint file of either package)
resumes as the JAX engine does: the first scan after the load re-seeds the
odometry.  ``utils.checkpoint`` reads and writes the ``.npz`` file.

``scmanager_state_to_numpy`` / ``load_scmanager_state`` do the same for a
``ScanContextManager``: ``{"bank", "ring_keys", "num"}``.

The configuration needs no conversion: the port's ``config.SlamConfig``
has the JAX package's fields and defaults, and ``configs/*.json`` load alike
in both.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict

import numpy as np
import torch

from navtech_radar_slam_torch.models.odometry import RadarOdometry, ScanFeatures

if TYPE_CHECKING:
    from navtech_radar_slam_torch.models.slam import SlamEngine
    from navtech_radar_slam_torch.ops.scancontext import ScanContextManager

#: graph arrays, by checkpoint key
_GRAPH_KEYS = ("poses", "odom_meas", "odom_valid", "loop_i", "loop_j", "loop_meas",
               "loop_valid", "gps_meas", "gps_valid")


def scan_features_from_numpy(d: Dict[str, np.ndarray], device) -> ScanFeatures:
    """numpy fields -> ``ScanFeatures`` on ``device`` (float32 / bool)."""
    def conv(name):
        dtype = torch.bool if name == "valid" else torch.float32
        return torch.tensor(np.asarray(d[name]), dtype=dtype, device=device)

    return ScanFeatures(*(conv(name) for name in ScanFeatures._fields))


def to_numpy(feats: ScanFeatures) -> Dict[str, np.ndarray]:
    """``ScanFeatures`` -> dict of numpy arrays (the inverse of
    ``scan_features_from_numpy``)."""
    return {name: getattr(feats, name).detach().cpu().numpy()
            for name in ScanFeatures._fields}


def odometry_state_to_numpy(odo: RadarOdometry) -> Dict:
    return {
        "prev": None if odo.prev is None else to_numpy(odo.prev),
        "pose": odo.pose.copy(),
        "last_rel": np.asarray(odo.last_rel, np.float64).copy(),
        "coast": odo._coast,
        "num_scans": odo.num_scans,
        "num_failures": odo.num_failures,
    }


def load_odometry_state(odo: RadarOdometry, d: Dict) -> None:
    """Restore the carry.  The last step's result is dropped with it, so an
    engine on this odometry takes the resume branch on its next scan and
    integrates no stale step."""
    odo.prev = (None if d["prev"] is None
                else scan_features_from_numpy(d["prev"], odo.device))
    odo.pose = np.asarray(d["pose"], np.float64).copy()
    odo.last_rel = np.asarray(d["last_rel"], np.float64).copy()
    odo._coast = int(d["coast"])
    odo.num_scans = int(d["num_scans"])
    odo.num_failures = int(d.get("num_failures", 0))
    odo.last_result = None
    odo.last_ok = False
    odo.last_applied_rel = np.zeros(3)


def slam_state_to_numpy(eng: "SlamEngine") -> Dict:
    """The engine state as numpy, in the JAX checkpoint's key names plus the
    odometry carry.  Finishes the in-flight chunks and commits the deferred
    loop decisions first, as the JAX checkpoint does."""
    eng.drain_chunks()
    eng._flush_pending_loop()
    g = eng.graph.g
    d = {name: getattr(eng, name).cpu().numpy()
         for name in ("clouds", "clouds_valid", "ring_keys")}
    # on a mesh the bank is gathered whole (every rank takes part)
    d["bank"] = eng.bank_whole().cpu().numpy()
    d.update({f"graph_{name}": getattr(g, name).cpu().numpy() for name in _GRAPH_KEYS})
    # the JAX graph's loop indices are int32
    d["graph_loop_i"] = d["graph_loop_i"].astype(np.int32)
    d["graph_loop_j"] = d["graph_loop_j"].astype(np.int32)
    d.update(
        kf_times=np.asarray(eng.kf_times, np.float64),
        odom_poses=np.asarray(eng.odom_poses, np.float64).reshape(-1, 3),
        num_keyframes=eng.num_keyframes,
        movement_accum=eng.movement_accum,
        last_kf_pose=np.asarray(eng.last_kf_pose, np.float64).copy(),
        odo_pose=eng.odometry.pose.copy(),
        odo_last_rel=np.asarray(eng.odometry.last_rel, np.float64).copy(),
        num_scans=eng.num_scans,
        session_start=eng.session_start,
        rebased=eng._rebased,
        gps_alt_offset=np.nan if eng.gps_alt_offset is None else eng.gps_alt_offset,
        graph_num_nodes=eng.graph.num_nodes,
        num_loops=eng.graph.num_loops,
        loop_events=np.asarray([[e.prev_idx, e.curr_idx, e.sc_dist, e.icp_fitness]
                                for e in eng.loops], np.float64).reshape(-1, 4),
        odometry=odometry_state_to_numpy(eng.odometry),
    )
    return d


def load_slam_state(eng: "SlamEngine", d: Dict) -> None:
    """Restore an engine state given as numpy (``slam_state_to_numpy``'s
    layout, or the fields of a checkpoint file).  The arrays must match the
    engine's capacities (``utils.checkpoint.load_engine`` builds the engine
    from the file's config, so a grown engine reloads at its capacity)."""
    from navtech_radar_slam_torch.models.slam import LoopEvent

    c = eng.cfg
    want = {"clouds": c.keyframes.max_keyframes, "graph_poses": c.pgo.max_nodes,
            "graph_loop_i": c.pgo.max_loop_edges}
    for key, cap in want.items():
        if np.asarray(d[key]).shape[0] != cap:
            raise ValueError(f"load_slam_state: {key} holds {np.asarray(d[key]).shape[0]} "
                             f"rows, the engine's capacity is {cap}")

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=eng.device).clone()

    eng.clouds = dev(d["clouds"], torch.float32)
    eng.clouds_valid = dev(d["clouds_valid"], torch.bool)
    eng.set_bank_whole(dev(d["bank"], torch.float32))   # a mesh rank keeps its block
    eng.ring_keys = dev(d["ring_keys"], torch.float32)
    dtypes = {"odom_valid": torch.bool, "loop_valid": torch.bool, "gps_valid": torch.bool,
              "loop_i": torch.int64, "loop_j": torch.int64}
    eng.graph.g = eng.graph.g._replace(
        num_nodes=dev(int(d["graph_num_nodes"]), torch.int64),
        **{name: dev(d[f"graph_{name}"], dtypes.get(name, torch.float32))
           for name in _GRAPH_KEYS})
    eng.graph.num_nodes = int(d["graph_num_nodes"])
    eng.graph.num_loops = int(d["num_loops"])
    eng.kf_times = [float(x) for x in np.asarray(d["kf_times"])]
    if "odom_poses" in d:
        eng.odom_poses = [p.copy() for p in np.asarray(d["odom_poses"], np.float64)]
    eng.num_keyframes = int(d["num_keyframes"])
    eng.movement_accum = float(d["movement_accum"])
    eng.last_kf_pose = np.asarray(d["last_kf_pose"], np.float64).copy()
    eng.num_scans = int(d["num_scans"])
    eng.session_start = int(d.get("session_start", 0))
    eng._rebased = bool(d.get("rebased", True))
    off = float(d.get("gps_alt_offset", np.nan))
    eng.gps_alt_offset = None if np.isnan(off) else off
    eng.loops = [LoopEvent(int(r[0]), int(r[1]), float(r[2]), float(r[3]), None)
                 for r in np.asarray(d["loop_events"]).reshape(-1, 4)]
    odo = d.get("odometry")
    if odo is None:
        # a JAX checkpoint: the carry's scan features are not saved, the
        # first scan after the load re-seeds them
        odo = {"prev": None, "pose": d["odo_pose"], "last_rel": d["odo_last_rel"],
               "coast": 0, "num_scans": int(d["num_scans"]), "num_failures": 0}
    load_odometry_state(eng.odometry, odo)
    eng._pending_loops = []
    eng._pending_count = 0
    eng._inflight.clear()
    eng._twist_dev = None
    eng._coast_dev = None
    eng._cur_pose = None
    eng._cur_pose_dev = None


def scmanager_state_to_numpy(mgr: "ScanContextManager") -> Dict:
    """A ``ScanContextManager``'s bank, ring keys and count as numpy."""
    return {"bank": mgr.bank.cpu().numpy(), "ring_keys": mgr.ring_keys.cpu().numpy(),
            "num": mgr.num}


def load_scmanager_state(mgr: "ScanContextManager", d: Dict) -> None:
    """Restore a manager's state given as numpy (``scmanager_state_to_numpy``'s
    layout, or a JAX manager's ``bank``, ``ring_keys`` and ``num`` through
    ``np.asarray``).  The arrays must have the manager's capacity and
    descriptor shape."""
    bank = np.asarray(d["bank"], np.float32)
    keys = np.asarray(d["ring_keys"], np.float32)
    num = int(d["num"])
    if bank.shape != tuple(mgr.bank.shape) or keys.shape != tuple(mgr.ring_keys.shape):
        raise ValueError(f"load_scmanager_state: bank {bank.shape} and ring keys "
                         f"{keys.shape}, the manager holds {tuple(mgr.bank.shape)} and "
                         f"{tuple(mgr.ring_keys.shape)}")
    if not 0 <= num <= mgr.capacity:
        raise ValueError(f"load_scmanager_state: num {num} outside 0 .. {mgr.capacity}")
    mgr.bank = torch.tensor(bank, device=mgr.device)
    mgr.ring_keys = torch.tensor(keys, device=mgr.device)
    mgr.num = num
