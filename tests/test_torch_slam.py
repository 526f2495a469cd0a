"""Parity of the port's full-SLAM engine with the JAX package's
(``models/slam.py``): the submap builder's tie order, loop verification on
a state carried across with ``state.load_slam_state``, the state round
trip and resume, and an end-to-end run of both engines.

The GPS datum, no-SLAM and ring-key modes run per scan through both
engines too (``test_engines_agree_in_mode``).

Tolerances: ``_build_submap`` keeps the identical mask and choice of
points, with coordinates within 1e-5 (sin/cos rounding); detection
gives the same index, flag and yaw; ``_verify_candidate`` gives the same
decision with the pose within 1e-3 (the ICP parity of test_torch_icp.py);
end to end, the same keyframe count and ``dispatch_counts``, a loop-set
overlap of at least 50 % and trajectories within 0.1 m (the band the JAX
suite's own mesh tests allow for borderline ICP decisions).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.config import SlamConfig
from navtech_radar_slam_tpu.data import RadarSimulator
from navtech_radar_slam_tpu.models import slam as jslam
from navtech_radar_slam_tpu.ops import scancontext as jsc
from navtech_radar_slam_tpu.utils import checkpoint as jckpt
from navtech_radar_slam_tpu.utils import geometry as jgeo
from navtech_radar_slam_torch import state
from navtech_radar_slam_torch.models import slam as tslam
from navtech_radar_slam_torch.models.odometry import RadarOdometry
from navtech_radar_slam_torch.ops import scancontext as tsc
from navtech_radar_slam_torch.utils import geometry as tgeo
from navtech_radar_slam_torch.utils.geometry import se2_between_np
from torch_parity_util import np_, one_torch_thread, t, tiny_cfg  # noqa: F401 (fixture)

N_SCANS = 25


def small_cfg() -> SlamConfig:
    """Narrow features and a short circuit: a 21-scan lap of radius 5 m
    revisits its start within N_SCANS with an 8-keyframe exclusion window;
    small submaps, banks and graph."""
    c = SlamConfig()
    return dataclasses.replace(
        c,
        features=dataclasses.replace(c.features, max_features=256, max_matches=128,
                                     motion_compensation=False),
        registration=dataclasses.replace(c.registration, spectral_top_k=128),
        keyframes=dataclasses.replace(c.keyframes, max_keyframes=64),
        scancontext=dataclasses.replace(c.scancontext, num_exclude_recent=8),
        icp=dataclasses.replace(c.icp, submap_half_size=3, max_query_points=256,
                                max_target_points=1024, max_iters=50),
        pgo=dataclasses.replace(c.pgo, max_nodes=64, max_loop_edges=16, gn_iters=6,
                                cg_iters=50, loop_commit_defer=4),
    )


CFG = small_cfg()


@pytest.fixture(scope="module")
def runs():
    """Both engines over the same N_SCANS scans."""
    sim = RadarSimulator(CFG.radar)
    gt = sim.circuit_trajectory(N_SCANS + 2, radius=5.0, speed=6.0)
    scans = [sim.render(gt[i], noise_seed=i) for i in range(N_SCANS + 2)]
    jeng = jslam.SlamEngine(CFG)
    teng = tslam.SlamEngine(CFG, device="cpu")
    for i, s in enumerate(scans[:N_SCANS]):
        jeng.process(s, timestamp=i * 0.25)
        teng.process(s, timestamp=i * 0.25)
    return gt, scans, jeng, teng


def test_engines_agree_end_to_end(runs):
    gt, _, jeng, teng = runs
    traj_j, traj_t = jeng.trajectory(), teng.trajectory()
    assert teng.num_keyframes == jeng.num_keyframes == N_SCANS
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts)
    assert teng.dispatch_counts["pgo_full"] >= 1
    loops_j = {(e.prev_idx, e.curr_idx) for e in jeng.loops}
    loops_t = {(e.prev_idx, e.curr_idx) for e in teng.loops}
    assert loops_t and loops_j
    assert len(loops_j & loops_t) >= 0.5 * max(len(loops_j), len(loops_t)), (loops_j, loops_t)
    np.testing.assert_allclose(traj_t, traj_j, rtol=0, atol=0.1)
    gt_rel = np.asarray([se2_between_np(gt[0], g) for g in gt[:N_SCANS]])
    ate = np.sqrt(np.mean(np.sum((traj_t[:, :2, 3] - gt_rel[:, :2]) ** 2, axis=1)))
    assert ate < 0.3, ate
    m_j, m_t = jeng.aggregate_map(), teng.aggregate_map()
    assert len(m_t) > 0 and np.isfinite(m_t).all()
    assert abs(len(m_t) - len(m_j)) <= 0.05 * len(m_j)


def _mode_cfg(mode: str) -> SlamConfig:
    if mode == "gps":
        # a tight altitude sigma and a loose odometry chain, so the pull of
        # the altitude factors shows in a 4-node graph (tests/test_slam.py:327)
        return dataclasses.replace(CFG, pgo=dataclasses.replace(
            CFG.pgo, use_gps=True, gps_sigma_alt=0.5, odom_sigma_trans=1.0))
    if mode == "no_slam":
        return dataclasses.replace(CFG, do_slam=False)
    return dataclasses.replace(CFG, scancontext=dataclasses.replace(
        CFG.scancontext, search_mode="ringkey"))


#: scans per mode, and the absolute GPS altitudes of the "gps" mode
MODE_SCANS = {"gps": 4, "no_slam": 8, "ringkey": N_SCANS}
GPS_ALTS = [70.0, 72.0, 72.0, 72.0]


@pytest.mark.parametrize("mode", ["gps", "no_slam", "ringkey"])
def test_engines_agree_in_mode(mode):
    """Both engines per scan in the modes of tests/test_slam.py that the
    full-mode fixture does not run: the GPS datum through the engine
    (:327), no-SLAM mode (:75) and the ring-key search (:96).  The same
    keyframes and ``dispatch_counts``, trajectories within 0.1 m, and the
    mode's own outcome in both."""
    cfg = _mode_cfg(mode)
    n = MODE_SCANS[mode]
    sim = RadarSimulator(cfg.radar)
    gt = sim.circuit_trajectory(n + 2, radius=5.0, speed=6.0)
    jeng = jslam.SlamEngine(cfg)
    teng = tslam.SlamEngine(cfg, device="cpu")
    for i in range(n):
        scan = sim.render(gt[i], noise_seed=i)
        for eng in (jeng, teng):
            if mode == "gps":
                eng.add_gps(np.array([0.0, 0.0, GPS_ALTS[i]]))
            eng.process(scan, timestamp=i * 0.25)
    traj_j, traj_t = jeng.trajectory(), teng.trajectory()
    assert teng.num_keyframes == jeng.num_keyframes >= n - 1
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts)
    np.testing.assert_allclose(traj_t, traj_j, rtol=0, atol=0.1)
    loops_j = {(e.prev_idx, e.curr_idx) for e in jeng.loops}
    loops_t = {(e.prev_idx, e.curr_idx) for e in teng.loops}
    if mode == "no_slam":
        assert not loops_j and not loops_t
    elif mode == "ringkey":
        assert loops_j and loops_t
        assert len(loops_j & loops_t) >= 0.5 * max(len(loops_j), len(loops_t))
    else:
        # the first fix latches the datum; node 0 carries no factor; the
        # rows hold the altitude above the datum and the last estimate's xy
        k = teng.num_keyframes
        assert teng.gps_alt_offset == jeng.gps_alt_offset == 70.0
        gv_t, gv_j = np_(teng.graph.g.gps_valid[:k]), np_(jeng.graph.g.gps_valid[:k])
        np.testing.assert_array_equal(gv_t, gv_j)
        assert not gv_t[0] and gv_t[1:].all()
        gm_t, gm_j = np_(teng.graph.g.gps_meas[:k]), np_(jeng.graph.g.gps_meas[:k])
        np.testing.assert_allclose(gm_t[1:, 2], np.asarray(GPS_ALTS[1:k]) - 70.0, atol=1e-6)
        np.testing.assert_allclose(gm_t, gm_j, rtol=0, atol=1e-4)
        jeng.graph.optimize()
        teng.graph.optimize()
        z_t = float(teng.graph.g.poses[k - 1, 2, 3])
        assert z_t > 0.3
        assert z_t == pytest.approx(float(jeng.graph.g.poses[k - 1, 2, 3]), abs=1e-3)


@pytest.mark.parametrize("seed,voxel", [(0, 0.4), (1, 1.0), (2, 0.0)])
def test_build_submap_identical(seed, voxel):
    """Five distinct priorities over W*K points: which points fill the
    budget is decided by the tie order alone (lowest index first).  The
    mask and the choice of points are identical; the coordinates agree to
    1e-5 (XLA's and torch's sin/cos differ in the last bit)."""
    rng = np.random.default_rng(seed)
    m, k, half, max_pts = 16, 128, 4, 400
    clouds = rng.uniform(-30, 30, (m, k, 2)).astype(np.float32)
    clouds[:, ::3] = np.round(clouds[:, ::3])            # voxel collisions
    valid = rng.random((m, k)) > 0.25
    poses = np.column_stack([rng.uniform(-5, 5, m), rng.uniform(-5, 5, m),
                             rng.uniform(-3, 3, m)]).astype(np.float32)
    for center, num_kf in ((6, 12), (1, 12), (10, 11)):
        want = jslam._build_submap(jnp.asarray(clouds), jnp.asarray(valid), jnp.asarray(poses),
                                   jnp.asarray(center), jnp.asarray(num_kf), half, max_pts,
                                   voxel)
        got = tslam._build_submap(t(clouds), t(valid), t(poses), torch.tensor(center),
                                  num_kf, half, max_pts, voxel)
        np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
        np.testing.assert_allclose(np_(got[0]), np.asarray(want[0]), rtol=0, atol=1e-5)
        assert np_(got[1]).sum() > 0


def _jax_state(jeng, tmp_path):
    path = tmp_path / "jax_state.npz"
    jckpt.save_engine(jeng, str(path))
    return dict(np.load(path))


def test_verify_candidate_matches_jax(runs, tmp_path):
    """Detection and submap ICP from one JAX engine state, loaded into the
    port with ``state.load_slam_state``, on the keyframes that closed
    loops."""
    _, _, jeng, _ = runs
    teng = tslam.SlamEngine(CFG, device="cpu")
    state.load_slam_state(teng, _jax_state(jeng, tmp_path))
    poses_j = jgeo.se3_to_se2(jeng.graph.g.poses)
    poses_t = tgeo.se3_to_se2(teng.graph.g.poses)
    path_j = jslam._odom_path_cum(jeng.graph.g)
    path_t = tslam._odom_path_cum(teng.graph.g)
    currs = sorted({e.curr_idx for e in jeng.loops})[:3]
    assert currs
    for k in currs:
        cj = jsc.detect_loop(jeng.bank[k], jeng.bank, jnp.asarray(k + 1), CFG.scancontext)
        ct = tsc.detect_loop(teng.bank[k], teng.bank, k + 1, CFG.scancontext)
        assert bool(ct.found) and bool(cj.found)
        assert int(ct.idx) == int(cj.idx)
        np.testing.assert_allclose(float(ct.yaw), float(cj.yaw), atol=1e-6)
        np.testing.assert_allclose(float(ct.dist), float(cj.dist), atol=2e-5)
        rj = jslam._verify_candidate(cj, jeng.clouds, jeng.clouds_valid, poses_j,
                                     jeng.clouds[k], jeng.clouds_valid[k], jnp.asarray(k + 1),
                                     CFG, path_cum=path_j, session_start=0)
        rt = tslam._verify_candidate(ct, teng.clouds, teng.clouds_valid, poses_t,
                                     teng.clouds[k], teng.clouds_valid[k], k + 1, CFG,
                                     path_cum=path_t, session_start=0)
        assert bool(rt.accepted) == bool(rj.accepted)
        np.testing.assert_allclose(np_(rt.rel_pose), np.asarray(rj.rel_pose), atol=1e-3)
        np.testing.assert_allclose(float(rt.fitness), float(rj.fitness), rtol=2e-2)


def test_verify_without_candidate_runs_no_icp(runs, monkeypatch):
    _, _, _, teng = runs

    def no_icp(*args, **kwargs):
        raise AssertionError("ICP ran without a candidate")

    monkeypatch.setattr(tslam.icp_ops, "icp_se2", no_icp)
    res = tslam._verify_candidate(tslam._empty_candidate("cpu"), teng.clouds,
                                  teng.clouds_valid, tgeo.se3_to_se2(teng.graph.g.poses),
                                  teng.clouds[5], teng.clouds_valid[5], 6, CFG)
    assert not bool(res.accepted) and np.isinf(float(res.fitness))


def test_load_slam_state_round_trip_and_resume(runs, tmp_path):
    """A JAX engine's state loads into the port bit for bit; the port's own
    export loads back; the next scan after a load takes the resume branch
    (no keyframe, no movement) and the one after it moves on."""
    _, scans, jeng, _ = runs
    d = _jax_state(jeng, tmp_path)
    teng = tslam.SlamEngine(CFG, device="cpu")
    state.load_slam_state(teng, d)
    for name in ("clouds", "clouds_valid", "bank", "ring_keys"):
        np.testing.assert_array_equal(np_(getattr(teng, name)), d[name], err_msg=name)
    np.testing.assert_array_equal(teng.trajectory(), d["graph_poses"][:N_SCANS])
    assert (teng.num_keyframes, teng.graph.num_loops) == (N_SCANS, len(jeng.loops))
    np.testing.assert_allclose(teng.current_pose(), jeng.current_pose(), atol=1e-6)

    back = state.slam_state_to_numpy(teng)
    again = tslam.SlamEngine(CFG, device="cpu")
    state.load_slam_state(again, back)
    for key, val in back.items():
        if key != "odometry":
            np.testing.assert_array_equal(np.asarray(state.slam_state_to_numpy(again)[key]),
                                          np.asarray(val), err_msg=key)

    accum = teng.movement_accum
    teng.process(scans[N_SCANS], timestamp=N_SCANS * 0.25)
    assert teng.num_keyframes == N_SCANS and teng.movement_accum == accum
    assert teng.odometry.prev is not None
    teng.process(scans[N_SCANS + 1], timestamp=(N_SCANS + 1) * 0.25)
    assert teng.odometry.last_result is not None
    assert teng.num_keyframes == N_SCANS + 1


def test_load_odometry_state_drops_the_last_step():
    """A carry whose ``prev`` is None (the JAX checkpoint's case) loaded
    into an odometry that has stepped: the last step's result goes with
    it, so an engine takes the resume branch on the next scan."""
    cfg = tiny_cfg()
    sim = RadarSimulator(cfg.radar)
    gt = sim.circuit_trajectory(3, radius=10.0, speed=6.0)
    odo = RadarOdometry(cfg, device="cpu")
    for i in range(3):
        odo.process(sim.render(gt[i], noise_seed=i))
    assert odo.last_result is not None and np.abs(odo.last_applied_rel).sum() > 0
    state.load_odometry_state(odo, {"prev": None, "pose": np.asarray([1.0, 2.0, 0.3]),
                                    "last_rel": np.zeros(3), "coast": 0, "num_scans": 3})
    assert odo.last_result is None and odo.last_ok is False
    np.testing.assert_array_equal(odo.last_applied_rel, np.zeros(3))
    np.testing.assert_array_equal(odo.pose, [1.0, 2.0, 0.3])


def test_engines_survive_garbage_scans():
    """Sensor dropout mid-run (tests/test_slam.py:111): three frames of pure
    noise among 14 scans.  Both engines coast, count the same failures
    (at least the three), keep every pose finite and register again after
    the dropout."""
    sim = RadarSimulator(CFG.radar)
    gt = sim.circuit_trajectory(14, radius=10.0, speed=6.0)
    noise_rng = np.random.default_rng(1)
    jeng = jslam.SlamEngine(CFG)
    teng = tslam.SlamEngine(CFG, device="cpu")
    for i in range(14):
        if 5 <= i < 8:
            scan = noise_rng.exponential(
                0.04, size=(CFG.radar.num_azimuths, CFG.radar.padded_range_bins)
            ).astype(np.float32).clip(0, 1)
        else:
            scan = sim.render(gt[i], noise_seed=i)
        pj = jeng.process(scan, timestamp=i * 0.25)
        pt = teng.process(scan, timestamp=i * 0.25)
        assert np.isfinite(pj).all() and np.isfinite(pt).all(), i
    assert teng.odometry.num_failures == jeng.odometry.num_failures >= 3
    assert bool(jeng.odometry.last_result.ok) and teng.odometry.last_ok
    assert np.isfinite(teng.trajectory()).all()
    np.testing.assert_allclose(teng.trajectory(), jeng.trajectory(), rtol=0, atol=0.1)


def _clone_case():
    """tests/test_slam.py:685's graph: 100 nodes walking +2 m in x, node 0's
    cloud observed again, exactly, at node 80 (160 m of path later); as
    numpy (poses, odometry steps, clouds, SE(2) poses)."""
    rng = np.random.default_rng(0)
    k, n, cap = 256, 100, 128
    cloud = rng.uniform(-30, 30, size=(k, 2)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    poses[:n, 0, 3] = 2.0 * np.arange(n)
    step = np.eye(4, dtype=np.float32)
    step[0, 3] = 2.0
    odom_valid = np.ones(cap, bool)
    odom_valid[0] = False
    clouds = np.zeros((cap, k, 2), np.float32)
    clouds[0] = cloud
    clouds_valid = np.zeros((cap, k), bool)
    clouds_valid[0] = True
    poses_se2 = np.zeros((cap, 3), np.float32)
    poses_se2[:n, 0] = 2.0 * np.arange(n)
    return n, cap, cloud, poses, np.tile(step, (cap, 1, 1)), odom_valid, clouds, \
        clouds_valid, poses_se2


@pytest.mark.parametrize("session_start,gate,accepted", [(0, True, False), (40, True, True),
                                                        (0, False, True)],
                         ids=["clone_rejected", "inter_session_exempt", "gate_off"])
def test_odom_consistency_gate_matches_jax(session_start, gate, accepted):
    """The odometry-consistency gate on an exact clone (tests/test_slam.py:685):
    ICP fits the alias with loop-grade fitness in both packages; the gate
    rejects it 160 m of path away, exempts the pair across a session start,
    and with ``odom_consistency_frac = 0`` fitness alone accepts.  The
    port's ``_odom_path_cum`` and ``_verify_candidate`` make JAX's decision
    on the same graph and clouds."""
    from navtech_radar_slam_tpu.models import posegraph as jpg
    from navtech_radar_slam_torch.models import posegraph as tpg

    cfg = CFG if gate else dataclasses.replace(
        CFG, icp=dataclasses.replace(CFG.icp, odom_consistency_frac=0.0))
    n, cap, cloud, poses, odom, odom_valid, clouds, clouds_valid, poses_se2 = _clone_case()
    pgo = dataclasses.replace(cfg.pgo, max_nodes=cap)
    gj = jpg.empty_graph(pgo)._replace(poses=jnp.asarray(poses), odom_meas=jnp.asarray(odom),
                                       odom_valid=jnp.asarray(odom_valid),
                                       num_nodes=jnp.asarray(n, jnp.int32))
    gt_ = tpg.empty_graph(pgo, device="cpu")._replace(
        poses=t(poses), odom_meas=t(odom), odom_valid=t(odom_valid),
        num_nodes=torch.tensor(n))
    path_j, path_t = jslam._odom_path_cum(gj), tslam._odom_path_cum(gt_)
    np.testing.assert_allclose(np_(path_t), np.asarray(path_j), rtol=1e-6)
    cj = jsc.LoopCandidate(idx=jnp.asarray(0, jnp.int32), dist=jnp.asarray(0.01, jnp.float32),
                           yaw=jnp.asarray(0.0, jnp.float32), found=jnp.asarray(True))
    ct = tsc.LoopCandidate(idx=torch.tensor(0), dist=torch.tensor(0.01),
                           yaw=torch.tensor(0.0), found=torch.tensor(True))
    rj = jslam._verify_candidate(cj, jnp.asarray(clouds), jnp.asarray(clouds_valid),
                                 jnp.asarray(poses_se2), jnp.asarray(cloud),
                                 jnp.ones(len(cloud), bool), jnp.asarray(81, jnp.int32), cfg,
                                 path_cum=path_j,
                                 session_start=jnp.asarray(session_start, jnp.int32))
    rt = tslam._verify_candidate(ct, t(clouds), t(clouds_valid), t(poses_se2), t(cloud),
                                 torch.ones(len(cloud), dtype=torch.bool), 81, cfg,
                                 path_cum=path_t, session_start=session_start)
    assert float(rt.fitness) < cfg.icp.fitness_thresh and float(rj.fitness) < cfg.icp.fitness_thresh
    assert bool(rt.accepted) == bool(rj.accepted) == accepted
    np.testing.assert_allclose(np_(rt.rel_pose), np.asarray(rj.rel_pose), atol=1e-3)
