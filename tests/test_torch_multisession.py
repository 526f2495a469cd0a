"""Multi-session in the port (``SlamEngine.attach_prior_session``,
``_rebase_session``) against the JAX engine, mirroring
tests/test_multisession.py: one JAX session-A checkpoint is attached in
both packages and session B runs per scan in each (:17), attaching after a
scan raises (:68), and in the port chunked equals per scan (:84).  Also:
an attached engine that has not rebased yet saves and reloads with its
flag.

Session A maps 12 scans of the radius-5 circuit (over half a lap);
session B starts at scan 3's true pose and drives 8 scans over the mapped
part, with other noise.

Tolerances: the attached state equals JAX's (banks bit for bit, graph poses
and odometry factors within 1e-6); port against JAX after session B, the
same keyframes, an inter-session loop in both, a loop-set overlap of at
least 50 % and trajectories within 0.1 m (the band of test_torch_slam.py);
port chunked against port per scan, the same loops and trajectories within
1e-3 (the JAX pin's); a mean placement error of session B under 1.5 m (the
JAX pin's).
"""

import dataclasses

import numpy as np
import pytest

from navtech_radar_slam_tpu.models import slam as jslam
from navtech_radar_slam_tpu.utils import checkpoint as jckpt
from navtech_radar_slam_torch.data import RadarSimulator
from navtech_radar_slam_torch.models import slam as tslam
from navtech_radar_slam_torch.utils import checkpoint as tckpt
from navtech_radar_slam_torch.utils.geometry import se2_between_np
from test_torch_slam import small_cfg
from torch_parity_util import np_, one_torch_thread  # noqa: F401 (autouse fixture)

_C = small_cfg()
CFG = dataclasses.replace(_C, pgo=dataclasses.replace(_C.pgo, odom_sigma_rot=0.005,
                                                      odom_sigma_trans=0.05))
N_A, OFFSET, N_B = 12, 3, 8
CHUNK = 8


def _inter(eng, start):
    return [(e.prev_idx, e.curr_idx) for e in eng.loops if e.prev_idx < start <= e.curr_idx]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Session A in the JAX engine, saved; session B attached to it in the
    JAX engine and in the port, per scan, and in the port chunked."""
    root = tmp_path_factory.mktemp("ms")
    sim = RadarSimulator(CFG.radar)
    gt = sim.circuit_trajectory(N_A + OFFSET + N_B, radius=5.0, speed=6.0)
    eng_a = jslam.SlamEngine(CFG)
    for i in range(N_A):
        eng_a.process(sim.render(gt[i], noise_seed=i), timestamp=i * 0.25)
    ck = str(root / "session_a.npz")
    jckpt.save_engine(eng_a, ck)

    gt_b = gt[OFFSET:OFFSET + N_B]
    scans = [sim.render(gt_b[i], noise_seed=500 + i) for i in range(N_B)]
    times = [100 + i * 0.25 for i in range(N_B)]
    jeng = jslam.SlamEngine(CFG)
    teng = tslam.SlamEngine(CFG, device="cpu")
    for eng in (jeng, teng):
        eng.attach_prior_session(ck)
        for s, ts in zip(scans, times):
            eng.process(s, timestamp=ts)
        eng.current_pose()
    chunked = tslam.SlamEngine(CFG, device="cpu")
    chunked.attach_prior_session(ck)
    for c0 in range(0, N_B, CHUNK):
        chunked.process_chunk(np.stack(scans[c0:c0 + CHUNK]), timestamps=times[c0:c0 + CHUNK])
    chunked.current_pose()
    return ck, gt, gt_b, eng_a, jeng, teng, chunked


def test_attach_matches_jax(sessions):
    """The attached prior: banks, clouds and carried factors as the JAX
    engine writes them, the session flags, and no scan processed."""
    ck = sessions[0]
    jeng = jslam.SlamEngine(CFG)
    teng = tslam.SlamEngine(CFG, device="cpu")
    jeng.attach_prior_session(ck)
    teng.attach_prior_session(ck)
    assert teng.num_keyframes == teng.session_start == jeng.session_start == N_A
    assert teng.graph.num_nodes == N_A and teng.graph.num_loops == jeng.graph.num_loops
    assert not teng._rebased and not jeng._rebased
    for name in ("clouds", "clouds_valid", "bank", "ring_keys"):
        np.testing.assert_array_equal(np_(getattr(teng, name)), np.asarray(getattr(jeng, name)))
    for name in ("poses", "odom_meas", "odom_valid", "loop_i", "loop_j", "loop_meas",
                 "loop_valid", "gps_meas", "gps_valid"):
        np.testing.assert_allclose(np_(getattr(teng.graph.g, name)),
                                   np.asarray(getattr(jeng.graph.g, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert teng.kf_times == [float(x) for x in jeng.kf_times]
    np.testing.assert_allclose(np.asarray(teng.odom_poses), np.asarray(jeng.odom_poses),
                               rtol=0, atol=1e-6)


def test_session_b_matches_jax(sessions):
    """Both engines join the sessions with an inter-session loop, rebase,
    and place session B alike, near its true poses in session A's frame."""
    _, gt, gt_b, eng_a, jeng, teng, _ = sessions
    assert teng.num_keyframes == jeng.num_keyframes > N_A
    inter_t, inter_j = _inter(teng, N_A), _inter(jeng, N_A)
    assert inter_t and inter_j, (inter_t, inter_j)
    assert teng._rebased and jeng._rebased
    loops_t = {(e.prev_idx, e.curr_idx) for e in teng.loops}
    loops_j = {(e.prev_idx, e.curr_idx) for e in jeng.loops}
    assert len(loops_t & loops_j) >= 0.5 * max(len(loops_t), len(loops_j)), (loops_t, loops_j)
    traj_t = teng.trajectory()
    np.testing.assert_allclose(traj_t, np.asarray(jeng.trajectory()), rtol=0, atol=0.1)
    errs = [np.linalg.norm(traj_t[j][:2, 3] - se2_between_np(gt[0], gt_b[j - N_A])[:2])
            for j in range(N_A, teng.num_keyframes)]
    assert np.mean(errs) < 1.5, errs
    # the prior session stays anchored
    np.testing.assert_allclose(traj_t[0], np.asarray(eng_a.trajectory()[0]), rtol=0,
                               atol=1e-5)


def test_attach_requires_fresh_engine(sessions):
    eng = tslam.SlamEngine(CFG, device="cpu")
    eng.process(RadarSimulator(CFG.radar).render(np.array([5.0, 0.0, 0.0]), noise_seed=0))
    with pytest.raises(RuntimeError):
        eng.attach_prior_session(sessions[0])


def test_chunked_matches_per_scan(sessions):
    """Session B streamed in chunks reproduces the per-scan merge: the same
    keyframes, inter-session loops and rebase (the segments keep the session
    gap), trajectories within 1e-3."""
    *_, teng, chunked = sessions
    assert chunked.num_keyframes == teng.num_keyframes
    assert chunked._rebased and _inter(chunked, N_A)
    assert ([(e.prev_idx, e.curr_idx) for e in chunked.loops]
            == [(e.prev_idx, e.curr_idx) for e in teng.loops])
    np.testing.assert_allclose(chunked.trajectory(), teng.trajectory(), rtol=0, atol=1e-3)


def test_unrebased_state_round_trip(sessions, tmp_path):
    """An attached engine that has not met an inter-session loop yet saves
    with rebased=False, and both packages reload it so."""
    eng = tslam.SlamEngine(CFG, device="cpu")
    eng.attach_prior_session(sessions[0])
    path = str(tmp_path / "attached.npz")
    tckpt.save_engine(eng, path)
    assert not bool(np.load(path)["rebased"])
    back = tckpt.load_engine(path, device="cpu")
    assert not back._rebased and back.session_start == N_A == back.num_keyframes
    jback = jckpt.load_engine(path)
    assert not jback._rebased and jback.session_start == N_A
    np.testing.assert_array_equal(back.trajectory(), eng.trajectory())
