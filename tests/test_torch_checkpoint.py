"""Persistence and the engine's run-time tools in the port, against the JAX
package: ``utils/checkpoint.py`` (``save_engine`` / ``load_engine``, both
ways across the packages; tests/test_cli.py:101, tests/test_slam.py:374),
the loop-debug dumps (tests/test_slam.py:281), ``prewarm``
(tests/test_slam.py:431), the ``StageTimers`` stage names, and capacity
growth (tests/test_slam.py:132) through a checkpoint.

One module fixture streams 22 scans (chunks of 8, GPS from a table,
``loop_debug_dir`` and ``timers`` set) through a JAX engine and a port
engine, both prewarmed first, and through a port engine that was not.

Tolerances: checkpoint arrays and counters bit for bit (the same keys,
dtypes and shapes); the prewarmed port run equal to the unwarmed one bit
for bit; the stage names and their call counts equal; the loop-debug files
of the two runs, the same names and verdicts with the scalars within the
verification tolerances of test_torch_slam.py, and from one shared state
(a JAX checkpoint loaded in both packages) the same fields with the query
cloud exact and the submap within 5e-5 (sin/cos rounding: a few float32
ulps at the submaps' 50 m); chunked against per scan through a capacity
growth, the same keyframes and loops with trajectories within 1e-3.
"""

import dataclasses

import numpy as np
import pytest

from navtech_radar_slam_tpu.models import slam as jslam
from navtech_radar_slam_tpu.utils import checkpoint as jckpt
from navtech_radar_slam_tpu.utils.profiling import StageTimers as JStageTimers
from navtech_radar_slam_torch.data import RadarSimulator
from navtech_radar_slam_torch.models import slam as tslam
from navtech_radar_slam_torch.utils import checkpoint as tckpt
from navtech_radar_slam_torch.utils.profiling import StageTimers
from test_torch_slam import small_cfg
from torch_parity_util import np_, one_torch_thread  # noqa: F401 (autouse fixture)

_C = small_cfg()
CFG = dataclasses.replace(_C, pgo=dataclasses.replace(_C.pgo, use_gps=True))
CHUNK = 8
#: a lap and a keyframe: the last keyframes close loops back to the first
N_SCANS = 22
TIMES = [i * 0.25 for i in range(N_SCANS + 2)]
#: a fix 0.03 s after each scan, absolute altitudes from 70 m
GPS = (np.asarray(TIMES) + 0.03, 70.0 + 0.5 * np.arange(N_SCANS + 2))
STATE = ("clouds", "clouds_valid", "bank", "ring_keys")


def _snapshot(eng) -> dict:
    d = {name: np_(getattr(eng, name)).copy() for name in STATE}
    d.update({f"graph_{k}": np_(v).copy() for k, v in eng.graph.g._asdict().items()})
    d.update(num_keyframes=eng.num_keyframes, num_scans=eng.num_scans,
             nodes=eng.graph.num_nodes, counts=dict(eng.dispatch_counts))
    return d


def _stream(eng, scans):
    """The first N_SCANS scans in chunks, GPS from the table."""
    eng.set_gps_table(*GPS)
    for c0 in range(0, N_SCANS, CHUNK):
        c1 = min(c0 + CHUNK, N_SCANS)
        eng.process_chunk(np.stack(scans[c0:c1]), timestamps=TIMES[c0:c1])
    eng.current_pose()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ck")
    sim = RadarSimulator(CFG.radar)
    gt = sim.circuit_trajectory(N_SCANS + 2, radius=5.0, speed=6.0)
    scans = [sim.render(gt[i], noise_seed=i) for i in range(N_SCANS + 2)]
    out = {"scans": scans, "root": root}
    for name, eng, timers in (("jax", jslam.SlamEngine(CFG), JStageTimers()),
                              ("torch", tslam.SlamEngine(CFG, device="cpu"), StageTimers())):
        before = _snapshot(eng)
        eng.prewarm(N_SCANS, chunk=CHUNK)
        out[f"{name}_prewarm"] = (before, _snapshot(eng))
        (root / name).mkdir()
        eng.loop_debug_dir = str(root / name)
        eng.timers = timers
        _stream(eng, scans)
        out[name] = eng
        out[f"{name}_stages"] = dict(timers._count)
    cold = tslam.SlamEngine(CFG, device="cpu")
    _stream(cold, scans)
    out["cold"] = cold
    jckpt.save_engine(out["jax"], str(root / "jax.npz"))
    tckpt.save_engine(out["torch"], str(root / "torch.npz"))
    return out


def test_prewarm_leaves_state_and_run_alone(runs):
    """``prewarm`` leaves every engine array, counter and dispatch count as
    it was, in both packages, and the port's run after it equals an
    unwarmed run bit for bit; the two prewarmed runs agree."""
    for name in ("jax", "torch"):
        before, after = runs[f"{name}_prewarm"]
        assert after.keys() == before.keys()
        for key, val in before.items():
            np.testing.assert_array_equal(np.asarray(after[key]), np.asarray(val),
                                          err_msg=f"{name} {key}")
        assert before["num_keyframes"] == 0 and not before["counts"]
    teng, cold, jeng = runs["torch"], runs["cold"], runs["jax"]
    np.testing.assert_array_equal(teng.trajectory(), cold.trajectory())
    for name in STATE:
        np.testing.assert_array_equal(np_(getattr(teng, name)), np_(getattr(cold, name)))
    assert [e[:2] for e in teng.loops] == [e[:2] for e in cold.loops]
    assert teng.num_keyframes == jeng.num_keyframes == N_SCANS
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts)
    np.testing.assert_allclose(teng.trajectory(), np.asarray(jeng.trajectory()), rtol=0,
                               atol=0.1)


def test_stage_names_match_jax(runs):
    """The same chunked run times the same stages, as often, in both
    engines."""
    stages = runs["torch_stages"]
    assert stages == runs["jax_stages"]
    for stage in ("odometry_seq", "odo_fetch", "kf_segment", "loop_fetch", "loop_debug_dump",
                  "pgo_refine_full"):
        assert stages.get(stage, 0) > 0, stage


def _dumps(directory):
    return {p.name: dict(np.load(p)) for p in sorted(directory.glob("loop_*.npz"))}


def test_loop_debug_artifacts_match_jax(runs):
    """Each run dumps every decision that found a candidate: the same file
    names and verdicts, the fields of the JAX file, the scalars within the
    verification tolerances, accepted and rejected alike."""
    dj, dt = _dumps(runs["root"] / "jax"), _dumps(runs["root"] / "torch")
    assert dt.keys() == dj.keys() and any(k.endswith("_accepted.npz") for k in dt)
    assert len([k for k in dt if k.endswith("_accepted.npz")]) >= len(runs["torch"].loops)
    for name, zj in dj.items():
        zt = dt[name]
        assert zt.keys() == zj.keys()
        for key in ("prev_idx", "curr_idx", "accepted"):
            assert zt[key] == zj[key] and zt[key].dtype == zj[key].dtype, (name, key)
        np.testing.assert_allclose(zt["sc_dist"], zj["sc_dist"], atol=2e-5)
        np.testing.assert_allclose(zt["sc_yaw_init"], zj["sc_yaw_init"], atol=1e-6)
        np.testing.assert_allclose(zt["icp_fitness"], zj["icp_fitness"], rtol=2e-2)
        np.testing.assert_allclose(zt["rel_pose"], zj["rel_pose"], atol=1e-3)
        for key in ("query_xy", "submap_xy"):
            assert zt[key].dtype == zj[key].dtype and zt[key].shape[1:] == (2,)


def test_loop_debug_dump_from_one_state(runs, tmp_path):
    """``_dump_loop_debug`` on one state (the JAX checkpoint loaded in both
    packages) writes the same file: the decision fields and the query cloud
    exactly, the submap's points within 5e-5."""
    path = str(runs["root"] / "jax.npz")
    jeng, teng = jckpt.load_engine(path), tckpt.load_engine(path, device="cpu")
    ev = runs["jax"].loops[0]
    for eng, sub in ((jeng, "j"), (teng, "t")):
        (tmp_path / sub).mkdir()
        eng.loop_debug_dir = str(tmp_path / sub)
        eng._dump_loop_debug(ev.curr_idx, ev.prev_idx, True, ev.sc_dist, 0.25,
                             ev.icp_fitness, np.asarray(ev.rel_pose, np.float64))
    (name, zj), = _dumps(tmp_path / "j").items()
    zt = _dumps(tmp_path / "t")[name]
    for key in zj:
        if key == "submap_xy":
            assert zt[key].shape == zj[key].shape and len(zt[key]) > 0
            np.testing.assert_allclose(zt[key], zj[key], rtol=0, atol=5e-5)
        else:
            np.testing.assert_array_equal(zt[key], zj[key], err_msg=key)
            assert zt[key].dtype == zj[key].dtype, key


def test_checkpoint_keys_match_jax(runs):
    """The port's file holds the JAX file's keys, each with its dtype and
    shape, and the same config."""
    zj = np.load(runs["root"] / "jax.npz")
    zt = np.load(runs["root"] / "torch.npz")
    assert sorted(zt.files) == sorted(zj.files)
    for key in zj.files:
        assert (zt[key].dtype, zt[key].shape) == (zj[key].dtype, zj[key].shape), key
    assert str(zt["config"]) == str(zj["config"])


def _assert_same_state(got, want):
    """Two engines (either package) hold the same checkpointed state."""
    for name in STATE:
        np.testing.assert_array_equal(np_(getattr(got, name)), np_(getattr(want, name)), name)
    np.testing.assert_array_equal(np.asarray(got.trajectory()), np.asarray(want.trajectory()))
    for attr in ("num_keyframes", "num_scans", "session_start", "_rebased", "gps_alt_offset",
                 "movement_accum"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert (got.graph.num_nodes, got.graph.num_loops) == (want.graph.num_nodes,
                                                          want.graph.num_loops)
    assert [tuple(e[:4]) for e in got.loops] == [tuple(e[:4]) for e in want.loops]
    np.testing.assert_array_equal(np.asarray(got.odometry.pose), np.asarray(want.odometry.pose))


def test_jax_checkpoint_resumes_in_port(runs):
    """The port's ``load_engine`` takes a JAX checkpoint: the same bank,
    trajectory, counters, loops and GPS datum; the first scan after it
    re-seeds the odometry (no keyframe), the next one moves on."""
    jeng, scans = runs["jax"], runs["scans"]
    eng = tckpt.load_engine(str(runs["root"] / "jax.npz"), device="cpu")
    assert eng.gps_alt_offset == 70.0 and jeng.loops
    _assert_same_state(eng, jeng)
    eng.process(scans[N_SCANS], timestamp=TIMES[N_SCANS])
    assert eng.num_keyframes == N_SCANS and eng.odometry.prev is not None
    eng.process(scans[N_SCANS + 1], timestamp=TIMES[N_SCANS + 1])
    assert eng.num_keyframes == N_SCANS + 1 and eng.num_scans == N_SCANS + 2


def test_port_checkpoint_resumes_in_jax(runs):
    """The JAX ``load_engine`` takes the port's checkpoint with the same
    state, and so does the port's own (tests/test_cli.py:101)."""
    teng = runs["torch"]
    path = str(runs["root"] / "torch.npz")
    _assert_same_state(jckpt.load_engine(path), teng)
    back = tckpt.load_engine(path, device="cpu")
    _assert_same_state(back, teng)
    np.testing.assert_array_equal(back.odometry.last_rel, teng.odometry.last_rel)


def test_capacity_growth_through_a_checkpoint(runs, tmp_path):
    """Started at 16 keyframes, the port grows its capacity mid-run alike per
    scan and chunked (tests/test_slam.py:132), and the grown engine's
    checkpoint reloads at the grown capacity in both packages."""
    cfg = dataclasses.replace(
        CFG, keyframes=dataclasses.replace(CFG.keyframes, max_keyframes=16),
        pgo=dataclasses.replace(CFG.pgo, use_gps=False, max_nodes=16, max_loop_edges=4))
    scans = runs["scans"][:N_SCANS]
    per_scan = tslam.SlamEngine(cfg, device="cpu")
    for s, ts in zip(scans, TIMES):
        per_scan.process(s, timestamp=ts)
    per_scan.current_pose()
    chunked = tslam.SlamEngine(cfg, device="cpu")
    for c0 in range(0, N_SCANS, CHUNK):
        c1 = min(c0 + CHUNK, N_SCANS)
        chunked.process_chunk(np.stack(scans[c0:c1]), timestamps=TIMES[c0:c1])
    chunked.current_pose()
    grown = chunked.cfg.keyframes.max_keyframes
    assert grown >= 32 and per_scan.cfg.keyframes.max_keyframes == grown
    assert chunked.num_keyframes == per_scan.num_keyframes == N_SCANS
    assert chunked.loops and ([e[:2] for e in chunked.loops] == [e[:2] for e in per_scan.loops])
    np.testing.assert_allclose(chunked.trajectory(), per_scan.trajectory(), rtol=0, atol=1e-3)

    path = str(tmp_path / "grown.npz")
    tckpt.save_engine(chunked, path)
    for eng in (tckpt.load_engine(path, device="cpu"), jckpt.load_engine(path)):
        assert eng.cfg.keyframes.max_keyframes == grown == eng.clouds.shape[0]
        assert eng.graph.g.poses.shape[0] == chunked.cfg.pgo.max_nodes
        _assert_same_state(eng, chunked)
