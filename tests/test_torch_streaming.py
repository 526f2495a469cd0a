"""The port's streaming engine (``SlamEngine.process_chunk``, ``begin_chunk``
/ ``finish_chunk``, the GPS table) against its per-scan path and against the
JAX package's streaming engine, mirroring the pins of tests/test_slam.py:
chunked == per-scan (:152), the sparse detect cadence (:394), chunked GPS
== per-scan (:460) and pipelined == sequential (:525).  One module fixture
runs the scans, GPS on, through each engine once; the pins share it.

Tolerances: port chunked against port per-scan, the same keyframes and
loops with trajectories within 1e-3 (the JAX pin's); pipelined against
sequential and the GPS rows, bit for bit; port chunked against JAX
chunked, the same keyframes and ``dispatch_counts``, a loop-set overlap of
at least 50 % and trajectories within 0.1 m (the band of
test_torch_slam.py).  Also: a segment reads nothing on the host but the
T-slot ICP's convergence check.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.data import RadarSimulator
from navtech_radar_slam_tpu.models import slam as jslam
from navtech_radar_slam_torch.models import slam as tslam
from navtech_radar_slam_torch.ops import icp as ticp
from test_torch_slam import N_SCANS, small_cfg
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = small_cfg()
#: the engine pins run with GPS on, fixes from a table (a dropout window
#: leaves keyframes 8 .. 11 without one)
GPS_CFG = dataclasses.replace(CFG, pgo=dataclasses.replace(CFG.pgo, use_gps=True))
CHUNK = 8
#: Tensor methods that bring a value to the host
HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "__array__", "item", "cpu",
              "tolist", "numpy", "nonzero")


def _scans(n):
    sim = RadarSimulator(CFG.radar)
    gt = sim.circuit_trajectory(n + 2, radius=5.0, speed=6.0)
    return [sim.render(gt[i], noise_seed=i) for i in range(n)]


def _gps_table(n):
    """Fixes 0.03 s after each scan's time, absolute altitudes ~70 m, none
    for scans 8 .. 11; and per scan the fix the CLI would attach (the
    first within gps_time_window of the scan's time), or None."""
    times = np.arange(n) * 0.25
    fixes = [(times[i] + 0.03, 70.0 + 0.5 * i) for i in range(n) if not 8 <= i < 12]
    gps_t, gps_a = (np.asarray(x) for x in zip(*fixes))
    per_scan = []
    for ts in times:
        j = int(np.searchsorted(gps_t, ts))
        near = [c for c in (j - 1, j) if 0 <= c < len(gps_t)
                and abs(gps_t[c] - ts) < GPS_CFG.pgo.gps_time_window]
        per_scan.append(gps_a[near[0]] if near else None)
    return gps_t, gps_a, per_scan


def _per_scan(cfg, scans, gps=None):
    eng = tslam.SlamEngine(cfg, device="cpu")
    for i, s in enumerate(scans):
        if gps is not None and gps[i] is not None:
            eng.add_gps(np.array([0.0, 0.0, gps[i]]))
        eng.process(s, timestamp=i * 0.25)
    eng.current_pose()
    return eng


def _chunked(eng, scans, table=None):
    if table is not None:
        eng.set_gps_table(*table)
    for c0 in range(0, len(scans), CHUNK):
        eng.process_chunk(np.stack(scans[c0:c0 + CHUNK]),
                          timestamps=[i * 0.25 for i in range(c0, min(c0 + CHUNK, len(scans)))])
    eng.current_pose()
    return eng


class _SegmentReads:
    """Counts the host reads made while a segment runs: those made by the
    T-slot ICP's own body (its convergence checks) and all others."""

    def __init__(self):
        self.inside = False
        self.checks = 0
        self.other = []
        self.segments = 0

    def patch(self, monkeypatch):
        for name in HOST_READS:
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._counting(name, orig))
        body = tslam._kf_segment_body

        def segment(*args, **kwargs):
            self.inside = True
            self.segments += 1
            try:
                return body(*args, **kwargs)
            finally:
                self.inside = False

        monkeypatch.setattr(tslam, "_kf_segment_body", segment)

    def _counting(self, name, orig):
        def read(tensor, *args, **kwargs):
            if self.inside:
                caller = sys._getframe(1).f_code
                if caller is ticp.icp_se2_multi.__code__ and name == "__bool__":
                    self.checks += 1
                else:
                    self.other.append((name, caller.co_name, caller.co_filename))
            return orig(tensor, *args, **kwargs)
        return read


@pytest.fixture(scope="module")
def runs():
    """One set of scans, GPS on, through: the port per scan (add_gps per
    scan), the port chunked (the GPS table; host reads inside segments
    counted), the port pipelined two chunks deep, and the JAX engine
    chunked (both with the table)."""
    scans = _scans(N_SCANS)
    gps_t, gps_a, per_scan_fix = _gps_table(N_SCANS)
    per_scan = _per_scan(GPS_CFG, scans, gps=per_scan_fix)
    reads = _SegmentReads()
    with pytest.MonkeyPatch.context() as mp:
        reads.patch(mp)
        chunked = _chunked(tslam.SlamEngine(GPS_CFG, device="cpu"), scans, (gps_t, gps_a))
    pipelined = tslam.SlamEngine(GPS_CFG, device="cpu")
    pipelined.set_gps_table(gps_t, gps_a)
    for c0 in range(0, N_SCANS, CHUNK):
        pipelined.begin_chunk(np.stack(scans[c0:c0 + CHUNK]),
                              timestamps=[i * 0.25 for i in range(c0, min(c0 + CHUNK, N_SCANS))])
        if pipelined.inflight_chunks >= 2:
            pipelined.finish_chunk()
    inflight = pipelined.inflight_chunks
    pipelined_pose = pipelined.current_pose()
    jax_chunked = jslam.SlamEngine(GPS_CFG)
    _chunked(jax_chunked, scans, (gps_t, gps_a))
    return dict(scans=scans, per_scan=per_scan, chunked=chunked, reads=reads,
                pipelined=pipelined, inflight=inflight, pipelined_pose=pipelined_pose,
                jax_chunked=jax_chunked)


def _loops(eng):
    return [(e.prev_idx, e.curr_idx) for e in eng.loops]


def test_chunk_matches_per_scan(runs):
    a, b = runs["per_scan"], runs["chunked"]
    assert b.num_keyframes == a.num_keyframes == N_SCANS
    assert _loops(b) == _loops(a) and _loops(a)
    np.testing.assert_allclose(b.trajectory(), a.trajectory(), rtol=0, atol=1e-3)
    assert b.dispatch_counts["kf_segment"] >= 1
    assert b.dispatch_counts["odometry_seq"] == b.dispatch_counts["pack_odo_fetch"] == 4


def test_pipelined_matches_sequential(runs):
    """Two chunks in flight give the sequential state bit for bit; the
    output consumer drains the last chunk; a per-scan step afterwards takes
    the host carry in both."""
    a, b = runs["chunked"], runs["pipelined"]
    assert runs["inflight"] == 1 and b.inflight_chunks == 0
    assert b.num_scans == a.num_scans == N_SCANS
    assert b.num_keyframes == a.num_keyframes and _loops(b) == _loops(a)
    np.testing.assert_array_equal(runs["pipelined_pose"], a.current_pose())
    np.testing.assert_array_equal(b.trajectory(), a.trajectory())
    assert dict(b.dispatch_counts) == dict(a.dispatch_counts)


def test_port_chunked_matches_jax_chunked(runs):
    j, p = runs["jax_chunked"], runs["chunked"]
    assert p.num_keyframes == j.num_keyframes
    assert dict(p.dispatch_counts) == dict(j.dispatch_counts)
    lj, lp = set(_loops(j)), set(_loops(p))
    assert lj and lp and len(lj & lp) >= 0.5 * max(len(lj), len(lp)), (lj, lp)
    np.testing.assert_allclose(p.trajectory(), j.trajectory(), rtol=0, atol=0.1)


def test_segment_reads_only_the_convergence_check(runs):
    """Inside a segment nothing comes to the host (no found flag, no slot's
    value) but the T-slot ICP's "every slot converged" checks."""
    reads = runs["reads"]
    assert reads.segments == runs["chunked"].dispatch_counts["kf_segment"] >= 1
    assert reads.other == []
    assert reads.checks >= 1


def test_chunk_matches_per_scan_sparse_detect():
    """detect_every_n_keyframes = 2: once loops exist, every other keyframe
    takes an in-line fast refine, which _process_keyframes routes through
    the per-keyframe path; chunked still equals per-scan."""
    cfg = dataclasses.replace(
        CFG, scancontext=dataclasses.replace(CFG.scancontext, detect_every_n_keyframes=2))
    scans = _scans(N_SCANS)
    a = _per_scan(cfg, scans)
    b = _chunked(tslam.SlamEngine(cfg, device="cpu"), scans)
    assert b.num_keyframes == a.num_keyframes
    assert _loops(b) == _loops(a) and _loops(a)
    np.testing.assert_allclose(b.trajectory(), a.trajectory(), rtol=0, atol=1e-3)
    assert b.dispatch_counts["kf_segment"] >= 1 and b.dispatch_counts["kf_step"] >= 1
    assert b.dispatch_counts["pgo_fast"] >= 1


def test_chunked_gps_matches_per_scan(runs):
    """The GPS table, associated per keyframe inside the segments, writes
    the rows that add_gps() writes per scan, bit for bit: node 0 only
    latches the datum, the dropout window leaves gaps."""
    a, b = runs["per_scan"], runs["chunked"]
    n = a.num_keyframes
    assert b.num_keyframes == n and b.gps_alt_offset == a.gps_alt_offset == 70.0
    va, vb = (e.graph.g.gps_valid[:n].numpy() for e in (a, b))
    np.testing.assert_array_equal(vb, va)
    assert not va[0] and va[1:8].all() and not va[8:12].any() and va[12:].all()
    ma, mb = (e.graph.g.gps_meas[:n].numpy() for e in (a, b))
    np.testing.assert_array_equal(mb[va], ma[va])
    np.testing.assert_allclose(ma[va][:, 2], 0.5 * np.flatnonzero(va), atol=1e-5)
    assert b.dispatch_counts["kf_segment"] >= 1 and b.dispatch_counts["kf_step"] == 0


def test_per_scan_step_after_chunks(runs):
    """process() after chunks finishes them first and re-seeds the twist and
    coast from the host carry; the two engines stay equal.  It steps the
    module's engines, so it is the file's last test."""
    a, b = runs["chunked"], runs["pipelined"]
    extra = _scans(N_SCANS + 1)[N_SCANS]
    np.testing.assert_array_equal(a.process(extra, timestamp=N_SCANS * 0.25),
                                  b.process(extra, timestamp=N_SCANS * 0.25))
    assert a._twist_dev is None and b._coast_dev is None
