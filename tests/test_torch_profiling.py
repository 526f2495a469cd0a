"""The port's program spans (``utils/profiling.py``): off, and free, with no
profiler session; under ``torch.profiler`` the batched odometry step
records its span tree, the profiler's timeline holds every span, and the
step's outputs do not change; an engine stage timed by ``StageTimers`` is
a span too.  A small batched step (B = 2, narrow scans) on the CPU."""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from navtech_radar_slam_torch.config import SlamConfig
from navtech_radar_slam_torch.models import odometry as odo
from navtech_radar_slam_torch.models.slam import SlamEngine
from navtech_radar_slam_torch.utils import profiling
from torch_parity_util import one_torch_thread  # noqa: F401 (fixture)

B = 2

#: the batched step's spans, (name, parent), in the order they open
TREE = [
    ("odo.step", None),
    ("odo.extract", "odo.step"),
    ("sync.topk", "odo.extract"),
    ("sync.bincount", "odo.extract"),
    ("odo.descriptors", "odo.extract"),
    ("odo.register_step", "odo.step"),
    ("odo.match", "odo.register_step"),
    ("sync.second_best", "odo.match"),
] + [("odo.register", "odo.register_step"), ("odo.spectral", "odo.register")] * 3


def small_cfg() -> SlamConfig:
    c = SlamConfig()
    return dataclasses.replace(
        c,
        radar=dataclasses.replace(c.radar, num_azimuths=64, num_range_bins=500),
        features=dataclasses.replace(c.features, max_features=64, max_matches=32),
        registration=dataclasses.replace(c.registration, spectral_top_k=32, gnc_max_iters=4,
                                         cote_iters=2, refine_iters=2),
    )


CFG = small_cfg()


@pytest.fixture(scope="module")
def inputs():
    """(prev scans, scans, azimuths, twists): B streams of random 8-bit scans."""
    g = torch.Generator().manual_seed(7)
    shape = (B, CFG.radar.num_azimuths, CFG.radar.padded_range_bins)
    scans = [torch.randint(0, 256, shape, generator=g, dtype=torch.uint8) for _ in range(2)]
    twists = torch.tensor([[0.5, 0.0, 0.01], [0.0, 0.0, 0.0]])
    return scans[0], scans[1], torch.as_tensor(odo.default_azimuths(CFG)), twists


@pytest.fixture(autouse=True)
def no_records():
    profiling.reset()
    yield
    profiling.reset()


def _step(inputs):
    prev_scans, scans, az, twists = inputs
    prev = odo.extract_scan_features_batched(prev_scans, az, CFG)
    step = odo.make_batched_odometry_step(CFG, device="cpu")
    return step(scans, az, prev, twists)


def _flat(out):
    """The step's outputs as a flat list of tensors."""
    return [x for part in out for x in part]


def test_no_profiler_no_span(inputs, monkeypatch):
    """With no profiler session a step records nothing, and a span enters
    no ``record_function`` and makes no CUDA event."""
    def refuse(*args, **kwargs):
        raise AssertionError("entered with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    _step(inputs)
    with profiling.span("odo.step"), profiling.StageTimers().time("kf_step"):
        pass
    assert profiling.RECORDS == []
    assert profiling.summary() == {}


def test_step_records_its_span_tree(inputs):
    """Under the profiler on the CPU: the seed's extraction and the step's
    tree, each span with its parent, the per-step counts of the table in
    ``PERF.md`` §3, host times that nest, and no device ms."""
    with torch.profiler.profile():
        _step(inputs)
    recs = profiling.RECORDS
    seed = [("odo.extract", None), ("sync.topk", "odo.extract"),
            ("sync.bincount", "odo.extract"), ("odo.descriptors", "odo.extract")]
    assert [(r.name, r.parent and r.parent.name) for r in recs] == seed + TREE
    for r in recs:
        assert r.host_start <= r.host_end
        if r.parent is not None:
            assert r.parent.host_start <= r.host_start and r.host_end <= r.parent.host_end
    s = profiling.summary()
    assert {k: v["count"] for k, v in s.items()} == Counter(n for n, _ in seed + TREE)
    assert all(v["device_ms"] is None for v in s.values())
    step = s["odo.step"]
    inner = [r.host_ms for r in recs if r.parent is not None and r.parent.name == "odo.step"]
    assert step["self_ms"] == pytest.approx(step["host_ms"] - sum(inner), abs=1e-9)
    assert 0 <= step["self_ms"] <= step["host_ms"]


def test_profiler_timeline_holds_every_span(inputs):
    with torch.profiler.profile() as prof:
        _step(inputs)
    names = {e.name for e in prof.events()}
    assert {name for name, _ in TREE} <= names


def test_step_outputs_bit_equal_with_profiler_on_and_off(inputs):
    off = _flat(_step(inputs))
    with torch.profiler.profile():
        on = _flat(_step(inputs))
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_engine_stage_is_a_span():
    """A ``SlamEngine`` stage timed through ``StageTimers`` (the keyframe
    step of the second scan) is recorded as a span, beside the odometry
    step's spans, and the timers' statistics are kept as before."""
    rng = np.random.default_rng(0)
    scans = rng.random((2, CFG.radar.num_azimuths, CFG.radar.padded_range_bins),
                       dtype=np.float32)
    eng = SlamEngine(CFG, device="cpu")
    eng.timers = profiling.StageTimers()
    eng.process(scans[0], timestamp=0.0)
    before = dict(eng.timers._count)
    with torch.profiler.profile() as prof:
        eng.process(scans[1], timestamp=0.25)
    timed = {k: v - before.get(k, 0) for k, v in eng.timers._count.items()}
    timed = {k: v for k, v in timed.items() if v}
    assert "kf_step" in timed
    s = profiling.summary()
    for stage, n in timed.items():
        assert s[stage]["count"] == n
    assert s["odo.step"]["count"] == 1
    assert "kf_step" in {e.name for e in prof.events()}
    assert "kf_step" in eng.timers.report()
