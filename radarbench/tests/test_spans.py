"""The per-layer metrics that read the program's spans: each reader's value
from a span summary made by hand, nothing without a trace or without the
program's recorder; and, on the card, one batched step whose ``sync.*``
spans are every call that waits for the device, and whose span tree covers
the step."""

import warnings

import pytest
import torch

from navtech_radar_slam_torch.utils import profiling
from radarbench import harness, rehearse, spans
from radarbench.runners import fleet

STEPS = 4
SUMMARY = {
    "odo.step": {"count": STEPS, "host_ms": 2000.0, "self_ms": 4.0, "device_ms": 1960.0},
    "odo.extract": {"count": STEPS, "host_ms": 80.0, "self_ms": 20.0, "device_ms": 1000.0},
    "odo.descriptors": {"count": STEPS, "host_ms": 40.0, "self_ms": 40.0, "device_ms": 920.0},
    "sync.topk": {"count": STEPS, "host_ms": 60.0, "self_ms": 60.0, "device_ms": 61.0},
    "sync.bincount": {"count": STEPS, "host_ms": 2.0, "self_ms": 2.0, "device_ms": 2.0},
    "sync.second_best": {"count": STEPS, "host_ms": 4.0, "self_ms": 4.0, "device_ms": 4.0},
    "odo.register_step": {"count": STEPS, "host_ms": 1600.0, "self_ms": 100.0,
                          "device_ms": 940.0},
    "odo.match": {"count": STEPS, "host_ms": 100.0, "self_ms": 100.0, "device_ms": 120.0},
    "odo.register": {"count": 3 * STEPS, "host_ms": 1400.0, "self_ms": 1300.0,
                     "device_ms": 800.0},
    "odo.spectral": {"count": 3 * STEPS, "host_ms": 100.0, "self_ms": 100.0,
                     "device_ms": 180.0},
    "kf_step": {"count": 1, "host_ms": 5.0, "self_ms": 5.0, "device_ms": 5.0},
}
#: each new reader's value per step from SUMMARY
WANT = {
    "fleet_extract_device_ms": 250.0,
    "fleet_descriptors_device_ms": 230.0,
    "fleet_match_device_ms": 30.0,
    "fleet_register_device_ms": 200.0,
    "fleet_spectral_device_ms": 45.0,
    "fleet_register_issue_ms": 400.0,
    "fleet_topk_wait_ms": 15.0,
    "fleet_host_syncs_per_step": 3.0,
}


def _traced():
    return harness.Records(trace=object())


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_gives_the_per_step_value(metric, monkeypatch):
    monkeypatch.setattr(profiling, "summary", lambda: SUMMARY)
    read = harness.reader(metric).read
    assert read(_traced()) == pytest.approx(WANT[metric], rel=1e-12)
    assert read(harness.Records()) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_finds_nothing_without_the_programs_spans(metric, monkeypatch):
    """A traced run of a program with no span recorder (the parent of the
    recorder), or whose spans hold no step, reads nothing and raises
    nothing."""
    read = harness.reader(metric).read
    monkeypatch.setattr(profiling, "summary", lambda: {})
    assert read(_traced()) is None
    monkeypatch.delattr(profiling, "summary")
    assert read(_traced()) is None


def test_every_span_reader_is_declared():
    spec = harness.load_spec()
    declared = {m["name"]: m for m in spec["per_layer"]}
    for metric in WANT:
        m = declared[metric]
        assert m["source"] == "program_span" and m["moves"] == "odo_scans_per_s"
        assert m["workloads"] == ["odo_fleet_b512"]


@pytest.mark.cuda
def test_sync_spans_are_the_steps_syncs_and_the_tree_covers_the_step(card):
    """One batched step at B = 8 of the cell's configuration, under the
    profiler and ``torch.cuda.set_sync_debug_mode("warn")``: the calls it
    warns of (one line of the program each; a call may sync more than once
    inside, as ``bincount`` reads its input's min and max) are as many as
    the ``sync.*`` spans, and each warning comes while one is open;
    ``odo.step``'s device ms is within 5 % of ``odo.extract``'s and
    ``odo.register_step``'s together, and each stage's device ms holds
    those of the stages inside it."""
    sets = [("traffic.streams", 8), ("traffic.lap_scans", 16), ("traffic.warm_steps", 1)]
    st = fleet.setup(rehearse.context("odo_fleet_b512", 2**31 + 5, sets, device=str(card)))
    idx = torch.as_tensor(fleet.scan_index(torch.arange(8).numpy(), 2, st.lap), device=card)
    powers = st.pool[idx]
    torch.cuda.synchronize()
    caught = []   # ((file, line), the innermost span open then)

    def note(message, category, filename, lineno, *rest):
        if "called a synchronizing CUDA operation" in str(message):
            caught.append(((filename, lineno),
                           profiling._OPEN[-1].name if profiling._OPEN else ""))

    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st.step(powers, st.az, st.carry, st.twists)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    s = profiling.summary()
    syncs = sum(v["count"] for k, v in s.items() if k.startswith(spans.SYNC))
    assert len({site for site, _ in caught}) == syncs, caught
    assert all(inside.startswith(spans.SYNC) for _, inside in caught), caught
    assert s["odo.step"]["count"] == 1
    dev = {k: v["device_ms"] for k, v in s.items()}
    inner = dev["odo.extract"] + dev["odo.register_step"]
    assert abs(dev["odo.step"] - inner) <= 0.05 * dev["odo.step"], dev
    assert dev["odo.descriptors"] <= dev["odo.extract"]
    assert dev["odo.spectral"] <= dev["odo.register"] <= dev["odo.register_step"]
    profiling.reset()
