"""The output check's numbers: a gate flipped at one ulp in one scan (one
weak peak kept by one side only) is allowed in one scan, whose descriptors
and poses stay judged, the reference following that scan's peaks; more
than that fails.  The reference carries its own twists."""

import numpy as np
import pytest
import torch

from navtech_radar_slam_torch.models import odometry
from navtech_radar_slam_torch.ops import cen2019
from radarbench import harness, rehearse
from radarbench.runners import fleet
from radarbench.tests.small import FLEET

#: every pool scan carried at the window's end: four streams on a lap of four
ALL_CARRIED = FLEET + [("traffic.lap_scans", 4)]
REAL = cen2019.cen2019_scores_batched


def _peaks_dropped(monkeypatch, ctx, scan: int, n: int) -> None:
    """The port's score maps of pool scan ``scan`` lose their ``n``
    strongest peaks, wherever the step extracts it."""
    target = odometry.decode_power(fleet.make_pool(ctx, "cpu")[scan:scan + 1], False)[0]

    def scores(power, fcfg, rcfg):
        out = REAL(power, fcfg, rcfg)
        for i, p in enumerate(power):
            if torch.equal(p, target):
                flat = out[i].view(-1)
                flat[torch.topk(flat, n).indices] = float("-inf")
        return out
    monkeypatch.setattr(cen2019, "cen2019_scores_batched", scores)


def _run(ctx):
    out = fleet.run(ctx, 0.5, False)
    fleet.release(out.state)
    return out.state


def test_a_one_peak_flip_stays_within_the_limits_and_a_wider_fault_does_not(monkeypatch):
    ctx = rehearse.context("odo_fleet_b512", 41, ALL_CARRIED)
    one_scan = dict(ctx.limits, scans_differing_share=100.0 / ctx.traffic["streams"])
    st = _run(ctx)
    assert sorted(fleet.carried_scans(st)) == [0, 1, 2, 3]
    assert harness.judge(fleet.readings(st), ctx.limits)[0]

    # scan 2 loses one peak: allowed, and judged still
    _peaks_dropped(monkeypatch, ctx, 2, 1)
    st = _run(ctx)
    r = fleet.readings(st)
    assert r["scans_differing_share"] == 25.0 and r["scans_beyond_one_flip"] == 0
    assert r["power_gap"] == 0 and r["descriptor_gap"] == 0
    assert r["rel_gap_m"] == 0 and r["rel_gap_rad"] == 0
    assert harness.judge(r, one_scan)[0] and not harness.judge(r, ctx.limits)[0]
    # ... its poses: altered where a sampled pair holds scan 2, they fail
    got = fleet.program_answers(st)
    _, prev, curr = fleet.sample(st)
    touch = (prev == 2) | (curr == 2)
    assert touch.any()
    got.rel[touch, 0] += 0.01
    assert not harness.judge(fleet.compare(st, got), one_scan)[0]
    # ... its descriptors and its powers, as those of a scan that did not flip
    for scan in (2, 0):
        i = int(np.flatnonzero(fleet.carried_scans(st) == scan)[0])
        for field, number in (("desc", "descriptor_gap"), ("power", "power_gap")):
            got = fleet.program_answers(st)
            setattr(got, field, getattr(got, field).clone())
            getattr(got, field)[i, 0] += 0.01
            r = fleet.compare(st, got)
            assert r[number] > 5e-3 and not harness.judge(r, one_scan)[0]

    # two peaks in one scan are beyond the allowance
    _peaks_dropped(monkeypatch, ctx, 2, 2)
    r = fleet.readings(_run(ctx))
    assert r["scans_beyond_one_flip"] == 1 and not harness.judge(r, one_scan)[0]


@pytest.mark.parametrize("seed", [3, 2**33 + 5])
def test_the_reference_carries_its_own_twists(seed):
    """``reference_chain`` gives what carrying every stream from step 1
    gives, with fewer registrations, where answers depend on the twist."""
    lap, n = 7, 5
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(lap, 3)).astype(np.float32)
    first = rng.random(lap) < 0.6
    ok = rng.random(lap) < 0.7
    calls = []

    def register(prev, curr, twists):
        calls.append(len(curr))
        rel = np.where(first[curr][:, None], base[curr], base[curr] + 0.5 * twists)
        return rel.astype(np.float32), ok[curr], first[curr]

    steps = rng.integers(4, 12, size=n)
    rel, good = fleet.reference_chain(register, steps, lap)
    assert sum(calls) < steps.sum()
    for b in range(n):
        twist = np.zeros(3, np.float32)
        for t in range(1, steps[b] + 1):
            r, o, _ = (x[0] for x in register(np.array([(b + t - 1) % lap]),
                                              np.array([(b + t) % lap]), twist[None]))
            twist = r if o else twist
        assert good[b] == o and np.array_equal(rel[b], r)
