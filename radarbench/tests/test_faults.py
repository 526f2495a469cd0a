"""The output check catches a broken timed path: a run of the fleet cell on
the CPU (small), with the look for a card skipped and the port's batched
step broken underneath, comes out not correct, once for each fault the cell
can have.  (It runs on one card: no exchange between chips to leave out.)"""

import pytest
import torch

from navtech_radar_slam_torch.models import odometry
from radarbench import rehearse
from radarbench.tests.small import FLEET

REAL = odometry.make_batched_odometry_step


def _unchanged(cfg, device="cpu"):
    real = REAL(cfg, device)

    def step(powers, az, prev, twists, **kw):
        _, res, out = real(powers, az, prev, twists, **kw)
        return prev, res, out
    return step


def _half_batch(cfg, device="cpu"):
    real = REAL(cfg, device)

    def step(powers, az, prev, twists, **kw):
        h = powers.shape[0] // 2
        carry, res, out = real(powers[:h], az, type(prev)(*(f[:h] for f in prev)),
                               twists[:h], **kw)

        def fill(x):
            return torch.cat([x, x[:powers.shape[0] - h]])
        return (type(carry)(*map(fill, carry)), type(res)(*map(fill, res)),
                type(out)(*map(fill, out)))
    return step


def _altered(cfg, device="cpu"):
    real = REAL(cfg, device)

    def step(powers, az, prev, twists, **kw):
        carry, res, out = real(powers, az, prev, twists, **kw)
        rel = res.rel_pose.clone()
        rel[0, 0] += 0.05
        return carry, res._replace(rel_pose=rel), out
    return step


def _run(seed):
    return rehearse.rehearse(rehearse.context("odo_fleet_b512", seed, FLEET), 0.5)


def test_a_sound_run_is_correct():
    correct, checks, _ = _run(21)
    assert correct, checks


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch_left_out", "answer_altered"])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(odometry, "make_batched_odometry_step", fault)
    correct, checks, _ = _run(22)
    assert not correct, checks
