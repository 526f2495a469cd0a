"""The control: the reference at TF32 in the program's place fails the
fleet cell's limits, where the program passes them (CPU, small)."""

import math

import pytest

from radarbench import control, harness, rehearse
from radarbench.reference.precision import round_tf32
from radarbench.tests.small import FLEET


def test_tf32_rounding_keeps_eleven_significant_bits():
    import torch
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -3.14159274, 1e-30])
    y = round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2.0 ** -10
    assert abs(y[2] / x[2] - 1) <= 2.0 ** -11 and abs(y[3] / x[3] - 1) <= 2.0 ** -11


@pytest.mark.parametrize("seed", [31, 2**33 + 1])
def test_the_control_fails_where_the_program_passes(seed):
    ctx = rehearse.context("odo_fleet_b512", seed, FLEET)
    r = control.readings(ctx, 0.5)
    ok, _ = harness.judge(r["program"], ctx.limits)
    bad, checks = harness.judge(r["control"], ctx.limits)
    assert ok and not bad, checks
    assert all(math.isfinite(v) for v in r["control"].values())
