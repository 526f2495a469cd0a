"""Parity of the port's voxel dedup mask with the JAX package's
(``ops/voxel.py``): the masks must be identical, the lowest index keeping
each cell."""

import jax.numpy as jnp
import numpy as np
import pytest

from navtech_radar_slam_tpu.ops.voxel import voxel_dedup_mask as jmask
from navtech_radar_slam_torch.ops.voxel import voxel_dedup_mask as tmask
from torch_parity_util import np_, one_torch_thread, t  # noqa: F401 (fixture)


@pytest.mark.parametrize("voxel,scale,n", [(0.4, 50.0, 3000), (1.0, 150.0, 2000),
                                           (0.4, 2.0, 500), (0.0, 50.0, 100)])
def test_mask_identical_to_jax(voxel, scale, n):
    """Random clouds, dense (many points per cell) to sparse, a fifth of the
    points invalid, and the disabled filter (voxel 0)."""
    rng = np.random.default_rng(int(voxel * 10) + n)
    pts = rng.uniform(-scale, scale, (n, 2)).astype(np.float32)
    valid = rng.random(n) > 0.2
    want = np.asarray(jmask(jnp.asarray(pts), jnp.asarray(valid), voxel))
    got = np_(tmask(t(pts), t(valid), voxel))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_lowest_index_and_negative_cells():
    """The JAX suite's hand case: floor (not trunc) cells, the first valid
    point of a cell wins, an invalid first point hands the cell on."""
    pts = np.asarray([[-0.35, -0.35], [-0.05, -0.05], [0.05, 0.05], [0.30, 0.30]],
                     np.float32)
    for valid in ([True] * 4, [False, True, True, True]):
        want = np.asarray(jmask(jnp.asarray(pts), jnp.asarray(valid), 0.4))
        np.testing.assert_array_equal(np_(tmask(t(pts), t(np.asarray(valid)), 0.4)), want)


def test_stacked_duplicates_collapse():
    """A cloud stacked on itself five times keeps exactly the first copy."""
    rng = np.random.default_rng(3)
    base = rng.uniform(-30, 30, (200, 2)).astype(np.float32)
    pts = np.concatenate([base] * 5)
    valid = np.ones(len(pts), bool)
    got = np_(tmask(t(pts), t(valid), 0.4))
    np.testing.assert_array_equal(got, np.asarray(jmask(jnp.asarray(pts),
                                                        jnp.asarray(valid), 0.4)))
    assert not got[200:].any()
