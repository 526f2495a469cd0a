"""Parity of the port's constellation descriptors and matcher, and of its
Cartesian utilities (polar -> Cartesian rendering, bilinear sampling,
radially-aligned patch descriptors), with JAX."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navtech_radar_slam_tpu.config import FeatureConfig, RadarConfig
from navtech_radar_slam_tpu.ops import features as jfeat
from navtech_radar_slam_torch.ops import features as tfeat
from torch_parity_util import np_, one_torch_thread, t, tuple_np  # noqa: F401 (fixture)


def _points(seed, K):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-80, 80, (K, 2)).astype(np.float32)
    xy[0] = 0.0          # a point at the sensor: the radial frame's fallback
    power = rng.uniform(0.05, 1.0, K).astype(np.float32)
    valid = rng.random(K) > 0.2
    return xy, power, valid


@pytest.mark.parametrize("K,grid,window", [(256, 16, 64.0), (64, 8, 48.0)])
def test_constellation_descriptors_match_jax(K, grid, window):
    """Unit-norm descriptors agree to 1e-5: the (K, K, P) contraction sums
    in another order (true fp32 on both sides)."""
    fcfg = FeatureConfig(max_features=K, desc_grid=grid, desc_window=window)
    xy, power, valid = _points(K, K)
    want = np.asarray(jax.jit(lambda *a: jfeat.constellation_descriptors(*a, fcfg))(
        jnp.asarray(xy), jnp.asarray(power), jnp.asarray(valid)))
    got = np_(tfeat.constellation_descriptors(t(xy), t(power), t(valid), fcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _descriptors(seed, K, D, n_shared):
    """Two descriptor sets where the first ``n_shared`` of B are noisy copies
    of a permutation of A's rows, the rest unrelated."""
    rng = np.random.default_rng(seed)
    da = rng.standard_normal((K, D)).astype(np.float32)
    perm = rng.permutation(K)[:n_shared]
    db = rng.standard_normal((K, D)).astype(np.float32)
    db[:n_shared] = da[perm] + 0.3 * rng.standard_normal((n_shared, D))
    da /= np.linalg.norm(da, axis=1, keepdims=True)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    return da, db


def test_match_features_match_jax():
    """Same descriptors in, identical matched indices and validity out."""
    K, D = 256, 64
    fcfg = FeatureConfig(max_features=K, max_matches=128)
    da, db = _descriptors(0, K, D, 180)
    rng = np.random.default_rng(1)
    xa = rng.uniform(-60, 60, (K, 2)).astype(np.float32)
    xb = rng.uniform(-60, 60, (K, 2)).astype(np.float32)
    va, vb = rng.random(K) > 0.1, rng.random(K) > 0.1
    fa, fb = rng.random(K).astype(np.float32), rng.random(K).astype(np.float32)
    args = (da, db, xa, xb, va, vb)
    want = tuple_np(jax.jit(
        lambda da, db, xa, xb, va, vb, fa, fb: jfeat.match_features(
            da, db, xa, xb, va, vb, fcfg, fa, fb))(*map(jnp.asarray, args + (fa, fb))))
    got = tuple_np(tfeat.match_features(*map(t, args), fcfg, t(fa), t(fb)))
    assert want["valid"].sum() > 50
    np.testing.assert_array_equal(got["valid"], want["valid"])
    # the matched points are gathered, so identical indices give identical xy
    for name in ("src_xy", "dst_xy", "src_frac", "dst_frac"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("src_range", "dst_range", "weight"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_match_features_ties_take_first():
    """Duplicated descriptors make exact argmax and score ties: the first
    maximal index wins, and equal scores keep index order, as in JAX."""
    K, D = 32, 16
    fcfg = FeatureConfig(max_features=K, max_matches=16, ratio_test=1.01)
    da, db = _descriptors(3, K, D, 20)
    db[5] = db[4]            # two identical candidates for one row of A
    da[9] = da[8]            # two identical rows of A
    rng = np.random.default_rng(4)
    xa = rng.uniform(-60, 60, (K, 2)).astype(np.float32)
    xb = rng.uniform(-60, 60, (K, 2)).astype(np.float32)
    ones = np.ones(K, bool)
    args = (da, db, xa, xb, ones, ones)
    want = tuple_np(jfeat.match_features(*map(jnp.asarray, args), fcfg))
    got = tuple_np(tfeat.match_features(*map(t, args), fcfg))
    for name in ("valid", "src_xy", "dst_xy"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_top_k_stable_matches_jax():
    x = np.asarray([1, 3, 3, 2, 3, 1, -np.inf, 3, -2], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 6)
    got_v, got_i = tfeat.top_k_stable(t(x), 6)
    np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
    np.testing.assert_array_equal(np_(got_v), np.asarray(want_v))


# -- the Cartesian utilities -----------------------------------------------

def _polar(seed):
    """A full-size polar image of uniform noise: the largest step between
    neighbouring bins, so the worst case of a sample's coordinate rounding."""
    rcfg = RadarConfig()
    rng = np.random.default_rng(seed)
    return rng.random((rcfg.num_azimuths, rcfg.padded_range_bins), dtype=np.float32)


@pytest.mark.parametrize("size,res", [(512, 0.5), (256, 1.0), (64, 8.0)])
def test_polar_to_cartesian_matches_jax(size, res):
    """The full-width 512 px grid at 0.5 m and the JAX tests' two grids (the
    64 px / 8 m grid reaches past the last range bin): atol 1e-4 (XLA's
    float32 atan2 and the port's rounded float64 one differ by an ulp, which
    moves an azimuth coordinate by up to 6e-5 of a bin) and the same zero
    mask.  The JAX side runs op by op, as its own tests run it."""
    rcfg = RadarConfig()
    fcfg = FeatureConfig(cart_size=size, cart_resolution=res)
    polar = _polar(size)
    want = np.asarray(jfeat.polar_to_cartesian(jnp.asarray(polar), fcfg, rcfg))
    got = np_(tfeat.polar_to_cartesian(t(polar), fcfg, rcfg))
    assert got.shape == (size, size)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (want == 0).any() == (size == 64)


def test_bilinear_sample_matches_jax():
    """Taps inside, on the last row and column and outside the image, at
    integer and fractional coordinates: the same values and zero mask."""
    rng = np.random.default_rng(5)
    img = rng.random((64, 64), dtype=np.float32)
    u = rng.uniform(-3.0, 66.0, (40, 36)).astype(np.float32)
    v = rng.uniform(-3.0, 66.0, (40, 36)).astype(np.float32)
    u[0, :6] = [0.0, 62.0, 63.0, -1.0, 62.5, 31.0]
    v[0, :6] = [0.0, 62.0, 10.0, 5.0, 62.999, 63.0]
    want = np.asarray(jax.jit(jfeat._bilinear_sample)(*map(jnp.asarray, (img, u, v))))
    got = np_(tfeat._bilinear_sample(t(img), t(u), t(v)))
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want[0, :6] != 0).tolist() == [True, True, False, False, True, False]


@pytest.mark.parametrize("K,P", [(1024, 8), (256, 6)])
def test_patch_descriptors_matches_jax(K, P):
    """K features (one at the sensor, some off the 256 m image) on the
    rendering of a noise scan: unit-norm patches within 1e-4."""
    rcfg = RadarConfig()
    fcfg = dataclasses.replace(FeatureConfig(), patch_size=P)
    cart = np.asarray(jax.jit(functools.partial(
        jfeat.polar_to_cartesian, fcfg=fcfg, rcfg=rcfg))(jnp.asarray(_polar(P))))
    rng = np.random.default_rng(K + P)
    xy = rng.uniform(-150.0, 150.0, (K, 2)).astype(np.float32)
    xy[0] = 0.0
    want = np.asarray(jax.jit(functools.partial(jfeat.patch_descriptors, fcfg=fcfg))(
        jnp.asarray(cart), jnp.asarray(xy)))
    got = np_(tfeat.patch_descriptors(t(cart), t(xy), fcfg))
    assert got.shape == (K, P * P)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (np.abs(want).sum(axis=1) == 0).sum() > 0     # patches off the image
