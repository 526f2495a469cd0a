"""Parity of the port's ORORA-style registration with the JAX package, stage
by stage and end to end, on the synthetic match sets of
tests/test_registration.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navtech_radar_slam_tpu.config import RegistrationConfig
from navtech_radar_slam_tpu.ops import features as jfeat
from navtech_radar_slam_tpu.ops import registration as jreg
from navtech_radar_slam_torch.ops import features as tfeat
from navtech_radar_slam_torch.ops import registration as treg
from torch_parity_util import np_, one_torch_thread, t  # noqa: F401 (fixture)

CFG = RegistrationConfig()


def make_matchset_np(rng, M=256, n_outliers=100, theta=0.08, t_=(1.2, -0.4),
                     noise=0.05):
    """b = R a + t (+noise); outliers get random b (tests/test_registration.py)."""
    a = rng.uniform(-60, 60, size=(M, 2))
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    b = a @ R.T + np.asarray(t_) + rng.normal(0, noise, size=(M, 2))
    idx = rng.permutation(M)[:n_outliers]
    b[idx] = rng.uniform(-60, 60, size=(n_outliers, 2))
    valid = np.ones(M, bool)
    valid[-5:] = False          # padded slots, as a real MatchSet has
    a[~valid], b[~valid] = 0.0, 0.0
    f32 = np.float32
    return dict(src_xy=a.astype(f32), dst_xy=b.astype(f32),
                src_range=np.linalg.norm(a, axis=-1).astype(f32),
                dst_range=np.linalg.norm(b, axis=-1).astype(f32),
                weight=np.ones(M, f32), valid=valid)


def _both(d):
    return (jfeat.MatchSet(**{k: jnp.asarray(v) for k, v in d.items()}),
            tfeat.MatchSet(**{k: t(v) for k, v in d.items()}))


def test_point_sigmas_and_information_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-150, 150, (300, 2)).astype(np.float32)
    r = np.linalg.norm(xy, axis=-1)
    np.testing.assert_allclose(np_(treg.point_sigmas(t(r), CFG)),
                               np.asarray(jreg.point_sigmas(jnp.asarray(r), CFG)),
                               rtol=1e-6)
    # information entries reach 1/(sigma_azimuth)^2 ~ 3e3: relative 1e-5
    np.testing.assert_allclose(np_(treg.point_information(t(xy), CFG)),
                               np.asarray(jreg.point_information(jnp.asarray(xy), CFG)),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n_out", [0, 102])
def test_spectral_inlier_scores_match_jax(n_out):
    """Unit-norm eigenvector entries after 20 power iterations: agree to
    1e-5 (matvec sums in another order)."""
    jm, tm = _both(make_matchset_np(np.random.default_rng(1), n_outliers=n_out))
    want = np.asarray(jax.jit(lambda m: jreg.spectral_inlier_scores(m, CFG))(jm))
    got = np_(treg.spectral_inlier_scores(tm, CFG))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_gnc_weights_match_jax():
    res2 = np.linspace(0.0, 4.0, 41).astype(np.float32)
    for mu in (0.01, 0.5, 1.0, 7.0):
        want = np.asarray(jreg._gnc_tls_weights(jnp.asarray(res2), jnp.float32(mu), 1.0))
        got = np_(treg._gnc_tls_weights(t(res2), t(np.float32(mu)), 1.0))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _tims(rng, n=128, theta=0.3, n_out=40):
    a = rng.uniform(-40, 40, (n, 2))
    c, s = np.cos(theta), np.sin(theta)
    b = a @ np.array([[c, -s], [s, c]]).T + rng.normal(0, 0.05, (n, 2))
    b[:n_out] = rng.uniform(-40, 40, (n_out, 2))
    sigma = rng.uniform(0.2, 1.0, n)
    valid = rng.random(n) > 0.1
    f32 = np.float32
    return a.astype(f32), b.astype(f32), sigma.astype(f32), valid


def test_gnc_rotation_matches_jax():
    a, b, sigma, valid = _tims(np.random.default_rng(2))
    cfg = RegistrationConfig(gnc_max_iters=8)
    th_j, w_j = jax.jit(lambda *x: jreg.gnc_rotation(*x, cfg))(*map(jnp.asarray, (a, b, sigma, valid)))
    th_t, w_t = treg.gnc_rotation(*map(t, (a, b, sigma, valid)), cfg)
    assert abs(float(th_t) - float(th_j)) < 1e-5
    # a weight is sqrt(barc2 mu (mu + 1) / r²) - mu: the subtraction
    # amplifies the ulp-level residual differences of two theta within
    # 1e-5 rad (measured up to 1.3e-4 on weights of order 1)
    np.testing.assert_allclose(np_(w_t), np.asarray(w_j), rtol=0, atol=1e-3)


def test_robust_translation_matches_jax():
    rng = np.random.default_rng(3)
    a, b, sigma, valid = _tims(rng)
    b = b + np.float32([1.5, -0.7])
    theta = np.float32(0.3)
    cfg = RegistrationConfig(cote_iters=4)
    want = np.asarray(jax.jit(lambda *x: jreg.robust_translation(*x, cfg))(
        *map(jnp.asarray, (a, b, sigma, valid, theta))))
    got = np_(treg.robust_translation(*map(t, (a, b, sigma, valid, theta)), cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_weighted_median_with_ties_matches_jax():
    """Tied candidate values with unequal weights: the stable argsort and
    the left-sided search pick the same element as JAX."""
    vals = np.asarray([2.0, 1.0, 2.0, 3.0, 1.0, 2.0, 5.0, 2.0], np.float32)
    sigma = np.asarray([1.0, 0.5, 2.0, 1.0, 4.0, 1.0, 1.0, 0.25], np.float32)
    valid = np.asarray([1, 1, 1, 1, 1, 0, 1, 1], bool)
    a = np.zeros((8, 2), np.float32)
    b = np.stack([vals, vals[::-1]], axis=-1)
    cfg = RegistrationConfig(cote_iters=0)
    want = np.asarray(jreg.robust_translation(*map(jnp.asarray, (a, b, sigma, valid)),
                                              jnp.float32(0.0), cfg))
    got = np_(treg.robust_translation(*map(t, (a, b, sigma, valid)),
                                      t(np.float32(0.0)), cfg))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_weighted_median_with_zero_weights_matches_jax(seed):
    """Half the matches invalid, so half the weights zero: past some of
    them the doubling prefix sums come out an ulp below their predecessor.
    The cumulative weights the median searches are non-decreasing all the
    same, and the median seed is the lower weighted median of a float64
    prefix sum, as JAX's."""
    n = 300
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    sigma = rng.uniform(0.05, 3.0, n).astype(np.float32)
    valid = rng.random(n) < 0.5
    w = np.where(valid, 1.0 / np.maximum(sigma, np.float32(1e-6)), 0).astype(np.float32)
    raw = [np_(treg._doubling_cumsum(t(w[np.argsort(vals[:, c], kind="stable")])))
           for c in range(2)]
    assert any((np.diff(r) < 0).any() for r in raw)      # the case this checks
    for c in range(2):
        cw = np_(treg._cumulative_weights(t(w[np.argsort(vals[:, c], kind="stable")])))
        assert (np.diff(cw) >= 0).all()
        np.testing.assert_allclose(cw, raw[c], rtol=2e-6, atol=0)
    want = []
    for c in range(2):
        order = np.argsort(vals[:, c], kind="stable")
        cw64 = np.cumsum(w[order].astype(np.float64))
        want.append(vals[order, c][np.searchsorted(cw64, 0.5 * cw64[-1])])
    a = np.zeros((n, 2), np.float32)
    cfg = RegistrationConfig(cote_iters=0)
    got = np_(treg.robust_translation(*map(t, (a, vals, sigma, valid)), t(np.float32(0.0)), cfg))
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    jax_t = np.asarray(jreg.robust_translation(*map(jnp.asarray, (a, vals, sigma, valid)),
                                               jnp.float32(0.0), cfg))
    np.testing.assert_array_equal(got, jax_t)


def test_solve3x3_and_refine_match_jax():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((3, 3)).astype(np.float32)
    H = A @ A.T + np.eye(3, dtype=np.float32)
    g = rng.standard_normal(3).astype(np.float32)
    np.testing.assert_allclose(np_(treg._solve3x3(t(H), t(g))),
                               np.asarray(jreg._solve3x3(jnp.asarray(H), jnp.asarray(g))),
                               rtol=1e-5, atol=1e-6)
    a, b, _, valid = _tims(rng, n_out=0)
    b = b + np.float32([0.8, 0.2])
    cfg = RegistrationConfig(refine_iters=4)
    args = (a, b, valid, np.float32(0.29), np.float32([0.7, 0.1]))
    th_j, t_j = jax.jit(lambda *x: jreg.anisotropic_refine(*x, cfg))(*map(jnp.asarray, args))
    th_t, t_t = treg.anisotropic_refine(*map(t, args), cfg)
    assert abs(float(th_t) - float(th_j)) < 1e-5
    np.testing.assert_allclose(np_(t_t), np.asarray(t_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("M,n_out", [(256, 0), (256, 102), (300, 210)])
def test_register_scans_matches_jax(M, n_out):
    """0 / 40 / 70 % outliers: rel_pose within 1e-4 m / 1e-5 rad of JAX and
    the same inlier count."""
    jm, tm = _both(make_matchset_np(np.random.default_rng(0), M=M, n_outliers=n_out))
    want = jax.jit(lambda m: jreg.register_scans(m, CFG))(jm)
    got = treg.register_scans(tm, CFG)
    wr, gr = np.asarray(want.rel_pose), np_(got.rel_pose)
    np.testing.assert_allclose(gr[:2], wr[:2], rtol=0, atol=1e-4)
    assert abs(gr[2] - wr[2]) < 1e-5
    assert int(got.num_inliers) == int(want.num_inliers)
    assert bool(got.ok) == bool(want.ok)
    np.testing.assert_array_equal(np_(got.inlier_mask), np.asarray(want.inlier_mask))


@pytest.mark.parametrize("n", [1, 2, 7, 256, 513])
def test_doubling_cumsum_is_a_prefix_sum(n):
    """The weighted median's prefix sum by doubling shifts: integers summed
    exactly, floats within float32 rounding of a float64 cumsum, and each
    row of a batch bit-equal to that row alone."""
    import torch

    rng = np.random.default_rng(n)
    ints = rng.integers(0, 100, (3, n)).astype(np.float32)
    np.testing.assert_array_equal(np_(treg._doubling_cumsum(t(ints))), np.cumsum(ints, -1))
    x = rng.uniform(0, 1, (3, n)).astype(np.float32)
    got = np_(treg._doubling_cumsum(t(x)))
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64), -1), rtol=2e-6, atol=0)
    for row in range(3):
        assert torch.equal(treg._doubling_cumsum(t(x[row])), treg._doubling_cumsum(t(x))[row])


def test_refine_under_vmap_is_batch_invariant():
    """``anisotropic_refine``'s sums over the points are elementwise halving
    adds, so under ``torch.func.vmap`` each stream of a batch of 5 refines
    bit for bit as that stream alone."""
    import torch

    rng = np.random.default_rng(31)
    sets = [make_matchset_np(rng, M=256, n_outliers=0) for _ in range(5)]
    a = t(np.stack([d["src_xy"] for d in sets]))
    b = t(np.stack([d["dst_xy"] for d in sets]))
    valid = t(np.stack([d["valid"] for d in sets]))
    theta0, t0 = t(np.full(5, 0.07, np.float32)), t(np.tile(np.float32([1.1, -0.3]), (5, 1)))
    refine = lambda *x: treg.anisotropic_refine(*x, CFG)   # noqa: E731
    th, tr = torch.func.vmap(refine)(a, b, valid, theta0, t0)
    for s in range(5):
        th1, tr1 = refine(a[s], b[s], valid[s], theta0[s], t0[s])
        assert torch.equal(th[s], th1) and torch.equal(tr[s], tr1)
    np.testing.assert_allclose(np_(th), 0.08, atol=1e-3)
