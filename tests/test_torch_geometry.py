"""Parity of the port's SE(2)/SO(3)/SE(3) functions with the JAX package's
``utils/geometry.py``, values and derivatives, on the same numpy inputs.

Tolerance: values atol 1e-5 (float32; the two frameworks contract the 3x3
matmuls in another order), including theta = 0 and theta near pi, where
the guard branches of so3_log and the Jacobians take over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.utils import geometry as jgeo
from navtech_radar_slam_torch.utils import geometry as tgeo
from torch_parity_util import np_, one_torch_thread, t  # noqa: F401 (fixture)

ATOL = 1e-5


def _tangents(rng, n=40):
    """se(3) tangents with the edge cases: 0, tiny, and rotations near pi
    about each axis."""
    xi = rng.normal(0, 0.6, (n, 6)).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = [1e-6, -2e-6, 0.0]
    xi[2, 3:] = [np.pi - 1e-4, 0.0, 0.0]
    xi[3, 3:] = [0.0, np.pi - 5e-4, 0.0]
    xi[4, 3:] = [0.0, 0.0, -(np.pi - 2e-4)]
    xi[5, 3:] = np.asarray([1.0, 1.0, 0.0]) / np.sqrt(2.0) * (np.pi - 3e-4)
    return xi


def test_wrap_angle(rng):
    th = np.concatenate([rng.uniform(-10, 10, 50), [0.0, np.pi, -np.pi]]).astype(np.float32)
    np.testing.assert_allclose(np_(tgeo.wrap_angle(t(th))),
                               np.asarray(jgeo.wrap_angle(jnp.asarray(th))), atol=ATOL)


@pytest.mark.parametrize("name", ["se2_mul", "se2_between"])
def test_se2_binary(rng, name):
    a = rng.normal(0, 3, (30, 3)).astype(np.float32)
    b = rng.normal(0, 3, (30, 3)).astype(np.float32)
    a[0, 2], b[0, 2] = 0.0, np.pi
    want = np.asarray(getattr(jgeo, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(np_(getattr(tgeo, name)(t(a), t(b))), want, atol=ATOL)


@pytest.mark.parametrize("name", ["se2_inv", "se2_to_se3"])
def test_se2_unary(rng, name):
    a = rng.normal(0, 3, (30, 3)).astype(np.float32)
    a[0] = 0.0
    want = np.asarray(getattr(jgeo, name)(jnp.asarray(a)))
    np.testing.assert_allclose(np_(getattr(tgeo, name)(t(a))), want, atol=ATOL)


def test_se2_apply_batched(rng):
    poses = rng.normal(0, 2, (5, 3)).astype(np.float32)
    pts = rng.uniform(-80, 80, (5, 64, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(jgeo.se2_apply)(jnp.asarray(poses), jnp.asarray(pts)))
    np.testing.assert_allclose(np_(tgeo.se2_apply(t(poses), t(pts))), want, atol=1e-4)


def test_se3_to_se2(rng):
    T = np.asarray(jgeo.se2_to_se3(jnp.asarray(rng.normal(0, 3, (30, 3)), jnp.float32)))
    np.testing.assert_allclose(np_(tgeo.se3_to_se2(t(T))),
                               np.asarray(jgeo.se3_to_se2(jnp.asarray(T))), atol=ATOL)


@pytest.mark.parametrize("name", ["so3_hat", "so3_exp", "_so3_left_jacobian",
                                  "_so3_left_jacobian_inv"])
def test_so3_functions(rng, name):
    w = _tangents(rng)[:, 3:]
    want = np.asarray(getattr(jgeo, name)(jnp.asarray(w)))
    np.testing.assert_allclose(np_(getattr(tgeo, name)(t(w))), want, atol=ATOL)


def test_so3_log_edge_cases(rng):
    """Logs of exp(w), including the identity and rotations near pi (the
    diagonal branch)."""
    R = np.asarray(jgeo.so3_exp(jnp.asarray(_tangents(rng)[:, 3:])))
    want = np.asarray(jgeo.so3_log(jnp.asarray(R)))
    np.testing.assert_allclose(np_(tgeo.so3_log(t(R))), want, atol=ATOL)


def test_se3_exp(rng):
    xi = _tangents(rng)
    np.testing.assert_allclose(np_(tgeo.se3_exp(t(xi))),
                               np.asarray(jgeo.se3_exp(jnp.asarray(xi))), atol=ATOL)


@pytest.mark.parametrize("name", ["se3_log", "se3_inv"])
def test_se3_unary(rng, name):
    T = np.asarray(jgeo.se3_exp(jnp.asarray(_tangents(rng))))
    want = np.asarray(getattr(jgeo, name)(jnp.asarray(T)))
    np.testing.assert_allclose(np_(getattr(tgeo, name)(t(T))), want, atol=ATOL)


@pytest.mark.parametrize("name", ["se3_mul", "se3_between"])
def test_se3_binary(rng, name):
    T = np.asarray(jgeo.se3_exp(jnp.asarray(_tangents(rng, 40))))
    A, B = T[:20], T[20:]
    want = np.asarray(getattr(jgeo, name)(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(np_(getattr(tgeo, name)(t(A), t(B))), want, atol=ATOL)


def test_se3_from_rt(rng):
    R = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(0, 1, (7, 3)), jnp.float32)))
    tr = rng.normal(0, 5, (7, 3)).astype(np.float32)
    np.testing.assert_array_equal(np_(tgeo.se3_from_rt(t(R), t(tr))),
                                  np.asarray(jgeo.se3_from_rt(jnp.asarray(R), jnp.asarray(tr))))


def _log_between_pair(rng):
    """Pose pairs whose relative rotation includes the identity and
    near-pi cases, plus tangents / cotangents for the derivative checks."""
    xi = _tangents(rng, 24)
    A = np.asarray(jgeo.se3_exp(jnp.asarray(rng.normal(0, 0.5, (24, 6)), jnp.float32)))
    B = np.asarray(jgeo.se3_mul(jnp.asarray(A), jgeo.se3_exp(jnp.asarray(xi))))
    dA = rng.normal(0, 0.1, A.shape).astype(np.float32)
    dB = rng.normal(0, 0.1, B.shape).astype(np.float32)
    ct = rng.normal(0, 1.0, (24, 6)).astype(np.float32)
    return A, B, dA, dB, ct


def test_jvp_of_log_between(rng):
    """torch.func.jvp of se3_log ∘ se3_between against jax.jvp (the
    derivative the pose graph's Gauss-Newton takes)."""
    A, B, dA, dB, _ = _log_between_pair(rng)
    _, want = jax.jvp(lambda a, b: jgeo.se3_log(jgeo.se3_between(a, b)),
                      (jnp.asarray(A), jnp.asarray(B)), (jnp.asarray(dA), jnp.asarray(dB)))
    _, got = torch.func.jvp(lambda a, b: tgeo.se3_log(tgeo.se3_between(a, b)),
                            (t(A), t(B)), (t(dA), t(dB)))
    want = np.asarray(want)
    assert np.isfinite(np_(got)).all()
    # relative to the derivative's scale: near pi it is ~1e2
    np.testing.assert_allclose(np_(got), want, atol=ATOL * max(1.0, np.abs(want).max()))


def test_vjp_of_log_between(rng):
    """torch.func.vjp of se3_log ∘ se3_between against jax.vjp, finite at
    the identity and near pi."""
    A, B, _, _, ct = _log_between_pair(rng)
    _, pj = jax.vjp(lambda a, b: jgeo.se3_log(jgeo.se3_between(a, b)),
                    jnp.asarray(A), jnp.asarray(B))
    _, pt = torch.func.vjp(lambda a, b: tgeo.se3_log(tgeo.se3_between(a, b)), t(A), t(B))
    for want, got in zip(pj(jnp.asarray(ct)), pt(t(ct))):
        want = np.asarray(want)
        assert np.isfinite(np_(got)).all()
        np.testing.assert_allclose(np_(got), want, atol=ATOL * max(1.0, np.abs(want).max()))


def test_numpy_host_helpers(rng):
    a, b = rng.normal(0, 3, 3), rng.normal(0, 3, 3)
    np.testing.assert_allclose(tgeo.se2_mul_np(a, b), jgeo.se2_mul_np(a, b), atol=1e-12)
    np.testing.assert_allclose(tgeo.se2_between_np(a, b), jgeo.se2_between_np(a, b),
                               atol=1e-12)
    np.testing.assert_allclose(tgeo.se2_to_se3_np(a), jgeo.se2_to_se3_np(a), atol=1e-12)


# the pose6d helpers (tests/test_geometry.py:31, :39, :84-85)

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_identities(dtype):
    tdt = getattr(torch, dtype)
    np.testing.assert_array_equal(np_(tgeo.se2_identity(tdt)),
                                  np.asarray(jgeo.se2_identity(jnp.float32)))
    np.testing.assert_array_equal(np_(tgeo.se3_identity(tdt)),
                                  np.asarray(jgeo.se3_identity(jnp.float32)))
    assert tgeo.se2_identity(tdt).dtype == tgeo.se3_identity(tdt).dtype == tdt


def test_se2_between_composes_back(rng):
    """a ∘ between(a, b) = b ∘ identity, in both packages."""
    a = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.normal(size=(5, 3)).astype(np.float32)
    got = tgeo.se2_mul(t(a), tgeo.se2_between(t(a), t(b)))
    want = jgeo.se2_mul(jnp.asarray(b), jgeo.se2_identity())
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(np_(tgeo.se2_mul(t(b), tgeo.se2_identity())), np.asarray(want),
                               atol=ATOL)


def test_se3_apply(rng):
    """Batched transforms of point sets against JAX's, and the SE(2) apply
    through se2_to_se3."""
    T = np.array(jgeo.se3_exp(jnp.asarray(_tangents(rng, 6))))
    T[:, :3, 3] *= 10.0
    pts = rng.uniform(-20, 20, (6, 50, 3)).astype(np.float32)
    want = np.asarray(jgeo.se3_apply(jnp.asarray(T), jnp.asarray(pts)))
    np.testing.assert_allclose(np_(tgeo.se3_apply(t(T), t(pts))), want, atol=1e-4)
    p = np.asarray([1.0, -2.0, 0.7], np.float32)
    pts2 = rng.normal(size=(10, 2)).astype(np.float32)
    pts3 = np.concatenate([pts2, np.zeros((10, 1), np.float32)], axis=-1)
    out3 = tgeo.se3_apply(tgeo.se2_to_se3(t(p)), t(pts3))
    np.testing.assert_allclose(np_(tgeo.se2_apply(t(p), t(pts2))), np_(out3)[:, :2], atol=ATOL)


def _pose6d(rng, n=8):
    return np.concatenate([rng.normal(size=(n, 3)) * 5,
                           rng.uniform(-1.2, 1.2, size=(n, 3))], axis=-1).astype(np.float32)


def test_rpy_to_rotmat(rng):
    p = _pose6d(rng, 30)
    want = np.asarray(jgeo.rpy_to_rotmat(*(jnp.asarray(p[:, k]) for k in (3, 4, 5))))
    got = tgeo.rpy_to_rotmat(*(t(p[:, k]) for k in (3, 4, 5)))
    np.testing.assert_allclose(np_(got), want, atol=ATOL)


def test_pose6d_round_trip(rng):
    """pose6d_to_se3 and se3_to_pose6d against JAX's, and the round trip."""
    p = _pose6d(rng)
    T = tgeo.pose6d_to_se3(t(p))
    np.testing.assert_allclose(np_(T), np.asarray(jgeo.pose6d_to_se3(jnp.asarray(p))),
                               atol=ATOL)
    Tj = np.asarray(jgeo.pose6d_to_se3(jnp.asarray(p)))
    np.testing.assert_allclose(np_(tgeo.se3_to_pose6d(t(Tj))),
                               np.asarray(jgeo.se3_to_pose6d(jnp.asarray(Tj))), atol=ATOL)
    np.testing.assert_allclose(np_(tgeo.se3_to_pose6d(T)), p, atol=1e-4)
