"""Parity of the port's robust pose graph with the JAX package's
(``models/posegraph.py``), on the graphs of tests/test_posegraph.py.

Both graphs are built from the same numpy measurements.  Tolerances:
residuals rtol 1e-4 (whitened by up to 100, so the f32 log-map rounding
shows at ~1e-5 relative); one GN step, a full solve and the bucketed solve
give poses within atol 1e-4.  The sums of the CG inner products and of the
preconditioners are taken in another order in each framework, so the
solves agree to f32 rounding, not bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.config import PgoConfig
from navtech_radar_slam_tpu.models import posegraph as jpg
from navtech_radar_slam_torch.models import posegraph as tpg
from navtech_radar_slam_torch.utils.geometry import se2_to_se3_np
from torch_parity_util import np_, one_torch_thread, t  # noqa: F401 (fixture)

CFG = dataclasses.replace(
    PgoConfig(), max_nodes=64, max_loop_edges=16, gn_iters=10, cg_iters=100,
    odom_sigma_rot=0.01, odom_sigma_trans=0.05,
)
#: the full solves: fewer iterations than CFG keep the eager CPU solve short
SOLVE_CFG = dataclasses.replace(CFG, gn_iters=4, cg_iters=48)
POSE_ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_solver(cfg):
    """JAX's jitted solver, compiled once per config for the module."""
    return jpg.make_solver(cfg)


def _se3(x, y, yaw):
    return se2_to_se3_np(np.asarray([x, y, yaw])).astype(np.float32)


class Both:
    """A JAX and a torch ``PoseGraph`` fed the same factors."""

    def __init__(self, cfg=CFG):
        self.cfg = cfg
        self.j = jpg.PoseGraph(cfg)
        self.t = tpg.PoseGraph(cfg, device="cpu")

    def add_node(self, pose, odom_meas=None):
        self.j.add_node(pose, odom_meas=odom_meas)
        return self.t.add_node(pose, odom_meas=odom_meas)

    def add_loop(self, i, j, meas):
        self.j.add_loop(i, j, meas)
        self.t.add_loop(i, j, meas)

    def add_gps(self, k, xyz):
        self.j.add_gps(k, xyz)
        self.t.add_gps(k, xyz)

    def optimize(self):
        self.j.optimize()
        self.t.optimize()

    def assert_poses_close(self, atol=POSE_ATOL):
        np.testing.assert_allclose(self.t.poses(), self.j.poses(), rtol=0, atol=atol)


def noisy_chain(n, seed, cfg=CFG, step=1.0):
    """tests/test_posegraph.py::build_noisy_chain for both graphs; returns
    (graphs, ground-truth (n, 4, 4))."""
    rng = np.random.default_rng(seed)
    both = Both(cfg)
    gt = [np.eye(4, dtype=np.float32)]
    est = np.eye(4, dtype=np.float32)
    both.add_node(est)
    for _ in range(1, n):
        gt.append(gt[-1] @ _se3(step, 0.0, 0.0))
        meas = _se3(step + rng.normal(0, cfg.odom_sigma_trans),
                    rng.normal(0, cfg.odom_sigma_trans), rng.normal(0, cfg.odom_sigma_rot))
        est = est @ meas
        both.add_node(est, odom_meas=meas)
    return both, np.stack(gt)


def looped(seed=0, outlier=False, gps=False):
    both, gt = noisy_chain(40, seed)
    for jj in range(8, 40, 8):
        both.add_loop(0, jj, (np.linalg.inv(gt[0]) @ gt[jj]).astype(np.float32))
    if outlier:
        both.add_loop(2, 37, _se3(-4.0, 11.0, 2.9))
    if gps:
        for k in range(1, 40, 3):
            both.add_gps(k, np.array([0.0, 0.0, 0.5 * np.sin(k)]))
    return both


def _weights(seed, cfg=CFG):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 1.0, cfg.max_loop_edges).astype(np.float32),
            rng.uniform(0.2, 1.0, cfg.max_nodes).astype(np.float32))


@pytest.mark.parametrize("outlier,gps", [(False, False), (True, True)])
def test_residuals_match_jax(outlier, gps):
    both = looped(1, outlier, gps)
    lw, gw = _weights(2)
    delta = np.random.default_rng(3).normal(0, 0.01, (CFG.max_nodes, 6)).astype(np.float32)
    for d in (np.zeros_like(delta), delta):
        want = np.asarray(jax.jit(jpg.residuals, static_argnums=(4,))(
            jnp.asarray(d), both.j.g, jnp.asarray(lw), jnp.asarray(gw), CFG))
        got = np_(tpg.residuals(t(d), both.t.g, t(lw), t(gw), CFG))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("precond", ["chain", "jacobi"])
def test_preconditioners_match_jax(precond):
    both = looped(4, outlier=True, gps=True)
    lw, gw = _weights(5)
    r = np.random.default_rng(6).normal(0, 1.0, CFG.max_nodes * 6).astype(np.float32)
    if precond == "chain":
        want = jpg._chain_precond(both.j.g, CFG, 1e-6)(jnp.asarray(r))
        got = tpg._chain_precond(both.t.g, CFG, 1e-6)(t(r))
    else:
        want = jpg._diag_precond(both.j.g, jnp.asarray(lw), jnp.asarray(gw), CFG, 1e-6)(
            jnp.asarray(r))
        got = tpg._diag_precond(both.t.g, t(lw), t(gw), CFG, 1e-6)(t(r))
    # XLA's cumsum is a tree scan, torch's a running sum: ~1e-4 relative
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=2e-4, atol=1e-7)


def test_cg_solve_matches_jax():
    """CG on a fixed SPD system, both with the early exit and at the
    iteration cap."""
    rng = np.random.default_rng(7)
    a = rng.normal(0, 1, (30, 30))
    h = (a @ a.T + 30 * np.eye(30)).astype(np.float32)
    b = rng.normal(0, 1, 30).astype(np.float32)
    dinv = (1.0 / np.diag(h)).astype(np.float32)
    for iters, tol in ((100, 1e-6), (3, 1e-6)):
        want = jpg._cg_solve(lambda v: jnp.asarray(h) @ v, jnp.asarray(b),
                             lambda v: jnp.asarray(dinv) * v, iters, tol)
        got = tpg._cg_solve(lambda v: t(h) @ v, t(b), lambda v: t(dinv) * v, iters, tol)
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("precond", ["chain", "jacobi"])
def test_one_gn_step_matches_jax(precond):
    cfg = dataclasses.replace(CFG, preconditioner=precond)
    both = looped(8, outlier=True, gps=True)
    gj, step_j = jax.jit(jpg._gn_step, static_argnums=(1, 2))(both.j.g, cfg, cfg.lm_lambda0)
    gt_, step_t = tpg._gn_step(both.t.g, cfg, cfg.lm_lambda0)
    n = both.t.num_nodes
    np.testing.assert_allclose(np_(gt_.poses)[:n], np.asarray(gj.poses)[:n], rtol=0,
                               atol=POSE_ATOL)
    np.testing.assert_allclose(float(step_t), float(step_j), rtol=1e-3)


@pytest.mark.parametrize("outlier,gps", [(False, False), (True, False), (False, True)])
def test_solve_matches_jax(outlier, gps):
    """tests/test_posegraph.py's looped graphs (clean, with a wild outlier
    loop, with altitude factors): the full solve on both sides."""
    both = looped(0, outlier, gps)
    n = both.t.num_nodes
    want = np.asarray(_jax_solver(SOLVE_CFG)(both.j.g).poses)[:n]
    got = np_(tpg.make_solver(SOLVE_CFG)(both.t.g).poses)[:n]
    np.testing.assert_allclose(got, want, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(got[0], np.eye(4), atol=1e-6)


def test_bucketed_solver_matches_jax():
    """tests/test_posegraph.py::test_bucketed_solver_matches_full's graph:
    60 nodes in a capacity of 256 solve on the 64-node prefix on both
    sides, and the padding past the prefix stays identity."""
    cfg = dataclasses.replace(PgoConfig(), max_nodes=256, max_loop_edges=64, gn_iters=4,
                              cg_iters=32)
    both = Both(cfg)
    pose = np.eye(4, dtype=np.float32)
    both.add_node(pose)
    step = _se3(1.0, 0.0, 0.1)
    for _ in range(1, 60):
        pose = pose @ step
        both.add_node(pose, odom_meas=step)
    both.add_loop(0, 59, _se3(0.5, 0.2, 0.05))
    assert tpg.bucket_size(256, 60) == 64 and tpg.bucket_size(256, 65) == 128
    gj = jpg.make_bucketed_solver(cfg)(both.j.g, 60, 1)
    gt_ = tpg.make_bucketed_solver(cfg)(both.t.g, 60, 1)
    np.testing.assert_allclose(np_(gt_.poses)[:60], np.asarray(gj.poses)[:60], rtol=0,
                               atol=POSE_ATOL)
    np.testing.assert_array_equal(np_(gt_.poses)[64:], np.broadcast_to(np.eye(4), (192, 4, 4)))


def test_incremental_warm_start_matches_jax():
    """tests/test_posegraph.py::test_incremental_warm_start: a re-solve
    after every node, on both sides."""
    both = Both()
    meas = _se3(1.0, 0.0, 0.05)
    pose = np.eye(4, dtype=np.float32)
    both.add_node(pose)
    for _ in range(1, 12):
        pose = pose @ meas
        both.add_node(pose, odom_meas=meas)
        both.optimize()
    both.assert_poses_close()
    assert np.isfinite(both.t.poses()).all()


def test_chain_without_loops_keeps_odometry():
    both, _ = noisy_chain(10, 9)
    before = both.t.poses().copy()
    both.optimize()
    np.testing.assert_allclose(both.t.poses(), before, atol=1e-3)
    both.assert_poses_close()


def test_capacity_guard_and_grow():
    small = dataclasses.replace(CFG, max_nodes=2, max_loop_edges=1)
    g = tpg.PoseGraph(small, device="cpu")
    g.add_node(np.eye(4))
    g.add_node(_se3(1.0, 0.0, 0.0), odom_meas=_se3(1.0, 0.0, 0.0))
    g.add_loop(0, 1, _se3(1.0, 0.0, 0.0))
    with pytest.raises(RuntimeError, match="capacity"):
        g.add_node(np.eye(4), odom_meas=np.eye(4))
    with pytest.raises(RuntimeError, match="capacity"):
        g.add_loop(0, 1, np.eye(4))
    g.grow()
    assert g.g.poses.shape[0] == 4 and g.g.loop_i.shape[0] == 2
    g.add_node(_se3(2.0, 0.0, 0.0), odom_meas=_se3(1.0, 0.0, 0.0))
    assert int(g.g.num_nodes) == 3 and bool(g.g.odom_valid[2]) and bool(g.g.loop_valid[0])
    np.testing.assert_allclose(g.poses()[1], _se3(1.0, 0.0, 0.0))
    assert torch.equal(g.g.poses[3], torch.eye(4))


def _dense_normal_equations(g, lin, shard):
    """JᵀJ and Jᵀr of ``residuals`` on ``shard`` at delta = 0, J the dense
    Jacobian from ``torch.autograd.functional.jacobian``."""
    n = g.poses.shape[0]
    f = lambda d: tpg.residuals(d, g, lin.loop_w, lin.gps_w, CFG, shard)  # noqa: E731
    zero = torch.zeros((n, 6))
    jac = torch.autograd.functional.jacobian(f, zero).reshape(-1, 6 * n)
    return jac.T @ jac, jac.T @ f(zero)


@pytest.mark.parametrize("shard", ["whole", "node_and_loop_block", "no_loops"])
def test_block_matvec_matches_dense_jacobian(shard):
    """H v and b from the per-factor blocks formed once per GN step against
    the dense JᵀJ v and Jᵀr of ``residuals`` (loops, GPS, an outlier loop, a
    loop on node 0, padding), on the whole graph and on ``FactorShard``s as
    the distributed solver cuts them.  Tolerance: float32 rounding of sums
    taken in another order (relative to the largest entry)."""
    both = looped(11, outlier=True, gps=True)
    g = both.t.g
    n = g.poses.shape[0]
    shard = {"whole": tpg._WHOLE,
             "node_and_loop_block": tpg.FactorShard(slice(16, 48), slice(0, 8), lambda x: x,
                                                    None),
             "no_loops": tpg.FactorShard(slice(48, 64), slice(0, 0), lambda x: x, None)}[shard]
    lin = tpg.linearize(g, CFG, shard)
    matvec, b = tpg.normal_equations(lin, n, 0.0, shard)
    h, jtr = _dense_normal_equations(g, lin, shard)
    rng = np.random.default_rng(12)
    for v in (rng.normal(0, 1, 6 * n), rng.normal(0, 1e-3, 6 * n)):
        v = t(v.astype(np.float32))
        want = np_(h @ v)
        np.testing.assert_allclose(np_(matvec(v)), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(np_(b), -np_(jtr), rtol=0, atol=1e-5 * np.abs(np_(jtr)).max())
    # node 0 is the gauge: its rows and columns of H are zero
    assert not np_(matvec(t(np.eye(6 * n, dtype=np.float32)[3]))).any()


def test_matvec_is_a_few_ops():
    """One CG matvec is a fixed few dozen ops whatever the graph holds (the
    double vjp it replaced dispatched ~1,200)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    both = looped(13, outlier=True, gps=True)
    n = both.t.g.poses.shape[0]
    matvec, b = tpg.normal_equations(tpg.linearize(both.t.g, CFG), n, 1e-6)
    with Count():
        matvec(b)
    assert 0 < Count.ops < 40, Count.ops
