"""Robust SE(3) pose-graph optimization in PyTorch.

Counterpart of ``navtech_radar_slam_tpu.models.posegraph``: a pose graph
with an exact gauge on node 0, odometry Between factors, Cauchy-robust loop
Between factors and altitude-dominated GPS factors, solved by warm-started
IRLS Gauss-Newton whose normal equations are solved matrix-free by
preconditioned conjugate gradients.  H v = Jᵀ (J v) through the residual
function, with no Jacobian ever built: Jᵀ u is the pullback of
``torch.func.vjp`` (taken once per GN step, as JAX takes it), and J v is the
vjp of that pullback (the pullback is linear in u, so its transpose is J),
also taken once per step.  JAX's matvec calls ``jax.jvp`` instead; the
values are the same, but ``torch.func.jvp`` through these ~1400 small ops
costs 90-140 ms per call on the CPU against ~5 ms for the transpose.

The JAX ``lax.while_loop``s (CG, outer GN) become bounded loops whose carry
freezes once done, which gives exactly the while-loop's result.  The host
reads the CG stop flag every ``_CG_CHECK_EVERY`` iterations and the GN step
size after every GN iteration, to stop early.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vjp

from navtech_radar_slam_torch.config import PgoConfig
from navtech_radar_slam_torch.utils import geometry as geo
from navtech_radar_slam_torch.utils.device import DEFAULT_DEVICE, resolve_device

#: CG iterations between host reads of the stop flag
_CG_CHECK_EVERY = 8
#: outer GN exit: stop once no pose moved more than this (m / rad)
_GN_STEP_TOL = 1e-5


class GraphArrays(NamedTuple):
    """Padded, statically-shaped pose-graph state on the device."""

    poses: torch.Tensor        # (N, 4, 4) current estimates
    num_nodes: torch.Tensor    # () int64
    odom_meas: torch.Tensor    # (N, 4, 4) measurement T_{k-1,k} stored at k
    odom_valid: torch.Tensor   # (N,) bool (slot 0 unused)
    loop_i: torch.Tensor       # (L,) int64 earlier node
    loop_j: torch.Tensor       # (L,) int64 later node
    loop_meas: torch.Tensor    # (L, 4, 4) T_{i,j} from ICP
    loop_valid: torch.Tensor   # (L,) bool
    gps_meas: torch.Tensor     # (N, 3) world-frame position measurement
    gps_valid: torch.Tensor    # (N,) bool


class FactorShard(NamedTuple):
    """The factors one rank of the distributed solver evaluates, and the
    collectives that merge the ranks (``parallel/dist_pgo.py`` builds it).
    On one device there is none: every factor, and no collective."""

    nodes: slice       # the odometry and GPS factors of these nodes
    loops: slice       # these loop factors
    reduce: Callable   # a partial matvec or b summed over the ranks
    agree: Callable    # the largest of every rank's flag or step size


_WHOLE = FactorShard(slice(None), slice(None), lambda x: x, None)


def empty_graph(cfg: PgoConfig, device=DEFAULT_DEVICE, dtype=torch.float32) -> GraphArrays:
    device = resolve_device(device)
    n, nl = cfg.max_nodes, cfg.max_loop_edges
    eye = torch.eye(4, dtype=dtype, device=device)
    return GraphArrays(
        poses=eye.repeat(n, 1, 1),
        num_nodes=torch.zeros((), dtype=torch.int64, device=device),
        odom_meas=eye.repeat(n, 1, 1),
        odom_valid=torch.zeros(n, dtype=torch.bool, device=device),
        loop_i=torch.zeros(nl, dtype=torch.int64, device=device),
        loop_j=torch.zeros(nl, dtype=torch.int64, device=device),
        loop_meas=eye.repeat(nl, 1, 1),
        loop_valid=torch.zeros(nl, dtype=torch.bool, device=device),
        gps_meas=torch.zeros((n, 3), dtype=dtype, device=device),
        gps_valid=torch.zeros(n, dtype=torch.bool, device=device),
    )


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def _between_residual(Ti, Tj, meas):
    """r = log(meas^{-1} Ti^{-1} Tj) ∈ R^6 (gtsam BetweenFactor error)."""
    return geo.se3_log(geo.se3_mul(geo.se3_inv(meas), geo.se3_between(Ti, Tj)))


def _between_residual_masked(Ti, Tj, meas, valid):
    """Between residual with the relative transform forced to identity for
    invalid (padding) factors BEFORE the log map: a padding slot can land
    the log on a pi-rotation where its backward pass is singular."""
    rel = geo.se3_mul(geo.se3_inv(meas), geo.se3_between(Ti, Tj))
    eye = torch.eye(4, dtype=rel.dtype, device=rel.device)
    return geo.se3_log(torch.where(valid[:, None, None], rel, eye))


def _apply_delta(poses, delta):
    """Right-perturbation update: T <- T exp(delta)."""
    return geo.se3_mul(poses, geo.se3_exp(delta))


def _between_whitening(cfg: PgoConfig, dtype, device) -> torch.Tensor:
    return torch.tensor([1.0 / cfg.odom_sigma_trans] * 3 + [1.0 / cfg.odom_sigma_rot] * 3,
                        dtype=dtype, device=device)


def _gps_whitening(cfg: PgoConfig, dtype, device) -> torch.Tensor:
    return torch.tensor([1.0 / cfg.gps_sigma_xy, 1.0 / cfg.gps_sigma_xy,
                         1.0 / cfg.gps_sigma_alt], dtype=dtype, device=device)


def residuals(delta: torch.Tensor, g: GraphArrays, loop_irls_w: torch.Tensor,
              gps_irls_w: torch.Tensor, cfg: PgoConfig,
              shard: FactorShard = _WHOLE) -> torch.Tensor:
    """The whitened residuals of ``shard``'s factors (default: all of them)
    as one flat vector; delta (N, 6) is the tangent update being linearized
    (0 at the linearization point), the IRLS weights those of the shard's
    factors.  Node 0 is the gauge: its delta is zeroed (exact prior)."""
    n = g.poses.shape[0]
    dev, dt = g.poses.device, g.poses.dtype
    gauge = (torch.arange(n, device=dev) == 0)[:, None]
    delta = torch.where(gauge, torch.zeros_like(delta), delta)
    P = _apply_delta(g.poses, delta)
    nodes, loops = shard.nodes, shard.loops

    # odometry chain factors: node k vs k-1
    ov = g.odom_valid[nodes]
    r_odom = _between_residual_masked(torch.roll(P, 1, dims=0)[nodes], P[nodes],
                                      g.odom_meas[nodes], ov)
    r_odom = r_odom * _between_whitening(cfg, dt, dev)[None, :]
    r_odom = r_odom * ov[:, None]

    # loop factors (IRLS-weighted Cauchy)
    lv = g.loop_valid[loops]
    r_loop = _between_residual_masked(P[g.loop_i[loops]], P[g.loop_j[loops]],
                                      g.loop_meas[loops], lv) / cfg.loop_sigma
    r_loop = r_loop * (lv * torch.sqrt(loop_irls_w))[:, None]

    # GPS position factors (altitude-dominated by the sigma pattern)
    r_gps = (P[nodes, :3, 3] - g.gps_meas[nodes]) * _gps_whitening(cfg, dt, dev)
    r_gps = r_gps * (g.gps_valid[nodes] * torch.sqrt(gps_irls_w))[:, None]
    return torch.cat([r_odom.reshape(-1), r_loop.reshape(-1), r_gps.reshape(-1)])


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

def _cg_solve(matvec: Callable, b: torch.Tensor, precond: Callable, iters: int,
              tol: float, agree: Optional[Callable] = None) -> torch.Tensor:
    """Preconditioned CG on H x = b, stopping once |r|² / |b|² < tol² or
    after ``iters`` iterations (the carry freezes from there on).  ``agree``
    (the distributed solver's ``Mesh.agree_max``) turns the stop flag the
    host reads into one every rank reads alike."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    b2 = torch.clamp(torch.dot(b, b), min=1e-30)
    for it in range(iters):
        active = torch.dot(r, r) / b2 >= tol * tol
        if it % _CG_CHECK_EVERY == 0 and it > 0 and not bool(
                active if agree is None else agree(active)):
            break
        Hp = matvec(p)
        alpha = rz / torch.clamp(torch.dot(p, Hp), min=1e-30)
        x1 = x + alpha * p
        r1 = r - alpha * Hp
        z1 = precond(r1)
        rz1 = torch.dot(r1, z1)
        beta = rz1 / torch.clamp(rz, min=1e-30)
        p1 = z1 + beta * p
        x = torch.where(active, x1, x)
        r = torch.where(active, r1, r)
        p = torch.where(active, p1, p)
        rz = torch.where(active, rz1, rz)
    return x


def _diag_precond(g: GraphArrays, loop_w, gps_w, cfg: PgoConfig, lam: float):
    """Analytic approximation of diag(JᵀJ): each factor adds its squared
    whitening to the diagonal blocks of both endpoint nodes.  The loop terms
    are scatter-added with ``index_add_``, whose float order differs on
    CUDA (the sums agree to float rounding)."""
    n = g.poses.shape[0]
    dev, dt = g.poses.device, g.poses.dtype
    s_odom = _between_whitening(cfg, dt, dev) ** 2
    ov = g.odom_valid.to(dt)[:, None]
    d = ov * s_odom[None, :] + torch.roll(ov, -1, dims=0) * s_odom[None, :]
    s_loop = (1.0 / cfg.loop_sigma ** 2) * (g.loop_valid * loop_w)
    ones = torch.ones((1, 6), dtype=dt, device=dev)
    d = d.index_add(0, g.loop_i, s_loop[:, None] * ones)
    d = d.index_add(0, g.loop_j, s_loop[:, None] * ones)
    s_gps = torch.tensor([1.0 / cfg.gps_sigma_xy ** 2, 1.0 / cfg.gps_sigma_xy ** 2,
                          1.0 / cfg.gps_sigma_alt ** 2, 0.0, 0.0, 0.0],
                         dtype=dt, device=dev)
    d = d + (g.gps_valid * gps_w)[:, None] * s_gps[None, :] + lam
    dinv = (1.0 / torch.clamp(d, min=1e-12)).reshape(-1)
    return lambda v: dinv * v


def _chain_precond(g: GraphArrays, cfg: PgoConfig, lam: float):
    """Exact inverse of the odometry-chain part of the normal equations in
    edge coordinates: M⁻¹ r = T diag(W)⁻¹ Tᵀ r, a suffix sum, a per-edge
    scale and a prefix sum.  Node 0 gets zero edge weight (the gauge);
    invalid edges get the valid weight (SPD and close is all it needs)."""
    n = g.poses.shape[0]
    w = _between_whitening(cfg, g.poses.dtype, g.poses.device) ** 2 + lam
    winv = (1.0 / w)[None, :].repeat(n, 1)
    winv[0] = 0.0

    def apply(r):
        rd = r.reshape(n, 6)
        a = torch.flip(torch.cumsum(torch.flip(rd, [0]), dim=0), [0])   # Tᵀ r
        return torch.cumsum(a * winv, dim=0).reshape(-1)               # T W⁻¹ a

    return apply


def _gn_step(g: GraphArrays, cfg: PgoConfig, lam: float, shard: FactorShard = _WHOLE):
    """One IRLS + damped GN step: recompute robust weights, solve the normal
    equations by CG through jvp/vjp matvecs, apply the tangent update.
    Returns (graph, max |delta|).

    A rank of the distributed solver passes its ``shard``: it evaluates only
    those factors, the partial matvec and b are summed over the ranks, and
    CG's stop flag is agreed, so that the CG state is the same on every
    rank."""
    n = g.poses.shape[0]
    zero = torch.zeros((n, 6), dtype=g.poses.dtype, device=g.poses.device)

    # IRLS weights from the current (unweighted) robust-factor residuals
    loops, nodes = shard.loops, shard.nodes
    r_loop_raw = _between_residual_masked(
        g.poses[g.loop_i[loops]], g.poses[g.loop_j[loops]], g.loop_meas[loops],
        g.loop_valid[loops]) / cfg.loop_sigma
    loop_w = 1.0 / (1.0 + torch.sum(r_loop_raw * r_loop_raw, dim=-1) / cfg.loop_cauchy_k ** 2)
    gps_r = (g.poses[nodes, :3, 3] - g.gps_meas[nodes]) * _gps_whitening(cfg, g.poses.dtype,
                                                                          g.poses.device)
    gps_w = 1.0 / (1.0 + torch.sum(gps_r ** 2, dim=-1) / cfg.gps_cauchy_k ** 2)

    def rfun(d):
        return residuals(d, g, loop_w, gps_w, cfg, shard)

    r0, pullback = vjp(rfun, zero)
    # J v as the transpose of the pullback u -> Jᵀu (linear in u), taken once
    # per step like the pullback: the same J v as torch.func.jvp, at a
    # twentieth of its cost per call (see the module docstring)
    _, transpose = vjp(lambda u: pullback(u)[0], torch.zeros_like(r0))

    def matvec(v):
        Jv = transpose(v.reshape(n, 6))[0]
        return shard.reduce(pullback(Jv)[0].reshape(-1)) + lam * v

    b = -shard.reduce(pullback(r0)[0].reshape(-1))
    if cfg.preconditioner == "chain":
        precond = _chain_precond(g, cfg, lam)
    elif shard is _WHOLE:
        precond = _diag_precond(g, loop_w, gps_w, cfg, lam)
    else:
        # a rank holds only its own factors' weights: the distributed
        # solver's Jacobi is the odometry-dominated diagonal, as JAX's
        s2 = _between_whitening(cfg, g.poses.dtype, g.poses.device) ** 2
        dinv = 1.0 / (2.0 * s2.repeat(n) + lam)
        precond = lambda v: dinv * v   # noqa: E731
    delta = _cg_solve(matvec, b, precond, cfg.cg_iters, cfg.cg_tol,
                      agree=shard.agree).reshape(n, 6)

    idx = torch.arange(n, device=g.poses.device)
    active = (idx > 0) & (idx < g.num_nodes)
    delta = torch.where(active[:, None], delta, torch.zeros_like(delta))
    return g._replace(poses=_apply_delta(g.poses, delta)), torch.max(torch.abs(delta))


def solve(g: GraphArrays, cfg: PgoConfig, shard: FactorShard = _WHOLE) -> GraphArrays:
    """Full robust solve: up to cfg.gn_iters outer IRLS/GN iterations,
    stopping once the applied tangent step (agreed over the ranks of a
    ``shard``) falls below _GN_STEP_TOL."""
    for _ in range(cfg.gn_iters):
        g, step = _gn_step(g, cfg, cfg.lm_lambda0, shard)
        if float(step if shard.agree is None else shard.agree(step)) < _GN_STEP_TOL:
            break
    return g


def make_solver(cfg: PgoConfig) -> Callable[[GraphArrays], GraphArrays]:
    return lambda g: solve(g, cfg)


def bucket_size(capacity: int, num_nodes: int) -> int:
    """The smallest power-of-two prefix, at least 64, that holds the active
    graph (the chain preconditioner's cumsums run over the solved prefix,
    so the bucket is part of the numbers, not only of the speed)."""
    return min(capacity, max(64, 1 << (max(int(num_nodes), 1) - 1).bit_length()))


def make_bucketed_solver(cfg: PgoConfig, solve_poses: Optional[Callable] = None,
                         min_bucket: int = 1):
    """``solver(g, num_nodes, num_loops) -> GraphArrays`` that solves on the
    active power-of-two prefix of the node arrays (loops stay at full
    padding) and writes the solved poses back into the prefix.

    ``solve_poses(g) -> poses`` solves a prefix (default: ``solve``).  The
    distributed solver passes its own with ``min_bucket`` the mesh size:
    the bucket is at least that, and a capacity or bucket the mesh size
    does not divide solves at full capacity (JAX's mesh rule)."""
    if solve_poses is None:
        solve_poses = lambda g: solve(g, cfg).poses   # noqa: E731

    def solver(g: GraphArrays, num_nodes: int, num_loops: int) -> GraphArrays:
        n = g.poses.shape[0]
        nb = max(bucket_size(n, num_nodes), min_bucket)
        if n % min_bucket or nb % min_bucket:
            nb = n
        gs = g._replace(poses=g.poses[:nb], odom_meas=g.odom_meas[:nb],
                        odom_valid=g.odom_valid[:nb], gps_meas=g.gps_meas[:nb],
                        gps_valid=g.gps_valid[:nb])
        return g._replace(poses=torch.cat([solve_poses(gs), g.poses[nb:]], dim=0))

    return solver


# ---------------------------------------------------------------------------
# host-side graph builder
# ---------------------------------------------------------------------------

class PoseGraph:
    """Host wrapper: accumulates factors into the padded arrays and re-solves
    warm-started, like the reference's per-keyframe iSAM2 update."""

    def __init__(self, cfg: PgoConfig, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.g = empty_graph(cfg, self.device)
        self._solve = make_bucketed_solver(cfg)
        self.num_nodes = 0
        self.num_loops = 0

    def grow(self, new_max_nodes: int = None, new_max_loops: int = None):
        """Raise the capacities (default: double), padding every array."""
        old = self.g
        self.cfg = dataclasses.replace(
            self.cfg, max_nodes=new_max_nodes or 2 * self.cfg.max_nodes,
            max_loop_edges=new_max_loops or 2 * self.cfg.max_loop_edges)
        g = empty_graph(self.cfg, self.device)
        n0, l0 = old.poses.shape[0], old.loop_i.shape[0]
        for name in ("poses", "odom_meas", "odom_valid", "gps_meas", "gps_valid"):
            getattr(g, name)[:n0] = getattr(old, name)
        for name in ("loop_i", "loop_j", "loop_meas", "loop_valid"):
            getattr(g, name)[:l0] = getattr(old, name)
        self.g = g._replace(num_nodes=old.num_nodes)
        self._solve = make_bucketed_solver(self.cfg)

    def add_node(self, pose_init: np.ndarray, odom_meas: np.ndarray = None) -> int:
        """Append a node with its initial SE(3) pose; odom_meas is
        T_{prev,this} (None for the first node, the gauge)."""
        k = self.num_nodes
        if k >= self.cfg.max_nodes:
            raise RuntimeError("pose graph capacity exceeded; raise max_nodes")
        self.g.poses[k] = torch.as_tensor(np.asarray(pose_init), dtype=torch.float32)
        if odom_meas is not None and k > 0:
            self.g.odom_meas[k] = torch.as_tensor(np.asarray(odom_meas),
                                                  dtype=torch.float32)
            self.g.odom_valid[k] = True
        self.num_nodes = k + 1
        self.g = self.g._replace(num_nodes=torch.tensor(k + 1, device=self.device))
        return k

    def add_loop(self, i: int, j: int, meas: np.ndarray):
        l = self.num_loops
        if l >= self.cfg.max_loop_edges:
            raise RuntimeError("loop edge capacity exceeded; raise max_loop_edges")
        self.g.loop_i[l] = i
        self.g.loop_j[l] = j
        self.g.loop_meas[l] = torch.as_tensor(np.asarray(meas), dtype=torch.float32)
        self.g.loop_valid[l] = True
        self.num_loops = l + 1

    def add_gps(self, node: int, xyz: np.ndarray):
        self.g.gps_meas[node] = torch.as_tensor(np.asarray(xyz), dtype=torch.float32)
        self.g.gps_valid[node] = True

    def optimize(self):
        self.g = self._solve(self.g, self.num_nodes, self.num_loops)

    def poses(self) -> np.ndarray:
        """(num_nodes, 4, 4) current estimates on the host."""
        return self.g.poses[: self.num_nodes].cpu().numpy()
