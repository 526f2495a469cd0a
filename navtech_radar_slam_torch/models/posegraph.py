"""Robust SE(3) pose-graph optimization in PyTorch.

Counterpart of ``navtech_radar_slam_tpu.models.posegraph``: a pose graph
with an exact gauge on node 0, odometry Between factors, Cauchy-robust loop
Between factors and altitude-dominated GPS factors, solved by warm-started
IRLS Gauss-Newton whose normal equations are solved by preconditioned
conjugate gradients.  Each GN step linearizes once, at delta = 0: every
factor's Jacobian block against its two endpoint tangents (9 x 12: the
6-row Between residual of an odometry or loop factor, and the 3 GPS rows
of the node's position; whitened, IRLS-weighted, zero for padding and in
node 0's gauge columns) comes from reverse-mode autodiff of the factors'
own residual function, batched over the factors (``_factor_jacobians``):
the derivative the residual function defines, not hand-derived SE(3)
Jacobians.  A CG matvec H v = Jᵀ (J v) + λ v is then a gather of v at each
factor's endpoints, two batched block products, a shift by one node for
the odometry chain and ``index_add`` for the loops: about two dozen ops,
whatever the graph's size.

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
import torch.nn.functional as F

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


def _factor_residuals(Ti, Tj, meas, valid, gps_meas) -> torch.Tensor:
    """Raw residuals (F, 9) of a batch of factors joining poses Ti and Tj:
    the Between residual against ``meas`` (rows 0-5), then Tj's position
    less ``gps_meas`` (rows 6-8)."""
    return torch.cat([_between_residual_masked(Ti, Tj, meas, valid), Tj[:, :3, 3] - gps_meas],
                     dim=1)


class _Factors(NamedTuple):
    """One shard's factors in ``_factor_residuals``' layout: first node k's
    (its odometry factor against node k - 1, mod N, and its GPS factor),
    then the loops (rows 6-8 unused)."""

    pairs: torch.Tensor    # (F, 2) int64 endpoint nodes i, j
    meas: torch.Tensor     # (F, 4, 4)
    valid: torch.Tensor    # (F,) bool, of the Between rows
    gps: torch.Tensor      # (F, 3)
    scale: torch.Tensor    # (F, 9) row whitening and IRLS weights, 0 for padding
    num_node: int


def _factors(g: GraphArrays, loop_w, gps_w, cfg: PgoConfig, shard: FactorShard) -> _Factors:
    n = g.poses.shape[0]
    dev, dt = g.poses.device, g.poses.dtype
    nodes, loops = shard.nodes, shard.loops
    k = torch.arange(n, device=dev)[nodes]
    m = k.shape[0]
    ov, lv, gv = g.odom_valid[nodes], g.loop_valid[loops], g.gps_valid[nodes]
    node_scale = torch.cat([_between_whitening(cfg, dt, dev) * ov[:, None],
                            _gps_whitening(cfg, dt, dev) * (gv * torch.sqrt(gps_w))[:, None]],
                           dim=1)
    loop_scale = F.pad((lv * torch.sqrt(loop_w) / cfg.loop_sigma)[:, None].expand(-1, 6),
                       (0, 3))
    return _Factors(
        pairs=torch.cat([torch.stack([torch.remainder(k - 1, n), k], dim=1),
                         torch.stack([g.loop_i[loops], g.loop_j[loops]], dim=1)]),
        meas=torch.cat([g.odom_meas[nodes], g.loop_meas[loops]]),
        valid=torch.cat([ov, lv]),
        gps=F.pad(g.gps_meas[nodes], (0, 0, 0, lv.shape[0])),
        scale=torch.cat([node_scale, loop_scale]),
        num_node=m)


def residuals(delta: torch.Tensor, g: GraphArrays, loop_irls_w: torch.Tensor,
              gps_irls_w: torch.Tensor, cfg: PgoConfig,
              shard: FactorShard = _WHOLE) -> torch.Tensor:
    """The whitened residuals of ``shard``'s factors (default: all of them)
    as one flat vector: odometry (6 a node), loops (6 a factor), GPS (3 a
    node).  delta (N, 6) is the tangent update being linearized (0 at the
    linearization point), the IRLS weights those of the shard's factors.
    Node 0 is the gauge: its delta is zeroed (exact prior)."""
    n = g.poses.shape[0]
    gauge = (torch.arange(n, device=g.poses.device) == 0)[:, None]
    P = _apply_delta(g.poses, torch.where(gauge, torch.zeros_like(delta), delta))
    f = _factors(g, loop_irls_w, gps_irls_w, cfg, shard)
    r = _factor_residuals(P[f.pairs[:, 0]], P[f.pairs[:, 1]], f.meas, f.valid, f.gps) * f.scale
    m = f.num_node
    return torch.cat([r[:m, :6].reshape(-1), r[m:, :6].reshape(-1), r[:m, 6:].reshape(-1)])


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


class Linearization(NamedTuple):
    """One shard's factors linearized at delta = 0 (``linearize``)."""

    pairs: torch.Tensor   # (F, 2) endpoint nodes, as ``_Factors``
    blk: torch.Tensor     # (F, 9, 12) vs [delta_i, delta_j]: whitened, weighted, gauge-free
    r0: torch.Tensor      # (F, 9) whitened, weighted residuals
    num_node: int         # the first num_node factors are node k's, the rest loops
    loop_w: torch.Tensor  # (l,) Cauchy IRLS weights of the shard's loop factors
    gps_w: torch.Tensor   # (num_node,) of its GPS factors


def _factor_jacobians(Ti, Tj, meas, valid, gps) -> tuple:
    """``_factor_residuals``' Jacobian blocks (F, 9, 12) against the
    endpoint tangents [delta_i, delta_j] (Ti exp(delta_i), Tj exp(delta_j))
    at zero, and its residuals (F, 9) there.  Factor f's rows depend on its
    own tangents only, so one reverse-mode pass over 9 copies of the
    factors, copy c seeded with unit row c, gives every block: plain
    autograd of sum(r * seed), since ``torch.func``'s vmap imports
    torch._dynamo and sympy on its first call in a process (seconds)."""
    f = Ti.shape[0]
    rep = lambda x: x.repeat((9,) + (1,) * (x.dim() - 1))   # noqa: E731
    with torch.enable_grad():
        d = torch.zeros((9 * f, 12), dtype=Ti.dtype, device=Ti.device, requires_grad=True)
        r = _factor_residuals(_apply_delta(rep(Ti), d[:, :6]), _apply_delta(rep(Tj), d[:, 6:]),
                              rep(meas), rep(valid), rep(gps))
        seed = torch.eye(9, dtype=r.dtype, device=r.device).repeat_interleave(f, dim=0)
        (jac,) = torch.autograd.grad(torch.sum(r * seed), d)
    return jac.reshape(9, f, 12).transpose(0, 1), r[:f].detach()


def linearize(g: GraphArrays, cfg: PgoConfig, shard: FactorShard = _WHOLE) -> Linearization:
    """The IRLS weights from the current (unweighted) robust-factor
    residuals, then the Jacobian blocks and residuals of ``shard``'s factors
    at delta = 0: ``residuals``' Jacobian block by block, by autodiff of the
    factors' own residual function, with node 0's columns zeroed."""
    dev, dt = g.poses.device, g.poses.dtype
    loops, nodes = shard.loops, shard.nodes
    r_loop_raw = _between_residual_masked(
        g.poses[g.loop_i[loops]], g.poses[g.loop_j[loops]], g.loop_meas[loops],
        g.loop_valid[loops]) / cfg.loop_sigma
    loop_w = 1.0 / (1.0 + torch.sum(r_loop_raw * r_loop_raw, dim=-1) / cfg.loop_cauchy_k ** 2)
    gps_r = (g.poses[nodes, :3, 3] - g.gps_meas[nodes]) * _gps_whitening(cfg, dt, dev)
    gps_w = 1.0 / (1.0 + torch.sum(gps_r ** 2, dim=-1) / cfg.gps_cauchy_k ** 2)

    f = _factors(g, loop_w, gps_w, cfg, shard)
    blk, r = _factor_jacobians(g.poses[f.pairs[:, 0]], g.poses[f.pairs[:, 1]], f.meas,
                               f.valid, f.gps)
    gauge_free = (f.pairs != 0).repeat_interleave(6, dim=1)[:, None, :]
    blk = torch.where(gauge_free, blk * f.scale[:, :, None], torch.zeros_like(blk))
    return Linearization(f.pairs, blk, r * f.scale, f.num_node, loop_w, gps_w)


def _bmv(blk: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched block-vector product: (F, a, b) x (F, b) -> (F, a)."""
    return torch.bmm(blk, x[:, :, None])[:, :, 0]


def _jt(lin: Linearization, u: torch.Tensor, n: int, nodes: slice) -> torch.Tensor:
    """Jᵀ u of one shard's factors, u (F, 9), as (N, 6): a node factor's
    halves added at node k and, shifted by one, at node k - 1; the loops'
    by ``index_add`` (whose float order differs on CUDA)."""
    y = _bmv(lin.blk.transpose(1, 2), u)
    node, loop = y[:lin.num_node], y[lin.num_node:]
    lo, hi, _ = nodes.indices(n)
    if (lo, hi) != (0, n):
        node = F.pad(node, (0, 0, lo, n - hi))
    out = node[:, 6:] + torch.roll(node[:, :6], -1, dims=0)
    return out.index_add(0, lin.pairs[lin.num_node:].reshape(-1), loop.reshape(-1, 6))


def _jtj(lin: Linearization, v: torch.Tensor, nodes: slice) -> torch.Tensor:
    """Jᵀ (J v) of one shard's factors; v and the result (N, 6)."""
    return _jt(lin, _bmv(lin.blk, v[lin.pairs].reshape(-1, 12)), v.shape[0], nodes)


def normal_equations(lin: Linearization, n: int, lam: float,
                     shard: FactorShard = _WHOLE) -> tuple:
    """(matvec, b) over flat (6 N,) vectors: H v = Jᵀ (J v) + λ v and
    b = -Jᵀ r0, each rank's partial sums merged by ``shard.reduce``."""

    def matvec(v):
        return shard.reduce(_jtj(lin, v.reshape(n, 6), shard.nodes).reshape(-1)) + lam * v

    return matvec, -shard.reduce(_jt(lin, lin.r0, n, shard.nodes).reshape(-1))


def _gn_step(g: GraphArrays, cfg: PgoConfig, lam: float, shard: FactorShard = _WHOLE):
    """One IRLS + damped GN step: recompute robust weights, linearize once,
    solve the normal equations by CG, apply the tangent update.  Returns
    (graph, max |delta|).

    A rank of the distributed solver passes its ``shard``: it linearizes
    only those factors, the partial matvec and b are summed over the ranks,
    and CG's stop flag is agreed, so that the CG state is the same on every
    rank."""
    n = g.poses.shape[0]
    lin = linearize(g, cfg, shard)
    matvec, b = normal_equations(lin, n, lam, shard)
    if cfg.preconditioner == "chain":
        precond = _chain_precond(g, cfg, lam)
    elif shard is _WHOLE:
        precond = _diag_precond(g, lin.loop_w, lin.gps_w, cfg, lam)
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
