"""Submap-to-scan ICP for loop verification, in PyTorch.

Counterpart of ``navtech_radar_slam_tpu.ops.icp``: align the query keyframe
cloud to a stacked submap by brute-force nearest neighbours and a
closed-form weighted SE(2) Horn update per iteration; accept by the
fitness gate ("whitened" or PCL "pcl" metric) after convergence.

``nearest_neighbors`` is the dispatch point of kernel K3: a CUDA tensor
launches ``ops.kernels.nn_dist`` (no fallback), a CPU tensor runs the plain
version below; ``nearest_neighbors_multi`` is that of K3-T, T problems in
one launch, which ``icp_se2_multi`` (the streaming segment's T slots in
lockstep) calls.  Both follow the TPU kernel's subtract-square contract
(dx² + dy², first index on ties); the JAX package's XLA fallback uses the
|a|² + |b|² - 2ab expansion instead, so its d² differs by ~1e-2 m² at 200 m.

The JAX ``lax.while_loop`` becomes a bounded loop whose carry freezes once
converged (``torch.where(done, old, new)``), which gives exactly the
while-loop's result; the host checks for convergence every
``_CHECK_EVERY`` iterations to stop early, instead of syncing on every
iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from navtech_radar_slam_torch.config import IcpConfig
from navtech_radar_slam_torch.ops.kernels import nn_dist
from navtech_radar_slam_torch.utils import geometry as geo

#: iterations between host reads of the convergence flag
_CHECK_EVERY = 8


class IcpResult(NamedTuple):
    rel_pose: torch.Tensor     # (3,) SE(2) aligning src into the tgt frame
    fitness: torch.Tensor      # () fitness under cfg.fitness_metric
    num_corr: torch.Tensor     # () int64 correspondences in the final pass
    converged: torch.Tensor    # () bool step or mse criterion met
    accepted: torch.Tensor     # () bool fitness <= thresh and >= 10 corr


def nearest_neighbors_plain(src: torch.Tensor, tgt: torch.Tensor, tgt_valid: torch.Tensor,
                            slot_mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernels K3 and K3-T (any device): the
    (..., Nq, Nt) subtract-square matrix on elementwise ops (no contracted
    multiply-add, so d² is bit-equal to the kernels'), invalid targets at
    +inf, then ``argmin`` (first index on ties; 0 for an all-invalid target
    set).  src (..., Nq, 2), tgt (..., Nt, 2), tgt_valid (..., Nt); leading
    dims are independent problems (K3-T's slots).  ``slot_mask`` (the
    leading dims, bool, optional): a problem where it is False has no valid
    target, so each of its queries gets (+inf, 0), as K3-T gives a masked
    slot."""
    if slot_mask is not None:
        tgt_valid = tgt_valid & slot_mask[..., None]
    dx = src[..., 0:1] - tgt[..., None, :, 0]
    dy = src[..., 1:2] - tgt[..., None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = torch.where(tgt_valid[..., None, :], d2, torch.full_like(d2, float("inf")))
    idx = torch.argmin(d2, dim=-1)
    return torch.gather(d2, -1, idx[..., None])[..., 0], idx


def nearest_neighbors(src: torch.Tensor, tgt: torch.Tensor, tgt_valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force NN: (min squared distance (Nq,), first argmin (Nq,)).
    A CUDA tensor runs kernel K3, a CPU tensor the plain version."""
    if src.device.type == "cuda":
        return nn_dist.nearest_neighbors_cuda(src.contiguous(), tgt.contiguous(),
                                              tgt_valid.contiguous())
    if src.device.type != "cpu":
        raise ValueError(f"nearest_neighbors: unsupported device {src.device}")
    return nearest_neighbors_plain(src, tgt, tgt_valid)


def nearest_neighbors_multi(src: torch.Tensor, tgt: torch.Tensor, tgt_valid: torch.Tensor,
                            slot_mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nearest_neighbors`` for T problems at once: (T, Nq, 2), (T, Nt, 2),
    (T, Nt) -> (T, Nq) d² and first index; with ``slot_mask`` (T,) only the
    slots where it holds are computed, the others give (+inf, 0).  A CUDA
    tensor runs kernel K3-T (one launch for every slot), a CPU tensor the
    plain version."""
    if src.device.type == "cuda":
        return nn_dist.nearest_neighbors_multi_cuda(
            src.contiguous(), tgt.contiguous(), tgt_valid.contiguous(),
            None if slot_mask is None else slot_mask.contiguous())
    if src.device.type != "cpu":
        raise ValueError(f"nearest_neighbors_multi: unsupported device {src.device}")
    return nearest_neighbors_plain(src, tgt, tgt_valid, slot_mask)


def _weighted_se2_horn(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor
                       ) -> torch.Tensor:
    """Closed-form weighted SE(2) alignment: [tx, ty, theta] minimizing
    Σ w |R s + t - d|²."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    cs = torch.sum(w[:, None] * src, dim=0) / wsum
    cd = torch.sum(w[:, None] * dst, dim=0) / wsum
    s0 = src - cs
    d0 = dst - cd
    dot = torch.sum(w * (s0[:, 0] * d0[:, 0] + s0[:, 1] * d0[:, 1]))
    crs = torch.sum(w * (s0[:, 0] * d0[:, 1] - s0[:, 1] * d0[:, 0]))
    theta = torch.atan2(crs, dot)
    c, s = torch.cos(theta), torch.sin(theta)
    t = cd - torch.stack([c * cs[0] - s * cs[1], s * cs[0] + c * cs[1]])
    return torch.stack([t[0], t[1], theta])


def icp_se2(src: torch.Tensor, src_valid: torch.Tensor, tgt: torch.Tensor,
            tgt_valid: torch.Tensor, init_pose: torch.Tensor, cfg: IcpConfig
            ) -> IcpResult:
    """Align src onto tgt starting from init_pose ([x, y, theta]).

    Converged when the transform step falls below cfg.epsilon in every
    component, or the mean squared correspondence error changes by less
    than cfg.euclidean_fitness_eps (or, outside "pcl" mode, by less than
    cfg.rel_fitness_eps of itself); at most cfg.max_iters iterations."""
    max_d2 = cfg.max_corr_dist * cfg.max_corr_dist
    dev = src.device
    pose = init_pose.to(torch.float32)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    prev_mse = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    for it in range(cfg.max_iters):
        if it % _CHECK_EVERY == 0 and it > 0 and bool(converged):
            break
        moved = geo.se2_apply(pose, src)
        nn_d2, nn_idx = nearest_neighbors(moved, tgt, tgt_valid)
        w = (src_valid & (nn_d2 < max_d2)).to(torch.float32)
        mse = torch.sum(w * nn_d2) / torch.clamp(torch.sum(w), min=1.0)
        upd = _weighted_se2_horn(moved, tgt[nn_idx], w)
        new_pose = geo.se2_mul(upd, pose)
        step = torch.abs(new_pose - pose)
        small = torch.all(step < cfg.epsilon)
        dmse = torch.abs(mse - prev_mse)
        mse_static = dmse < cfg.euclidean_fitness_eps
        if cfg.rel_fitness_eps > 0 and cfg.fitness_metric != "pcl":
            # relative plateau: NN-assignment oscillation at the optimum
            # keeps the step above epsilon while mse is static to ~0.1 %
            mse_static = mse_static | (dmse < cfg.rel_fitness_eps * mse)
        # freeze the carry once converged: the while-loop's result
        pose = torch.where(converged, pose, new_pose)
        prev_mse = torch.where(converged, prev_mse, mse)
        converged = converged | small | mse_static

    # final fitness over in-range correspondences ("pcl": mean squared NN
    # distance; "whitened": each normalised by 2 (sigma_r² + (r sigma_az)²))
    moved = geo.se2_apply(pose, src)
    nn_d2, _ = nearest_neighbors(moved, tgt, tgt_valid)
    in_range = src_valid & (nn_d2 < max_d2)
    n = torch.sum(in_range)
    if cfg.fitness_metric == "whitened":
        r2 = torch.sum(src * src, dim=-1)
        sig2 = cfg.whiten_sigma_range ** 2 + r2 * cfg.whiten_sigma_azimuth_rad ** 2
        contrib = nn_d2 / (2.0 * sig2)
    else:
        contrib = nn_d2
    fitness = (torch.sum(torch.where(in_range, contrib, torch.zeros_like(contrib)))
               / torch.clamp(n, min=1))
    accepted = (fitness <= cfg.fitness_thresh) & (n >= 10)
    return IcpResult(rel_pose=pose, fitness=fitness, num_corr=n, converged=converged,
                     accepted=accepted)


def _weighted_se2_horn_multi(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """``_weighted_se2_horn`` for T problems: src, dst (T, N, 2), w (T, N) ->
    (T, 3)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[:, None]
    cs = torch.sum(w[..., None] * src, dim=-2) / wsum
    cd = torch.sum(w[..., None] * dst, dim=-2) / wsum
    s0 = src - cs[:, None]
    d0 = dst - cd[:, None]
    dot = torch.sum(w * (s0[..., 0] * d0[..., 0] + s0[..., 1] * d0[..., 1]), dim=-1)
    crs = torch.sum(w * (s0[..., 0] * d0[..., 1] - s0[..., 1] * d0[..., 0]), dim=-1)
    theta = torch.atan2(crs, dot)
    c, s = torch.cos(theta), torch.sin(theta)
    t = cd - torch.stack([c * cs[:, 0] - s * cs[:, 1], s * cs[:, 0] + c * cs[:, 1]], dim=-1)
    return torch.cat([t, theta[:, None]], dim=-1)


def icp_se2_multi(src: torch.Tensor, src_valid: torch.Tensor, tgt: torch.Tensor,
                  tgt_valid: torch.Tensor, init_pose: torch.Tensor, cfg: IcpConfig,
                  active: torch.Tensor) -> IcpResult:
    """``icp_se2`` for T problems in lockstep (the ``jax.vmap`` of the JAX
    segment): src (T, Nq, 2), src_valid (T, Nq), tgt (T, Nt, 2), tgt_valid
    (T, Nt), init_pose (T, 3) -> an IcpResult of (T,)-leading leaves.

    Every iteration is one K3-T call for all slots, and each slot's carry
    freezes once it converges, so slot t ends where ``icp_se2`` on its own
    problem ends.  Slots with ``active`` False (no candidate, or an empty
    slot) start converged: their result is meaningless and the caller
    replaces it, as the vmapped ``lax.cond`` selects it away.  K3-T computes
    only the slots that still move (its slot mask: the unconverged ones,
    then ``active`` for the final fitness); a frozen slot's (+inf, 0)
    neighbours feed only values that the freeze discards.  The host
    reads "every slot converged" once every ``_CHECK_EVERY`` iterations
    (from iteration 0, so a segment without a candidate runs no iteration),
    never one slot's flag."""
    max_d2 = cfg.max_corr_dist * cfg.max_corr_dist
    pose = init_pose.to(torch.float32)
    converged = ~active
    prev_mse = torch.full(converged.shape, float("inf"), dtype=torch.float32,
                          device=src.device)
    for it in range(cfg.max_iters):
        if it % _CHECK_EVERY == 0 and bool(converged.all()):
            break
        moved = geo.se2_apply(pose, src)
        # converged covers ~active, so this is active & ~converged
        nn_d2, nn_idx = nearest_neighbors_multi(moved, tgt, tgt_valid, ~converged)
        w = (src_valid & (nn_d2 < max_d2)).to(torch.float32)
        mse = torch.sum(w * nn_d2, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)
        matched = torch.gather(tgt, 1, nn_idx[..., None].expand(-1, -1, 2))
        upd = _weighted_se2_horn_multi(moved, matched, w)
        new_pose = geo.se2_mul(upd, pose)
        small = torch.all(torch.abs(new_pose - pose) < cfg.epsilon, dim=-1)
        dmse = torch.abs(mse - prev_mse)
        mse_static = dmse < cfg.euclidean_fitness_eps
        if cfg.rel_fitness_eps > 0 and cfg.fitness_metric != "pcl":
            mse_static = mse_static | (dmse < cfg.rel_fitness_eps * mse)
        pose = torch.where(converged[:, None], pose, new_pose)
        prev_mse = torch.where(converged, prev_mse, mse)
        converged = converged | small | mse_static

    # the final fitness, as icp_se2: one K3-T call on the active slots
    moved = geo.se2_apply(pose, src)
    nn_d2, _ = nearest_neighbors_multi(moved, tgt, tgt_valid, active)
    in_range = src_valid & (nn_d2 < max_d2)
    n = torch.sum(in_range, dim=-1)
    if cfg.fitness_metric == "whitened":
        r2 = torch.sum(src * src, dim=-1)
        sig2 = cfg.whiten_sigma_range ** 2 + r2 * cfg.whiten_sigma_azimuth_rad ** 2
        contrib = nn_d2 / (2.0 * sig2)
    else:
        contrib = nn_d2
    fitness = (torch.sum(torch.where(in_range, contrib, torch.zeros_like(contrib)), dim=-1)
               / torch.clamp(n, min=1))
    accepted = (fitness <= cfg.fitness_thresh) & (n >= 10)
    return IcpResult(rel_pose=pose, fitness=fitness, num_corr=n, converged=converged,
                     accepted=accepted)
