"""Constellation descriptors and mutual-nearest matching in plain PyTorch
(a frozen copy of the port's ``ops/features.py`` pipeline functions).
Every float32 product goes through the ``mm`` it is given, so the control
can compute them at TF32 precision (``precision.py``)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

def _radial_frame(xy: torch.Tensor):
    """cos / sin of each point's bearing from the sensor ((1, 0) at the origin)."""
    rngs = torch.linalg.norm(xy, dim=-1)
    safe = torch.clamp(rngs, min=1e-6)
    far = rngs > 1e-6
    c = torch.where(far, xy[:, 0] / safe, torch.ones_like(rngs))
    s = torch.where(far, xy[:, 1] / safe, torch.zeros_like(rngs))
    return c, s



def constellation_descriptors(
    xy: torch.Tensor,
    power: torch.Tensor,
    valid: torch.Tensor,
    fcfg,
    mm: Callable = torch.bmm,
) -> torch.Tensor:
    """Point-set "constellation" descriptors: (K, desc_grid²).

    Each feature's neighbours (weighted by power and a radial falloff) are
    soft-splatted into a desc_grid x desc_grid histogram in the feature's
    radial frame, then the histogram is centred and normalised.  The
    bilinear splat is a separable hat basis contracted with one batched
    matmul, as in the JAX code; it holds two (K, K, P) float32 tensors (about
    64 MB each at K = 1024, P = 16)."""
    K = xy.shape[0]
    P = fcfg.desc_grid
    cell = fcfg.desc_window / P

    delta = xy[None, :, :] - xy[:, None, :]            # (K_center, K_nbr, 2)
    c, s = _radial_frame(xy)
    # rotate each center's neighbourhood into its radial frame
    dx = c[:, None] * delta[..., 0] + s[:, None] * delta[..., 1]
    dy = -s[:, None] * delta[..., 0] + c[:, None] * delta[..., 1]

    gx = dx / cell + P / 2 - 0.5
    gy = dy / cell + P / 2 - 0.5

    w = (valid[None, :] & valid[:, None]).to(torch.float32)
    w = w * power[None, :]
    # mild radial falloff keeps distant in-window neighbours from dominating
    w = w * torch.exp(-0.5 * (dx * dx + dy * dy) / (fcfg.desc_window * 0.5) ** 2)

    # max(0, 1 - |g - p|) over cell centres p is exactly the two bilinear
    # tap weights (zero outside the grid):
    #   desc[i, y, x] = sum_j w_ij * hat_y(gy_ij)[y] * hat_x(gx_ij)[x]
    cells = torch.arange(P, dtype=torch.float32, device=xy.device)
    bx = torch.clamp(1.0 - torch.abs(gx[..., None] - cells), min=0.0)   # (K, K, P)
    by = torch.clamp(1.0 - torch.abs(gy[..., None] - cells), min=0.0)
    desc = mm((by * w[..., None]).transpose(1, 2), bx).reshape(K, P * P)
    desc = desc - torch.mean(desc, dim=1, keepdim=True)
    norm = torch.linalg.norm(desc, dim=1, keepdim=True)
    return desc / torch.clamp(norm, min=1e-6)


class MatchSet(NamedTuple):
    """Fixed-size matched correspondence set between two scans."""

    src_xy: torch.Tensor    # (M, 2) prev-scan points (sensor frame, m)
    dst_xy: torch.Tensor    # (M, 2) curr-scan points
    src_range: torch.Tensor  # (M,) range of src points (for anisotropic noise)
    dst_range: torch.Tensor  # (M,)
    weight: torch.Tensor    # (M,) match confidence in [0, 1]
    valid: torch.Tensor     # (M,) bool
    #: sweep fractions of the matched rays (for the de-skew of the
    #: correspondence set, models.odometry.deskew_matches); None when the
    #: producer has no ray timing (e.g. synthetic test sets)
    src_frac: Optional[torch.Tensor] = None   # (M,)
    dst_frac: Optional[torch.Tensor] = None   # (M,)


def top_k_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` of a 1-D tensor: the k largest values, equal values
    lowest index first (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def match_features(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    xy_a: torch.Tensor,
    xy_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    fcfg,
    frac_a: Optional[torch.Tensor] = None,
    frac_b: Optional[torch.Tensor] = None,
    mm: Callable = torch.matmul,
) -> MatchSet:
    """Mutual-nearest + ratio-gated matches via one correlation matmul.

    ``argmax`` takes the first maximal index on the CPU and on CUDA alike,
    as ``jnp.argmax`` does."""
    neg = -2.0
    C = mm(desc_a, desc_b.T)
    C = torch.where(valid_a[:, None] & valid_b[None, :], C, torch.full_like(C, neg))

    rows = torch.arange(C.shape[0], device=C.device)
    best_j = torch.argmax(C, dim=1)                      # (K,)
    best_c = torch.max(C, dim=1).values
    # second-best for the ratio test
    C_wo = C.clone()
    C_wo[rows, best_j] = neg
    second_c = torch.max(C_wo, dim=1).values
    best_i_of_j = torch.argmax(C, dim=0)                 # (K,)
    mutual = best_i_of_j[best_j] == rows

    # Lowe ratio on correlation distance (1 - c)
    d1 = 1.0 - best_c
    d2 = 1.0 - second_c
    ratio_ok = d1 < fcfg.ratio_test * d2
    good = mutual & ratio_ok & valid_a & (best_c > neg + 1.0)

    score = torch.where(good, best_c, torch.full_like(best_c, neg))
    top_score, top_i = top_k_stable(score, fcfg.max_matches)
    sel_j = best_j[top_i]
    m_valid = top_score > neg + 1.0
    mv = m_valid.to(torch.float32)

    src = xy_a[top_i]
    dst = xy_b[sel_j]
    zero = torch.zeros_like(src)
    return MatchSet(
        src_xy=torch.where(m_valid[:, None], src, zero),
        dst_xy=torch.where(m_valid[:, None], dst, zero),
        src_range=torch.linalg.norm(src, dim=-1) * mv,
        dst_range=torch.linalg.norm(dst, dim=-1) * mv,
        weight=torch.where(m_valid, torch.clamp(top_score, 0.0, 1.0),
                           torch.zeros_like(top_score)),
        valid=m_valid,
        src_frac=None if frac_a is None else frac_a[top_i] * mv,
        dst_frac=None if frac_b is None else frac_b[sel_j] * mv,
    )
