"""Constellation descriptors and mutual-nearest matching in PyTorch, and
the Cartesian rendering utilities.

Counterpart of ``navtech_radar_slam_tpu.ops.features``: the pipeline's
constellation descriptors and matcher (both matmuls in true float32: the
package turns TF32 off at import; on a CUDA tensor the descriptors are
kernel K4, ``ops.kernels.descriptors``), and the polar -> Cartesian bilinear
rendering with radially-aligned image-patch descriptors
(``polar_to_cartesian``, ``_bilinear_sample``, ``patch_descriptors``;
visualisation and experiments, on no pipeline), plain torch ops on the
device of their input.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from navtech_radar_slam_torch.config import FeatureConfig, RadarConfig
from navtech_radar_slam_torch.ops.kernels import descriptors
from navtech_radar_slam_torch.utils.profiling import span


def _radial_frame(xy: torch.Tensor):
    """cos / sin of each point's bearing from the sensor ((1, 0) at the origin)."""
    rngs = torch.linalg.norm(xy, dim=-1)
    safe = torch.clamp(rngs, min=1e-6)
    far = rngs > 1e-6
    c = torch.where(far, xy[:, 0] / safe, torch.ones_like(rngs))
    s = torch.where(far, xy[:, 1] / safe, torch.zeros_like(rngs))
    return c, s


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as one division on every device: CUDA applies a
    Python-scalar divisor as a multiplication by its reciprocal, up to an
    ulp off, and an ulp of a range-bin coordinate (~2.4e-4 at 3,000 bins)
    moves a bilinear sample by that share of the step between two bins."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def polar_to_cartesian(power: torch.Tensor, fcfg: FeatureConfig, rcfg: RadarConfig
                       ) -> torch.Tensor:
    """Render the (S, S) Cartesian image of a (NA, NB) polar power image by
    bilinear sampling; x right, y down-range of azimuth 0, the sensor at the
    centre, zero beyond the last range bin.

    Each pixel's range and bearing are taken in float64 and rounded to
    float32, so the CPU and the card sample at the same coordinates: torch's
    float32 sqrt on the CPU is not always correctly rounded (an ulp of a
    range is 2.4e-4 of a bin at 180 m), and CUDA's atan2f is not the CPU's."""
    S = fcfg.cart_size
    na = rcfg.num_azimuths
    nrb = rcfg.num_range_bins
    ij = (torch.arange(S, dtype=torch.float32, device=power.device) - S / 2 + 0.5) \
        * fcfg.cart_resolution
    x = ij[None, :]                      # columns -> x
    y = ij[:, None]                      # rows -> y
    r = torch.sqrt((x * x + y * y).to(torch.float64)).to(torch.float32)
    theta = torch.remainder(torch.atan2(y.to(torch.float64), x.to(torch.float64))
                            .to(torch.float32), 2.0 * math.pi)

    az_f = _true_div(theta, 2.0 * math.pi) * na - 0.5
    rb_f = _true_div(r, rcfg.range_resolution) - 0.5
    a0 = torch.floor(az_f).to(torch.int64)
    r0 = torch.floor(rb_f).to(torch.int64)
    wa = az_f - a0.to(torch.float32)
    wr = rb_f - r0.to(torch.float32)

    # the first half-bin of azimuth has a0 = -1: remainder takes the
    # divisor's sign, as jnp.mod does
    a0m = torch.remainder(a0, na)
    a1m = torch.remainder(a0 + 1, na)
    in_range = (r0 >= 0) & (r0 + 1 < nrb)
    r0c = torch.clamp(r0, 0, nrb - 1)
    r1c = torch.clamp(r0 + 1, 0, nrb - 1)
    out = (power[a0m, r0c] * (1 - wa) * (1 - wr)
           + power[a0m, r1c] * (1 - wa) * wr
           + power[a1m, r0c] * wa * (1 - wr)
           + power[a1m, r1c] * wa * wr)
    return torch.where(in_range, out, torch.zeros_like(out))


def _bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample img[(v, u)] bilinearly; u = column (x), v = row (y); zero
    where a tap falls outside the image."""
    S = img.shape[0]
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    du = u - u0.to(u.dtype)
    dv = v - v0.to(v.dtype)
    ok = (u0 >= 0) & (u0 + 1 < S) & (v0 >= 0) & (v0 + 1 < S)
    u0c = torch.clamp(u0, 0, S - 1)
    u1c = torch.clamp(u0 + 1, 0, S - 1)
    v0c = torch.clamp(v0, 0, S - 1)
    v1c = torch.clamp(v0 + 1, 0, S - 1)
    out = (img[v0c, u0c] * (1 - du) * (1 - dv)
           + img[v0c, u1c] * du * (1 - dv)
           + img[v1c, u0c] * (1 - du) * dv
           + img[v1c, u1c] * du * dv)
    return torch.where(ok, out, torch.zeros_like(out))


def patch_descriptors(cart: torch.Tensor, xy: torch.Tensor, fcfg: FeatureConfig
                      ) -> torch.Tensor:
    """(K, patch²) centred, unit-norm intensity patches of the Cartesian
    image at (K, 2) sensor-frame feature positions (m), sampled in each
    feature's radial frame, so a sensor rotation leaves them unchanged."""
    S = fcfg.cart_size
    P = fcfg.patch_size
    res = fcfg.cart_resolution
    u = _true_div(xy[:, 0], res) + S / 2 - 0.5
    v = _true_div(xy[:, 1], res) + S / 2 - 0.5

    offs = torch.arange(P, dtype=torch.float32, device=xy.device) - (P - 1) / 2.0
    du, dv = torch.meshgrid(offs, offs, indexing="xy")
    du = du.reshape(-1)[None, :]                  # (1, P²)
    dv = dv.reshape(-1)[None, :]
    # rotate the sampling grid into the radial frame of each feature
    c, s = _radial_frame(xy)
    c, s = c[:, None], s[:, None]
    uu = u[:, None] + (c * du - s * dv)           # (K, P²)
    vv = v[:, None] + (s * du + c * dv)
    patches = _bilinear_sample(cart, uu, vv)

    patches = patches - torch.mean(patches, dim=1, keepdim=True)
    norm = torch.linalg.norm(patches, dim=1, keepdim=True)
    return patches / torch.clamp(norm, min=1e-6)


def constellation_descriptors(
    xy: torch.Tensor,
    power: torch.Tensor,
    valid: torch.Tensor,
    fcfg: FeatureConfig,
) -> torch.Tensor:
    """Point-set "constellation" descriptors: (K, desc_grid²).

    Each feature's neighbours (weighted by power and a radial falloff) are
    soft-splatted into a desc_grid x desc_grid histogram in the feature's
    radial frame, then the histogram is centred and normalised.  A CUDA
    input takes kernel K4 (``descriptors.constellation_descriptors_cuda`` at
    B = 1), which gives each scan the bits the batched call gives it; a CPU
    input the plain form, ``constellation_descriptors_plain``."""
    if xy.device.type == "cuda":
        return descriptors.constellation_descriptors_cuda(
            xy.contiguous()[None], power.contiguous()[None], valid.contiguous()[None], fcfg)[0]
    return constellation_descriptors_plain(xy, power, valid, fcfg)


def constellation_descriptors_plain(
    xy: torch.Tensor,
    power: torch.Tensor,
    valid: torch.Tensor,
    fcfg: FeatureConfig,
) -> torch.Tensor:
    """``constellation_descriptors`` in plain torch ops on the device of its
    input (K4's twin, and the CPU's form): the bilinear splat is a separable
    hat basis contracted with one batched matmul, as in the JAX code; it
    holds two (K, K, P) float32 tensors (about 64 MB each at K = 1024, P =
    16)."""
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
    desc = torch.bmm((by * w[..., None]).transpose(1, 2), bx).reshape(K, P * P)
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
    fcfg: FeatureConfig,
    frac_a: Optional[torch.Tensor] = None,
    frac_b: Optional[torch.Tensor] = None,
) -> MatchSet:
    """Mutual-nearest + ratio-gated matches via one correlation matmul.

    ``argmax`` takes the first maximal index on the CPU and on CUDA alike,
    as ``jnp.argmax`` does."""
    neg = -2.0
    C = desc_a @ desc_b.T
    C = torch.where(valid_a[:, None] & valid_b[None, :], C, torch.full_like(C, neg))

    rows = torch.arange(C.shape[0], device=C.device)
    best_j = torch.argmax(C, dim=1)                      # (K,)
    best_c = torch.max(C, dim=1).values
    # second-best for the ratio test
    C_wo = C.clone()
    # under torch.func.vmap the scalar reaches the card by a copy that waits
    with span("sync.second_best"):
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
