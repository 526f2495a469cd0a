"""ORORA-style outlier-robust SE(2) scan registration in PyTorch.

Counterpart of ``navtech_radar_slam_tpu.ops.registration``: spectral
pruning of the pairwise-consistency graph, GNC-TLS rotation over TIMs,
component-wise robust translation, then a joint anisotropic Gauss-Newton
polish.  Every loop runs its fixed count with no early exit, as the JAX
``lax.scan``s do, and nothing here reads a value back to the host.

Convention: for a world point seen as ``a`` in the previous scan and ``b``
in the current one, the estimate satisfies b ≈ R a + t; the odometry
increment is T_rel = (R^T, -R^T t), returned as [x, y, theta].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from navtech_radar_slam_torch.config import RegistrationConfig
from navtech_radar_slam_torch.ops.features import MatchSet, top_k_stable
from navtech_radar_slam_torch.utils.ordered import halving_sum
from navtech_radar_slam_torch.utils.profiling import span


class RegistrationResult(NamedTuple):
    rel_pose: torch.Tensor       # (3,) odometry increment [x, y, theta]
    inlier_mask: torch.Tensor    # (M,) bool final inliers
    num_inliers: torch.Tensor    # () int32
    mean_residual: torch.Tensor  # () float32 mean inlier residual (m)
    ok: torch.Tensor             # () bool — enough inliers to trust the result


def _rotate(a: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.stack([c * a[:, 0] - s * a[:, 1], s * a[:, 0] + c * a[:, 1]], dim=-1)


def point_sigmas(ranges: torch.Tensor, cfg: RegistrationConfig) -> torch.Tensor:
    """Isotropic envelope sqrt(sigma_r² + (r sigma_theta)²) of the
    anisotropic radar noise."""
    tang = ranges * cfg.sigma_azimuth_rad
    return torch.sqrt(cfg.sigma_range ** 2 + tang * tang)


def _doubling_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis by doubling shifts (element i
    adds element i - s for s = 1, 2, 4, ...), each an elementwise add.  As
    with ``halving_sum``, the order of the adds depends only on the length,
    so a batch of rows (``torch.func.vmap``) sums each row exactly as that
    row alone; CUDA's scan kernel orders a row's adds by the number of rows."""
    n = x.shape[-1]
    s = 1
    while s < n:
        x = x + torch.nn.functional.pad(x[..., :-s], (s, 0))
        s *= 2
    return x


def spectral_inlier_scores(matches: MatchSet, cfg: RegistrationConfig) -> torch.Tensor:
    """Leading-eigenvector scores of the pairwise-consistency graph
    (A_ij = 1 iff the TIM lengths agree within the gate), by a fixed number
    of power iterations, as unit-norm |v|.

    Batch-invariant: under ``torch.func.vmap`` each stream's scores are the
    one-stream scores bit for bit, since the stable top-k of the scores
    turns a last-bit difference between near-equal scores into other TIMs.
    So the product is a row-wise sum (a batched ``@`` rounds unlike a
    matrix-vector product), the iterations scale v by its max (exact in any
    order; the direction is the same as with JAX's per-iteration unit norm),
    and the one unit norm at the end sums by ``halving_sum``.  The row sum
    is torch's reduction, which on the card may split a row by the shape:
    ``tests/test_torch_batched_odometry.py`` holds the invariance on the
    CPU, and ``chip_smoke.py`` on the card at B = 64 of the default config."""
    a, b = matches.src_xy, matches.dst_xy
    va = matches.valid
    M = va.shape[-1]

    da = torch.linalg.norm(a[:, None, :] - a[None, :, :], dim=-1)
    db = torch.linalg.norm(b[:, None, :] - b[None, :, :], dim=-1)
    sig = point_sigmas(torch.maximum(matches.src_range, matches.dst_range), cfg)
    gate = cfg.consistency_gate + (sig[:, None] + sig[None, :])
    A = ((torch.abs(da - db) <= gate) & va[:, None] & va[None, :]
         & ~torch.eye(M, dtype=torch.bool, device=va.device))
    Af = A.to(torch.float32)

    v = va.to(torch.float32)
    for _ in range(cfg.spectral_iters):
        v = (Af * v[None, :]).sum(-1)
        v = v / torch.clamp(torch.amax(v), min=1e-9)
    v = v / torch.clamp(torch.sqrt(halving_sum(v * v)), min=1e-9)
    return torch.where(va, torch.abs(v), torch.zeros_like(v))


def _gnc_tls_weights(res2: torch.Tensor, mu: torch.Tensor, barc2: float) -> torch.Tensor:
    """Closed-form GNC-TLS weight update (Yang et al. GNC, used by ORORA)."""
    upper = (mu + 1.0) / mu * barc2
    lower = mu / (mu + 1.0) * barc2
    w = torch.sqrt(barc2 * mu * (mu + 1.0) / torch.clamp(res2, min=1e-12)) - mu
    w = torch.clamp(w, 0.0, 1.0)
    w = torch.where(res2 >= upper, torch.zeros_like(w), w)
    w = torch.where(res2 <= lower, torch.ones_like(w), w)
    return w


def gnc_rotation(
    tim_a: torch.Tensor,
    tim_b: torch.Tensor,
    tim_sigma: torch.Tensor,
    tim_valid: torch.Tensor,
    cfg: RegistrationConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GNC-TLS rotation over TIMs; closed-form inner step
    theta = atan2(Σ w (â × b̂), Σ w (â · b̂)).  Returns (theta, final weights)."""
    cross = tim_a[:, 0] * tim_b[:, 1] - tim_a[:, 1] * tim_b[:, 0]
    dot = torch.sum(tim_a * tim_b, dim=-1)
    inv_var = torch.where(tim_valid, 1.0 / torch.clamp(tim_sigma ** 2, min=1e-9),
                          torch.zeros_like(tim_sigma))
    valid_f = tim_valid.to(torch.float32)

    def residual2(theta):
        Ra = _rotate(tim_a, torch.cos(theta), torch.sin(theta))
        return torch.sum((Ra - tim_b) ** 2, dim=-1) * inv_var

    def solve(w):
        wv = w * inv_var
        return torch.atan2(torch.sum(wv * cross), torch.sum(wv * dot))

    theta = solve(valid_f)
    r2_max = torch.max(torch.where(tim_valid, residual2(theta),
                                   torch.zeros_like(inv_var)))
    mu = cfg.gnc_barc2 / torch.clamp(2.0 * r2_max - cfg.gnc_barc2, min=1e-6)
    mu = torch.clamp(mu, min=1e-6)

    w = valid_f
    for _ in range(cfg.gnc_max_iters):
        w = _gnc_tls_weights(residual2(theta), mu, cfg.gnc_barc2) * valid_f
        theta = solve(w)
        mu = mu * cfg.gnc_div_factor
    return theta, w


def _cumulative_weights(w: torch.Tensor) -> torch.Tensor:
    """Non-decreasing prefix sums of non-negative weights, the same bits at
    any batch size: ``_doubling_cumsum`` under a running maximum.  The
    doubling adds round each prefix in its own order, so past a zero weight
    a prefix can come out one ulp below the one before it; the maximum is
    exact in any order."""
    return torch.cummax(_doubling_cumsum(w), dim=-1).values


def _weighted_median(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Lower weighted median: stable argsort, then the first index whose
    cumulative weight (``_cumulative_weights``, non-decreasing as
    ``searchsorted`` needs) reaches half the total (side left)."""
    order = torch.argsort(vals, stable=True)
    vs = vals[order]
    cw = _cumulative_weights(w[order])
    total = torch.clamp(cw[-1], min=1e-9)
    idx = torch.searchsorted(cw, (0.5 * total).reshape(1), right=False)
    return vs[torch.clamp(idx, 0, vals.shape[0] - 1)][0]


def robust_translation(
    a: torch.Tensor,
    b: torch.Tensor,
    sigma: torch.Tensor,
    valid: torch.Tensor,
    theta: torch.Tensor,
    cfg: RegistrationConfig,
) -> torch.Tensor:
    """Decoupled component-wise robust translation (COTE-style): candidates
    t_i = b_i - R a_i; per-component weighted-median seed, then Cauchy IRLS
    at the anisotropic noise scale."""
    cand = b - _rotate(a, torch.cos(theta), torch.sin(theta))     # (M, 2)
    w_meas = torch.where(valid, 1.0 / torch.clamp(sigma, min=1e-6),
                         torch.zeros_like(sigma))
    t = torch.stack([_weighted_median(cand[:, 0], w_meas),
                     _weighted_median(cand[:, 1], w_meas)])
    valid_f = valid.to(torch.float32)
    sig = torch.clamp(sigma[:, None], min=1e-6)
    for _ in range(cfg.cote_iters):
        r = (cand - t[None, :]) / sig
        w = 1.0 / (1.0 + torch.sum(r * r, dim=-1)) * valid_f          # Cauchy IRLS
        t = torch.sum(w[:, None] * cand, dim=0) / torch.clamp(torch.sum(w), min=1e-9)
    return t


def _solve3x3(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 solve (adjugate / Cramer), no LU and no host sync."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f = H[1, 0], H[1, 1], H[1, 2]
    h, i, j = H[2, 0], H[2, 1], H[2, 2]
    A = e * j - f * i
    B = -(d * j - f * h)
    C = d * i - e * h
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([A, -(b * j - c * i), b * f - c * e]),
        torch.stack([B, a * j - c * h, -(a * f - c * d)]),
        torch.stack([C, -(a * i - b * h), a * e - b * d]),
    ])
    return adj @ g / det


def point_information(xy: torch.Tensor, cfg: RegistrationConfig) -> torch.Tensor:
    """Per-point 2x2 inverse covariance W = R(phi) diag(1/sr², 1/st²) R(phi)^T
    (phi the bearing, st = r sigma_theta the tangential sigma)."""
    r = torch.linalg.norm(xy, dim=-1)
    phi = torch.atan2(xy[..., 1], xy[..., 0])
    c, s = torch.cos(phi), torch.sin(phi)
    ir2 = 1.0 / max(cfg.sigma_range ** 2, 1e-12)
    it2 = 1.0 / torch.clamp((torch.clamp(r, min=1.0) * cfg.sigma_azimuth_rad) ** 2,
                            min=1e-12)
    w00 = c * c * ir2 + s * s * it2
    w01 = c * s * (ir2 - it2)
    w11 = s * s * ir2 + c * c * it2
    return torch.stack(
        [torch.stack([w00, w01], dim=-1), torch.stack([w01, w11], dim=-1)], dim=-2
    )


def anisotropic_refine(
    a: torch.Tensor,
    b: torch.Tensor,
    valid: torch.Tensor,
    theta0: torch.Tensor,
    t0: torch.Tensor,
    cfg: RegistrationConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint (theta, t) Gauss-Newton over inliers with per-point anisotropic
    information and Cauchy robustness; residual e_i = R a_i + t - b_i,
    Jacobian [I2 | dR/dtheta a_i].  The contractions run in true fp32: each
    point's products with its 2 x 2 information are elementwise, and the
    sums over the points are ``halving_sum``'s, so under ``torch.func.vmap``
    each stream sums as that stream alone (the batched matmul an einsum
    becomes chose its order of summation by the batch size on the card);
    they sum metric coordinates of up to ~80 m."""
    W = point_information(b, cfg) * valid[:, None, None].to(torch.float32)
    eye = torch.eye(2, dtype=a.dtype, device=a.device).expand(a.shape[0], 2, 2)
    theta, t = theta0, t0
    for _ in range(cfg.refine_iters):
        c, s = torch.cos(theta), torch.sin(theta)
        e = _rotate(a, c, s) + t[None, :] - b                       # (M, 2)
        dRa = torch.stack([-s * a[:, 0] - c * a[:, 1], c * a[:, 0] - s * a[:, 1]],
                          dim=-1)
        J = torch.cat([eye, dRa[:, :, None]], dim=2)                # (M, 2, 3)
        We = torch.sum(W * e[:, None, :], dim=-1)                   # (M, 2)
        r2 = torch.sum(e * We, dim=-1)
        rho = (1.0 / (1.0 + r2))[:, None, None]
        WrJ = torch.sum((W * rho)[:, :, :, None] * J[:, None, :, :], dim=2)   # (M, 2, 3)
        Hm = torch.sum(J[:, :, :, None] * WrJ[:, :, None, :], dim=1)        # (M, 3, 3)
        gm = torch.sum(J * (We[:, :, None] * rho[:, :, 0, None]), dim=1)    # (M, 3)
        H = halving_sum(Hm.permute(1, 2, 0)) + 1e-6 * torch.eye(
            3, dtype=a.dtype, device=a.device)
        g = halving_sum(gm.T)
        delta = _solve3x3(H, -g)
        theta, t = theta + delta[2], t + delta[:2]
    return theta, t


def register_scans(matches: MatchSet, cfg: RegistrationConfig) -> RegistrationResult:
    """Full ORORA-style pipeline on a padded MatchSet."""
    with span("odo.register"):
        M = matches.valid.shape[0]
        with span("odo.spectral"):
            scores = spectral_inlier_scores(matches, cfg)
        # stable: correspondences with identical consistency rows score exactly
        # alike, and the TIM ring below pairs consecutive selections, so the tie
        # order decides the TIMs (JAX's top_k: lowest index first)
        top_scores, top_idx = top_k_stable(scores, min(cfg.spectral_top_k, M))
        sel_valid = matches.valid[top_idx] & (top_scores > 1e-6)

        a = matches.src_xy[top_idx]
        b = matches.dst_xy[top_idx]
        sigma = point_sigmas(
            torch.maximum(matches.src_range, matches.dst_range), cfg)[top_idx]

        # TIMs: differences of consecutive selected correspondences (a ring)
        def roll(x):
            return torch.roll(x, shifts=-1, dims=0)

        tim_a = a - roll(a)
        tim_b = b - roll(b)
        tim_sigma = torch.sqrt(sigma ** 2 + roll(sigma) ** 2)
        # degenerate TIMs (nearly coincident points) carry no rotation signal
        tim_valid = (sel_valid & roll(sel_valid)
                     & (torch.linalg.norm(tim_a, dim=-1) > 4.0 * tim_sigma))

        theta, _ = gnc_rotation(tim_a, tim_b, tim_sigma, tim_valid, cfg)
        t = robust_translation(a, b, sigma, sel_valid, theta, cfg)

        # polish jointly with the full anisotropic noise model over the seed
        # inlier set
        res0 = torch.linalg.norm(
            _rotate(a, torch.cos(theta), torch.sin(theta)) + t[None, :] - b, dim=-1)
        seed_inl = sel_valid & (res0 < 5.0 * torch.clamp(sigma, min=cfg.sigma_range))
        theta, t = anisotropic_refine(a, b, seed_inl, theta, t, cfg)

        # final inlier classification at the measurement level
        c, s = torch.cos(theta), torch.sin(theta)
        res = torch.linalg.norm(_rotate(a, c, s) + t[None, :] - b, dim=-1)
        inl = sel_valid & (res < 3.0 * torch.clamp(sigma, min=cfg.sigma_range))
        n_inl = torch.sum(inl)
        mean_res = (torch.sum(torch.where(inl, res, torch.zeros_like(res)))
                    / torch.clamp(n_inl, min=1))

        # b = R a + t  =>  T_rel = (R^T, -R^T t), theta_rel = -theta
        rel = torch.stack([-(c * t[0] + s * t[1]), -(-s * t[0] + c * t[1]), -theta])

        # out of place, so that torch.func.vmap batches it
        inlier_mask = torch.zeros(M, dtype=torch.bool, device=inl.device).scatter(0, top_idx, inl)
        return RegistrationResult(
            rel_pose=rel,
            inlier_mask=inlier_mask,
            num_inliers=n_inl.to(torch.int32),
            mean_residual=mean_res,
            ok=n_inl >= cfg.min_inliers,
        )
