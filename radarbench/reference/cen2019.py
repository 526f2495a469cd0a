"""The cen2019 score map and its exact top-k, in plain PyTorch (a frozen
copy of the port's plain twin, ``ops/cen2019.py``, without the CUDA
dispatch).  Part of the benchmark's reference: it imports nothing of the
port, so a change to the port cannot move it."""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

class FeatureSet(NamedTuple):
    """K extracted features (padded to cfg.max_features)."""

    azimuth_idx: torch.Tensor  # (K,) int64 row in the polar image
    range_bin: torch.Tensor    # (K,) int64 column in the polar image
    power: torch.Tensor        # (K,) float32 peak power
    valid: torch.Tensor        # (K,) bool


def _gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    """Normalised Gaussian taps, computed in float32 as the JAX code does.

    Always computed on the CPU, so the twin (on any device) and the CUDA
    kernel smooth with bit-identical taps."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def smoothing_taps(fcfg) -> torch.Tensor:
    """The range-smoothing taps of the cen detectors (CPU, float32)."""
    return _gaussian_kernel1d(fcfg.smooth_sigma_bins,
                              max(1, int(3 * fcfg.smooth_sigma_bins)))


def _conv_along_range(img: torch.Tensor, kernel: torch.Tensor,
                      mul: Callable = torch.mul) -> torch.Tensor:
    """1-D convolution along the last axis, zero padding, 'same' size.

    Shift-and-add in the JAX code's tap order, so the sums round alike;
    each tap's product through ``mul``."""
    taps = int(kernel.shape[0])
    r = taps // 2
    nb = img.shape[-1]
    padded = F.pad(img, (r, r))
    out = torch.zeros_like(img)
    for t in range(taps):
        out = out + mul(kernel[t], padded[..., t:t + nb])
    return out


def _conv_along_azimuth_wrap(img: torch.Tensor, kernel: torch.Tensor,
                             mul: Callable = torch.mul) -> torch.Tensor:
    """1-D convolution along the first axis with circular wrap."""
    taps = int(kernel.shape[0])
    r = taps // 2
    na = img.shape[0]
    wrapped = torch.cat([img[-r:], img, img[:r]], dim=0)
    out = torch.zeros_like(img)
    for t in range(taps):
        out = out + mul(kernel[t], wrapped[t:t + na])
    return out


def _segmented_running_max(v: torch.Tensor, reset: torch.Tensor,
                           reverse: bool = False) -> torch.Tensor:
    """Inclusive running max along the last axis that restarts where
    ``reset`` is True (at position i the scan starts fresh from v[i]).

    Log-step doubling (Hillis-Steele) over the segmented-max monoid; lanes
    shifted in from beyond the edge carry -inf and a reset flag, so nothing
    wraps around."""
    n = v.shape[-1]
    m, r = v, reset
    d = 1
    while d < n:
        if reverse:
            m_s = F.pad(m[..., d:], (0, d), value=float("-inf"))
            r_s = F.pad(r[..., d:], (0, d), value=True)
        else:
            m_s = F.pad(m[..., :-d], (d, 0), value=float("-inf"))
            r_s = F.pad(r[..., :-d], (d, 0), value=True)
        m = torch.where(r, m, torch.maximum(m, m_s))
        r = r | r_s
        d *= 2
    return m


def run_peaks(power: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One peak per contiguous True-run of ``mask`` along the last axis: the
    first position that attains the run's max ``power``."""
    neg = float("-inf")
    v = torch.where(mask, power, torch.full_like(power, neg))
    prev_mask = F.pad(mask[..., :-1], (1, 0), value=False)
    run_start = mask & ~prev_mask
    m_fwd_incl = _segmented_running_max(v, run_start | ~mask)

    next_mask = F.pad(mask[..., 1:], (0, 1), value=False)
    run_end = mask & ~next_mask
    m_bwd_incl = _segmented_running_max(v, run_end | ~mask, reverse=True)

    run_max = torch.maximum(m_fwd_incl, m_bwd_incl)
    # exclusive forward prefix max within the run
    m_fwd_excl = torch.where(
        run_start | ~mask,
        torch.full_like(v, neg),
        F.pad(m_fwd_incl[..., :-1], (1, 0), value=neg),
    )
    return mask & (v >= run_max) & (m_fwd_excl < v)


def _valid_region_mask(shape: Sequence[int], min_bin: int, num_range_bins: int,
                       device=None) -> torch.Tensor:
    na, nb = shape
    col = torch.arange(nb, device=device).expand(na, nb)
    return (col >= min_bin) & (col < num_range_bins)


def _smoothed_region(power: torch.Tensor, fcfg, rcfg, mul: Callable = torch.mul):
    """Range band mask, range-smoothed power and per-azimuth mean / variance
    over the band (shared by both detectors)."""
    region = _valid_region_mask(power.shape, fcfg.min_range_bins,
                                rcfg.num_range_bins, power.device)
    s = torch.where(region, power, torch.zeros_like(power))
    s_smooth = _conv_along_range(s, smoothing_taps(fcfg).to(power.device), mul)
    denom = torch.clamp(region.sum(dim=1, keepdim=True), min=1).to(torch.float32)
    mean = torch.sum(s_smooth * region, dim=1, keepdim=True) / denom
    var = torch.sum(torch.square(s_smooth - mean) * region, dim=1,
                    keepdim=True) / denom
    return region, s_smooth, mean, var


def cen2019_scores(power: torch.Tensor, fcfg, rcfg,
                   mul: Callable = torch.mul) -> torch.Tensor:
    """(NA, NBp) power -> (NA, NBp) score map: s_smooth at run peaks, -inf
    elsewhere.  The plain twin of the CUDA kernel (same contract as the
    TPU kernel ``cen2019_scores_pallas``); the convolutions' products
    through ``mul``."""
    region, s_smooth, az_mean, az_var = _smoothed_region(power, fcfg, rcfg, mul)

    # gradient along range, smoothed across azimuth (prewitt-style)
    dev = power.device
    grad = _conv_along_range(
        s_smooth, torch.tensor([0.5, 0.0, -0.5], dtype=torch.float32, device=dev), mul)
    grad = _conv_along_azimuth_wrap(
        torch.abs(grad),
        torch.tensor([0.25, 0.5, 0.25], dtype=torch.float32, device=dev), mul)
    g = grad / torch.clamp(torch.max(grad), min=1e-9)

    # mean-subtracted power (positive part): suppress the noise floor
    sp = torch.clamp(s_smooth - az_mean, min=0.0)
    h = sp * (1.0 - g)
    h_mean = torch.sum(h * region) / torch.clamp(region.sum(), min=1)
    mask = (h > h_mean) & region
    if fcfg.peak_zq > 0:
        # per-azimuth noise gate (FIDELITY.md divergence #2); <= 0 disables
        mask = mask & (s_smooth > az_mean + fcfg.peak_zq * torch.sqrt(az_var))

    peaks = run_peaks(s_smooth, mask)
    return torch.where(peaks, s_smooth, torch.full_like(s_smooth, float("-inf")))


def _finalize_topk_scores_batched(scores: torch.Tensor, k: int) -> FeatureSet:
    """Exact top-k of each map of a (B, NA, NBp) batch, as (B, k) fields,
    with JAX's tie order (equal scores lowest flat index first) and one
    ``nonzero`` (one wait for the device) for the whole batch.  Only the
    finite entries are sorted: ``nonzero`` lists them by scan, then by flat
    index; a stable descending sort of their values, then a stable sort by
    scan, leaves each scan's entries in a segment of their own, ties in
    ``nonzero``'s order.  Each scan takes the first k of its segment; a slot
    past the end of it is padded as JAX pads it: azimuth = range bin = 0,
    power 0, invalid.

    JAX's ``approx_max_k`` (``topk_recall < 1``) approximates only on a TPU
    and is exact on the CPU; the port is always exact."""
    n_scans, _, nb = scores.shape
    flat = scores.reshape(n_scans, -1)
    scan, idx = torch.nonzero(torch.isfinite(flat)).unbind(1)
    vals = flat[scan, idx]
    order = torch.sort(vals, descending=True, stable=True).indices
    order = order[torch.sort(scan[order], stable=True).indices]
    counts = torch.bincount(scan, minlength=n_scans)
    slot = torch.arange(k, device=scores.device)
    valid = slot[None, :] < counts[:, None]
    # a slot past its scan's segment reads the zero appended at the end
    pos = torch.where(valid, (torch.cumsum(counts, 0) - counts)[:, None] + slot[None, :],
                      scan.shape[0])
    sel = torch.cat([idx[order], idx.new_zeros(1)])[pos]
    return FeatureSet(azimuth_idx=sel // nb, range_bin=sel % nb,
                      power=torch.cat([vals[order], vals.new_zeros(1)])[pos], valid=valid)


def features_to_xy(feats: FeatureSet, azimuths: torch.Tensor,
                   rcfg) -> torch.Tensor:
    """Polar feature indices -> Cartesian sensor-frame xy (K, 2), meters
    ((B, K, 2) for the (B, K) fields of a batch).

    ``azimuths``: (num_azimuths,) ray angles (rad) from the scan metadata."""
    theta = azimuths[feats.azimuth_idx]
    r = (feats.range_bin.to(torch.float32) + 0.5) * rcfg.range_resolution
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
