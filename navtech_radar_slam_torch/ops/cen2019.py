"""cen2019 / cen2018 radar feature extraction in PyTorch.

Counterpart of ``navtech_radar_slam_tpu.ops.cen2019``.  The cen2019 score
map (s_smooth at one peak per contiguous high-h run, -inf elsewhere) has two
implementations with one contract:

  * ``cen2019_scores`` — the plain PyTorch twin below, run for CPU tensors
    and used by the tests as the oracle;
  * ``ops.kernels.cen_peaks.cen2019_scores_cuda`` — the hand-written CUDA
    kernel, run for every CUDA tensor.

``cen2019_features`` picks between them by the tensor's device and nothing
else, then takes the exact top-k with JAX's tie order (``top_k`` returns
equal values lowest index first; ``torch.topk`` promises no order).

A batch of B scans (``extract_features_batched``, the counterpart of
``jax.vmap`` of the detector) has the same two implementations,
``cen2019_scores_batched`` and K1 x B (``cen_peaks.
cen2019_scores_batched_cuda``, one launch), and one exact top-k for all B
scans that waits for the device twice per batch, not per scan.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from navtech_radar_slam_torch.config import FeatureConfig, RadarConfig
from navtech_radar_slam_torch.ops.kernels import cen_peaks
from navtech_radar_slam_torch.utils.profiling import span


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


def smoothing_taps(fcfg: FeatureConfig) -> torch.Tensor:
    """The range-smoothing taps of the cen detectors (CPU, float32)."""
    return _gaussian_kernel1d(fcfg.smooth_sigma_bins,
                              max(1, int(3 * fcfg.smooth_sigma_bins)))


def _conv_along_range(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """1-D convolution along the last axis, zero padding, 'same' size.

    Shift-and-add in the JAX code's tap order, so the sums round alike."""
    taps = int(kernel.shape[0])
    r = taps // 2
    nb = img.shape[-1]
    padded = F.pad(img, (r, r))
    out = torch.zeros_like(img)
    for t in range(taps):
        out = out + kernel[t] * padded[..., t:t + nb]
    return out


def _conv_along_azimuth_wrap(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """1-D convolution along the first axis with circular wrap."""
    taps = int(kernel.shape[0])
    r = taps // 2
    na = img.shape[0]
    wrapped = torch.cat([img[-r:], img, img[:r]], dim=0)
    out = torch.zeros_like(img)
    for t in range(taps):
        out = out + kernel[t] * wrapped[t:t + na]
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


def _smoothed_region(power: torch.Tensor, fcfg: FeatureConfig, rcfg: RadarConfig):
    """Range band mask, range-smoothed power and per-azimuth mean / variance
    over the band (shared by both detectors)."""
    region = _valid_region_mask(power.shape, fcfg.min_range_bins,
                                rcfg.num_range_bins, power.device)
    s = torch.where(region, power, torch.zeros_like(power))
    s_smooth = _conv_along_range(s, smoothing_taps(fcfg).to(power.device))
    denom = torch.clamp(region.sum(dim=1, keepdim=True), min=1).to(torch.float32)
    mean = torch.sum(s_smooth * region, dim=1, keepdim=True) / denom
    var = torch.sum(torch.square(s_smooth - mean) * region, dim=1,
                    keepdim=True) / denom
    return region, s_smooth, mean, var


def cen2019_scores(power: torch.Tensor, fcfg: FeatureConfig,
                   rcfg: RadarConfig) -> torch.Tensor:
    """(NA, NBp) power -> (NA, NBp) score map: s_smooth at run peaks, -inf
    elsewhere.  The plain twin of the CUDA kernel (same contract as the
    TPU kernel ``cen2019_scores_pallas``)."""
    region, s_smooth, az_mean, az_var = _smoothed_region(power, fcfg, rcfg)

    # gradient along range, smoothed across azimuth (prewitt-style)
    dev = power.device
    grad = _conv_along_range(
        s_smooth, torch.tensor([0.5, 0.0, -0.5], dtype=torch.float32, device=dev))
    grad = _conv_along_azimuth_wrap(
        torch.abs(grad),
        torch.tensor([0.25, 0.5, 0.25], dtype=torch.float32, device=dev))
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
    ``nonzero`` for the whole batch (on the card the host waits for the
    device there and in ``bincount``: the ``sync.*`` spans).  Only the
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
    finite = torch.isfinite(flat)
    with span("sync.topk"):
        scan, idx = torch.nonzero(finite).unbind(1)
    vals = flat[scan, idx]
    order = torch.sort(vals, descending=True, stable=True).indices
    order = order[torch.sort(scan[order], stable=True).indices]
    with span("sync.bincount"):   # on the card it reads its input's min and max
        counts = torch.bincount(scan, minlength=n_scans)
    slot = torch.arange(k, device=scores.device)
    valid = slot[None, :] < counts[:, None]
    # a slot past its scan's segment reads the zero appended at the end
    pos = torch.where(valid, (torch.cumsum(counts, 0) - counts)[:, None] + slot[None, :],
                      scan.shape[0])
    sel = torch.cat([idx[order], idx.new_zeros(1)])[pos]
    return FeatureSet(azimuth_idx=sel // nb, range_bin=sel % nb,
                      power=torch.cat([vals[order], vals.new_zeros(1)])[pos], valid=valid)


def _finalize_topk_scores(scores2d: torch.Tensor, k: int) -> FeatureSet:
    """The exact top-k of one (NA, NBp) score map: the batched top-k of a
    batch of one."""
    return FeatureSet(*(f[0] for f in _finalize_topk_scores_batched(scores2d[None], k)))


def cen2019_features(power: torch.Tensor, fcfg: FeatureConfig,
                     rcfg: RadarConfig) -> FeatureSet:
    """Extract up to ``fcfg.max_features`` targets from one polar scan.

    power: (num_azimuths, padded_range_bins) float32 in [0, 1].  A CUDA
    tensor goes through the CUDA kernel, a CPU tensor through the plain
    twin; the device is the only switch."""
    if power.device.type == "cuda":
        scores = cen_peaks.cen2019_scores_cuda(power, fcfg, rcfg)
    elif power.device.type == "cpu":
        scores = cen2019_scores(power, fcfg, rcfg)
    else:
        raise ValueError(f"cen2019_features: unsupported device {power.device}")
    return _finalize_topk_scores(scores, fcfg.max_features)


def cen2018_scores(power: torch.Tensor, fcfg: FeatureConfig,
                   rcfg: RadarConfig) -> torch.Tensor:
    """Threshold detector's score map: s_smooth at the run peaks of the
    per-azimuth mean + zq * std gate, -inf elsewhere."""
    region, s_smooth, mean, var = _smoothed_region(power, fcfg, rcfg)
    mask = (s_smooth > mean + fcfg.cen2018_zq * torch.sqrt(var)) & region
    peaks = run_peaks(s_smooth, mask)
    return torch.where(peaks, s_smooth, torch.full_like(s_smooth, float("-inf")))


def cen2018_features(power: torch.Tensor, fcfg: FeatureConfig,
                     rcfg: RadarConfig) -> FeatureSet:
    """Threshold detector: per-azimuth mean + zq * std gate, then run peaks."""
    return _finalize_topk_scores(cen2018_scores(power, fcfg, rcfg), fcfg.max_features)


def extract_features(power: torch.Tensor, fcfg: FeatureConfig,
                     rcfg: RadarConfig) -> FeatureSet:
    if fcfg.detector == "cen2019":
        return cen2019_features(power, fcfg, rcfg)
    if fcfg.detector == "cen2018":
        return cen2018_features(power, fcfg, rcfg)
    raise ValueError(f"unknown detector {fcfg.detector!r}")


def cen2019_scores_batched(power: torch.Tensor, fcfg: FeatureConfig,
                           rcfg: RadarConfig) -> torch.Tensor:
    """(B, NA, NBp) power -> (B, NA, NBp) score maps: ``cen2019_scores`` of
    each scan, stacked.  The plain twin of K1 x B."""
    return torch.stack([cen2019_scores(p, fcfg, rcfg) for p in power])


def extract_features_batched(power: torch.Tensor, fcfg: FeatureConfig,
                             rcfg: RadarConfig) -> FeatureSet:
    """``extract_features`` of each scan of a (B, NA, NBp) float32 batch, as
    (B, K) fields.  cen2019 on a CUDA batch is one K1 x B launch, on a CPU
    batch the plain twin; cen2018 (plain PyTorch on either device) runs scan
    by scan.  Then one exact top-k for the batch."""
    if fcfg.detector == "cen2019":
        if power.device.type == "cuda":
            scores = cen_peaks.cen2019_scores_batched_cuda(power, fcfg, rcfg)
        elif power.device.type == "cpu":
            scores = cen2019_scores_batched(power, fcfg, rcfg)
        else:
            raise ValueError(f"extract_features_batched: unsupported device {power.device}")
    elif fcfg.detector == "cen2018":
        scores = torch.stack([cen2018_scores(p, fcfg, rcfg) for p in power])
    else:
        raise ValueError(f"unknown detector {fcfg.detector!r}")
    return _finalize_topk_scores_batched(scores, fcfg.max_features)


def features_to_xy(feats: FeatureSet, azimuths: torch.Tensor,
                   rcfg: RadarConfig) -> torch.Tensor:
    """Polar feature indices -> Cartesian sensor-frame xy (K, 2), meters
    ((B, K, 2) for the (B, K) fields of a batch).

    ``azimuths``: (num_azimuths,) ray angles (rad) from the scan metadata."""
    theta = azimuths[feats.azimuth_idx]
    r = (feats.range_bin.to(torch.float32) + 0.5) * rcfg.range_resolution
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
