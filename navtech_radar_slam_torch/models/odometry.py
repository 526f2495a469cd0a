"""Radar odometry front-end in PyTorch: the capability of the ORORA node.

Counterpart of ``navtech_radar_slam_tpu.models.odometry``.  One step is
cen2019 extraction (the CUDA kernel on a CUDA tensor), constellation
descriptors (kernel K4 on a CUDA tensor), mutual matching and ORORA-style
registration, then two de-skew re-registrations of the matched set
(``odometry_step``).  ``RadarOdometry``
is the host accumulator: one fetch of (ok, rel_pose) per scan, the pose
composed on the host in float64; ``make_odometry_step`` is the step with
the configuration bound.

``make_batched_odometry_step`` advances B independent streams in one call
(mapping fleets, dataset reprocessing): one batched extraction with one
K1 x B launch and one K4 launch, then the per-stream registration under
``torch.func.vmap`` (the counterpart of the JAX package's ``jax.vmap``),
each stream's result that of ``odometry_step`` on the stream alone.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from navtech_radar_slam_torch.config import SlamConfig
from navtech_radar_slam_torch.ops import cen2019, features, registration
from navtech_radar_slam_torch.ops.kernels import descriptors
from navtech_radar_slam_torch.utils.device import DEFAULT_DEVICE, resolve_device
from navtech_radar_slam_torch.utils.geometry import se2_mul_np
from navtech_radar_slam_torch.utils.profiling import span


class ScanFeatures(NamedTuple):
    """Per-scan front-end state on the device.

    ``xy`` is RAW (as measured, skewed by platform motion during the sweep);
    de-skewed views are derived per registration, so the carry never
    accumulates twist-estimate errors."""

    xy: torch.Tensor        # (K, 2) sensor-frame feature positions (m), raw
    desc: torch.Tensor      # (K, D) normalized constellation descriptors
    power: torch.Tensor     # (K,)
    valid: torch.Tensor     # (K,) bool
    ranges: torch.Tensor    # (K,) range of each feature (m)
    ray_frac: torch.Tensor  # (K,) sweep fraction of the feature's ray


def motion_compensate(xy: torch.Tensor, ray_frac: torch.Tensor,
                      twist: torch.Tensor) -> torch.Tensor:
    """De-skew for platform motion during the sweep: a ray at sweep fraction
    f sees the world from pose f * twist; p' = R(f dtheta) p + f [dx, dy]."""
    th = ray_frac * twist[2]
    c, s = torch.cos(th), torch.sin(th)
    x, y = xy[:, 0], xy[:, 1]
    return (torch.stack([c * x - s * y, s * x + c * y], dim=-1)
            + ray_frac[:, None] * twist[None, :2])


def doppler_compensate(xy: torch.Tensor, twist: torch.Tensor,
                       beta: float, scan_rate_hz: float) -> torch.Tensor:
    """Undo the FMCW Doppler range shift: r_true = r_meas + beta (d̂ · v),
    v ≈ twist[:2] * scan rate."""
    v = twist[:2] * scan_rate_hz
    r = torch.linalg.norm(xy, dim=-1, keepdim=True)
    d = xy / torch.clamp(r, min=1e-6)
    r_true = r + beta * torch.sum(d * v[None, :], dim=-1, keepdim=True)
    return d * r_true


def _masked_desc(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))


def _with_xy(feats: ScanFeatures, xy: torch.Tensor, fcfg) -> ScanFeatures:
    """Replace positions and rebuild the (position-dependent) descriptors."""
    desc = features.constellation_descriptors(xy, feats.power, feats.valid, fcfg)
    return feats._replace(xy=xy, desc=_masked_desc(desc, feats.valid),
                          ranges=torch.linalg.norm(xy, dim=-1))


def _deskew_xy(xy: torch.Tensor, frac: torch.Tensor, twist: torch.Tensor,
               cfg: SlamConfig) -> torch.Tensor:
    """Positions-only de-skew: Doppler first (it acts on the measured range
    at the ray's own sample time), then the motion skew."""
    if cfg.features.doppler_compensation:
        xy = doppler_compensate(xy, twist, cfg.features.doppler_beta,
                                cfg.radar.scan_rate_hz)
    if cfg.features.motion_compensation:
        xy = motion_compensate(xy, frac, twist)
    return xy


def deskew_features(feats: ScanFeatures, twist: torch.Tensor,
                    cfg: SlamConfig) -> ScanFeatures:
    """De-skewed view of a raw feature set (descriptors rebuilt)."""
    return _with_xy(feats, _deskew_xy(feats.xy, feats.ray_frac, twist, cfg),
                    cfg.features)


def deskew_matches(matches: features.MatchSet, twist: torch.Tensor,
                   cfg: SlamConfig) -> features.MatchSet:
    """De-skew an already-matched correspondence set (association is kept:
    only the matched geometry moves)."""
    src = _deskew_xy(matches.src_xy, matches.src_frac, twist, cfg)
    dst = _deskew_xy(matches.dst_xy, matches.dst_frac, twist, cfg)
    v = matches.valid
    vf = v.to(torch.float32)
    return matches._replace(
        src_xy=torch.where(v[:, None], src, torch.zeros_like(src)),
        dst_xy=torch.where(v[:, None], dst, torch.zeros_like(dst)),
        src_range=torch.linalg.norm(src, dim=-1) * vf,
        dst_range=torch.linalg.norm(dst, dim=-1) * vf,
    )


def decode_power(power: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """Wire format -> float32 power in [0, 1], on the tensor's device.

    float32 passes through; uint8 is x * (1/255); ``packed`` uint8 holds two
    4-bit codes per byte, high nibble first (data/packing.py), decoded as
    (q * (1/15))². The multiply-by-reciprocal forms are the JAX code's, so
    the decoded power is bit-identical and smoothed-power ties stay ties."""
    if packed:
        if power.dtype != torch.uint8:
            raise TypeError(f"packed scans are uint8, got {power.dtype}")
        hi = (power >> 4).to(torch.float32)
        lo = (power & 0xF).to(torch.float32)
        q = torch.stack([hi, lo], dim=-1).reshape(
            power.shape[:-1] + (2 * power.shape[-1],))
        return torch.square(q * (1.0 / 15.0))
    if power.dtype == torch.uint8:
        return power.to(torch.float32) * (1.0 / 255.0)
    if power.dtype != torch.float32:
        raise TypeError(f"scans are float32 or uint8, got {power.dtype}")
    return power


def extract_scan_features(power: torch.Tensor, azimuths: torch.Tensor,
                          cfg: SlamConfig, ray_valid: Optional[torch.Tensor] = None,
                          packed: bool = False) -> ScanFeatures:
    """cen2019 peaks -> metric xy -> constellation descriptors.

    ``power``: (NA, NBp) float32 in [0, 1], raw uint8, or with ``packed``
    the (NA, NBp // 2) 4-bit wire format; it is decoded on its device.
    ``ray_valid`` ((NA,) bool, optional): rays the sensor marked invalid are
    zeroed before extraction (zeroing a byte zeroes both packed nibbles)."""
    with span("odo.extract"):
        if ray_valid is not None:
            power = power * ray_valid.to(power.dtype)[:, None]
        power = decode_power(power, packed)
        feats = cen2019.extract_features(power.contiguous(), cfg.features, cfg.radar)
        xy = cen2019.features_to_xy(feats, azimuths, cfg.radar)
        with span("odo.descriptors"):
            desc = features.constellation_descriptors(xy, feats.power, feats.valid,
                                                      cfg.features)
        ray_frac = (feats.azimuth_idx.to(torch.float32) + 0.5) / cfg.radar.num_azimuths
        return ScanFeatures(
            xy=xy,
            desc=_masked_desc(desc, feats.valid),
            power=feats.power,
            valid=feats.valid,
            ranges=torch.linalg.norm(xy, dim=-1),
            ray_frac=ray_frac,
        )


#: most streams of one vmapped descriptor call on the CPU: a call holds two
#: (streams, K, K, P) float32 hat tensors
DESC_STREAMS = 32


def _descriptors_batched(xy: torch.Tensor, power: torch.Tensor, valid: torch.Tensor,
                         cfg: SlamConfig) -> torch.Tensor:
    """``constellation_descriptors`` of B streams ((B, K, 2), (B, K),
    (B, K)).  On the card one K4 launch for the whole batch
    (``ops.kernels.descriptors``), each scan's rows the same bits at any B.
    On the CPU the plain matmul form under ``torch.func.vmap``, in calls of
    at most DESC_STREAMS streams, which bounds the hat tensors' memory."""
    if xy.device.type == "cuda":
        return descriptors.constellation_descriptors_cuda(
            xy.contiguous(), power.contiguous(), valid.contiguous(), cfg.features)
    fn = torch.func.vmap(functools.partial(features.constellation_descriptors_plain,
                                           fcfg=cfg.features))
    return torch.cat([fn(*(x[i:i + DESC_STREAMS] for x in (xy, power, valid)))
                      for i in range(0, xy.shape[0], DESC_STREAMS)])


def extract_scan_features_batched(powers: torch.Tensor, azimuths: torch.Tensor,
                                  cfg: SlamConfig, ray_valids: Optional[torch.Tensor] = None,
                                  packed: bool = False) -> ScanFeatures:
    """``extract_scan_features`` of each scan of a batch, as ScanFeatures
    with a leading B axis (the counterpart of ``jax.vmap`` of it).

    ``powers``: (B, NA, NBp) float32, raw uint8, or with ``packed`` the
    (B, NA, NBp // 2) 4-bit wire format; ``azimuths`` (NA,) shared by the
    streams; ``ray_valids`` ((B, NA) bool, optional) each stream's valid
    rays.  One K1 x B launch on a CUDA batch and one exact top-k for the
    batch; the descriptors by ``_descriptors_batched`` (one K4 launch on a
    CUDA batch)."""
    with span("odo.extract"):
        if ray_valids is not None:
            powers = powers * ray_valids.to(powers.dtype)[:, :, None]
        powers = decode_power(powers, packed)
        feats = cen2019.extract_features_batched(powers.contiguous(), cfg.features, cfg.radar)
        xy = cen2019.features_to_xy(feats, azimuths, cfg.radar)
        with span("odo.descriptors"):
            desc = _descriptors_batched(xy, feats.power, feats.valid, cfg)
        ray_frac = (feats.azimuth_idx.to(torch.float32) + 0.5) / cfg.radar.num_azimuths
        return ScanFeatures(
            xy=xy,
            desc=_masked_desc(desc, feats.valid),
            power=feats.power,
            valid=feats.valid,
            ranges=torch.linalg.norm(xy, dim=-1),
            ray_frac=ray_frac,
        )


def match_feature_pair(prev: ScanFeatures, curr: ScanFeatures,
                       cfg: SlamConfig) -> features.MatchSet:
    with span("odo.match"):
        return features.match_features(
            prev.desc, curr.desc, prev.xy, curr.xy, prev.valid, curr.valid,
            cfg.features, prev.ray_frac, curr.ray_frac,
        )


def register_feature_pair(prev: ScanFeatures, curr: ScanFeatures,
                          cfg: SlamConfig) -> registration.RegistrationResult:
    return registration.register_scans(match_feature_pair(prev, curr, cfg),
                                       cfg.registration)


def register_step(prev: ScanFeatures, curr: ScanFeatures, twist: torch.Tensor,
                  cfg: SlamConfig
                  ) -> Tuple[registration.RegistrationResult, ScanFeatures]:
    """The step after extraction: register the current scan's features
    against the previous ones.  Returns (result, de-skewed features).

    With motion compensation on, match ONCE on raw descriptors, register for
    a seed twist, then de-skew the matched set with the twist estimate and
    re-register, twice.  One stream's tensors; ``torch.func.vmap`` of it is
    the batched step's (its spans open once per batched call)."""
    with span("odo.register_step"):
        matches = match_feature_pair(prev, curr, cfg)
        res = registration.register_scans(matches, cfg.registration)
        if not (cfg.features.motion_compensation
                or cfg.features.doppler_compensation):
            return res, curr

        t = torch.where(res.ok, res.rel_pose, twist)
        for _ in range(2):
            res = registration.register_scans(deskew_matches(matches, t, cfg),
                                              cfg.registration)
            t = torch.where(res.ok, res.rel_pose, t)
        # descriptors are not rebuilt: no downstream consumer reads curr_out.desc
        xy = _deskew_xy(curr.xy, curr.ray_frac, t, cfg)
        return res, curr._replace(xy=xy, ranges=torch.linalg.norm(xy, dim=-1))


def odometry_step(
    power: torch.Tensor,
    azimuths: torch.Tensor,
    prev: ScanFeatures,
    twist: torch.Tensor,
    cfg: SlamConfig,
    ray_valid: Optional[torch.Tensor] = None,
    packed: bool = False,
) -> Tuple[ScanFeatures, registration.RegistrationResult, ScanFeatures]:
    """One front-end step: extract the current scan, register it against the
    previous one (``register_step``).  Returns (raw carry, result, de-skewed
    features); the carry stays raw."""
    with span("odo.step"):
        curr = extract_scan_features(power, azimuths, cfg, ray_valid, packed)
        res, curr_out = register_step(prev, curr, twist, cfg)
        return curr, res, curr_out


def _require_device(fn: str, dev: torch.device, prev: ScanFeatures, **named) -> None:
    """Raise unless every tensor of ``named`` and of ``prev`` is on ``dev``."""
    for name, x in list(named.items()) + [(f"prev.{k}", v) for k, v in prev._asdict().items()]:
        if x is not None and (x.device.type != dev.type
                              or (dev.index is not None and x.device.index != dev.index)):
            raise ValueError(f"{fn}: {name} is on {x.device}, the step runs on {dev}")


def make_odometry_step(cfg: SlamConfig, device: torch.device | str = DEFAULT_DEVICE
                       ) -> Callable:
    """``odometry_step`` with the configuration bound (the JAX package's
    jitted factory; plain Python here): (power, azimuths, prev, twist,
    ray_valid=None, packed=False) -> (raw carry, result, de-skewed
    features).  Every input must be on ``device`` (the card unless the
    caller names the CPU); one on another device raises."""
    dev = resolve_device(device)

    def step(power, azimuths, prev, twist, ray_valid=None, packed=False):
        _require_device("make_odometry_step", dev, prev, power=power, azimuths=azimuths,
                        twist=twist, ray_valid=ray_valid)
        return odometry_step(power, azimuths, prev, twist, cfg, ray_valid, packed)

    return step


def make_batched_odometry_step(cfg: SlamConfig,
                               device: torch.device | str = DEFAULT_DEVICE) -> Callable:
    """Data-parallel front-end: one call advances B independent scan streams
    (the JAX package's ``make_batched_odometry_step``, ``jax.vmap`` of the
    step with ``in_axes=(0, None, 0, 0)``).

    Returns
        (powers (B, NA, NBp) (or packed (B, NA, NBp // 2) uint8), azimuths
         (NA,) shared, prev ScanFeatures with a leading B axis, twists
         (B, 3), ray_valids=None ((B, NA) bool), packed=False) ->
        (carry', RegistrationResult, de-skewed features), each with a
        leading B axis.
    Stream b's result is ``odometry_step`` on stream b alone: one batched
    extraction (one K1 x B launch on the card), then ``register_step``
    under ``torch.func.vmap``, whose reductions are batch-invariant where a
    rounding difference could change a discrete choice
    (``registration.spectral_inlier_scores``).  The step reads nothing back
    per stream; the host waits for the device three times per batch, at the
    ``sync.*`` spans (the top-k's ``nonzero`` and ``bincount``, matching's
    second-best).  Every
    input must be on ``device`` (the card unless the caller names the CPU);
    one on another device raises."""
    dev = resolve_device(device)
    pair = torch.func.vmap(functools.partial(register_step, cfg=cfg))

    def step(powers, azimuths, prev, twists, ray_valids=None, packed=False):
        _require_device("make_batched_odometry_step", dev, prev,
                        powers=powers, azimuths=azimuths, twists=twists,
                        ray_valids=ray_valids)
        with span("odo.step"):
            curr = extract_scan_features_batched(powers, azimuths, cfg, ray_valids, packed)
            res, curr_out = pair(prev, curr, twists)
            return curr, res, curr_out

    return step


def make_odometry_sequence(cfg: SlamConfig, return_features: bool = False
                           ) -> Callable:
    """Streaming odometry over a chunk of S consecutive scans: a plain loop
    of ``odometry_step`` with the coast semantics of ``RadarOdometry``,
    everything kept on the device.

    Returns
        (powers (S, NA, NB), azimuths (NA,) or (S, NA), prev, twist (3,),
         coast (), ray_valids=None, packed=False) ->
        (prev', twist', coast', rels (S, 3), oks (S,), num_inliers (S,))
    and, with ``return_features``, the de-skewed positions (S, K, 2) and
    validity (S, K).  ``rels[i]`` is the increment applied at scan i: the
    registration result when ok, else the previous increment, zeroed once
    the coast exceeds cfg.registration.max_coast_frames."""
    max_coast = cfg.registration.max_coast_frames

    def seq(powers, azimuths, prev, twist, coast, ray_valids=None, packed=False):
        rels, oks, n_inl, xys, valids = [], [], [], [], []
        for i in range(powers.shape[0]):
            az = azimuths if azimuths.dim() == 1 else azimuths[i]
            rv = None if ray_valids is None else ray_valids[i]
            curr, res, curr_out = odometry_step(powers[i], az, prev, twist, cfg,
                                                rv, packed)
            coast = torch.where(res.ok, torch.zeros_like(coast), coast + 1)
            twist = torch.where(
                res.ok, res.rel_pose,
                torch.where(coast > max_coast, torch.zeros_like(twist), twist))
            prev = curr
            rels.append(twist)
            oks.append(res.ok)
            n_inl.append(res.num_inliers)
            xys.append(curr_out.xy)
            valids.append(curr_out.valid)
        out = (prev, twist, coast, torch.stack(rels), torch.stack(oks),
               torch.stack(n_inl))
        if return_features:
            out = out + (torch.stack(xys), torch.stack(valids))
        return out

    return seq


def default_azimuths(cfg: SlamConfig) -> np.ndarray:
    """Evenly spaced ray angles (rad) at the ray centres."""
    na = cfg.radar.num_azimuths
    return (np.arange(na, dtype=np.float32) + 0.5) / na * 2.0 * np.pi


class RadarOdometry:
    """Host-side accumulator mirroring the ORORA node's output contract:
    per scan the accumulated SE(2) pose (``/orora/odom``) and the current
    feature cloud (``/orora/cloud_local``)."""

    def __init__(self, cfg: Optional[SlamConfig] = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.cfg = cfg or SlamConfig()
        self.device = resolve_device(device)
        self.prev: Optional[ScanFeatures] = None
        self.pose = np.zeros(3)          # accumulated [x, y, theta], f64
        self.num_scans = 0
        self.last_result: Optional[registration.RegistrationResult] = None
        #: host copy of the last step's (ok, rel_pose) — one device fetch
        self.last_ok: bool = False
        self.last_rel = np.zeros(3)      # constant-velocity fallback
        #: the increment composed into ``pose`` last scan (last_rel or the
        #: coast fallback)
        self.last_applied_rel = np.zeros(3)
        self.num_failures = 0
        self._coast = 0
        #: applied to the (ok, rel_pose) packet before the host reads it; a
        #: mesh engine sets its ``Mesh.broadcast``, so that every rank reads
        #: rank 0's result
        self.agree: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        self._az_dev = torch.as_tensor(default_azimuths(self.cfg), device=self.device)

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def process(self, power, azimuths=None, ray_valid=None,
                packed: bool = False) -> Tuple[np.ndarray, ScanFeatures]:
        """Feed one polar scan (numpy or tensor; float32, uint8, or with
        ``packed`` the 4-bit wire format); returns (accumulated pose, scan
        features).

        Per scan: the scan upload, the step, and ONE fetch of (ok, rel_pose);
        the pose is composed on the host in f64.  (The exact top-k of the
        score map also waits for the device once, to size its sort.)"""
        azimuths = self._az_dev if azimuths is None else self._to_device(azimuths)
        power = self._to_device(power)
        if ray_valid is not None:
            ray_valid = self._to_device(ray_valid)
        if self.prev is None:
            self.prev = extract_scan_features(power, azimuths, self.cfg, ray_valid,
                                              packed)
            self.num_scans = 1
            return self.pose.copy(), self.prev
        twist = torch.as_tensor(self.last_rel, dtype=torch.float32, device=self.device)
        curr, result, curr_out = odometry_step(power, azimuths, self.prev, twist,
                                               self.cfg, ray_valid, packed)
        self.last_result = result
        packet = torch.cat([result.ok.to(torch.float32)[None], result.rel_pose])
        if self.agree is not None:
            packet = self.agree(packet)
        fetched = packet.cpu().numpy()
        self.last_ok = bool(fetched[0])
        if self.last_ok:
            rel = fetched[1:].astype(np.float64)
            self.last_rel = rel
            self._coast = 0
        else:
            # constant-velocity fallback: reuse the previous increment, but
            # stop blind extrapolation after max_coast_frames failures
            self.num_failures += 1
            self._coast += 1
            if self._coast > self.cfg.registration.max_coast_frames:
                self.last_rel = np.zeros(3)
            rel = self.last_rel
        self.last_applied_rel = np.asarray(rel, np.float64)
        self.pose = se2_mul_np(self.pose, self.last_applied_rel)
        self.prev = curr
        self.num_scans += 1
        return self.pose.copy(), curr_out

    # -- carrying state across (see navtech_radar_slam_torch.state) ---------

    def load_state(self, d: Dict) -> None:
        """Resume from a carry given as numpy (e.g. the JAX RadarOdometry's,
        exported with ``state.odometry_state_to_numpy``'s layout)."""
        from navtech_radar_slam_torch import state

        state.load_odometry_state(self, d)

    def to_numpy(self) -> Dict:
        """The carry as numpy, in the layout ``load_state`` reads."""
        from navtech_radar_slam_torch import state

        return state.odometry_state_to_numpy(self)
