"""The plain radar odometry front-end: what one step of the port's batched
odometry computes, worked out again from the scans.

A frozen copy of the port's ``models/odometry.py`` front-end functions
(extraction, de-skew, ``register_step``) on the plain copies beside it.
It reads the configuration from the configuration file's dict and takes
nothing the port made: it decodes the 8-bit scans, finds the features,
builds the descriptors and registers each pair itself.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple, Sequence

import numpy as np
import torch

from radarbench.reference import cen2019, features, registration
from radarbench.reference.precision import FP32, Precision

#: scans per vmapped descriptor call (two (n, K, K, P) float32 hat tensors,
#: 2 GB each at 16 x (1024, 1024, 16))
DESC_SCANS = 16
#: pairs per vmapped registration call
PAIRS = 128


def sections(config: dict) -> SimpleNamespace:
    """The configuration file's sections as attribute namespaces (the
    radar's padded width worked out as the port pads it: to 128 bins)."""
    ns = SimpleNamespace(**{k: SimpleNamespace(**v) if isinstance(v, dict) else v
                            for k, v in config.items()})
    nb = ns.radar.num_range_bins
    ns.radar.padded_range_bins = -(-nb // 128) * 128
    return ns


class Feats(NamedTuple):
    xy: torch.Tensor        # (..., K, 2) raw sensor-frame positions (m)
    desc: torch.Tensor      # (..., K, D) masked descriptors
    power: torch.Tensor     # (..., K)
    valid: torch.Tensor     # (..., K) bool
    ray_frac: torch.Tensor  # (..., K)


def azimuths(cfg: SimpleNamespace, device) -> torch.Tensor:
    """Evenly spaced ray angles (rad) at the ray centres, float32."""
    na = cfg.radar.num_azimuths
    return torch.as_tensor((np.arange(na, dtype=np.float32) + 0.5) / na * 2.0 * np.pi,
                           device=device)


def _masked(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))


def describe(xy: torch.Tensor, power: torch.Tensor, valid: torch.Tensor,
             cfg: SimpleNamespace, prec: Precision = FP32) -> torch.Tensor:
    """(S, K) peaks -> their masked (S, K, D) descriptors."""
    fn = torch.func.vmap(functools.partial(features.constellation_descriptors,
                                           fcfg=cfg.features, mm=prec.bmm))
    desc = torch.cat([fn(xy[i:i + DESC_SCANS], power[i:i + DESC_SCANS],
                         valid[i:i + DESC_SCANS])
                      for i in range(0, xy.shape[0], DESC_SCANS)])
    return _masked(desc, valid)


def extract(scans_u8: torch.Tensor, cfg: SimpleNamespace,
            prec: Precision = FP32) -> Feats:
    """(S, NA, NBp) uint8 scans -> each scan's features, (S, K) fields."""
    power = scans_u8.to(torch.float32) * (1.0 / 255.0)
    scores = torch.stack([cen2019.cen2019_scores(p, cfg.features, cfg.radar, prec.mul)
                          for p in power])
    fs = cen2019._finalize_topk_scores_batched(scores, cfg.features.max_features)
    del scores
    xy = cen2019.features_to_xy(fs, azimuths(cfg, scans_u8.device), cfg.radar)
    return Feats(xy=xy, desc=describe(xy, fs.power, fs.valid, cfg, prec), power=fs.power,
                 valid=fs.valid,
                 ray_frac=(fs.azimuth_idx.to(torch.float32) + 0.5) / cfg.radar.num_azimuths)


def motion_compensate(xy, ray_frac, twist):
    th = ray_frac * twist[2]
    c, s = torch.cos(th), torch.sin(th)
    x, y = xy[:, 0], xy[:, 1]
    return (torch.stack([c * x - s * y, s * x + c * y], dim=-1)
            + ray_frac[:, None] * twist[None, :2])


def doppler_compensate(xy, twist, beta: float, scan_rate_hz: float):
    v = twist[:2] * scan_rate_hz
    r = torch.linalg.norm(xy, dim=-1, keepdim=True)
    d = xy / torch.clamp(r, min=1e-6)
    r_true = r + beta * torch.sum(d * v[None, :], dim=-1, keepdim=True)
    return d * r_true


def deskew_xy(xy, frac, twist, cfg):
    if cfg.features.doppler_compensation:
        xy = doppler_compensate(xy, twist, cfg.features.doppler_beta,
                                cfg.radar.scan_rate_hz)
    if cfg.features.motion_compensation:
        xy = motion_compensate(xy, frac, twist)
    return xy


def deskew_matches(m: features.MatchSet, twist, cfg) -> features.MatchSet:
    src = deskew_xy(m.src_xy, m.src_frac, twist, cfg)
    dst = deskew_xy(m.dst_xy, m.dst_frac, twist, cfg)
    vf = m.valid.to(torch.float32)
    return m._replace(
        src_xy=torch.where(m.valid[:, None], src, torch.zeros_like(src)),
        dst_xy=torch.where(m.valid[:, None], dst, torch.zeros_like(dst)),
        src_range=torch.linalg.norm(src, dim=-1) * vf,
        dst_range=torch.linalg.norm(dst, dim=-1) * vf,
    )


def register_step(prev: Feats, curr: Feats, twist: torch.Tensor, cfg,
                  prec: Precision = FP32):
    """One stream's registration of ``curr`` against ``prev`` with the
    carried ``twist``: match once, register, then two de-skewed
    re-registrations.  Returns (rel_pose (3,), ok (), first_ok ()): where
    the first registration is ok, the answer does not depend on ``twist``."""
    m = features.match_features(prev.desc, curr.desc, prev.xy, curr.xy, prev.valid,
                                curr.valid, cfg.features, prev.ray_frac, curr.ray_frac,
                                mm=prec.mm)
    res = registration.register_scans(m, cfg.registration, prec.mm)
    first_ok = res.ok
    if not (cfg.features.motion_compensation or cfg.features.doppler_compensation):
        return res.rel_pose, res.ok, torch.ones_like(first_ok)
    t = torch.where(res.ok, res.rel_pose, twist)
    for _ in range(2):
        res = registration.register_scans(deskew_matches(m, t, cfg), cfg.registration,
                                          prec.mm)
        t = torch.where(res.ok, res.rel_pose, t)
    return res.rel_pose, res.ok, first_ok


def register_pairs(feats: Feats, prev_idx: Sequence[int], curr_idx: Sequence[int],
                   twists: torch.Tensor, cfg, prec: Precision = FP32):
    """Register scan ``curr_idx[i]`` against scan ``prev_idx[i]`` of
    ``feats`` with ``twists[i]``, for every i, in vmapped calls of
    ``PAIRS`` pairs.  Returns (rel (n, 3), ok (n,), first_ok (n,))."""
    fn = torch.func.vmap(functools.partial(register_step, cfg=cfg, prec=prec))
    dev = feats.xy.device
    p = torch.as_tensor(np.asarray(prev_idx), device=dev)
    c = torch.as_tensor(np.asarray(curr_idx), device=dev)
    outs = []
    for i in range(0, len(p), PAIRS):
        sl = slice(i, i + PAIRS)
        outs.append(fn(Feats(*(f[p[sl]] for f in feats)), Feats(*(f[c[sl]] for f in feats)),
                       twists[sl]))
    return tuple(torch.cat(parts) for parts in zip(*outs))
