"""Synthetic Navtech radar simulator (the port's copy of the JAX package's
``data/synthetic.py``; numpy only, byte-identical scans).

The reference validates only visually on MulRan (SURVEY §4: no tests exist).
This simulator provides ground-truth-controlled polar scans so every stage —
cen2019 peaks, registration, ScanContext, ICP, PGO, full SLAM — is unit- and
integration-testable without the dataset, and so `bench.py` has a
deterministic, self-contained workload.

World model: static 2-D point scatterers with per-point reflectivity.  A scan
renders each visible scatterer as a Gaussian blob in (azimuth, range) with
multiplicative speckle + additive noise floor, mimicking the MulRan polar
PNGs the real reader decodes (data/mulran.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from navtech_radar_slam_torch.config import RadarConfig


@dataclass
class SimConfig:
    num_landmarks: int = 400
    world_size: float = 400.0          # landmarks in [-ws/2, ws/2]^2 (m)
    min_reflect: float = 0.35
    max_reflect: float = 1.0
    blob_sigma_range: float = 1.5      # bins
    blob_sigma_azimuth: float = 0.8    # azimuth rows
    noise_floor: float = 0.04
    speckle: float = 0.05
    max_visible_range: float = 180.0   # m
    #: FMCW Doppler coupling (seconds): measured range = true + beta * rdot.
    #: Applied only to motion-distorted renders (end_pose given); 0 disables.
    doppler_beta: float = 0.0
    #: PERCEPTUAL ALIASING (VERDICT r4 next #4): when set, the landmark
    #: field is cloned shifted by this (dx, dy) — a second, distant site
    #: whose local geometry is SIMILAR (not identical: each cloned landmark
    #: is jittered by alias_jitter and only alias_keep of them survive, the
    #: density refilled with fresh ones).  Similar enough to fool the coarse
    #: 20x60 ScanContext occupancy image into a below-threshold candidate;
    #: different enough that submap ICP's fine alignment fails — exactly
    #: the false-candidate regime the reference's fitness gate exists for
    #: (laserPosegraphOptimization.cpp:389-394).
    alias_offset: Optional[Tuple[float, float]] = None
    alias_jitter: float = 1.5          # m, per cloned landmark
    alias_keep: float = 0.8            # surviving fraction of the clone
    #: DYNAMIC SCATTERERS: this many extra reflectors oscillate through the
    #: world (amplitude dynamic_amp, period dynamic_period seconds) — they
    #: appear as features but occupy different positions at revisit time,
    #: stressing registration outlier rejection and the ICP gate.
    num_dynamic: int = 0
    dynamic_amp: float = 10.0
    dynamic_period: float = 60.0
    seed: int = 0


class RadarSimulator:
    def __init__(self, radar: Optional[RadarConfig] = None, sim: Optional[SimConfig] = None):
        self.radar = radar or RadarConfig()
        self.sim = sim or SimConfig()
        rng = np.random.default_rng(self.sim.seed)
        ws = self.sim.world_size
        self.landmarks = rng.uniform(-ws / 2, ws / 2, size=(self.sim.num_landmarks, 2))
        self.reflect = rng.uniform(
            self.sim.min_reflect, self.sim.max_reflect, size=(self.sim.num_landmarks,)
        )
        sc = self.sim
        if sc.alias_offset is not None:
            off = np.asarray(sc.alias_offset, np.float64)
            keep = rng.random(len(self.landmarks)) < sc.alias_keep
            clone = self.landmarks[keep] + off
            clone = clone + rng.normal(0, sc.alias_jitter, clone.shape)
            n_fresh = len(self.landmarks) - int(keep.sum())
            fresh = rng.uniform(-ws / 2, ws / 2, size=(n_fresh, 2)) + off
            self.landmarks = np.concatenate([self.landmarks, clone, fresh])
            self.reflect = np.concatenate([
                self.reflect, self.reflect[keep],
                rng.uniform(sc.min_reflect, sc.max_reflect, size=(n_fresh,)),
            ])
        if sc.num_dynamic > 0:
            span = ws / 2 + (abs(sc.alias_offset[0]) + abs(sc.alias_offset[1])
                             if sc.alias_offset is not None else 0.0)
            self.dyn_base = rng.uniform(-span, span, size=(sc.num_dynamic, 2))
            ang = rng.uniform(0, 2 * np.pi, size=sc.num_dynamic)
            self.dyn_dir = np.stack([np.cos(ang), np.sin(ang)], -1)
            self.dyn_phase = rng.uniform(0, 2 * np.pi, size=sc.num_dynamic)
            self.dyn_reflect = rng.uniform(
                sc.min_reflect, sc.max_reflect, size=(sc.num_dynamic,)
            )
        else:
            self.dyn_base = None
        self._rng = rng

    def _world_points(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        """Scatterer positions + reflectivities at time ``t`` (static
        landmarks plus the oscillating dynamic set)."""
        if self.dyn_base is None:
            return self.landmarks, self.reflect
        sc = self.sim
        s = np.sin(2 * np.pi * t / sc.dynamic_period + self.dyn_phase)
        dyn = self.dyn_base + self.dyn_dir * (sc.dynamic_amp * s[:, None])
        return (np.concatenate([self.landmarks, dyn]),
                np.concatenate([self.reflect, self.dyn_reflect]))

    # -- trajectories -------------------------------------------------------

    def circuit_trajectory(self, num_scans: int, radius: float = 60.0,
                           speed: float = 3.0) -> np.ndarray:
        """Closed loop around the origin -> guaranteed loop closures.
        Returns (N, 3) SE(2) ground-truth poses [x, y, theta]."""
        dt = 1.0 / self.radar.scan_rate_hz
        omega = speed / radius
        t = np.arange(num_scans) * dt
        ang = omega * t
        x = radius * np.cos(ang)
        y = radius * np.sin(ang)
        theta = ang + np.pi / 2  # tangent heading
        return np.stack([x, y, np.arctan2(np.sin(theta), np.cos(theta))], axis=-1)

    def two_site_trajectory(self, num_scans: int, radius: float = 12.0,
                            speed: float = 6.0,
                            site_offset: Tuple[float, float] = (150.0, 0.0),
                            laps_a: float = 1.6) -> np.ndarray:
        """Aliasing-world path: ``laps_a`` laps around site A (origin), a
        straight transit to site B (the aliased clone at ``site_offset``),
        then laps around B until ``num_scans`` is filled.

        True loop closures fire on the second lap at A and on B's own
        revisits; while circling B, ScanContext sees descriptors nearly
        identical to site A's bank — the FALSE candidates submap ICP must
        reject (VERDICT r4 next #4).  Returns (num_scans, 3) poses."""
        dt = 1.0 / self.radar.scan_rate_hz
        ds = speed * dt
        off = np.asarray(site_offset, np.float64)

        # dense polyline: arc at A, transit, generous arc at B
        def arc(center, a0, a1, n):
            a = np.linspace(a0, a1, n)
            return np.asarray(center)[None, :] + radius * np.stack(
                [np.cos(a), np.sin(a)], -1
            )

        pts = [arc((0.0, 0.0), 0.0, laps_a * 2 * np.pi,
                   max(int(laps_a * 720), 8))]
        end_a = pts[0][-1]
        # B arc starts at the point of B's circle facing the A exit
        a0b = np.arctan2(end_a[1] - off[1], end_a[0] - off[0])
        start_b = off + radius * np.array([np.cos(a0b), np.sin(a0b)])
        n_tr = max(int(np.linalg.norm(start_b - end_a) / ds) * 4, 8)
        pts.append(np.linspace(end_a, start_b, n_tr)[1:])
        # generously long arc at B; truncated to num_scans below
        need = num_scans * ds
        laps_b = need / (2 * np.pi * radius) + 2
        pts.append(arc(off, a0b, a0b + laps_b * 2 * np.pi,
                       max(int(laps_b * 720), 8))[1:])
        poly = np.concatenate(pts)

        # resample at ds spacing; heading = local tangent
        seg = np.diff(poly, axis=0)
        seglen = np.linalg.norm(seg, axis=-1)
        s_cum = np.concatenate([[0.0], np.cumsum(seglen)])
        s_want = np.arange(num_scans) * ds
        x = np.interp(s_want, s_cum, poly[:, 0])
        y = np.interp(s_want, s_cum, poly[:, 1])
        idx = np.clip(np.searchsorted(s_cum, s_want, side="right") - 1,
                      0, len(seg) - 1)
        theta = np.arctan2(seg[idx, 1], seg[idx, 0])
        return np.stack([x, y, theta], -1)

    def random_trajectory(self, num_scans: int, speed: float = 3.0,
                          yaw_rate_std: float = 0.05, seed: int = 1) -> np.ndarray:
        rng = np.random.default_rng(seed)
        dt = 1.0 / self.radar.scan_rate_hz
        poses = np.zeros((num_scans, 3))
        yaw_rate = 0.0
        for i in range(1, num_scans):
            yaw_rate = 0.9 * yaw_rate + rng.normal(0, yaw_rate_std)
            th = poses[i - 1, 2] + yaw_rate * dt
            poses[i, 0] = poses[i - 1, 0] + speed * dt * np.cos(th)
            poses[i, 1] = poses[i - 1, 1] + speed * dt * np.sin(th)
            poses[i, 2] = th
        return poses

    # -- rendering ----------------------------------------------------------

    def visible_landmarks(self, pose: np.ndarray, t: float = 0.0
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Landmark (range_m, bearing_rad in sensor frame, reflect) visible
        from an SE(2) pose at time ``t`` (dynamic scatterers move)."""
        pts, refl = self._world_points(t)
        d = pts - pose[:2]
        rng_m = np.linalg.norm(d, axis=-1)
        bearing = np.arctan2(d[:, 1], d[:, 0]) - pose[2]
        bearing = np.mod(bearing, 2 * np.pi)
        vis = (rng_m > 2.0) & (rng_m < min(self.sim.max_visible_range, self.radar.max_range))
        return rng_m[vis], bearing[vis], refl[vis]

    def render(self, pose: np.ndarray, noise_seed: int = 0,
               end_pose: Optional[np.ndarray] = None,
               t: float = 0.0) -> np.ndarray:
        """Render one polar power scan (num_azimuths, padded_range_bins) f32.

        If ``end_pose`` is given, the sweep is motion-distorted: the ray at
        azimuth fraction f is rendered from the pose interpolated between
        ``pose`` (sweep start, azimuth 0) and ``end_pose`` (sweep end) —
        the real Navtech behaviour a moving platform induces.  ``t`` is the
        scan's wall-clock time (drives dynamic scatterers)."""
        rc, sc = self.radar, self.sim
        na, nb = rc.num_azimuths, rc.num_range_bins
        img = np.zeros((na, rc.padded_range_bins), np.float32)
        if end_pose is None:
            rng_m, bearing, refl = self.visible_landmarks(pose, t)
        else:
            dp = np.asarray(end_pose, np.float64) - np.asarray(pose, np.float64)
            dp[2] = np.arctan2(np.sin(dp[2]), np.cos(dp[2]))
            pts, refl_all = self._world_points(t)
            d0 = pts - np.asarray(pose)[:2]
            r0 = np.linalg.norm(d0, axis=-1)
            vis = (r0 > 2.0) & (
                r0 < min(sc.max_visible_range, rc.max_range)
            )
            lm = pts[vis]
            refl = refl_all[vis]
            bearing = np.mod(
                np.arctan2(d0[vis, 1], d0[vis, 0]) - pose[2], 2 * np.pi
            )
            # fixed-point: a landmark's azimuth sets its sample time, which
            # sets the pose it is observed from
            for _ in range(3):
                frac = bearing / (2 * np.pi)
                interp = np.asarray(pose)[None, :] + frac[:, None] * dp[None, :]
                dxy = lm - interp[:, :2]
                rng_m = np.linalg.norm(dxy, axis=-1)
                bearing = np.mod(
                    np.arctan2(dxy[:, 1], dxy[:, 0]) - interp[:, 2], 2 * np.pi
                )
            if sc.doppler_beta != 0.0:
                # static world, moving sensor: rdot = -d̂·v (world frame);
                # the radar reports r + beta * rdot
                v_world = dp[:2] * rc.scan_rate_hz
                d_hat = dxy / np.maximum(rng_m[:, None], 1e-9)
                rng_m = rng_m - sc.doppler_beta * (d_hat @ v_world)

        az_f = bearing / (2 * np.pi) * na          # fractional azimuth row
        rb_f = rng_m / rc.range_resolution          # fractional range bin

        half_a = max(1, int(np.ceil(3 * sc.blob_sigma_azimuth)))
        half_r = max(1, int(np.ceil(3 * sc.blob_sigma_range)))
        da = np.arange(-half_a, half_a + 1)
        dr = np.arange(-half_r, half_r + 1)

        for i in range(len(rng_m)):
            a0 = int(np.round(az_f[i]))
            r0 = int(np.round(rb_f[i]))
            rows = np.mod(a0 + da, na)
            cols = r0 + dr
            ok = (cols >= 0) & (cols < nb)
            if not ok.any():
                continue
            wa = np.exp(-0.5 * ((a0 + da - az_f[i]) / sc.blob_sigma_azimuth) ** 2)
            wr = np.exp(-0.5 * ((r0 + dr - rb_f[i]) / sc.blob_sigma_range) ** 2)
            # 1/r power falloff, mild
            amp = refl[i] * (1.0 / (1.0 + 0.002 * rng_m[i]))
            patch = amp * np.outer(wa, wr[ok])
            np.maximum.at(img, (rows[:, None], cols[None, ok]), patch)

        noise_rng = np.random.default_rng(noise_seed)
        img[:, :nb] += noise_rng.exponential(sc.noise_floor, size=(na, nb)).astype(np.float32)
        if sc.speckle > 0:
            img[:, :nb] *= (
                1.0 + sc.speckle * noise_rng.standard_normal((na, nb))
            ).clip(0.0, None).astype(np.float32)
        np.clip(img, 0.0, 1.0, out=img)
        img[:, : min(40, nb)] = 0.0  # sensor dead zone near 0 range
        return img

    def render_sequence(self, poses: np.ndarray) -> List[np.ndarray]:
        return [self.render(poses[i], noise_seed=i) for i in range(len(poses))]
