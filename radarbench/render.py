"""Simulated Navtech scans rendered on the device from the seed.

A PyTorch copy of the port's ``data/synthetic.py`` (``RadarSimulator``:
the landmark world, ``circuit_trajectory`` and the motion-distorted
``render``), batched over scans: one scatter of every landmark's blob for
a block of scans, then the noise floor and speckle from a
``torch.Generator`` on the device.  The geometry is float64, as there; the
noise is the device generator's, so only the noise-free render equals the
host simulator's (``radarbench/tests``).  Scans are 8-bit power, as
MulRan's PNGs hold them (``data/make_sequence.py``'s quantisation).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

#: scans rendered per scatter (float32 images of 5.5 MB each)
BLOCK = 64


def world(gen: torch.Generator, sim: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, 2) landmark positions uniform in the square of side
    ``world_size`` around the origin and (L,) reflectivities, float64."""
    n, ws = sim["num_landmarks"], sim["world_size"]
    xy = (torch.rand((n, 2), generator=gen, dtype=torch.float64, device=device) - 0.5) * ws
    refl = sim["min_reflect"] + (sim["max_reflect"] - sim["min_reflect"]) * torch.rand(
        n, generator=gen, dtype=torch.float64, device=device)
    return xy, refl


def circuit(n: int, radius: float, speed: float, rate_hz: float, device) -> torch.Tensor:
    """(n, 3) poses [x, y, theta] on a circle around the origin, counter-
    clockwise at ``speed``, heading along the tangent (``RadarSimulator.
    circuit_trajectory``)."""
    ang = (speed / radius) * (torch.arange(n, dtype=torch.float64, device=device) / rate_hz)
    theta = ang + math.pi / 2
    return torch.stack([radius * torch.cos(ang), radius * torch.sin(ang),
                        torch.atan2(torch.sin(theta), torch.cos(theta))], dim=-1)


def render_clean(lm: torch.Tensor, refl: torch.Tensor, pose: torch.Tensor,
                 end_pose: torch.Tensor, radar: dict, sim: dict) -> torch.Tensor:
    """(S, NA, NBp) float32 noise-free power of S sweeps, each motion-
    distorted from ``pose`` (azimuth 0) to ``end_pose`` (sweep end): every
    landmark within range of the sweep's start, at the fixed point of its
    sample time, as a Gaussian blob max-combined into the image."""
    na, nb = radar["num_azimuths"], radar["num_range_bins"]
    nbp = -(-nb // 128) * 128
    res = radar["range_resolution"]
    two_pi = 2 * math.pi
    dev = lm.device
    s_n = pose.shape[0]
    dp = end_pose - pose
    dp[:, 2] = torch.atan2(torch.sin(dp[:, 2]), torch.cos(dp[:, 2]))
    d0 = lm[None] - pose[:, None, :2]                              # (S, L, 2)
    r0 = torch.linalg.norm(d0, dim=-1)
    vis = (r0 > 2.0) & (r0 < min(sim["max_visible_range"], nb * res))
    bearing = torch.remainder(torch.atan2(d0[..., 1], d0[..., 0]) - pose[:, None, 2], two_pi)
    for _ in range(3):
        frac = bearing / two_pi
        interp = pose[:, None, :] + frac[..., None] * dp[:, None, :]
        dxy = lm[None] - interp[..., :2]
        rng_m = torch.linalg.norm(dxy, dim=-1)
        bearing = torch.remainder(torch.atan2(dxy[..., 1], dxy[..., 0]) - interp[..., 2],
                                  two_pi)
    beta = sim.get("doppler_beta", 0.0)
    if beta != 0.0:
        v = dp[:, None, :2] * radar["scan_rate_hz"]
        d_hat = dxy / torch.clamp(rng_m[..., None], min=1e-9)
        rng_m = rng_m - beta * torch.sum(d_hat * v, dim=-1)
    az_f = bearing / two_pi * na
    rb_f = rng_m / res

    sa, sr = sim["blob_sigma_azimuth"], sim["blob_sigma_range"]
    half_a, half_r = max(1, math.ceil(3 * sa)), max(1, math.ceil(3 * sr))
    da = torch.arange(-half_a, half_a + 1, device=dev, dtype=torch.float64)
    dr = torch.arange(-half_r, half_r + 1, device=dev, dtype=torch.float64)
    a0, r0b = torch.round(az_f), torch.round(rb_f)
    rows = torch.remainder(a0[..., None] + da, na).to(torch.int64)   # (S, L, A)
    cols = r0b[..., None] + dr                                       # (S, L, R)
    col_ok = (cols >= 0) & (cols < nb)
    wa = torch.exp(-0.5 * ((a0[..., None] + da - az_f[..., None]) / sa) ** 2)
    wr = torch.exp(-0.5 * ((cols - rb_f[..., None]) / sr) ** 2)
    amp = refl[None] * (1.0 / (1.0 + 0.002 * rng_m))
    patch = amp[..., None, None] * wa[..., :, None] * wr[..., None, :]
    keep = vis[..., None, None] & col_ok[..., None, :]
    patch = torch.where(keep, patch, torch.zeros_like(patch)).to(torch.float32)
    flat = (torch.arange(s_n, device=dev)[:, None, None, None] * (na * nbp)
            + rows[..., :, None] * nbp
            + torch.clamp(cols, 0, nb - 1).to(torch.int64)[..., None, :])
    img = torch.zeros(s_n * na * nbp, dtype=torch.float32, device=dev)
    img.scatter_reduce_(0, flat.reshape(-1), patch.reshape(-1), reduce="amax")
    return img.reshape(s_n, na, nbp)


def add_noise(img: torch.Tensor, gen: torch.Generator, radar: dict, sim: dict) -> torch.Tensor:
    """The simulator's noise in place: an exponential noise floor, then
    multiplicative speckle, clipped to [0, 1], and the dead zone of the
    first 40 bins zeroed."""
    nb = radar["num_range_bins"]
    band = img[..., :nb]
    if sim["noise_floor"] > 0:
        band += torch.empty_like(band).exponential_(1.0 / sim["noise_floor"], generator=gen)
    if sim["speckle"] > 0:
        band *= torch.clamp(1.0 + sim["speckle"] * torch.randn(
            band.shape, generator=gen, dtype=band.dtype, device=band.device), min=0.0)
    img.clamp_(0.0, 1.0)
    img[..., :min(40, nb)] = 0.0
    return img


def to_u8(img: torch.Tensor, radar: dict) -> torch.Tensor:
    """float power in [0, 1] -> the 8-bit power of a MulRan PNG (truncated,
    as ``data/make_sequence.py`` writes it); padding bins stay 0."""
    out = (img * 255.0).to(torch.uint8)
    out[..., radar["num_range_bins"]:] = 0
    return out


def render_pool(seed: int, poses: torch.Tensor, end_poses: torch.Tensor, radar: dict,
                sim: dict, noise: bool = True, gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """(S, NA, NBp) uint8 scans of the sweeps ``poses`` -> ``end_poses`` in
    a world drawn from ``seed``, rendered on the poses' device in blocks of
    ``BLOCK`` scans, each scan with noise of its own."""
    dev = poses.device
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    lm, refl = world(gen, sim, dev)
    na, nb = radar["num_azimuths"], radar["num_range_bins"]
    out = torch.empty((poses.shape[0], na, -(-nb // 128) * 128), dtype=torch.uint8,
                      device=dev)
    for i in range(0, poses.shape[0], BLOCK):
        img = render_clean(lm, refl, poses[i:i + BLOCK], end_poses[i:i + BLOCK], radar, sim)
        if noise:
            add_noise(img, gen, radar, sim)
        out[i:i + BLOCK] = to_u8(img, radar)
    return out
