"""One radar-odometry step at a tiny configuration, on a given device.

The counterpart of ``__graft_entry__.entry()``: ``entry(device)`` returns
``(fn, example_args)`` where ``fn(*example_args)`` runs cen2019 extraction,
constellation matching and the ORORA-style registration for one random
full-size scan against a carry extracted from the same scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navtech_radar_slam_torch.config import SlamConfig
from navtech_radar_slam_torch.models import odometry as odo_mod
from navtech_radar_slam_torch.utils.device import DEFAULT_DEVICE, resolve_device


def tiny_cfg() -> SlamConfig:
    """The default config with the feature, match and solver budgets cut
    (the same cut as ``__graft_entry__._tiny_cfg``)."""
    c = SlamConfig()
    return dataclasses.replace(
        c,
        features=dataclasses.replace(c.features, max_features=256, max_matches=128),
        registration=dataclasses.replace(
            c.registration, spectral_top_k=128, gnc_max_iters=8, cote_iters=4,
            refine_iters=4,
        ),
    )


def entry(device: torch.device | str = DEFAULT_DEVICE):
    device = resolve_device(device)
    cfg = tiny_cfg()
    na, nb = cfg.radar.num_azimuths, cfg.radar.padded_range_bins
    azimuths = torch.as_tensor(odo_mod.default_azimuths(cfg), device=device)
    rng = np.random.default_rng(0)
    power = torch.as_tensor(rng.random((na, nb), dtype=np.float32), device=device)

    prev = odo_mod.extract_scan_features(power, azimuths, cfg)
    twist = torch.zeros(3, dtype=torch.float32, device=device)

    def fn(power, azimuths, prev, twist):
        curr, result, curr_out = odo_mod.odometry_step(power, azimuths, prev, twist, cfg)
        return result.rel_pose, result.num_inliers, curr_out.xy

    return fn, (power, azimuths, prev, twist)
