"""Checkpoint / resume of the full SLAM state as one compressed ``.npz``.

The counterpart of ``navtech_radar_slam_tpu/utils/checkpoint.py``: the file
holds exactly the JAX checkpoint's keys, dtypes and shapes (keyframe
clouds, descriptor bank, ring keys, pose-graph arrays, counters, the
session flags and the GPS datum) plus ``config``, the ``SlamConfig`` as
JSON, so either package loads the other's file.  The odometry carry's scan
features are not saved, as in JAX: the first scan after a resume re-seeds
them.

On a mesh every rank calls ``save_engine`` (the bank is gathered whole to
write the same file) and rank 0 alone writes it; ``load_engine(...,
mesh=...)`` gives each rank its block of the bank, so a resumed mesh run
stays on its mesh.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from navtech_radar_slam_torch import state
from navtech_radar_slam_torch.config import SlamConfig

if TYPE_CHECKING:
    from navtech_radar_slam_torch.models.slam import SlamEngine


def save_engine(eng: "SlamEngine", path: str) -> None:
    """Write ``eng``'s state to ``path``, after finishing the in-flight
    chunks and committing the pending loop decisions (on a mesh: every rank
    calls it, rank 0 writes)."""
    d = state.slam_state_to_numpy(eng)
    del d["odometry"]
    if eng.mesh is None or eng.mesh.rank == 0:
        np.savez_compressed(path, config=json.dumps(eng.cfg.to_dict()), **d)


def load_engine(path: str, device: Optional[torch.device | str] = None,
                mesh=None) -> "SlamEngine":
    """A ``SlamEngine`` on ``device`` (default: the mesh's device, else the
    card) built from the file's config (so a grown engine reloads at its own
    capacity) and holding its state; with ``mesh`` one rank's engine of a
    mesh run."""
    from navtech_radar_slam_torch.models.slam import SlamEngine

    z = np.load(path, allow_pickle=False)
    eng = SlamEngine(SlamConfig.from_json(str(z["config"])), device=device, mesh=mesh)
    state.load_slam_state(eng, dict(z))
    return eng
