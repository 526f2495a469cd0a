"""Result plot — the offline counterpart of the reference's rviz topics
(/aft_pgo_path, /aft_pgo_map, loop markers; laserPosegraphOptimization.cpp:
698-704).  A copy of ``navtech_radar_slam_tpu/utils/viz.py``; matplotlib is
imported when a plot is drawn, never at import."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def save_map_plot(
    path: str,
    trajectory: np.ndarray,
    map_points: Optional[np.ndarray] = None,
    odometry_xy: Optional[np.ndarray] = None,
    loops: Optional[Sequence] = None,
    title: str = "navtech_radar_slam_torch",
) -> None:
    """Write a PNG: aggregated map + optimized path (+ raw odometry and
    loop-closure chords, when given).

    trajectory: (N, 4, 4) SE(3) keyframe poses."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10))
    if map_points is not None and len(map_points):
        ax.scatter(map_points[:, 0], map_points[:, 1], s=0.5, c="#9aa5b1",
                   linewidths=0, label="map")
    xy = np.asarray(trajectory)[:, :2, 3]
    if odometry_xy is not None and len(odometry_xy):
        ax.plot(odometry_xy[:, 0], odometry_xy[:, 1], "-", lw=1.0,
                color="#e06c4f", alpha=0.8, label="odometry")
    ax.plot(xy[:, 0], xy[:, 1], "-", lw=1.6, color="#2569b0",
            label="optimized")
    if loops:
        for ev in loops:
            i, j = ev.prev_idx, ev.curr_idx
            if i < len(xy) and j < len(xy):
                ax.plot([xy[i, 0], xy[j, 0]], [xy[i, 1], xy[j, 1]], "-",
                        lw=0.8, color="#3e9850", alpha=0.7)
        ax.plot([], [], "-", color="#3e9850", label=f"loops ({len(loops)})")
    ax.set_aspect("equal")
    ax.legend(loc="best")
    ax.set_title(title)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
