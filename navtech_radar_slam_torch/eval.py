"""Trajectory evaluation CLI: ATE / RTE against ground truth.

    python -m navtech_radar_slam_torch.eval \
        --traj out/trajectory_tum.txt --gt <seq_dir>/global_pose.csv

Supports MulRan ``global_pose.csv`` (stamp_ns + row-major 3x4) and TUM files
as ground truth; trajectories are time-associated (nearest stamp within
--max_dt) and SE(2)-aligned before the error metrics — the quantitative
validation loop the reference never had (SURVEY §4/§6).
Prints one JSON line.  A copy of ``navtech_radar_slam_tpu/eval.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load_tum(path: str):
    raw = np.loadtxt(path)
    if raw.ndim == 1:
        raw = raw[None, :]
    return raw[:, 0], raw[:, 1:3]


def load_tum_se2(path: str):
    """(stamps, (N, 3) [x, y, yaw]) from a TUM file (t x y z qx qy qz qw);
    yaw extracted from the quaternion so RPE can be rotation-aware."""
    raw = np.loadtxt(path)
    if raw.ndim == 1:
        raw = raw[None, :]
    if raw.shape[1] >= 8:
        qx, qy, qz, qw = raw[:, 4], raw[:, 5], raw[:, 6], raw[:, 7]
        yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy**2 + qz**2))
    else:
        d = np.gradient(raw[:, 1:3], axis=0)
        yaw = np.arctan2(d[:, 1], d[:, 0])
    return raw[:, 0], np.stack([raw[:, 1], raw[:, 2], yaw], axis=1)


def load_gt(path: str):
    if path.endswith("global_pose.csv"):
        from navtech_radar_slam_torch.data.mulran import load_global_pose_csv

        ts, poses = load_global_pose_csv(path)
        return ts, poses[:, :2, 3]
    return load_tum(path)


def load_gt_se2(path: str):
    """(stamps, (N, 3) [x, y, yaw]) ground truth; yaw from the rotation
    matrix for MulRan global_pose.csv, from the quaternion for TUM files."""
    if path.endswith("global_pose.csv"):
        from navtech_radar_slam_torch.data.mulran import load_global_pose_csv

        ts, poses = load_global_pose_csv(path)
        yaw = np.arctan2(poses[:, 1, 0], poses[:, 0, 0])
        return ts, np.stack([poses[:, 0, 3], poses[:, 1, 3], yaw], axis=1)
    return load_tum_se2(path)


def associate(t_a, t_b, max_dt: float):
    """Indices pairing each a-stamp with its nearest b-stamp within max_dt."""
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    prev_closer = np.abs(t_b[j - 1] - t_a) <= np.abs(t_b[j] - t_a)
    j = np.where(prev_closer, j - 1, j)
    ok = np.abs(t_b[j] - t_a) <= max_dt
    return np.nonzero(ok)[0], j[ok]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="navtech_radar_slam_torch.eval")
    p.add_argument("--traj", required=True, help="estimated trajectory (TUM)")
    p.add_argument("--gt", required=True,
                   help="ground truth (MulRan global_pose.csv or TUM)")
    p.add_argument("--max_dt", type=float, default=0.15,
                   help="time association window (s)")
    p.add_argument("--rte_delta", type=int, default=10)
    p.add_argument("--no_align", action="store_true")
    args = p.parse_args(argv)

    from navtech_radar_slam_torch.utils import metrics

    t_est, se2_est = load_tum_se2(args.traj)
    t_gt, se2_gt = load_gt_se2(args.gt)
    ia, ib = associate(t_est, t_gt, args.max_dt)
    if len(ia) < 3:
        print(json.dumps({"error": "fewer than 3 time-associated poses"}))
        return 1
    est = se2_est[ia]
    gt = se2_gt[ib]
    ate = metrics.ate_rmse(est[:, :2], gt[:, :2], align=not args.no_align)
    rte_t, rte_r = metrics.relative_pose_error(est, gt, delta=args.rte_delta)
    print(json.dumps({
        "metric": "ate_rmse",
        "value": round(ate, 4),
        "unit": "m",
        "rte": round(rte_t, 4),
        "rte_rot_deg": round(np.degrees(rte_r), 4),
        "pairs": int(len(ia)),
        "path_length": round(metrics.path_length(gt[:, :2]), 1),
        "ate_pct_of_path": round(
            100 * ate / max(metrics.path_length(gt[:, :2]), 1e-9), 3),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
