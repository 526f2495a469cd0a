#!/usr/bin/env python3
"""Drive the PyTorch port's odometry and full-SLAM paths once on one NVIDIA GPU.

    python3 chip_smoke.py            (from the repository root)

Phases, in order; any failure ends the run with a non-zero exit:

  1. the card: CUDA must be available; prints nvidia-smi's name and power
     limit of the card;
  2. the build: nvcc builds kernels K1, K2 and K3 (navtech_radar_slam_torch/
     csrc/{cen_peaks,sc_corr,nn_dist}.cu) from this checkout, all three at
     once, into navtech_radar_slam_torch/_build/;
  3. K1 against its plain PyTorch twin on the card, on a full-size simulated
     scan as float input and through the 4-bit wire format;
  4. the odometry path: RadarOdometry at the default config (= configs/
     config1_odometry_only.json) over 24 full-size scans of a circuit, with
     K1's launch counter reset just before and read just after;
  5. K1's times against its twin, and the per-scan RadarOdometry.process time;
  6. K2 against its plain version at full size: a query and a (4096, 20, 60)
     bank of make_scancontext descriptors of simulator landmark clouds, 400
     rows live and the rest zero;
  7. K3 against its plain version at (1024, 8192), 20 % of the targets
     invalid, and with every target invalid;
  8. the full-SLAM path: SlamEngine(SlamConfig()) over 60 motion-distorted
     full-size scans of a circuit, every launch counter reset just before
     and read just after; checks the keyframes, K2 once per detecting
     keyframe, K3 at least twice per verified candidate, >= 12 accepted
     loops, a full pose-graph solve, ATE < 1 % of the path and a finite map;
  9. times: K2 and K3 against their plain versions, and the per-scan
     SlamEngine.process time split into odometry, keyframe step and refine.

The line before the last is the kernel report
{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms"}]} (launches: the full-SLAM path's), the
last line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Scans come from the shared numpy simulator (navtech_radar_slam_tpu.data,
which imports no jax); nothing here or in the port imports jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from navtech_radar_slam_tpu.config import SlamConfig
from navtech_radar_slam_tpu.data import RadarSimulator
from navtech_radar_slam_tpu.data.packing import pack4
from navtech_radar_slam_torch.models import slam as slam_mod
from navtech_radar_slam_torch.models.odometry import RadarOdometry, decode_power
from navtech_radar_slam_torch.ops import cen2019, icp, scancontext
from navtech_radar_slam_torch.ops.kernels import cen_peaks, nn_dist, sc_corr
from navtech_radar_slam_torch.utils.geometry import se2_between_np

N_SCANS = 24
N_SLAM_SCANS = 60
TIMED_RUNS = 30
PEAK_FRAC = 0.01     # tests/test_pallas_kernels.py: borderline h > mean(h) flips
VALUE_ATOL = 1e-5
SC_ATOL = 2e-5       # the JAX suite's bound for the SC distances
MIN_LOOPS = 12       # the JAX engine closes 17 on this circuit (CPU run)
KERNELS = (cen_peaks, sc_corr, nn_dist)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def compare_kernel(power: torch.Tensor, cfg: SlamConfig) -> float:
    """K1 vs the twin on one scan; returns the max abs error at common peaks."""
    got = cen_peaks.cen2019_scores_cuda(power, cfg.features, cfg.radar)
    want = cen2019.cen2019_scores(power, cfg.features, cfg.radar)
    torch.cuda.synchronize()
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    n_peaks = int(fw.sum())
    n_diff = int((fg ^ fw).sum())
    both = fg & fw
    err = float((got[both] - want[both]).abs().max())
    k = cfg.features.max_features
    g = cen2019._finalize_topk_scores(got, k)
    w = cen2019._finalize_topk_scores(want, k)
    nb = power.shape[1]
    g_set = set((g.azimuth_idx * nb + g.range_bin)[g.valid].tolist())
    w_set = set((w.azimuth_idx * nb + w.range_bin)[w.valid].tolist())
    sym = len(g_set ^ w_set)
    print(f"  peaks {n_peaks}, positions differing {n_diff}, max abs err {err:.3g}, "
          f"top-{k} symmetric difference {sym}")
    if n_peaks == 0 or n_diff > PEAK_FRAC * n_peaks:
        raise AssertionError(f"K1 peak positions differ in {n_diff} of {n_peaks}")
    if err > VALUE_ATOL:
        raise AssertionError(f"K1 values differ by {err} > {VALUE_ATOL}")
    if sym > PEAK_FRAC * len(w_set):
        raise AssertionError(f"K1 top-k sets differ in {sym} of {len(w_set)}")
    return err


def sc_inputs(cfg: SlamConfig, sim: RadarSimulator, dev) -> tuple:
    """A query and a (max_keyframes, R, S) bank of make_scancontext
    descriptors of simulator landmark clouds at random poses: 400 rows
    live, the rest zero; the query is taken near the pose of row 123."""
    rng = np.random.default_rng(7)
    poses = np.column_stack([rng.uniform(-60, 60, 400), rng.uniform(-60, 60, 400),
                             rng.uniform(-np.pi, np.pi, 400)])
    query_pose = poses[123] + np.asarray([0.4, -0.3, 0.5])

    def desc(pose):
        r, b, _ = sim.visible_landmarks(pose)
        xy = torch.as_tensor(np.column_stack([r * np.cos(b), r * np.sin(b)]),
                             dtype=torch.float32, device=dev)
        n = xy.shape[0]
        return scancontext.make_scancontext(
            xy, torch.zeros(n, device=dev), torch.ones(n, dtype=torch.bool, device=dev),
            cfg.scancontext)

    bank = torch.zeros((cfg.keyframes.max_keyframes, cfg.scancontext.num_ring,
                        cfg.scancontext.num_sector), device=dev)
    for i, p in enumerate(poses):
        bank[i] = desc(p)
    return desc(query_pose), bank


def median_ms(fn, runs: int) -> float:
    """Median over ``runs`` calls, each fenced by CUDA events."""
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_vs_plain(kernel, plain) -> tuple:
    """(kernel ms, plain ms): medians, plain timed before and after."""
    for _ in range(5):
        kernel()
        plain()
    torch.cuda.synchronize()
    plain_a = median_ms(plain, TIMED_RUNS // 2)
    k_ms = median_ms(kernel, TIMED_RUNS)
    plain_b = median_ms(plain, TIMED_RUNS // 2)
    return k_ms, float(np.median([plain_a, plain_b])), plain_a, plain_b


def timed(bucket: dict, name: str, fn):
    """Wrap ``fn`` so each call adds its host time (synchronized) to
    ``bucket[name]``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        bucket[name] += time.perf_counter() - t0
        return out
    return wrapper


def slam_path(cfg: SlamConfig, sim: RadarSimulator, dev, name_power: str) -> dict:
    """Phase 8: the full-SLAM path, checked; returns launches and times."""
    gt = sim.circuit_trajectory(N_SLAM_SCANS + 1, radius=10.0, speed=6.0)
    scans = [sim.render(gt[i], noise_seed=i, end_pose=gt[i + 1])
             for i in range(N_SLAM_SCANS)]
    eng = slam_mod.SlamEngine(cfg, device=dev)
    # stage split: odometry, refine (inside the keyframe step), keyframe step
    stage = defaultdict(float)
    eng.odometry.process = timed(stage, "odometry", eng.odometry.process)
    eng._refine_graph = timed(stage, "refine", eng._refine_graph)
    eng._add_keyframe = timed(stage, "keyframe", eng._add_keyframe)
    n_icp = [0]
    icp_se2 = slam_mod.icp_ops.icp_se2

    def counted_icp(*args, **kwargs):
        n_icp[0] += 1
        return icp_se2(*args, **kwargs)

    slam_mod.icp_ops.icp_se2 = counted_icp
    per_scan = []
    try:
        for kern in KERNELS:
            kern.launch_count = 0
        for i, s in enumerate(scans):
            stage.clear()
            t0 = time.perf_counter()
            eng.process(s, timestamp=i * 0.25)
            torch.cuda.synchronize()
            per_scan.append((time.perf_counter() - t0, stage["odometry"],
                             stage["keyframe"] - stage["refine"], stage["refine"]))
        t0 = time.perf_counter()
        traj = eng.trajectory()
        final_flush = time.perf_counter() - t0
        launches = {kern.__name__.rsplit(".", 1)[1]: kern.launch_count for kern in KERNELS}
    finally:
        slam_mod.icp_ops.icp_se2 = icp_se2
    world_map = eng.aggregate_map()

    c = cfg.scancontext
    n_detect = sum(1 for k in range(eng.num_keyframes)
                   if (k + 1) % c.detect_every_n_keyframes == 0
                   and (k + 1) > c.num_exclude_recent)
    gt_rel = np.asarray([se2_between_np(gt[0], g) for g in gt[:N_SLAM_SCANS]])
    path = float(np.sum(np.linalg.norm(np.diff(gt_rel[:, :2], axis=0), axis=1)))
    n = min(len(traj), len(gt_rel))
    ate = float(np.sqrt(np.mean(np.sum((traj[:n, :2, 3] - gt_rel[:n, :2]) ** 2, axis=1))))
    odo = np.asarray(eng.odom_poses)[:n]
    ate_odo = float(np.sqrt(np.mean(np.sum((odo[:, :2] - gt_rel[:n, :2]) ** 2, axis=1))))
    loops = [(e.prev_idx, e.curr_idx) for e in eng.loops]
    print(f"full-SLAM path: {N_SLAM_SCANS} scans, {eng.num_keyframes} keyframes, "
          f"{n_detect} detecting, {n_icp[0]} candidates verified by ICP, "
          f"{len(loops)} loops accepted {loops}")
    print(f"  launches {launches}, dispatch counts {dict(eng.dispatch_counts)}")
    print(f"  ATE {ate:.4f} m (odometry alone {ate_odo:.4f} m) over a {path:.2f} m "
          f"path; map {len(world_map)} points")
    if eng.num_keyframes != N_SLAM_SCANS:
        raise AssertionError(f"{eng.num_keyframes} keyframes, expected {N_SLAM_SCANS}")
    if launches["cen_peaks"] != N_SLAM_SCANS:
        raise AssertionError(f"K1 launched {launches['cen_peaks']} times")
    if launches["sc_corr"] != n_detect:
        raise AssertionError(f"K2 launched {launches['sc_corr']} times for "
                             f"{n_detect} detecting keyframes")
    if n_icp[0] == 0 or launches["nn_dist"] < 2 * n_icp[0]:
        raise AssertionError(f"K3 launched {launches['nn_dist']} times for "
                             f"{n_icp[0]} verified candidates")
    if len(loops) < MIN_LOOPS or any(j - i <= 30 for i, j in loops):
        raise AssertionError(f"loops {loops}: need >= {MIN_LOOPS}, each spanning > 30")
    if eng.dispatch_counts["pgo_full"] < 1:
        raise AssertionError("no full pose-graph solve ran")
    if not ate < 0.01 * path:
        raise AssertionError(f"ATE {ate} m is not below 1 % of the {path} m path")
    if not (len(world_map) > 0 and np.isfinite(world_map).all() and np.isfinite(traj).all()):
        raise AssertionError("empty or non-finite map or trajectory")

    steps = np.asarray(per_scan[1:]) * 1e3   # scan 0 only seeds the carry
    med = np.median(steps, axis=0)
    print(f"SlamEngine.process, SlamConfig(): median {med[0]:.3f} ms per scan (min "
          f"{steps[:, 0].min():.3f}, max {steps[:, 0].max():.3f}) over {len(steps)} "
          f"scans; medians odometry {med[1]:.3f}, keyframe step {med[2]:.3f}, refine "
          f"{med[3]:.3f} ms; sums odometry {steps[:, 1].sum():.1f}, keyframe step "
          f"{steps[:, 2].sum():.1f}, refine {steps[:, 3].sum():.1f} ms; final "
          f"drain + trajectory {1e3 * final_flush:.1f} ms; host clock after "
          f"synchronize [{name_power}]")
    return launches


def main() -> None:
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name_power = card()
    print(f"card: {name_power}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. the build: one nvcc per source, all started together
    t0 = time.perf_counter()
    for kern in KERNELS:
        kern.LIBRARY.start()
    for kern in KERNELS:
        kern.LIBRARY.load()
    print(f"build: K1, K2, K3 built and loaded in {time.perf_counter() - t0:.2f} s")
    for kern in KERNELS:
        for line in kern.LIBRARY.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {kern.LIBRARY.name}: {line.strip()}")

    # 3. K1 against its twin, full size
    cfg = SlamConfig()
    sim = RadarSimulator(cfg.radar)
    scan = sim.render(np.asarray([5.0, -3.0, 0.7]), noise_seed=3)
    u8 = (np.clip(scan, 0, 1) * 255).astype(np.uint8)
    inputs = {
        "float": torch.as_tensor(scan, device=dev),
        "packed4": decode_power(torch.as_tensor(pack4(u8), device=dev), packed=True),
    }
    k1_err = 0.0
    for label, power in inputs.items():
        print(f"K1 vs twin, {label} input {tuple(power.shape)}:")
        k1_err = max(k1_err, compare_kernel(power, cfg))

    # 4. the odometry path
    gt = sim.circuit_trajectory(N_SCANS)
    scans = [sim.render(gt[i], noise_seed=i) for i in range(N_SCANS)]
    warm = RadarOdometry(cfg, device=dev)
    for s in scans[:3]:
        warm.process(s)
    torch.cuda.synchronize()

    odo = RadarOdometry(cfg, device=dev)
    est, step_s, oks = [], [], []
    cen_peaks.launch_count = 0
    for i, s in enumerate(scans):
        t0 = time.perf_counter()
        pose, _ = odo.process(s)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        est.append(pose)
        if i > 0:
            step_s.append(dt)
            oks.append(odo.last_ok)
    odo_launches = cen_peaks.launch_count
    est = np.asarray(est)
    gt_rel = np.asarray([se2_between_np(gt[0], g) for g in gt])
    ate = float(np.sqrt(np.mean(np.sum((est[:, :2] - gt_rel[:, :2]) ** 2, axis=1))))
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1)))
    n_ok = int(np.sum(oks))
    print(f"odometry path: {N_SCANS} scans, K1 launches {odo_launches}, registration ok "
          f"{n_ok}/{N_SCANS - 1}, ATE {ate:.4f} m over a {path:.2f} m path")
    if odo_launches != N_SCANS:
        raise AssertionError(f"K1 launched {odo_launches} times for {N_SCANS} scans")
    if n_ok < 20:
        raise AssertionError(f"registration ok on only {n_ok} of {N_SCANS - 1} steps")
    if not ate < 0.05 * path:
        raise AssertionError(f"ATE {ate} m is not below 5 % of the {path} m path")
    if not np.isfinite(est).all():
        raise AssertionError("non-finite pose")

    # 5. K1 times
    x = inputs["float"]
    k1_ms, k1_plain, pa, pb = kernel_vs_plain(
        lambda: cen_peaks.cen2019_scores_cuda(x, cfg.features, cfg.radar),
        lambda: cen2019.cen2019_scores(x, cfg.features, cfg.radar))
    step_ms = 1e3 * float(np.median(step_s))
    print(f"K1 cen2019_scores (400, 3456): kernel {k1_ms:.4f} ms, plain twin "
          f"{k1_plain:.4f} ms (halves {pa:.4f} / {pb:.4f}), median of "
          f"{TIMED_RUNS} CUDA-event-timed runs each [{name_power}]")
    print(f"RadarOdometry.process, default config: median {step_ms:.3f} ms per scan "
          f"(min {1e3 * min(step_s):.3f}, max {1e3 * max(step_s):.3f}) over "
          f"{len(step_s)} steps, host clock after synchronize [{name_power}]")

    # 6. K2 against its plain version, full size
    query, bank = sc_inputs(cfg, sim, dev)
    got = sc_corr.sc_shift_distances_cuda(query, bank)
    want = scancontext.sc_shift_distance_matrix_plain(query, bank)
    torch.cuda.synchronize()
    k2_err = float((got - want).abs().max())
    g_row, w_row = int(torch.argmin(got.min(dim=1).values)), int(torch.argmin(want.min(dim=1).values))
    g_shift, w_shift = int(torch.argmin(got[g_row])), int(torch.argmin(want[w_row]))
    live = int((bank.abs().sum(dim=(1, 2)) > 0).sum())
    print(f"K2 vs plain, query (20, 60), bank {tuple(bank.shape)} ({live} rows live): "
          f"max abs err {k2_err:.3g}, best row {g_row} / {w_row}, shift "
          f"{g_shift} / {w_shift}, best distance {float(got[g_row, g_shift]):.4f}")
    if k2_err > SC_ATOL:
        raise AssertionError(f"K2 differs by {k2_err} > {SC_ATOL}")
    if (g_row, g_shift) != (w_row, w_shift):
        raise AssertionError("K2's best row or shift differs from the plain version's")

    # 7. K3 against its plain version at (1024, 8192)
    rng = np.random.default_rng(11)
    src = torch.as_tensor(rng.uniform(-150, 150, (1024, 2)), dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(rng.uniform(-150, 150, (8192, 2)), dtype=torch.float32, device=dev)
    tv = torch.as_tensor(rng.random(8192) >= 0.2, device=dev)
    gd, gi = nn_dist.nearest_neighbors_cuda(src, tgt, tv)
    wd, wi = icp.nearest_neighbors_plain(src, tgt, tv)
    none = torch.zeros_like(tv)
    nd, ni = nn_dist.nearest_neighbors_cuda(src, tgt, none)
    torch.cuda.synchronize()
    k3_err = float((gd - wd).abs().max())
    n_idx = int((gi != wi).sum())
    print(f"K3 vs plain, src (1024, 2), tgt (8192, 2), {int(tv.sum())} valid: "
          f"indices differing {n_idx}, d2 max abs err {k3_err:.3g}; all invalid: "
          f"d2 all inf {bool(torch.isinf(nd).all())}, indices all 0 {bool((ni == 0).all())}")
    if n_idx or k3_err != 0.0:
        raise AssertionError(f"K3 differs: {n_idx} indices, d2 by {k3_err}")
    if not (bool(torch.isinf(nd).all()) and bool((ni == 0).all())):
        raise AssertionError("K3 with no valid target: want inf and index 0")

    # 8. the full-SLAM path
    launches = slam_path(cfg, sim, dev, name_power)

    # 9. K2 and K3 times at the main path's shapes
    k2_ms, k2_plain, pa, pb = kernel_vs_plain(
        lambda: sc_corr.sc_shift_distances_cuda(query, bank),
        lambda: scancontext.sc_shift_distance_matrix_plain(query, bank))
    print(f"K2 sc_shift_distances (20, 60) x {tuple(bank.shape)}: kernel {k2_ms:.4f} ms, "
          f"plain {k2_plain:.4f} ms (halves {pa:.4f} / {pb:.4f}), median of "
          f"{TIMED_RUNS} CUDA-event-timed runs each [{name_power}]")
    k3_ms, k3_plain, pa, pb = kernel_vs_plain(
        lambda: nn_dist.nearest_neighbors_cuda(src, tgt, tv),
        lambda: icp.nearest_neighbors_plain(src, tgt, tv))
    print(f"K3 nearest_neighbors (1024, 2) x (8192, 2): kernel {k3_ms:.4f} ms, plain "
          f"{k3_plain:.4f} ms (halves {pa:.4f} / {pb:.4f}), median of {TIMED_RUNS} "
          f"CUDA-event-timed runs each [{name_power}]")

    if "jax" in sys.modules or any(m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [
        {"name": "cen2019_scores", "route": "cuda",
         "source": "navtech_radar_slam_torch/csrc/cen_peaks.cu",
         "replaces": "navtech_radar_slam_tpu/ops/pallas/cen_peaks.py:121",
         "launches": launches["cen_peaks"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "sc_shift_distances", "route": "cuda",
         "source": "navtech_radar_slam_torch/csrc/sc_corr.cu",
         "replaces": "navtech_radar_slam_tpu/ops/pallas/sc_corr.py:49",
         "launches": launches["sc_corr"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "nearest_neighbors", "route": "cuda",
         "source": "navtech_radar_slam_torch/csrc/nn_dist.cu",
         "replaces": "navtech_radar_slam_tpu/ops/pallas/nn_dist.py:42",
         "launches": launches["nn_dist"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
