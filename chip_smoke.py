#!/usr/bin/env python3
"""Drive the PyTorch port's odometry and full-SLAM paths once on one NVIDIA GPU.

    python3 chip_smoke.py            (from the repository root)

Phases, in order; any failure ends the run with a non-zero exit:

  1. the card: CUDA must be available; prints nvidia-smi's name and power
     limit of the card;
  2. the build: nvcc builds kernels K1, K2 and K3 (navtech_radar_slam_torch/
     csrc/{cen_peaks,sc_corr,nn_dist}.cu; K2-T and K3-T are the T-slot entry
     points of the last two) from this checkout, all three at once, into
     navtech_radar_slam_torch/_build/;
  3. K1 against its plain PyTorch twin on the card, on a full-size simulated
     scan as float input and through the 4-bit wire format: the same peak
     positions and values, exactly;
  4. the odometry path: RadarOdometry at the default config (= configs/
     config1_odometry_only.json) over 24 full-size scans of a circuit, with
     every launch counter reset just before and read just after;
  5. K1's times against its twin, and the per-scan RadarOdometry.process time;
  6. K2 against its plain version (max abs err <= 2e-5, the same best row
     and shift): a query and a (4096, 20, 60) bank of make_scancontext
     descriptors of simulator landmark clouds, 400 rows live and the rest
     zero; a 4096-row bank with every row live (the 400 descriptors, then
     copies of them under seeded circular column rolls with a tenth of
     their cells cleared); its first 1 and 30 rows and 4097 rows; a query
     with five empty columns, and an all-zero query (every distance 1);
  7. K3 against its plain version at (1024, 8192), 20 % of the targets
     invalid, with every target tied across the target chunks, and with
     every target invalid: the same indices and d2, exactly;
  8. K2-T (one launch for T queries) against its plain version (max abs
     err <= 2e-5, the same best row and shift in every slot): 16 queries
     against the 400-live bank and against the all-live bank, 16 queries
     each against its own 10 ring-key candidates (a (16, 10, 20, 60) bank,
     as ring-key mode makes), and T = 1, bit-equal to K2;
  9. K3-T (one launch for T ICP problems) against its plain version: 16
     slots at (1024, 8192) with masks that differ per slot, every target
     tied across the chunks, and T = 1, bit-equal to K3: the same indices
     and d2, exactly;
 10. the full-SLAM path per scan: SlamEngine(SlamConfig()) over 60
     motion-distorted full-size scans of a circuit, every launch counter
     reset just before and read just after; checks the keyframes, K2 once
     per detecting keyframe on the searchable bank prefix (max(keyframes -
     30, 1) rows), K3 at least twice per verified candidate, >= 12 accepted
     loops, a full pose-graph solve, ATE < 1 % of the path and a finite map;
 11. the full-SLAM path streamed: the same 60 scans through begin_chunk /
     finish_chunk, chunks of 16, two in flight, then current_pose(), every
     counter reset just before and read just after; checks 60 keyframes,
     a segment, K2-T once per segment that detects, K3-T once per T-slot
     ICP iteration plus the final fitness, K2 and K3 only for the keyframes
     sent down the per-keyframe path, the same loop, solve and ATE checks,
     and prints its loops beside the per-scan run's;
 12. times: K2 (on the all-live bank), K3, K2-T and K3-T (16 slots) against
     their plain versions, the per-scan SlamEngine.process time split into
     odometry, keyframe step and refine, and the streamed run's time per
     scan beside it;
 13. for each kernel, the device time per launch (CUDA events around 200
     back-to-back launches, the host queued ahead of the card behind a
     sleep kernel), its bound (the larger of the bytes it must move over
     the H100's 3.35 TB/s and its fp32 operations over 67 TFLOP/s, from
     this run's shapes and data), the share of the bound, the launches on
     each path, and the device kernels of one call (torch.profiler): one.
     K2's report is at the 4096-row all-live bank; lines before it give
     K2's device ms and bound at the SLAM run's largest prefix (30 rows)
     and at the 400-live bank, and K2-T's at 16 x 400 rows.  K2-T's report
     is at 16 queries x the 30-row prefix, K3-T's at 16 x (1024, 8192).

The line before the last is the kernel report
{"kernels": [{"name", "route", "source", "replaces", "launches",
"launches_odometry", "launches_slam", "launches_streaming", "max_abs_err",
"ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}]}
("launches": the per-scan full-SLAM path's for K1, K2 and K3, the streamed
path's for K2-T and K3-T; "ms": one wrapper call fenced by CUDA events,
median; "library_ms": null, since no single PyTorch call computes any of
the five functions), the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Scans come from the port's numpy simulator (navtech_radar_slam_torch.data);
nothing here or in the port imports jax or the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from navtech_radar_slam_torch.config import SlamConfig
from navtech_radar_slam_torch.data import RadarSimulator, pack4
from navtech_radar_slam_torch.models import slam as slam_mod
from navtech_radar_slam_torch.models.odometry import RadarOdometry, decode_power
from navtech_radar_slam_torch.ops import cen2019, icp, scancontext
from navtech_radar_slam_torch.ops.kernels import cen_peaks, nn_dist, sc_corr
from navtech_radar_slam_torch.utils.geometry import se2_between_np

N_SCANS = 24
N_SLAM_SCANS = 60
TIMED_RUNS = 30
SC_ATOL = 2e-5       # the JAX suite's bound for the SC distances
MIN_LOOPS = 12       # the JAX engine closes 17 on this circuit (CPU run)
KERNELS = (cen_peaks, sc_corr, nn_dist)
#: every kernel's launch counter: (name, module, counter attribute)
COUNTERS = (("cen_peaks", cen_peaks, "launch_count"), ("sc_corr", sc_corr, "launch_count"),
            ("nn_dist", nn_dist, "launch_count"),
            ("sc_corr_multi", sc_corr, "multi_launch_count"),
            ("nn_dist_multi", nn_dist, "multi_launch_count"))
CHUNK = 16           # scans per chunk of the streamed path
SLOTS = 16           # query slots of the K2-T and K3-T checks and timings
DEVICE_LAUNCHES = 200  # back-to-back launches per device-time reading
# NVIDIA H100 SXM data-sheet peaks (at 700 W): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


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
    # the kernel rounds every map value as the twin does; only the sums behind
    # the row statistics and mean h run in another order, which on these
    # inputs flips no decision
    if n_peaks == 0 or n_diff or err or sym:
        raise AssertionError(f"K1 differs from its twin: {n_diff} of {n_peaks} peak "
                             f"positions, values by {err}, top-k sets in {sym}")
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


def all_live_bank(bank: torch.Tensor, n_live: int) -> torch.Tensor:
    """``bank`` with every row live: rows 0 .. n_live - 1 as they are, each
    later row one of them under a seeded circular column roll with a seeded
    tenth of its cells cleared, so no two rows tie.  Made on the device."""
    rng = np.random.default_rng(17)
    n, nr, ns = bank.shape
    roll = rng.integers(0, ns, n)
    roll[:n_live] = 0
    keep = rng.random((n, nr, ns), dtype=np.float32) >= 0.1
    keep[:n_live] = True
    dev = bank.device
    # np.roll(row, s)[:, c] = row[:, (c - s) mod S]
    col = torch.as_tensor((np.arange(ns)[None, :] - roll[:, None]) % ns, device=dev)
    src = bank[torch.arange(n, device=dev) % n_live]
    return torch.gather(src, 2, col[:, None, :].expand(n, nr, ns)) * torch.as_tensor(
        keep, device=dev)


def check_k2(label: str, query: torch.Tensor, bank: torch.Tensor) -> float:
    """K2 against its plain version: max abs err <= SC_ATOL and the same
    best (row, shift), and every distance 1 for an all-zero query; returns
    the error."""
    got = sc_corr.sc_shift_distances_cuda(query, bank)
    want = scancontext.sc_shift_distance_matrix_plain(query, bank)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ns = bank.shape[2]
    g, w = int(torch.argmin(got)), int(torch.argmin(want))
    row_best = torch.sort(want.min(dim=1).values).values
    runner_up = f"{float(row_best[1]):.5f}" if len(row_best) > 1 else "none"
    print(f"  {label}, bank {tuple(bank.shape)}: max abs err {err:.3g}, best row "
          f"{g // ns} / {w // ns}, shift {g % ns} / {w % ns}, best distance "
          f"{float(row_best[0]):.5f}, next row's {runner_up}")
    if err > SC_ATOL:
        raise AssertionError(f"K2 differs by {err} > {SC_ATOL} ({label})")
    if g != w:
        raise AssertionError(f"K2's best row or shift differs from the plain version's ({label})")
    if not bool(query.any()) and not bool((got == 1).all()):
        raise AssertionError(f"K2 with an all-zero query: want every distance 1 ({label})")
    return err


def reset_counts() -> None:
    for _, mod, attr in COUNTERS:
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, mod, attr in COUNTERS}


def best_per_slot(d: torch.Tensor) -> torch.Tensor:
    """(T, N, S) distances -> each slot's flat argmin (row * S + shift)."""
    return torch.argmin(d.reshape(d.shape[0], -1), dim=1)


def check_k2t(label: str, queries: torch.Tensor, bank: torch.Tensor) -> float:
    """K2-T against its plain version: max abs err <= SC_ATOL and the same
    best (row, shift) in every slot; returns the error."""
    got = sc_corr.sc_shift_distances_multi_cuda(queries, bank)
    want = scancontext.sc_shift_distance_matrix_multi_plain(queries, bank)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    n_diff = int((best_per_slot(got) != best_per_slot(want)).sum())
    print(f"  {label}, queries {tuple(queries.shape)}, bank {tuple(bank.shape)}: max abs "
          f"err {err:.3g}, slots with another best row or shift {n_diff}")
    if err > SC_ATOL:
        raise AssertionError(f"K2-T differs by {err} > {SC_ATOL} ({label})")
    if n_diff:
        raise AssertionError(f"K2-T's best row or shift differs in {n_diff} slots ({label})")
    return err


def ringkey_banks(queries: torch.Tensor, bank: torch.Tensor, k: int) -> torch.Tensor:
    """Each query's k nearest bank rows by ring key, gathered: the
    (T, k, R, S) bank that ring-key mode hands K2-T."""
    d2 = torch.sum((scancontext.ring_key(bank)[None] - scancontext.ring_key(queries)[:, None])
                   ** 2, dim=-1)
    _, cand = scancontext.top_k(-d2, k)
    return bank[cand].contiguous()


def check_k3t(label: str, src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor) -> float:
    """K3-T against its plain version: the same indices and d2, exactly."""
    gd, gi = nn_dist.nearest_neighbors_multi_cuda(src, tgt, valid)
    wd, wi = icp.nearest_neighbors_plain(src, tgt, valid)
    torch.cuda.synchronize()
    both = torch.isfinite(wd)
    err = float((gd[both] - wd[both]).abs().max()) if bool(both.any()) else 0.0
    n_idx = int((gi != wi).sum())
    same_inf = bool(torch.equal(torch.isinf(gd), torch.isinf(wd)))
    print(f"  {label}, src {tuple(src.shape)}, tgt {tuple(tgt.shape)}: indices differing "
          f"{n_idx}, d2 max abs err {err:.3g}, the same +inf entries {same_inf}")
    if n_idx or err != 0.0 or not same_inf:
        raise AssertionError(f"K3-T differs: {n_idx} indices, d2 by {err} ({label})")
    return err


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


def device_ms(launch, n: int = DEVICE_LAUNCHES) -> float:
    """Device time per launch: CUDA events around ``n`` back-to-back
    launches, divided by ``n``, after a warm-up.  A sleep kernel queued
    first keeps the card busy while the host queues all ``n`` launches, so
    the events time the card and not the wrappers' host work; if the start
    event has already fired when the last launch is queued, the host fell
    behind, and the reading is taken again with a longer sleep.  Inputs stay
    in the 50 MB L2 cache between launches."""
    for _ in range(10):
        launch()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            launch()
        end.record()
        host_ahead = not start.query()
        end.synchronize()
        if host_ahead:
            return start.elapsed_time(end) / n
        cycles *= 4
    raise AssertionError("the host never queued the launches ahead of the card")


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(least time in ms, what sets it): the bytes the function must move
    over the HBM rate, or its fp32 operations over the fp32 peak."""
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * n_ops / PEAK_FP32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_per_call(launch) -> list:
    """Device kernels of one wrapper call, (name, count), from torch.profiler;
    empty when the profiler saw no device events."""
    launch()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        launch()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]


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


def slam_scans(sim: RadarSimulator) -> tuple:
    """The full-SLAM paths' 60 motion-distorted scans and ground truth."""
    gt = sim.circuit_trajectory(N_SLAM_SCANS + 1, radius=10.0, speed=6.0)
    return gt, [sim.render(gt[i], noise_seed=i, end_pose=gt[i + 1])
                for i in range(N_SLAM_SCANS)]


def check_slam_result(label: str, eng, gt: np.ndarray) -> tuple:
    """The checks both full-SLAM paths share: keyframes, loops, a full
    solve, ATE < 1 % of the path, a finite map.  Returns (loops, ATE, path
    length, map points, trajectory)."""
    traj = eng.trajectory()
    world_map = eng.aggregate_map()
    gt_rel = np.asarray([se2_between_np(gt[0], g) for g in gt[:N_SLAM_SCANS]])
    path = float(np.sum(np.linalg.norm(np.diff(gt_rel[:, :2], axis=0), axis=1)))
    n = min(len(traj), len(gt_rel))
    ate = float(np.sqrt(np.mean(np.sum((traj[:n, :2, 3] - gt_rel[:n, :2]) ** 2, axis=1))))
    loops = [(e.prev_idx, e.curr_idx) for e in eng.loops]
    if eng.num_keyframes != N_SLAM_SCANS:
        raise AssertionError(f"{label}: {eng.num_keyframes} keyframes, expected {N_SLAM_SCANS}")
    if len(loops) < MIN_LOOPS or any(j - i <= 30 for i, j in loops):
        raise AssertionError(f"{label}: loops {loops}: need >= {MIN_LOOPS}, each spanning > 30")
    if eng.dispatch_counts["pgo_full"] < 1:
        raise AssertionError(f"{label}: no full pose-graph solve ran")
    if not ate < 0.01 * path:
        raise AssertionError(f"{label}: ATE {ate} m is not below 1 % of the {path} m path")
    if not (len(world_map) > 0 and np.isfinite(world_map).all() and np.isfinite(traj).all()):
        raise AssertionError(f"{label}: empty or non-finite map or trajectory")
    return loops, ate, path, len(world_map), traj


def slam_path(cfg: SlamConfig, gt: np.ndarray, scans: list, dev, name_power: str) -> tuple:
    """Phase 10: the full-SLAM path per scan, checked; returns its launches,
    loops and per-scan times (ms)."""
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

    k2_rows = []   # bank rows of each K2 launch
    k2 = sc_corr.sc_shift_distances_cuda

    def recorded_k2(query, bank):
        k2_rows.append(bank.shape[0])
        return k2(query, bank)

    slam_mod.icp_ops.icp_se2 = counted_icp
    sc_corr.sc_shift_distances_cuda = recorded_k2
    per_scan = []
    try:
        reset_counts()
        for i, s in enumerate(scans):
            stage.clear()
            t0 = time.perf_counter()
            eng.process(s, timestamp=i * 0.25)
            torch.cuda.synchronize()
            per_scan.append((time.perf_counter() - t0, stage["odometry"],
                             stage["keyframe"] - stage["refine"], stage["refine"]))
        t0 = time.perf_counter()
        eng.trajectory()
        final_flush = time.perf_counter() - t0
        launches = read_counts()
    finally:
        slam_mod.icp_ops.icp_se2 = icp_se2
        sc_corr.sc_shift_distances_cuda = k2

    c = cfg.scancontext
    detecting = [k + 1 for k in range(eng.num_keyframes)
                 if (k + 1) % c.detect_every_n_keyframes == 0
                 and (k + 1) > c.num_exclude_recent]
    n_detect = len(detecting)
    want_rows = [max(nk - c.num_exclude_recent, 1) for nk in detecting]
    loops, ate, path, n_map, traj = check_slam_result("per-scan path", eng, gt)
    odo = np.asarray(eng.odom_poses)
    gt_rel = np.asarray([se2_between_np(gt[0], g) for g in gt[:len(odo)]])
    ate_odo = float(np.sqrt(np.mean(np.sum((odo[:, :2] - gt_rel[:, :2]) ** 2, axis=1))))
    print(f"full-SLAM path, per scan: {N_SLAM_SCANS} scans, {eng.num_keyframes} keyframes, "
          f"{n_detect} detecting, {n_icp[0]} candidates verified by ICP, "
          f"{len(loops)} loops accepted {loops}")
    print(f"  launches {launches}, dispatch counts {dict(eng.dispatch_counts)}")
    print(f"  K2 bank rows per launch {k2_rows} (searchable prefix, "
          f"max(keyframes - {c.num_exclude_recent}, 1))")
    print(f"  ATE {ate:.4f} m (odometry alone {ate_odo:.4f} m) over a {path:.2f} m "
          f"path; map {n_map} points")
    if launches["cen_peaks"] != N_SLAM_SCANS:
        raise AssertionError(f"K1 launched {launches['cen_peaks']} times")
    if launches["sc_corr"] != n_detect:
        raise AssertionError(f"K2 launched {launches['sc_corr']} times for "
                             f"{n_detect} detecting keyframes")
    if k2_rows != want_rows:
        raise AssertionError(f"K2 scored {k2_rows} bank rows, expected {want_rows}")
    if n_icp[0] == 0 or launches["nn_dist"] < 2 * n_icp[0]:
        raise AssertionError(f"K3 launched {launches['nn_dist']} times for "
                             f"{n_icp[0]} verified candidates")
    if launches["sc_corr_multi"] or launches["nn_dist_multi"]:
        raise AssertionError(f"the per-scan path launched a T-slot kernel: {launches}")

    steps = np.asarray(per_scan[1:]) * 1e3   # scan 0 only seeds the carry
    med = np.median(steps, axis=0)
    print(f"SlamEngine.process, SlamConfig(): median {med[0]:.3f} ms per scan (min "
          f"{steps[:, 0].min():.3f}, max {steps[:, 0].max():.3f}) over {len(steps)} "
          f"scans; medians odometry {med[1]:.3f}, keyframe step {med[2]:.3f}, refine "
          f"{med[3]:.3f} ms; sums odometry {steps[:, 1].sum():.1f}, keyframe step "
          f"{steps[:, 2].sum():.1f}, refine {steps[:, 3].sum():.1f} ms; final "
          f"drain + trajectory {1e3 * final_flush:.1f} ms; host clock after "
          f"synchronize [{name_power}]")
    whole = 1e3 * (sum(x[0] for x in per_scan) + final_flush) / N_SLAM_SCANS
    print(f"  per-scan run: {whole:.3f} ms per scan over the whole run (the "
          f"{N_SLAM_SCANS} process calls and the final drain) [{name_power}]")
    return launches, loops, traj, med[0], whole


def streaming_path(cfg: SlamConfig, gt: np.ndarray, scans: list, dev, name_power: str,
                   per_scan_loops: list, per_scan_traj: np.ndarray) -> tuple:
    """Phase 11: the same scans through begin_chunk / finish_chunk, chunks of
    CHUNK scans, two in flight; returns its launches, loops, the median ms
    per scan of its chunk steps and its whole-run ms per scan."""
    eng = slam_mod.SlamEngine(cfg, device=dev)
    c = cfg.scancontext
    per_kf = [0, 0]      # keyframes sent down the per-keyframe path, detecting ones
    add_keyframe = eng._add_keyframe

    def counted_add(*args, **kwargs):
        k = eng.num_keyframes
        per_kf[0] += 1
        per_kf[1] += bool(eng.cfg.do_slam and (k + 1) % c.detect_every_n_keyframes == 0
                          and (k + 1) > c.num_exclude_recent)
        return add_keyframe(*args, **kwargs)

    segments = [0, 0]    # segments, segments that detect
    get_segment = eng._get_segment

    def counted_segment(tp, with_detect):
        segments[0] += 1
        segments[1] += bool(with_detect)
        return get_segment(tp, with_detect)

    icp_calls = []       # K3-T calls of each T-slot ICP
    icp_multi, nn_multi = slam_mod.icp_ops.icp_se2_multi, icp.nearest_neighbors_multi

    def counted_icp_multi(*args, **kwargs):
        icp_calls.append(0)
        return icp_multi(*args, **kwargs)

    def counted_nn_multi(*args, **kwargs):
        icp_calls[-1] += 1
        return nn_multi(*args, **kwargs)

    n_icp = [0]
    icp_se2 = slam_mod.icp_ops.icp_se2

    def counted_icp(*args, **kwargs):
        n_icp[0] += 1
        return icp_se2(*args, **kwargs)

    # the keyframe work: segments, per-keyframe steps, refines (each call
    # fenced by synchronize, as in the per-scan path's split)
    stage = defaultdict(float)
    eng._add_keyframe = timed(stage, "keyframe", counted_add)
    eng._get_segment = counted_segment
    eng._dispatch_segment = timed(stage, "segment", eng._dispatch_segment)
    eng._refine_graph = timed(stage, "refine", eng._refine_graph)
    slam_mod.icp_ops.icp_se2_multi, icp.nearest_neighbors_multi = counted_icp_multi, counted_nn_multi
    slam_mod.icp_ops.icp_se2 = counted_icp
    steps = []
    try:
        torch.cuda.synchronize()
        reset_counts()
        t_run = time.perf_counter()
        for c0 in range(0, N_SLAM_SCANS, CHUNK):
            t0 = time.perf_counter()
            chunk = np.stack(scans[c0:c0 + CHUNK])
            eng.begin_chunk(chunk, timestamps=[i * 0.25 for i in range(c0, c0 + len(chunk))])
            if eng.inflight_chunks >= 2:
                eng.finish_chunk()
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - t0) / len(chunk))
        eng.current_pose()
        torch.cuda.synchronize()
        whole = 1e3 * (time.perf_counter() - t_run) / N_SLAM_SCANS
        launches = read_counts()
    finally:
        slam_mod.icp_ops.icp_se2_multi, icp.nearest_neighbors_multi = icp_multi, nn_multi
        slam_mod.icp_ops.icp_se2 = icp_se2
    loops, ate, path, n_map, traj = check_slam_result("streamed path", eng, gt)
    print(f"full-SLAM path, streamed in chunks of {CHUNK}, two in flight: {eng.num_keyframes} "
          f"keyframes, {segments[0]} segments ({segments[1]} detecting), {per_kf[0]} "
          f"keyframes on the per-keyframe path ({per_kf[1]} detecting), {n_icp[0]} of them "
          f"verified by ICP, T-slot ICPs {len(icp_calls)} with K3-T calls {icp_calls}, "
          f"{len(loops)} loops accepted {loops}")
    print(f"  launches {launches}, dispatch counts {dict(eng.dispatch_counts)}")
    print(f"  ATE {ate:.4f} m over a {path:.2f} m path; map {n_map} points; keyframe "
          f"positions differ from the per-scan run's by at most "
          f"{float(np.abs(traj[:, :2, 3] - per_scan_traj[:, :2, 3]).max()):.3g} m")
    only_stream = sorted(set(loops) - set(per_scan_loops))
    only_scan = sorted(set(per_scan_loops) - set(loops))
    print(f"  loops streamed vs per scan: only streamed {only_stream}, only per scan "
          f"{only_scan}, common {len(set(loops) & set(per_scan_loops))}")
    if eng.dispatch_counts["kf_segment"] < 1 or segments[0] != eng.dispatch_counts["kf_segment"]:
        raise AssertionError(f"{segments[0]} segments, dispatch counts "
                             f"{dict(eng.dispatch_counts)}")
    if launches["sc_corr_multi"] != segments[1]:
        raise AssertionError(f"K2-T launched {launches['sc_corr_multi']} times for "
                             f"{segments[1]} detecting segments")
    if len(icp_calls) != segments[1] or launches["nn_dist_multi"] != sum(icp_calls):
        raise AssertionError(f"K3-T launched {launches['nn_dist_multi']} times, the "
                             f"T-slot ICPs called it {icp_calls}")
    if any(n > cfg.icp.max_iters + 1 for n in icp_calls):
        raise AssertionError(f"a T-slot ICP called K3-T more than max_iters + 1 times")
    if launches["sc_corr"] != per_kf[1]:
        raise AssertionError(f"K2 launched {launches['sc_corr']} times for {per_kf[1]} "
                             f"detecting keyframes on the per-keyframe path")
    if launches["nn_dist"] < 2 * n_icp[0] or (n_icp[0] == 0 and launches["nn_dist"]):
        raise AssertionError(f"K3 launched {launches['nn_dist']} times for {n_icp[0]} "
                             f"per-keyframe candidates")
    if launches["cen_peaks"] != N_SLAM_SCANS + 1:
        # scan 0 seeds the carry and then registers against itself in chunk 0
        raise AssertionError(f"K1 launched {launches['cen_peaks']} times")
    med = float(np.median(steps))
    print(f"SlamEngine streamed (begin_chunk / finish_chunk), SlamConfig(): median "
          f"{med:.3f} ms per scan over its {len(steps)} chunk steps {['%.3f' % x for x in steps]}, "
          f"{whole:.3f} ms per scan over the whole run with the final drain; sums "
          f"segments {1e3 * stage['segment']:.1f}, per-keyframe steps "
          f"{1e3 * stage['keyframe']:.1f}, refine (all) {1e3 * stage['refine']:.1f} ms; host "
          f"clock after synchronize [{name_power}]")
    return launches, loops, med, whole


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
    reset_counts()
    for i, s in enumerate(scans):
        t0 = time.perf_counter()
        pose, _ = odo.process(s)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        est.append(pose)
        if i > 0:
            step_s.append(dt)
            oks.append(odo.last_ok)
    odo_launches = read_counts()
    est = np.asarray(est)
    gt_rel = np.asarray([se2_between_np(gt[0], g) for g in gt])
    ate = float(np.sqrt(np.mean(np.sum((est[:, :2] - gt_rel[:, :2]) ** 2, axis=1))))
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1)))
    n_ok = int(np.sum(oks))
    print(f"odometry path: {N_SCANS} scans, launches {odo_launches}, registration ok "
          f"{n_ok}/{N_SCANS - 1}, ATE {ate:.4f} m over a {path:.2f} m path")
    if odo_launches["cen_peaks"] != N_SCANS:
        raise AssertionError(f"K1 launched {odo_launches['cen_peaks']} times for "
                             f"{N_SCANS} scans")
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

    # 6. K2 against its plain version
    query, bank = sc_inputs(cfg, sim, dev)
    t0 = time.perf_counter()
    live_bank = all_live_bank(bank, 400)
    torch.cuda.synchronize()
    print(f"K2 vs plain, query (20, 60); all-live bank made in "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms:")
    hollow = query.clone()
    hollow[:, 5:10] = 0.0
    k2_err = max(
        check_k2("400 live, 3696 zero", query, bank),
        check_k2("all live", query, live_bank),
        check_k2("first row", query, live_bank[:1]),
        check_k2("first 30 rows", query, live_bank[:30]),
        check_k2("4097 rows", query, torch.cat([live_bank, live_bank[-1:].flip(1)])),
        check_k2("query with 5 empty columns", hollow, live_bank),
        check_k2("all-zero query", torch.zeros_like(query), live_bank),
    )

    # 7. K3 against its plain version at (1024, 8192)
    rng = np.random.default_rng(11)
    src = torch.as_tensor(rng.uniform(-150, 150, (1024, 2)), dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(rng.uniform(-150, 150, (8192, 2)), dtype=torch.float32, device=dev)
    tv = torch.as_tensor(rng.random(8192) >= 0.2, device=dev)
    gd, gi = nn_dist.nearest_neighbors_cuda(src, tgt, tv)
    wd, wi = icp.nearest_neighbors_plain(src, tgt, tv)
    none = torch.zeros_like(tv)
    nd, ni = nn_dist.nearest_neighbors_cuda(src, tgt, none)
    # ties: the first 1024 targets repeated in each of the eight chunks (one
    # per cluster rank), so every minimum is tied; the first valid one wins
    rep = tgt[:1024].repeat(8, 1)
    td, ti = nn_dist.nearest_neighbors_cuda(src, rep, tv)
    pd, pi = icp.nearest_neighbors_plain(src, rep, tv)
    torch.cuda.synchronize()
    k3_err = max(float((gd - wd).abs().max()), float((td - pd).abs().max()))
    n_idx = int((gi != wi).sum())
    n_tie = int((ti != pi).sum())
    print(f"K3 vs plain, src (1024, 2), tgt (8192, 2), {int(tv.sum())} valid: "
          f"indices differing {n_idx}, with every target tied across the chunks "
          f"{n_tie}, d2 max abs err {k3_err:.3g}; all invalid: "
          f"d2 all inf {bool(torch.isinf(nd).all())}, indices all 0 {bool((ni == 0).all())}")
    if n_idx or n_tie or k3_err != 0.0:
        raise AssertionError(f"K3 differs: {n_idx} + {n_tie} indices, d2 by {k3_err}")
    if not (bool(torch.isinf(nd).all()) and bool((ni == 0).all())):
        raise AssertionError("K3 with no valid target: want inf and index 0")

    # 8. K2-T against its plain version
    rng = np.random.default_rng(23)
    picks = np.concatenate([[0], rng.choice(np.arange(400, live_bank.shape[0]), SLOTS - 1,
                                            replace=False)])
    queries = torch.cat([query[None], live_bank[torch.as_tensor(picks[1:], device=dev)]])
    ring_banks = ringkey_banks(queries, live_bank, 10)
    prefix = live_bank[:30]   # the SLAM run's largest searchable prefix
    print("K2-T vs plain (one launch for all slots):")
    k2t_err = max(
        check_k2t("400 live, 3696 zero", queries, bank),
        check_k2t("all live", queries, live_bank),
        check_k2t("30-row prefix", queries, prefix),
        check_k2t("per-slot ring-key candidates", queries, ring_banks),
    )
    one = sc_corr.sc_shift_distances_multi_cuda(query[None], live_bank)[0]
    single = sc_corr.sc_shift_distances_cuda(query, live_bank)
    torch.cuda.synchronize()
    print(f"  T = 1 against K2 on the all-live bank: bit-equal {bool(torch.equal(one, single))}")
    if not torch.equal(one, single):
        raise AssertionError("K2-T with one slot is not bit-equal to K2")

    # 9. K3-T against its plain version: 16 slots at (1024, 8192)
    src_t = torch.as_tensor(rng.uniform(-150, 150, (SLOTS, 1024, 2)), dtype=torch.float32,
                            device=dev)
    tgt_t = torch.as_tensor(rng.uniform(-150, 150, (SLOTS, 8192, 2)), dtype=torch.float32,
                            device=dev)
    # masks that differ per slot: a slot's share of invalid targets from 0 to 0.9
    tv_t = torch.as_tensor(rng.random((SLOTS, 8192)) >= np.linspace(0, 0.9, SLOTS)[:, None],
                           device=dev)
    print("K3-T vs plain (one launch for all slots):")
    k3t_err = max(
        check_k3t("masks differing per slot", src_t, tgt_t, tv_t),
        check_k3t("every target tied across the chunks", src_t,
                  tgt_t[:, :1024].repeat(1, 8, 1), tv_t),
    )
    od, oi = nn_dist.nearest_neighbors_multi_cuda(src[None], tgt[None], tv[None])
    sd, si = nn_dist.nearest_neighbors_cuda(src, tgt, tv)
    torch.cuda.synchronize()
    same = bool(torch.equal(od[0], sd) and torch.equal(oi[0], si))
    print(f"  T = 1 against K3 at (1024, 8192): bit-equal {same}")
    if not same:
        raise AssertionError("K3-T with one problem is not bit-equal to K3")

    # 10. the full-SLAM path, per scan
    gt_slam, slam_scan_list = slam_scans(sim)
    launches, scan_loops, scan_traj, scan_med, scan_whole = slam_path(
        cfg, gt_slam, slam_scan_list, dev, name_power)

    # 11. the full-SLAM path, streamed
    stream_launches, _, stream_med, stream_whole = streaming_path(
        cfg, gt_slam, slam_scan_list, dev, name_power, scan_loops, scan_traj)
    print(f"full SLAM, ms per scan: per-scan median {scan_med:.3f} / whole run "
          f"{scan_whole:.3f}, streamed median {stream_med:.3f} / whole run "
          f"{stream_whole:.3f}; one call, host clock [{name_power}]")

    # 12. kernel times at the main path's shapes
    for label, b in (("30 rows", prefix), ("all live", live_bank)):
        k2_ms, k2_plain, pa, pb = kernel_vs_plain(
            lambda: sc_corr.sc_shift_distances_cuda(query, b),
            lambda: scancontext.sc_shift_distance_matrix_plain(query, b))
        print(f"K2 sc_shift_distances (20, 60) x {tuple(b.shape)} ({label}): kernel "
              f"{k2_ms:.4f} ms, plain {k2_plain:.4f} ms (halves {pa:.4f} / {pb:.4f}), "
              f"median of {TIMED_RUNS} CUDA-event-timed runs each [{name_power}]")
    k3_ms, k3_plain, pa, pb = kernel_vs_plain(
        lambda: nn_dist.nearest_neighbors_cuda(src, tgt, tv),
        lambda: icp.nearest_neighbors_plain(src, tgt, tv))
    print(f"K3 nearest_neighbors (1024, 2) x (8192, 2): kernel {k3_ms:.4f} ms, plain "
          f"{k3_plain:.4f} ms (halves {pa:.4f} / {pb:.4f}), median of {TIMED_RUNS} "
          f"CUDA-event-timed runs each [{name_power}]")
    k2t_ms, k2t_plain, pa, pb = kernel_vs_plain(
        lambda: sc_corr.sc_shift_distances_multi_cuda(queries, prefix),
        lambda: scancontext.sc_shift_distance_matrix_multi_plain(queries, prefix))
    print(f"K2-T sc_shift_distances_multi {tuple(queries.shape)} x {tuple(prefix.shape)}: "
          f"kernel {k2t_ms:.4f} ms, plain {k2t_plain:.4f} ms (halves {pa:.4f} / {pb:.4f}), "
          f"median of {TIMED_RUNS} CUDA-event-timed runs each [{name_power}]")
    k3t_ms, k3t_plain, pa, pb = kernel_vs_plain(
        lambda: nn_dist.nearest_neighbors_multi_cuda(src_t, tgt_t, tv_t),
        lambda: icp.nearest_neighbors_plain(src_t, tgt_t, tv_t))
    print(f"K3-T nearest_neighbors_multi {tuple(src_t.shape)} x {tuple(tgt_t.shape)}: "
          f"kernel {k3t_ms:.4f} ms, plain {k3t_plain:.4f} ms (halves {pa:.4f} / {pb:.4f}), "
          f"median of {TIMED_RUNS} CUDA-event-timed runs each [{name_power}]")

    # 13. device time per launch against the bound, at the main path's shapes
    fc = cfg.features
    na, nbp = x.shape
    ntaps = cen2019.smoothing_taps(fc).numel()
    n_valid = int(tv.sum())
    nq, nt = src.shape[0], tgt.shape[0]

    def k2_work(b: torch.Tensor) -> tuple:
        # query and bank read once, (N, S) distances written once; two
        # operations per cell and shift (the cosine mass), three per
        # cell for the column norms
        n_rows, nr, ns = b.shape
        return (4 * (nr * ns + n_rows * nr * ns + n_rows * ns),
                2 * n_rows * nr * ns * ns + 3 * n_rows * nr * ns)

    def k2t_work(q: torch.Tensor, b: torch.Tensor) -> tuple:
        # the T queries and the bank (shared or per slot) read once, (T, N,
        # S) written once; two operations per slot, row, cell and shift,
        # three per cell of the bank and the queries for the column norms
        t_slots, nr, ns = q.shape
        n_rows = b.shape[-3]
        bank_rows = b.numel() // (nr * ns)
        return (4 * (t_slots * nr * ns + bank_rows * nr * ns + t_slots * n_rows * ns),
                2 * t_slots * n_rows * nr * ns * ns + 3 * (bank_rows + t_slots) * nr * ns)

    for label, b in (("30 rows, the SLAM run's largest prefix", prefix),
                     ("400 live, 3696 zero", bank)):
        b_ms, b_by = bound(*k2_work(b))
        dev_ms = device_ms(lambda: sc_corr.sc_shift_distances_cuda(query, b))
        print(f"sc_shift_distances at {tuple(b.shape)} ({label}, variant "
              f"{sc_corr.launch_geometry(b.shape[0])[0]}): device {dev_ms:.5f} ms per "
              f"launch, bound {1e3 * b_ms:.3f} us by {b_by}, share {b_ms / dev_ms:.4f} "
              f"[{name_power}]")
    for label, b in (("400 live, 3696 zero", bank), ("per-slot ring-key candidates",
                                                      ring_banks)):
        b_ms, b_by = bound(*k2t_work(queries, b))
        dev_ms = device_ms(lambda: sc_corr.sc_shift_distances_multi_cuda(queries, b))
        print(f"sc_shift_distances_multi {tuple(queries.shape)} x {tuple(b.shape)} ({label}): "
              f"device {dev_ms:.5f} ms per launch, bound {1e3 * b_ms:.3f} us by {b_by}, "
              f"share {b_ms / dev_ms:.4f} [{name_power}]")
    n_valid_t = int(tv_t.sum())
    specs = {
        # name: (launch, bytes moved, fp32 operations, ms, plain ms, max abs
        # err, counter, source, TPU kernel)
        "cen2019_scores": (
            lambda: cen_peaks.cen2019_scores_cuda(x, fc, cfg.radar),
            # the scan read once, the map written once; per pixel 2 per tap
            # of the range smoothing, 3 for the gradient, 5 for the azimuth
            # smoothing, 1 division, 3 for h, 4 for the row mean and
            # variance, 1 for the whole-scan sum of h
            8 * na * nbp, na * nbp * (2 * ntaps + 17),
            k1_ms, k1_plain, k1_err, "cen_peaks", "cen_peaks", "cen_peaks.py:121"),
        "sc_shift_distances": (
            lambda: sc_corr.sc_shift_distances_cuda(query, live_bank),
            *k2_work(live_bank),
            k2_ms, k2_plain, k2_err, "sc_corr", "sc_corr", "sc_corr.py:49"),
        "nearest_neighbors": (
            lambda: nn_dist.nearest_neighbors_cuda(src, tgt, tv),
            # src, tgt and the mask read once, (d2, int64 index) written
            # once; 5 operations (2 sub, 2 mul, 1 add) per query and VALID
            # target, as this run's data needs
            8 * nq + 9 * nt + 12 * nq, 5 * nq * n_valid,
            k3_ms, k3_plain, k3_err, "nn_dist", "nn_dist", "nn_dist.py:42"),
        "sc_shift_distances_multi": (
            lambda: sc_corr.sc_shift_distances_multi_cuda(queries, prefix),
            *k2t_work(queries, prefix),
            k2t_ms, k2t_plain, k2t_err, "sc_corr_multi", "sc_corr", "sc_corr.py:49"),
        "nearest_neighbors_multi": (
            lambda: nn_dist.nearest_neighbors_multi_cuda(src_t, tgt_t, tv_t),
            # K3's count per slot: each slot's valid targets
            SLOTS * (8 * nq + 9 * nt + 12 * nq), 5 * nq * n_valid_t,
            k3t_ms, k3t_plain, k3t_err, "nn_dist_multi", "nn_dist", "nn_dist.py:42"),
    }
    report = []
    for name, (launch, n_bytes, n_ops, ms, plain, err, counter, src_name,
               tpu) in specs.items():
        odo_n = odo_launches.get(counter, 0)
        dev_ms = device_ms(launch)
        b_ms, b_by = bound(n_bytes, n_ops)
        per_call = kernels_per_call(launch)
        main = stream_launches if counter.endswith("_multi") else launches
        print(f"{name}: device {dev_ms:.5f} ms per launch (CUDA events over "
              f"{DEVICE_LAUNCHES} back-to-back launches), bound {1e3 * b_ms:.3f} us by "
              f"{b_by} ({n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.2f} Mop), share "
              f"{b_ms / dev_ms:.4f}; wrapper-inclusive {ms:.4f} ms; launches odometry "
              f"{odo_n}, SLAM per scan {launches[counter]}, streamed "
              f"{stream_launches[counter]}; device kernels per call: "
              f"{', '.join(f'{k} x{c}' for k, c in per_call) or 'not measured (no device events)'}"
              f" [{name_power}]")
        if per_call and sum(c for _, c in per_call) != 1:
            raise AssertionError(f"{name}: one call ran {per_call}, expected one kernel")
        if main[counter] == 0:
            raise AssertionError(f"{name}: no launch on its main path")
        report.append({
            "name": name, "route": "cuda",
            "source": f"navtech_radar_slam_torch/csrc/{src_name}.cu",
            "replaces": f"navtech_radar_slam_tpu/ops/pallas/{tpu}",
            "launches": main[counter], "launches_odometry": odo_n,
            "launches_slam": launches[counter], "launches_streaming": stream_launches[counter],
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })

    if "jax" in sys.modules or any(m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    if any(m.startswith("navtech_radar_slam_tpu") for m in sys.modules):
        raise AssertionError("a module of the JAX package was imported")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
