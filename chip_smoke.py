#!/usr/bin/env python3
"""Drive the PyTorch port's odometry, batched-odometry and full-SLAM paths,
its command line, its multi-device layer, and its SCManager interface and
Cartesian utilities once on one NVIDIA GPU.

    python3 chip_smoke.py            (from the repository root)

Phases, in order; any failure ends the run with a non-zero exit:

  1. the card: CUDA must be available; prints nvidia-smi's name and power
     limit of the card;
  2. the build: nvcc builds kernels K1, K2 and K3 (navtech_radar_slam_torch/
     csrc/{cen_peaks,sc_corr,nn_dist}.cu; K1 x B is an entry point of the
     first, K2-T and K3-T the T-slot entry points of the last two) from this
     checkout, all three at once, into navtech_radar_slam_torch/_build/;
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
     as ring-key mode makes), and T = 1, bit-equal to K2; then 16 queries
     on one shared bank (all 4096 rows live, its first 400 and 30 rows) at
     the host's query slots a block, every slot bit-equal to K2 for that
     query;
  9. K3-T (one launch for T ICP problems) against its plain version: 16
     slots at (1024, 8192) with masks that differ per slot, every target
     tied across the chunks, and with its slot mask: half the slots masked
     off, every slot masked off, and valid targets a prefix of each slot
     (as submaps pack them) with half the slots masked off; and T = 1,
     bit-equal to K3: the same indices and d2, exactly;
 10. the full-SLAM path per scan: SlamEngine(SlamConfig()) over 60
     motion-distorted full-size scans of a circuit, every launch counter
     reset just before and read just after; checks the keyframes, K2 once
     per detecting keyframe on the searchable bank prefix (max(keyframes -
     30, 1) rows), K3 at least twice per verified candidate, >= 12 accepted
     loops, a full pose-graph solve, ATE < 1 % of the path and a finite map;
     prints each full pose-graph solve's ms and, on the final graph, one
     CG matvec of its normal equations: its device launches (a CUDA graph
     capture; fails at 100 or more; the earlier double-vjp matvec took
     1206), its device ms (replays of the capture) and eager ms, and the
     once-per-GN-step linearization's;
 11. the full-SLAM path streamed: the same 60 scans through begin_chunk /
     finish_chunk, chunks of 16, two in flight, then current_pose(), every
     counter reset just before and read just after; checks 60 keyframes,
     a segment, K2-T once per segment that detects, K3-T once per T-slot
     ICP iteration plus the final fitness, K2 and K3 only for the keyframes
     sent down the per-keyframe path, the same loop, solve and ATE checks,
     and prints its loops beside the per-scan run's, each full solve's ms,
     and its K3-T launches replayed from their recorded inputs: the slots
     each computed and their valid targets, the device ms summed over the
     launches as run and with every slot computed, beside the earlier
     design's (every slot and pair at 0.07130 ms a launch, PERF.md), and
     the valid pairs' bound and instruction floor;
 12. K1 x B (one launch for B scans) against its plain version, exactly
     (the same peak positions and values in every scan), in the design the
     host picks for B (resident below cen_peaks.STREAM_MIN_SCANS, streamed
     from there): B = 1, bit-equal to K1; B = 2, 3, 5 (with a scan through
     the 4-bit wire format and an all-zero one), 33; B = 64 full-size scans
     (the 60 of the SLAM paths and 4 of the odometry path), one of them
     through the 4-bit wire format and one all zero (no peak), each scan
     bit-equal to K1 on that scan;
 13. the batched odometry path: make_batched_odometry_step at the default
     config, B = 64 streams over 8 steps, stream b stepping through scans
     o_b .. o_b + 8 of the odometry path's 24 (o_b = b % 16), seeded by the
     batched extraction, every counter reset just before the seed and read
     after the 8th step (K1 x B once per step plus once for the seed, K1
     never); checks each stream's ok (at least 7 of 8) and composed pose
     against the ground truth (ATE < 5 % of its path), and each stream
     against RadarOdometry run on that stream alone (the same ok, rel_pose
     within 1e-3 m / 1e-4 rad), and, on the first step's matches, each
     stream's spectral scores under torch.func.vmap bit-equal to that
     stream's alone; the 64 streams in one step against the same streams
     in two steps of 32 (as two mesh ranks run them), every leaf of the
     seed and the step bit-equal (rel_pose, ok and the de-skewed xy among
     them), and on a difference the first op whose inputs agree and whose
     outputs differ, recorded op by op; then two more timed windows, and prints the
     aggregate frames/s and the median, min and max step ms;
 14. the command line, navtech_radar_slam_torch.cli.main, in this process on
     MulRan sequences that the port's make_sequence writes into a temporary
     directory (the JAX rehearsal: 70 motion-distorted full-size scans of
     circuit_trajectory(71, radius=12.0, speed=6.0), 1.4 laps, with gps.csv;
     and 20 scans of the same circuit with other noise, seed=5).  First the
     native scan loader (navtech_radar_slam_torch/runtime/src/
     radar_loader.cc): g++ builds it (the command line and its time are
     printed), and the 70 scans are read through decode_png_native, through
     NativeRadarLoader(raw_u8=True, num_workers=2) and with the Python
     decoder (data/png.py + decode_polar_scan), every array equal across the
     three; prints the median, min and max ms per scan of the two decoders
     on one thread, taken in turns.  Every CLI call must read with the
     native loader (the banner's "native loader"), and prints the wait in
     NativeRadarLoader.__next__ per scan and each full pose-graph solve's
     ms (prewarm's excluded).  Every counter is reset just before
     each CLI call and read just after.  (a) --chunk 16 --prewarm true
     --pack4 true --checkpoint_every 35 --loop_debug_dir --use_gps true
     --live true on the 70 scans at SlamConfig(): 70 scans, no odometry
     failure, a first loop spanning more than 40 keyframes, stats.json's loop
     count equal to final.npz's, ATE (the CLI's own evaluation against
     global_pose.csv) under 1 % of the path, the outputs and an accepted loop
     dump written, and outside prewarm K1 at least once per scan and K2-T and
     K3-T at least once; prints prewarm's seconds, stats.json's rates, the
     CLI's StageTimers report and the wall ms per scan.  (b) --resume from
     the run's first checkpoint: 70 scans at the end, at least the
     checkpoint's keyframes.  (c) per scan, --prior_session on (a)'s
     final.npz, the 20 scans: an inter-session loop, rebased, and the second
     session's keyframes within 1.5 m on average of their ground truth in
     the first session's frame.  Then the three calls' K3-T launches
     (prewarm's included) replayed as phase 11's are, with how many computed
     slots had fewer valid targets than the submap holds;
 15. the multi-device layer (navtech_radar_slam_torch/parallel/): one
     NCCL all_reduce and all_gather through the port's Mesh at world size
     1 (with NCCL's version), and what NCCL says to two ranks on cuda:0
     (refused: "Duplicate GPU"); then 2 gloo ranks on cuda:0 started by
     parallel.launch (CUDA tensors copied through the host), on full-size
     inputs, each held against the single-device path on the same inputs,
     every rank's result equal: the sharded search (full and ring-key, T =
     1 and 16, at 2048 and 8192 bank rows a rank; idx equal to the
     single-device K2-T search, dist within 2e-5), one distributed solve at
     1024 x 2 nodes from poses ~0.1 m off the odometry chain (positions
     within 5e-2 m of the single-device solve, which must move them 10x
     that), the sharded odometry step at B = 64 (32 streams a rank, one
     K1 x 32 launch a step; every leaf bit-equal to the one-device step on
     the rank's streams and to the same streams of the 64-stream step), and the
     mesh engine streamed over the 60 SLAM scans at SlamConfig() (every
     counter reset just before and read just after; the streamed run's
     loops within the band, positions within 0.1 m, ATE < 1 % of the
     path).  Prints each rank's K2-T device ms (and the earlier design's, one
     query slot a block), the collectives' ms, the
     solve's ms, the engine's ms per scan and the bank bytes per rank;
 16. times: K2 (on the all-live bank), K3, K2-T (16 slots, on the 30-row
     prefix and on the all-live bank), K3-T (16 slots) and K1 x B
     (B = 64) against their plain versions, the per-scan SlamEngine.process
     time split into odometry, keyframe step and refine, and the streamed
     run's time per scan beside it;
 17. for each kernel, the device time per launch (CUDA events around 200
     back-to-back launches, the host queued ahead of the card behind a
     sleep kernel), its bound (the larger of the bytes it must move over
     the H100's 3.35 TB/s and its fp32 operations over 67 TFLOP/s, from
     this run's shapes and data), the share of the bound, the launches on
     each path, and the device work of one call, read from a CUDA graph
     capture of the call: exactly one kernel node and nothing else.
     K2's report is at the 4096-row all-live bank; lines before it give
     K2's device ms and bound at the SLAM run's largest prefix (30 rows)
     and at the 400-live bank, K2-T's at 16 x 400 rows, and K3-T's with
     half the slots masked off; then K1 x B at B = 1, 8, 32 and 64 and K2-T
     on a shared bank of 30, 400 and 4096 rows, each in this run's design
     and in the earlier one (the resident K1 x B; K2-T with one query slot
     a block), with bound and share.  K3 and K3-T print an instruction floor
     beside the bound (their 5 operations a pair are separate FSUB / FMUL
     / FADD, issued at half the FMA-counted peak), and K3-T the earlier
     design's time, as K2-T and K1 x B do (EARLIER_K2T_MS, EARLIER_K1B_MS).
     K2-T's report
     is at 16 queries x the 30-row prefix, K3-T's at 16 x (1024, 8192)
     with every slot computed,
     K1 x B's at the 64 scans of phase 12.  Last, one RadarOdometry step
     and one batched step under torch.profiler: wall ms, device kernels,
     the device's busy ms and share, and the step's one K1 (K1 x B)
     kernel as the trace holds it, as a share of the busy time and of the
     wall, beside its device ms above (or that the trace holds none);
 18. outside the engine: (a) polar_to_cartesian of phase 3's scan to the
     512 x 512 image at 0.5 m and patch_descriptors at that scan's 1024
     features (extract_scan_features' xy), on the card and on CPU copies
     of the same inputs: max abs err <= 1e-4 and the same zeros, with the
     median ms of each on the card; (b) ScanContextManager(capacity=4096)
     on the card (created without device=) fed the 400 landmark clouds of
     phase 6's bank, a detectLoopClosureID after every insert from the
     31st, in "full" and in "ringkey" mode, a CPU manager fed the same
     clouds beside each: every (index, yaw) equal, and per insert no host
     sync (torch.cuda.set_sync_debug_mode) and no K2 launch, per detect
     one of each; a second session of 60 clouds within 0.5 m / 0.5 rad of
     60 of those poses, descriptors made on the card and saved with
     saveScancontextAndKeys, each queried through the first manager's
     detectLoopClosureIDBetweenSession, equal to the CPU manager's answer
     (prints how many found a loop, and how many at the row drawn near);
     (c) detect_loop_between_sessions on the all-live bank at 0, 1, 400 and
     4096 valid rows against the plain version (the same index, found flag
     and yaw, dist within 2e-5), one K2 launch on max(n, 1) rows each, and
     the 4096-row call's median ms and, from the profiler's trace of one
     call, its device kernels, busy ms and K2 kernel ms beside K2's device
     ms from phase 17.  Every
     counter is reset before (b) and read after (c): K2 once per detect,
     query and call, nothing else.

The line before the last is the kernel report
{"kernels": [{"name", "route", "source", "replaces", "launches",
"launches_odometry", "launches_slam", "launches_streaming",
"launches_batched", "launches_cli", "launches_mesh", "launches_sc_manager",
"max_abs_err", "ms", "device_ms",
"plain_ms", "bound_ms", "bound_by", "library_ms"}]} ("launches": the
per-scan full-SLAM path's for K1, K2 and K3, the streamed path's for K2-T
and K3-T, the batched odometry path's for K1 x B; "launches_cli": the sum
over phase 14's three CLI calls, prewarm included; "launches_mesh": phase
15's mesh paths (search, odometry, engine), summed over the ranks;
"launches_sc_manager": phase 18's (b) and (c); "ms": one
wrapper call fenced by
CUDA events, median; "library_ms": null, since no single PyTorch call
computes any of the six functions), the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Scans come from the port's numpy simulator (navtech_radar_slam_torch.data);
nothing here or in the port imports jax or the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
import collections
from collections import defaultdict

import numpy as np
import torch
import torch.utils._python_dispatch
import torch.utils._pytree

from navtech_radar_slam_torch.config import SlamConfig
from navtech_radar_slam_torch.data import RadarSimulator, pack4
from navtech_radar_slam_torch.models import posegraph as pg_mod
from navtech_radar_slam_torch.models import slam as slam_mod
from navtech_radar_slam_torch.models.odometry import (
    RadarOdometry, decode_power, default_azimuths, extract_scan_features,
    extract_scan_features_batched, make_batched_odometry_step, match_feature_pair,
    register_step)
from navtech_radar_slam_torch.ops import cen2019, icp, registration, scancontext
from navtech_radar_slam_torch.ops.features import (
    constellation_descriptors, patch_descriptors, polar_to_cartesian)
from navtech_radar_slam_torch.ops.kernels import cen_peaks, nn_dist, sc_corr
from navtech_radar_slam_torch.utils.geometry import se2_between_np, se2_mul_np, se2_to_se3_np

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
            ("nn_dist_multi", nn_dist, "multi_launch_count"),
            ("cen_peaks_batched", cen_peaks, "batched_launch_count"))
CHUNK = 16           # scans per chunk of the streamed path
STREAMS = 64         # streams of the batched odometry path (bench.py's B)
STREAM_STEPS = 8     # steps of each batched window
STREAM_OFFSETS = 16  # stream b starts at scan b % STREAM_OFFSETS
BATCH_WINDOWS = 3    # timed windows of the batched path
SLOTS = 16           # query slots of the K2-T and K3-T checks and timings
CLI_SCANS = 70       # the JAX rehearsal: 1.4 laps of radius 12 m at 1.5 m a scan
CLI_SCANS_B = 20     # the second session, from the circuit's first pose
#: the CLI run's ATE bound, a share of the path (PERF.md §2's full-SLAM rule)
CLI_ATE_BOUND_FRAC = 0.01
DEVICE_LAUNCHES = 200  # back-to-back launches per device-time reading
#: marker kernels (torch.cuda._sleep's spin_kernel) each profiled session
#: launches before the call it profiles (device_busy)
PROFILE_MARKERS = 1000
#: the earlier design's numbers that this run's are printed beside (PERF.md,
#: NVIDIA H100 80GB HBM3, 700.00 W): one CG matvec of the pose graph as a
#: double vjp (kernels, ms), the per-scan run's two full solves (s, two
#: calls), K3-T's device ms per launch at 16 x (1024, 8192), which computed
#: every slot and pair whatever the data
EARLIER_MATVEC = (1206, 17.719)
EARLIER_FULL_SOLVES_S = (16.3, 23.2)
EARLIER_K3T_MS = 0.07130
#: K1 x B's resident design (every row of a scan resident, the scans in
#: turn) at B = 64, and K2-T with one query slot a block at 16 x 30 rows, the
#: device ms per launch before the streamed design and the query groups
EARLIER_K1B_MS = 1.46242
EARLIER_K2T_MS = 0.01061
#: the batches and shared-bank sizes phase 17 times each of the two designs at
K1B_REPORT_SIZES = (1, 8, 32, 64)
K2T_REPORT_ROWS = (30, 400, 4096)
#: the most device launches (kernels and other nodes) one CG matvec may take
MATVEC_MAX_LAUNCHES = 100
#: phase 18: the manager detects after every insert past this many, as the
#: engine's recency exclusion first allows; the second session's clouds; the
#: Cartesian utilities' bound against their CPU run
SC_MANAGER_FIRST_DETECT = 30
SESSION_B_CLOUDS = 60
CART_ATOL = 1e-4
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


def sc_poses() -> np.ndarray:
    """The 400 random poses of the bank rows of ``sc_inputs`` (seed 7)."""
    rng = np.random.default_rng(7)
    return np.column_stack([rng.uniform(-60, 60, 400), rng.uniform(-60, 60, 400),
                            rng.uniform(-np.pi, np.pi, 400)])


def landmark_cloud(sim: RadarSimulator, pose: np.ndarray, dev) -> torch.Tensor:
    """The simulator's landmarks visible from ``pose``, (K, 2) sensor-frame
    metres on ``dev``."""
    r, b, _ = sim.visible_landmarks(pose)
    return torch.as_tensor(np.column_stack([r * np.cos(b), r * np.sin(b)]),
                           dtype=torch.float32, device=dev)


def sc_inputs(cfg: SlamConfig, sim: RadarSimulator, dev) -> tuple:
    """A query and a (max_keyframes, R, S) bank of make_scancontext
    descriptors of simulator landmark clouds at random poses: 400 rows
    live, the rest zero; the query is taken near the pose of row 123."""
    poses = sc_poses()
    query_pose = poses[123] + np.asarray([0.4, -0.3, 0.5])

    def desc(pose):
        xy = landmark_cloud(sim, pose, dev)
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


def check_k2t_bits(label: str, queries: torch.Tensor, bank: torch.Tensor) -> None:
    """K2-T on one shared bank, at the host's query slots a block: every slot
    bit-equal to K2 for that query on the bank."""
    got = sc_corr.sc_shift_distances_multi_cuda(queries, bank)
    one = [sc_corr.sc_shift_distances_cuda(q, bank) for q in queries]
    torch.cuda.synchronize()
    n_diff = sum(not torch.equal(g, o) for g, o in zip(got, one))
    qgroup = sc_corr.multi_geometry(queries.shape[0], bank.shape[0], False)[1]
    print(f"  shared bank, {label}, {queries.shape[0]} x {bank.shape[0]} rows, {qgroup} slots "
          f"a block: slots not bit-equal to K2 {n_diff}")
    if n_diff:
        raise AssertionError(f"K2-T differs from K2 in {n_diff} slots ({label})")


def ringkey_banks(queries: torch.Tensor, bank: torch.Tensor, k: int) -> torch.Tensor:
    """Each query's k nearest bank rows by ring key, gathered: the
    (T, k, R, S) bank that ring-key mode hands K2-T."""
    d2 = torch.sum((scancontext.ring_key(bank)[None] - scancontext.ring_key(queries)[:, None])
                   ** 2, dim=-1)
    _, cand = scancontext.top_k(-d2, k)
    return bank[cand].contiguous()


def check_k3t(label: str, src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
              mask: torch.Tensor = None) -> float:
    """K3-T (with its slot mask, if given) against its plain version: the
    same indices and d2, exactly."""
    gd, gi = nn_dist.nearest_neighbors_multi_cuda(src, tgt, valid, mask)
    wd, wi = icp.nearest_neighbors_plain(src, tgt, valid, mask)
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


def kernels_per_call(name: str, launch) -> tuple:
    """The device work one wrapper call puts on its stream, read from a CUDA
    graph capture of the call: (kernel nodes, other nodes).  The capture
    records every kernel, copy and memset the call enqueues, whatever a
    tracer sees (late in this script torch.profiler loses the first device
    events of a session: see device_busy).  Raises when the capture is
    empty or a CUDA query fails."""
    libcuda = ctypes.CDLL("libcuda.so.1")

    def check(err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} reading the captured graph")

    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        launch()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(libcuda.cuGraphGetNodes(raw, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        kinds.append(kind.value)
    graph.reset()
    torch.cuda.synchronize()
    if not kinds:
        raise AssertionError(f"{name}: one call put no work on the device")
    n_kernels = kinds.count(0)   # CU_GRAPH_NODE_TYPE_KERNEL
    return n_kernels, len(kinds) - n_kernels


def device_busy(fn, match: str = "") -> tuple:
    """One call of ``fn`` under torch.profiler (device activity only):
    (wall ms, device kernel ms, device kernels, ms and count of the kernels
    whose name holds ``match``, marker kernels the trace kept); the kernel ms
    is None when the profiler saw no device events.  The kernels run on one
    stream, so their summed time is the time the device was busy.  Late in
    this script the trace loses the first device events of a session (the
    step's first kernels, K1 or K1 x B among them), so the session first
    launches PROFILE_MARKERS marker kernels, which the counts leave out."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_MARKERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    markers = sum(e.count for e in events if "spin_kernel" in e.key)
    events = [e for e in events if "spin_kernel" not in e.key]
    if not events:
        return 1e3 * wall, None, 0, 0.0, 0, markers

    def us(e) -> float:
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    hits = [e for e in events if match and match in e.key]
    return (1e3 * wall, 1e-3 * sum(us(e) for e in events), sum(e.count for e in events),
            1e-3 * sum(us(e) for e in hits), sum(e.count for e in hits), markers)


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


class FullSolves:
    """While entered, times every full pose-graph solve of every engine
    (``SlamEngine._refine_graph(full=True)`` with a loop factor): ms on the
    host clock, fenced by synchronize, in ``ms``."""

    def __init__(self):
        self.ms = []

    def __enter__(self):
        self._refine = refine = slam_mod.SlamEngine._refine_graph
        ms = self.ms

        def timed_refine(eng, full: bool):
            if not full or eng.graph.num_loops == 0:
                return refine(eng, full)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = refine(eng, full)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            return out

        slam_mod.SlamEngine._refine_graph = timed_refine
        return self

    def __exit__(self, *exc):
        slam_mod.SlamEngine._refine_graph = self._refine

    def line(self, label: str, name_power: str) -> str:
        return (f"  {label}: full pose-graph solves {len(self.ms)}, ms each "
                f"{', '.join('%.1f' % x for x in self.ms)}, {sum(self.ms) / 1e3:.3f} s in all "
                f"(the earlier design's per-scan run: {EARLIER_FULL_SOLVES_S[0]} / "
                f"{EARLIER_FULL_SOLVES_S[1]} s for its two); host clock after synchronize "
                f"[{name_power}]")


def matvec_probe(label: str, g, cfg: SlamConfig, name_power: str) -> None:
    """One CG matvec of the pose graph's normal equations at the bucket the
    solver takes for ``g``'s active nodes: its device work (kernels and other
    nodes of a CUDA graph capture of the call), its device ms (CUDA events
    over replays of that capture), its ms as an eager call (median of
    TIMED_RUNS calls fenced by CUDA events), and the linearization's once
    per GN step; beside the earlier double-vjp matvec.  Fails at
    MATVEC_MAX_LAUNCHES launches or more."""
    nb = pg_mod.bucket_size(g.poses.shape[0], int(g.num_nodes))
    gs = g._replace(poses=g.poses[:nb], odom_meas=g.odom_meas[:nb], odom_valid=g.odom_valid[:nb],
                    gps_meas=g.gps_meas[:nb], gps_valid=g.gps_valid[:nb])
    lin = pg_mod.linearize(gs, cfg.pgo)
    matvec, b = pg_mod.normal_equations(lin, nb, cfg.pgo.lm_lambda0)
    kernels, other = kernels_per_call("matvec", lambda: matvec(b))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        matvec(b)
    replay_ms = device_ms(graph.replay)
    eager_ms = median_ms(lambda: matvec(b), TIMED_RUNS)
    # the linearization builds small tensors on the host, which a graph
    # capture refuses: its kernels are the profiler's count
    lin_wall, lin_busy, lin_kernels, _, _, lin_markers = device_busy(
        lambda: pg_mod.linearize(gs, cfg.pgo))
    print(f"  {label}: one CG matvec at the {nb}-node bucket ({int(g.num_nodes)} nodes, "
          f"{int(g.loop_valid.sum())} loops): {kernels} kernels + {other} other nodes (CUDA graph "
          f"capture), device {replay_ms:.5f} ms (events over {DEVICE_LAUNCHES} replays of the "
          f"capture), {eager_ms:.4f} ms a call eager (median of {TIMED_RUNS}); the earlier "
          f"double-vjp matvec {EARLIER_MATVEC[0]} kernels, {EARLIER_MATVEC[1]} ms; the "
          f"linearization once per GN step: {lin_kernels} kernels (profiler; marker kernels "
          f"kept {lin_markers} of {PROFILE_MARKERS}), {lin_wall:.3f} "
          f"ms wall, device busy " + ("not measured" if lin_busy is None else
                                     f"{lin_busy:.3f} ms") + f" [{name_power}]")
    if kernels + other >= MATVEC_MAX_LAUNCHES:
        raise AssertionError(f"one CG matvec took {kernels + other} launches (limit "
                             f"{MATVEC_MAX_LAUNCHES})")


def k3t_workload(label: str, calls: list, name_power: str) -> None:
    """A run's K3-T launches, replayed from their recorded inputs: the slots
    each computed (its mask) and the valid targets of those (how many of
    them fewer than all), and
    the device ms summed over the launches, as the run made them and with
    every slot computed (the mask dropped), beside the earlier design (every
    slot and pair, EARLIER_K3T_MS a launch); with the operations bound and
    the instruction floor of the valid pairs (5 fp32 instructions a pair,
    issued at half the 67 TFLOP/s, which counts an FMA as two)."""
    active = [int(m.sum()) for _, _, _, m in calls]
    valid = torch.cat([v[m].sum(-1) for _, _, v, m in calls]).cpu().numpy()
    pairs = sum(int(v[m].sum()) * s.shape[1] for s, _, v, m in calls)
    masked = sum(device_ms(lambda: nn_dist.nearest_neighbors_multi_cuda(s, t, v, m), 50)
                 for s, t, v, m in calls)
    every = sum(device_ms(lambda: nn_dist.nearest_neighbors_multi_cuda(s, t, v), 50)
                for s, t, v, _ in calls)
    bound_ms = 1e3 * 5 * pairs / PEAK_FP32_PER_S
    nt = calls[0][1].shape[1]
    slots = sorted({s.shape[0] for s, _, _, _ in calls})
    print(f"  K3-T on the {label}, {len(calls)} launches of {'-'.join(map(str, slots))} "
          f"slots x ({calls[0][0].shape[1]}, {nt}): slots computed per launch "
          f"{dict(sorted(collections.Counter(active).items()))} (launch: count), valid "
          f"targets per computed slot {int(valid.min())} to {int(valid.max())} (median "
          f"{int(np.median(valid))}), fewer than {nt} in {int((valid < nt).sum())} of "
          f"{len(valid)} computed slots; device ms summed over the launches {masked:.4f} as run, "
          f"{every:.4f} with every slot computed, the earlier design "
          f"{len(calls) * EARLIER_K3T_MS:.4f} ({len(calls)} x {EARLIER_K3T_MS}); bound "
          f"{bound_ms:.4f} ms ({pairs / 1e6:.1f} M valid pairs, operations), instruction floor "
          f"{2 * bound_ms:.4f} ms (CUDA events over 50 launches of each) [{name_power}]")


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
    loops and per-scan times (ms).  Prints each full pose-graph solve's ms
    and, on the final graph, one CG matvec's device work and ms."""
    with FullSolves() as solves:
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
          f"{N_SLAM_SCANS} process calls and the final drain), {whole * N_SLAM_SCANS / 1e3:.3f} "
          f"s [{name_power}]")
    print(solves.line("per-scan run", name_power))
    if not solves.ms:
        raise AssertionError("the per-scan run timed no full solve")
    matvec_probe("per-scan run's final graph", eng.graph.g, cfg, name_power)
    return launches, loops, traj, med[0], whole


def streaming_path(cfg: SlamConfig, gt: np.ndarray, scans: list, dev, name_power: str,
                   per_scan_loops: list, per_scan_traj: np.ndarray) -> tuple:
    """Phase 11: the same scans through begin_chunk / finish_chunk, chunks of
    CHUNK scans, two in flight; returns its launches, loops, the median ms
    per scan of its chunk steps, its whole-run ms per scan and its
    trajectory.  Prints each full solve's ms and its K3-T work
    (``k3t_workload``)."""
    with FullSolves() as solves:
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

        k3t_calls = []       # each K3-T call's inputs, for the replay

        def counted_nn_multi(*args):
            icp_calls[-1] += 1
            k3t_calls.append(args)
            return nn_multi(*args)

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
    print(solves.line("streamed run", name_power))
    k3t_workload("streamed run", k3t_calls, name_power)
    return launches, loops, med, whole, traj


def check_k1b(label: str, x: torch.Tensor, cfg: SlamConfig) -> float:
    """K1 x B against its plain version, exactly: the same peak positions
    and values in every scan, and every scan bit-equal to K1 on that scan
    alone.  Returns the max abs error at common peaks (0)."""
    got = cen_peaks.cen2019_scores_batched_cuda(x, cfg.features, cfg.radar)
    design = cen_peaks.design_for(x.shape[0])
    want = cen2019.cen2019_scores_batched(x, cfg.features, cfg.radar)
    one = [cen_peaks.cen2019_scores_cuda(s.contiguous(), cfg.features, cfg.radar) for s in x]
    torch.cuda.synchronize()
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    per_scan = fw.flatten(1).sum(1).tolist()
    n_diff = int((fg ^ fw).sum())
    both = fg & fw
    err = float((got[both] - want[both]).abs().max())
    n_k1 = sum(not torch.equal(g, o) for g, o in zip(got, one))
    print(f"  {label}, batch {tuple(x.shape)}, {design} design: peaks {sum(per_scan)} (per "
          f"scan {min(per_scan)} to {max(per_scan)}), positions differing {n_diff}, max abs err "
          f"{err:.3g}, scans not bit-equal to K1 {n_k1}")
    if sum(per_scan) == 0 or n_diff or err or n_k1:
        raise AssertionError(f"K1 x B differs ({label}): {n_diff} peak positions, values by "
                             f"{err}, {n_k1} scans from K1")
    return err


def check_spectral_invariance(prev, curr, cfg: SlamConfig) -> None:
    """The batched path's spectral scores on the card: for every stream,
    ``spectral_inlier_scores`` under torch.func.vmap over the B streams'
    matches equals the scores of that stream's matches alone, bit for bit
    (the stable top-k of the scores picks the TIMs, so a last-bit
    difference between near-equal scores changes the registration)."""
    matches = torch.func.vmap(functools.partial(match_feature_pair, cfg=cfg))(prev, curr)
    scores = functools.partial(registration.spectral_inlier_scores, cfg=cfg.registration)
    got = torch.func.vmap(scores)(matches)
    differ = [b for b in range(got.shape[0]) if not torch.equal(
        got[b], scores(type(matches)(*(None if f is None else f[b] for f in matches))))]
    n_valid = matches.valid.sum(1)
    print(f"  spectral scores under vmap at B = {got.shape[0]} (matches per stream "
          f"{int(n_valid.min())} to {int(n_valid.max())}): streams not bit-equal to the "
          f"one-stream scores {len(differ)}{' ' + str(differ) if differ else ''}")
    if differ or int(n_valid.min()) == 0:
        raise AssertionError(f"vmapped spectral scores differ from one stream's in streams "
                             f"{differ}")


def _fingerprint(x: torch.Tensor) -> torch.Tensor:
    """A position-weighted sum of the bit patterns of ``x`` (an int64 scalar
    on its device): equal tensors give equal sums, and a tensor with any
    element's bits changed gives another sum but by a collision."""
    if x.is_floating_point():
        x = x.contiguous().view({8: torch.int64, 4: torch.int32, 2: torch.int16}[
            x.element_size()])
    flat = x.reshape(-1).to(torch.int32 if x.element_size() <= 4 else torch.int64)
    w = torch.arange(flat.numel(), device=x.device, dtype=flat.dtype) % 65521 + 1
    return (flat * w).sum(dtype=torch.int64)


class OpRecord(torch.utils._python_dispatch.TorchDispatchMode):
    """Every aten op the recorded code dispatches (under torch.func.vmap:
    the batched ops), with where in the port it was called and a
    fingerprint of each tensor it reads and writes.  With ``like``, the
    record of the same code on a batch of half the streams, each tensor is
    fingerprinted on the half of its batch dimension (the dimension of
    twice ``like``'s size, the streams of ``part``) that holds those
    streams; a tensor without one is fingerprinted whole, or not at all
    when its shape does not follow."""

    def __init__(self, like: "OpRecord" = None, part: int = 0):
        super().__init__()
        self.like, self.part, self.ops = like, part, []

    def _fp(self, x: torch.Tensor, half: tuple):
        if half is not None and tuple(x.shape) != half:
            dims = [d for d in range(x.dim()) if len(half) == x.dim() and x.shape[d] == 2 * half[d]
                    and all(x.shape[e] == half[e] for e in range(x.dim()) if e != d)]
            if len(dims) != 1:
                return None
            x = x.narrow(dims[0], self.part * half[dims[0]], half[dims[0]])
        return _fingerprint(x)

    @staticmethod
    def _where() -> str:
        frame = sys._getframe(2)
        while frame is not None and "navtech_radar_slam_torch" not in frame.f_code.co_filename:
            frame = frame.f_back
        if frame is None:
            return "?"
        path = frame.f_code.co_filename.split("navtech_radar_slam_torch/")[-1]
        return f"{path}:{frame.f_lineno} ({frame.f_code.co_name})"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ref = None
        if self.like is not None and len(self.ops) < len(self.like.ops):
            ref = self.like.ops[len(self.ops)]
        leaves = lambda tree: [a for a in torch.utils._pytree.tree_leaves(tree)  # noqa: E731
                               if isinstance(a, torch.Tensor)]
        rec = []
        for k, tensors in ((2, leaves((args, kwargs))), (3, leaves(out))):
            # an empty* op's output is uninitialised memory: not compared
            skip = k == 3 and func.__name__.startswith("empty")
            rec.append([(tuple(a.shape), None if skip else self._fp(
                a, None if ref is None or j >= len(ref[k]) else ref[k][j][0]))
                for j, a in enumerate(tensors)])
        self.ops.append((str(func), self._where(), *rec))
        return out


def first_differing_op(step, cfg: SlamConfig, prev: torch.Tensor, curr: torch.Tensor,
                       az: torch.Tensor, part: int) -> str:
    """The constellation descriptors of B streams' features as one vmapped
    call, and their batched registration (``register_step`` under
    torch.func.vmap), each recorded op by op against the same on half of the
    streams (``part`` 0: the first half, 1: the second; the half reads the
    B-stream extraction's rows, so both read the same inputs), compared on
    those streams: for each, the first op whose inputs agree and whose
    outputs differ, and how many ops' outputs differ.  (The batched top-k
    sorts every stream's scores together, so the extraction as a whole does
    not compare op by op; its leaves are compared in
    ``check_batch_size_invariance``.)"""
    b = prev.shape[0]
    sl = slice(part * b // 2, (part + 1) * b // 2)
    zero = torch.zeros(b, 3, device=prev.device)
    feats = [extract_scan_features_batched(x, az, cfg) for x in (prev, curr)]
    # the halves sliced here, so that both records hold the same ops
    halves = [type(f)(*(x[sl] for x in f)) for f in feats] + [zero[sl]]
    desc_in = [(f.xy, f.power, f.valid) for f in (feats[1], halves[1])]
    pair = torch.func.vmap(functools.partial(register_step, cfg=cfg))
    desc = torch.func.vmap(functools.partial(constellation_descriptors, fcfg=cfg.features))
    stages = (("descriptors as one torch.func.vmap over the streams (the extraction runs "
               "it in calls of a fixed number of streams)",
               lambda: desc(*desc_in[1]), lambda: desc(*desc_in[0])),
              ("registration (register_step under vmap)",
               lambda: pair(*halves), lambda: pair(*feats, zero)))
    report = []
    for stage, run_half, run_whole in stages:
        with OpRecord() as half:
            run_half()
        with OpRecord(like=half, part=part) as whole:
            run_whole()
        torch.cuda.synchronize()
        if len(half.ops) != len(whole.ops):
            report.append(f"{stage}: {len(half.ops)} and {len(whole.ops)} ops dispatched "
                          "(a loop over the streams), not compared op by op")
            continue

        def same(x, y):
            return [None if u[1] is None or v[1] is None else bool(u[1] == v[1])
                    for u, v in zip(x, y)]

        # a candidate reads tensors and writes only tensors with a batch
        # dimension: vmap's own batch indices (an arange of B, a select of
        # one stream) differ by position in the second half, not by rounding
        first, n_out = None, 0
        for (name, where, ins, outs), (_, _, hin, hout) in zip(whole.ops, half.ops):
            if False in same(outs, hout):
                n_out += 1
                batched = all(u[0] != v[0] for u, v in zip(outs, hout))
                if first is None and ins and batched and False not in same(ins, hin):
                    first = f"{name} at {where}"
        report.append(f"{stage}: first op whose inputs agree and outputs differ "
                      f"{first or 'none'}, ops whose outputs differ {n_out} of {len(whole.ops)}")
    return "; ".join(report)


def check_batch_size_invariance(step, prev: torch.Tensor, curr: torch.Tensor,
                                az: torch.Tensor, cfg: SlamConfig, name_power: str) -> None:
    """The batched step at B streams against the same streams in two steps
    of B / 2 (as two mesh ranks run them): the seed's and the step's leaves,
    rel_pose, ok and the de-skewed xy among them, bit for bit; on a
    difference, the first op that differs (``first_differing_op``)."""
    b = prev.shape[0]

    def run(sl):
        carry = extract_scan_features_batched(prev[sl], az, cfg)
        out = step(curr[sl], az, carry, torch.zeros(prev[sl].shape[0], 3, device=prev.device))
        leaves = {f"seed.{k}": v for k, v in carry._asdict().items()}
        for part, tup in zip(("carry", "res", "feats"), out):
            leaves.update({f"{part}.{k}": v for k, v in tup._asdict().items()})
        return leaves

    whole = run(slice(None))
    halves = [run(slice(0, b // 2)), run(slice(b // 2, b))]
    torch.cuda.synchronize()
    differ = {}
    for key, x in whole.items():
        y = torch.cat([h[key] for h in halves])
        if not torch.equal(x, y):
            differ[key] = (int((x != y).sum()), [int((x[sl] != y[sl]).sum()) for sl in (
                slice(0, b // 2), slice(b // 2, b))])
    print(f"  batch size: B = {b} against the same streams in two steps of B = {b // 2}, the "
          f"seed and the step (rel_pose, ok, de-skewed xy among {len(whole)} leaves): not "
          f"bit-equal {differ or 'none'} [{name_power}]")
    if differ:
        for part in (0, 1):
            print(f"  batch size, streams of half {part}: "
                  f"{first_differing_op(step, cfg, prev, curr, az, part)} [{name_power}]")
    if differ:
        raise AssertionError(f"batched odometry depends on the batch size: {differ}")


def batched_path(cfg: SlamConfig, gt: np.ndarray, scans: list, dev, name_power: str) -> tuple:
    """Phase 13: the batched odometry path, checked against the ground truth
    and against RadarOdometry on each stream alone, then timed; returns its
    launches, the median step ms and one more step to profile."""
    n_scans = STREAM_STEPS + 1
    offsets = np.arange(STREAMS) % STREAM_OFFSETS
    stack = torch.as_tensor(np.stack(scans), device=dev)
    batches = [stack[torch.as_tensor(offsets + i, device=dev)] for i in range(n_scans)]
    az = torch.as_tensor(default_azimuths(cfg), device=dev)
    step = make_batched_odometry_step(cfg, device=dev)
    max_coast = cfg.registration.max_coast_frames

    def window() -> tuple:
        """Seed and STREAM_STEPS steps; the twist carried as RadarOdometry
        carries it.  Returns (launches, rel_poses, oks, applied increments,
        step seconds, the inputs of one more step)."""
        torch.cuda.synchronize()
        reset_counts()
        prev = extract_scan_features_batched(batches[0], az, cfg)
        twists = torch.zeros(STREAMS, 3, device=dev)
        coast = torch.zeros(STREAMS, dtype=torch.int64, device=dev)
        rels, oks, applied, secs = [], [], [], []
        for i in range(1, n_scans):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prev, res, _ = step(batches[i], az, prev, twists)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            coast = torch.where(res.ok, torch.zeros_like(coast), coast + 1)
            twists = torch.where(res.ok[:, None], res.rel_pose, torch.where(
                (coast > max_coast)[:, None], torch.zeros_like(twists), twists))
            rels.append(res.rel_pose)
            oks.append(res.ok)
            applied.append(twists)
        launches = read_counts()
        return (launches, torch.stack(rels).cpu().numpy(), torch.stack(oks).cpu().numpy(),
                torch.stack(applied).cpu().numpy().astype(np.float64), secs,
                (batches[n_scans - 1], az, prev, twists))

    launches, rels, oks, applied, secs, last = window()
    want_k1b = STREAM_STEPS + 1
    print(f"batched odometry path: B = {STREAMS} streams x {STREAM_STEPS} steps, stream b on "
          f"scans b % {STREAM_OFFSETS} + 0..{STREAM_STEPS}; launches {launches} (K1xB "
          f"{launches['cen_peaks_batched']}: one per step plus one for the seed)")
    if launches["cen_peaks_batched"] != want_k1b or launches["cen_peaks"]:
        raise AssertionError(f"K1 x B launched {launches['cen_peaks_batched']} times (want "
                             f"{want_k1b}), K1 {launches['cen_peaks']} (want 0)")

    # each stream against the ground truth
    worst_ate, worst_share, min_ok = 0.0, 0.0, STREAM_STEPS
    for b, o in enumerate(offsets):
        pose = np.zeros(3)
        est = [pose]
        for i in range(STREAM_STEPS):
            pose = se2_mul_np(pose, applied[i, b])
            est.append(pose)
        est = np.asarray(est)
        ref = np.asarray([se2_between_np(gt[o], gt[o + i]) for i in range(n_scans)])
        path = float(np.sum(np.linalg.norm(np.diff(gt[o:o + n_scans, :2], axis=0), axis=1)))
        ate = float(np.sqrt(np.mean(np.sum((est[:, :2] - ref[:, :2]) ** 2, axis=1))))
        n_ok = int(oks[:, b].sum())
        worst_ate, min_ok = max(worst_ate, ate), min(min_ok, n_ok)
        worst_share = max(worst_share, ate / path)
        if n_ok < STREAM_STEPS - 1 or not ate < 0.05 * path or not np.isfinite(est).all():
            raise AssertionError(f"stream {b}: ok {n_ok}/{STREAM_STEPS}, ATE {ate} m over a "
                                 f"{path} m path")
    print(f"  against the ground truth: ok at least {min_ok}/{STREAM_STEPS} in every stream, "
          f"ATE at most {worst_ate:.4f} m ({worst_share:.4f} of the stream's path)")

    # each stream against RadarOdometry on that stream alone (streams b and
    # b + 16 see the same scans)
    ref_rel, ref_ok = {}, {}
    t0 = time.perf_counter()
    for o in range(STREAM_OFFSETS):
        odo = RadarOdometry(cfg, device=dev)
        odo.process(scans[o])
        r, k = [], []
        for i in range(1, n_scans):
            odo.process(scans[o + i])
            r.append(odo.last_result.rel_pose.cpu().numpy())
            k.append(odo.last_ok)
        ref_rel[o], ref_ok[o] = np.asarray(r), np.asarray(k)
    ref_s = time.perf_counter() - t0
    dxy = np.asarray([np.abs(rels[:, b, :2] - ref_rel[o][:, :2]).max()
                      for b, o in enumerate(offsets)])
    dth = np.asarray([np.abs(rels[:, b, 2] - ref_rel[o][:, 2]).max()
                      for b, o in enumerate(offsets)])
    n_ok_diff = sum(int((oks[:, b] != ref_ok[o]).sum()) for b, o in enumerate(offsets))
    print(f"  against RadarOdometry on each stream alone ({STREAM_OFFSETS} runs of {n_scans} "
          f"scans, {ref_s:.1f} s): ok differs in {n_ok_diff} steps; rel_pose differs by at most "
          f"{dxy.max():.3g} m (stream {int(dxy.argmax())}) and {dth.max():.3g} rad (stream "
          f"{int(dth.argmax())})")
    if n_ok_diff or dxy.max() > 1e-3 or dth.max() > 1e-4:
        raise AssertionError(f"the batched path differs from RadarOdometry: ok in {n_ok_diff} "
                             f"steps, {dxy.max()} m in stream {int(dxy.argmax())}, {dth.max()} "
                             f"rad in stream {int(dth.argmax())}")

    check_spectral_invariance(extract_scan_features_batched(batches[0], az, cfg),
                              extract_scan_features_batched(batches[1], az, cfg), cfg)
    check_batch_size_invariance(step, batches[0], batches[1], az, cfg, name_power)

    # two more timed windows
    windows = [secs] + [window()[4] for _ in range(BATCH_WINDOWS - 1)]
    ms = 1e3 * np.asarray(windows)
    med = float(np.median(ms))
    print(f"make_batched_odometry_step, default config, B = {STREAMS}: median {med:.3f} ms per "
          f"step (min {ms.min():.3f}, max {ms.max():.3f}) over {BATCH_WINDOWS} windows of "
          f"{STREAM_STEPS} steps (window medians "
          f"{', '.join('%.3f' % x for x in np.median(ms, axis=1))}); aggregate "
          f"{1e3 * STREAMS / med:.1f} frames/s at the median; host clock after synchronize "
          f"[{name_power}]")
    return launches, med, lambda: step(*last)


def cli_path(cfg: SlamConfig, name_power: str) -> dict:
    """Phase 14: the command line (``navtech_radar_slam_torch.cli.main``) on
    MulRan sequences written by the port's writer into a temporary
    directory: a chunked run with the checks of the JAX rehearsal, a resume
    from its first checkpoint, and a second session attached to the first
    run's final.npz.  Every launch counter is reset just before each CLI call
    and read just after; returns each kernel's launches summed over the
    three calls."""
    from navtech_radar_slam_torch import cli, runtime
    from navtech_radar_slam_torch.data.make_sequence import write_sequence
    from navtech_radar_slam_torch.data.mulran import MulranRadarDataset
    from navtech_radar_slam_torch.utils import checkpoint as ckpt
    from navtech_radar_slam_torch.utils.metrics import path_length

    total = defaultdict(int)
    saved = []                     # (scans, path) of each checkpoint the CLI wrote
    prewarm_s, prewarm_launches = [], defaultdict(int)
    save_engine, prewarm = ckpt.save_engine, slam_mod.SlamEngine.prewarm
    scan_stream, loader_next = cli.scan_stream, runtime.NativeRadarLoader.__next__
    kinds = []                     # the scan source of each CLI call
    waits = []                     # ms in NativeRadarLoader.__next__ per scan, per call
    nn_multi, k3t_calls = icp.nearest_neighbors_multi, []   # K3-T inputs, for the replay

    def recorded_nn_multi(*args):
        k3t_calls.append(args)
        return nn_multi(*args)

    def recorded_stream(args, cfg):
        stream, n, kind = scan_stream(args, cfg)
        kinds.append(kind)
        return stream, n, kind

    def timed_next(loader):
        t0 = time.perf_counter()
        scan = loader_next(loader)
        waits[-1].append(1e3 * (time.perf_counter() - t0))
        return scan

    def keep_checkpoints(eng, path):
        save_engine(eng, path)
        if os.path.basename(path) == "checkpoint.npz":
            kept = f"{path[:-4]}_{eng.num_scans}.npz"
            shutil.copy(path, kept)
            saved.append((eng.num_scans, kept))

    def timed_prewarm(eng, *args, **kwargs):
        before = read_counts()
        t0 = time.perf_counter()
        prewarm(eng, *args, **kwargs)
        prewarm_s.append(time.perf_counter() - t0)
        for name, n in read_counts().items():
            prewarm_launches[name] += n - before[name]

    def run(argv: list) -> tuple:
        """One CLI call: (launches, wall s, stats.json, final.npz)."""
        out = argv[argv.index("--output_dir") + 1]
        torch.cuda.synchronize()
        waits.append([])
        reset_counts()
        t0 = time.perf_counter()
        with FullSolves() as solves:
            if cli.main(argv + ["--device", "cuda", "--save_plot", "false"]) != 0:
                raise AssertionError(f"cli.main returned non-zero for {argv}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        print(solves.line("this CLI call", name_power))
        if kinds[-1] != "native":
            raise AssertionError(f"the CLI read with the {kinds[-1]} loader, not the native one")
        w = waits[-1]
        print(f"  native loader: wait in next() median {np.median(w):.3f} ms per scan over "
              f"{len(w)} scans (first {w[0]:.3f}, after the first median "
              f"{np.median(w[1:]):.3f} / max {max(w[1:]):.3f} ms), host clock [{name_power}]")
        for name, n in launches.items():
            total[name] += n
        with open(os.path.join(out, "stats.json")) as f:
            stats = json.load(f)
        return launches, wall, stats, dict(np.load(os.path.join(out, "final.npz")))

    ckpt.save_engine = keep_checkpoints
    slam_mod.SlamEngine.prewarm = timed_prewarm
    cli.scan_stream = recorded_stream
    icp.nearest_neighbors_multi = recorded_nn_multi
    try:
        with tempfile.TemporaryDirectory() as tmp:
            seq_a, seq_b = os.path.join(tmp, "seq_a"), os.path.join(tmp, "seq_b")
            t0 = time.perf_counter()
            gt_a = write_sequence(seq_a, num_scans=CLI_SCANS, radius=12.0, speed=6.0, gps=True)
            gt_b = write_sequence(seq_b, num_scans=CLI_SCANS_B, radius=12.0, speed=6.0, seed=5)
            print(f"CLI sequences: {CLI_SCANS} + {CLI_SCANS_B} scans written by make_sequence "
                  f"in {time.perf_counter() - t0:.1f} s")
            ds = MulranRadarDataset(seq_a, cfg.radar, raw_u8=True)
            loader_phase(ds, cfg, name_power)
            runtime.NativeRadarLoader.__next__ = timed_next

            # the chunked run
            out_a, dumps = os.path.join(tmp, "out_a"), os.path.join(tmp, "loops")
            launches, wall, stats, final = run([
                "--seq_dir", seq_a, "--output_dir", out_a, "--chunk", str(CHUNK),
                "--prewarm", "true", "--pack4", "true", "--checkpoint_every", "35",
                "--loop_debug_dir", dumps, "--use_gps", "true", "--live", "true"])
            events = final["loop_events"]
            path = path_length(gt_a[:, :2])
            accepted = [f for f in os.listdir(dumps) if f.endswith("_accepted.npz")]
            print(f"CLI chunked run (--chunk {CHUNK} --pack4 true, two chunks in flight, "
                  f"SlamConfig()): {stats['num_scans']} scans, {stats['num_keyframes']} "
                  f"keyframes, {stats['num_loops']} loops (first "
                  f"{tuple(int(x) for x in events[0, :2]) if len(events) else None}), odometry "
                  f"failures {stats['odometry_failures']}, ATE {stats['ate_rmse']} m over a "
                  f"{path:.2f} m path (bound {CLI_ATE_BOUND_FRAC} of it), RTE {stats['rte']}; "
                  f"launches {launches}, of them in prewarm {dict(prewarm_launches)}; "
                  f"{len(accepted)} accepted loop dumps")
            print(f"  prewarm {', '.join('%.3f' % x for x in prewarm_s)} s; stats.json "
                  f"frames_per_sec {stats['frames_per_sec']}, warmup_s {stats['warmup_s']}, "
                  f"steady_scans_per_sec {stats['steady_scans_per_sec']}; wall "
                  f"{1e3 * wall / CLI_SCANS:.3f} ms per scan over the whole call ({wall:.2f} "
                  f"s, writing the outputs included) [{name_power}]")
            outside = {k: launches[k] - prewarm_launches[k] for k in launches}
            if stats["num_scans"] != CLI_SCANS or stats["odometry_failures"] != 0:
                raise AssertionError(f"CLI run: {stats}")
            if stats["num_loops"] < 1 or events[0, 1] - events[0, 0] <= 40:
                raise AssertionError(f"CLI run: loops {events[:, :2].tolist()}, want a first "
                                     "loop spanning more than 40 keyframes")
            if stats["num_loops"] != len(events) or int(final["num_loops"]) != len(events):
                raise AssertionError(f"stats.json counts {stats['num_loops']} loops, final.npz "
                                     f"{len(events)}")
            if stats["ate_rmse"] is None or not stats["ate_rmse"] < CLI_ATE_BOUND_FRAC * path:
                raise AssertionError(f"CLI ATE {stats['ate_rmse']} m is not below "
                                     f"{CLI_ATE_BOUND_FRAC} of the {path} m path")
            for name in ("trajectory_tum.txt", "map_points.csv", "final.npz"):
                if not os.path.exists(os.path.join(out_a, name)):
                    raise AssertionError(f"the CLI wrote no {name}")
            if not accepted:
                raise AssertionError("no loop_*_accepted.npz in --loop_debug_dir")
            if (outside["cen_peaks"] < CLI_SCANS or outside["sc_corr_multi"] < 1
                    or outside["nn_dist_multi"] < 1):
                raise AssertionError(f"CLI run outside prewarm launched {outside}: want K1 at "
                                     "least once per scan and K2-T, K3-T at least once")

            # resume from the run's first checkpoint
            first_scans, first_ckpt = saved[0]
            first_kf = int(np.load(first_ckpt)["num_keyframes"])
            out_r = os.path.join(tmp, "out_resume")
            launches, wall, stats, final = run([
                "--seq_dir", seq_a, "--output_dir", out_r, "--chunk", str(CHUNK),
                "--resume", first_ckpt, "--use_gps", "true", "--live", "false"])
            print(f"CLI resume from the checkpoint of scan {first_scans} ({first_kf} keyframes; "
                  f"checkpoints at scans {[n for n, _ in saved]}: the cadence rounds to the "
                  f"chunk and a save finishes the chunk in flight): {stats['num_scans']} scans, "
                  f"{stats['num_keyframes']} keyframes, {stats['num_loops']} loops, ATE "
                  f"{stats['ate_rmse']} m; launches {launches}; wall {wall:.2f} s")
            if stats["num_scans"] != CLI_SCANS or stats["num_keyframes"] < first_kf:
                raise AssertionError(f"resume: {stats}")

            # a second session on the same circuit, attached to the first
            out_b = os.path.join(tmp, "out_b")
            launches, wall, stats, final = run([
                "--seq_dir", seq_b, "--output_dir", out_b,
                "--prior_session", os.path.join(out_a, "final.npz"), "--live", "false"])
            start = int(final["session_start"])
            inter = [tuple(int(x) for x in e[:2]) for e in final["loop_events"]
                     if e[0] < start <= e[1]]
            poses = final["graph_poses"][start:int(final["num_keyframes"])]
            errs = [np.linalg.norm(poses[j, :2, 3] - se2_between_np(gt_a[0], gt_b[j])[:2])
                    for j in range(len(poses))]
            print(f"CLI second session ({CLI_SCANS_B} scans, other noise, per scan, "
                  f"--prior_session): session_start {start}, {len(poses)} keyframes, "
                  f"inter-session loops {inter[:5]}{' ...' if len(inter) > 5 else ''} "
                  f"({len(inter)}), rebased {bool(final['rebased'])}, mean distance from the "
                  f"ground truth in the first session's frame {np.mean(errs):.4f} m (max "
                  f"{np.max(errs):.4f}); launches {launches}; wall {wall:.2f} s "
                  f"[{name_power}]")
            if not inter or not bool(final["rebased"]) or not np.mean(errs) < 1.5:
                raise AssertionError(f"second session: inter-session loops {inter}, rebased "
                                     f"{bool(final['rebased'])}, mean error {np.mean(errs)} m")
    finally:
        ckpt.save_engine, slam_mod.SlamEngine.prewarm = save_engine, prewarm
        cli.scan_stream, runtime.NativeRadarLoader.__next__ = scan_stream, loader_next
        icp.nearest_neighbors_multi = nn_multi
    if len(k3t_calls) != total["nn_dist_multi"]:
        raise AssertionError(f"{len(k3t_calls)} K3-T calls recorded, {total['nn_dist_multi']} "
                             "launched")
    k3t_workload("three CLI calls, prewarm included", k3t_calls, name_power)
    return dict(total)


def loader_phase(ds, cfg: SlamConfig, name_power: str) -> None:
    """Phase 14's loader part: build the native scan loader with the host
    compiler, then read every scan of the written sequence three ways, one
    native decode per call, through the prefetching NativeRadarLoader and
    with the Python decoder, and require the same arrays bit for bit."""
    from navtech_radar_slam_torch import runtime
    from navtech_radar_slam_torch.data.mulran import decode_polar_scan
    from navtech_radar_slam_torch.data.png import read_png
    from navtech_radar_slam_torch.runtime import loader as loader_mod

    t0 = time.perf_counter()
    if not runtime.native_available():
        raise AssertionError(f"the native loader did not build:\n{runtime.build_error()}")
    print(f"native loader build: {loader_mod.LIBRARY.command or '(already built)'}: "
          f"{time.perf_counter() - t0:.2f} s{', output: ' if loader_mod.LIBRARY.log else ''}"
          f"{loader_mod.LIBRARY.log.strip()}")
    paths = [os.path.join(ds.scan_dir, f) for f in ds.scan_files]
    native, python, native_ms, python_ms = [], [], [], []
    for i, path in enumerate(paths):     # the two decoders in turns
        t0 = time.perf_counter()
        native.append(runtime.decode_png_native(path, cfg.radar, raw_u8=True))
        t1 = time.perf_counter()
        s = decode_polar_scan(read_png(path), cfg.radar, ds.timestamp(i), raw_u8=True)
        t2 = time.perf_counter()
        python.append((s.power, s.ray_timestamps, s.azimuths, s.valid))
        native_ms.append(1e3 * (t1 - t0))
        python_ms.append(1e3 * (t2 - t1))
    t0 = time.perf_counter()
    prefetched = list(runtime.NativeRadarLoader(paths, cfg.radar, num_workers=2, raw_u8=True))
    prefetch_s = time.perf_counter() - t0
    if len(prefetched) != len(paths):
        raise AssertionError(f"NativeRadarLoader gave {len(prefetched)} of {len(paths)} scans")
    for path, a, b, c in zip(paths, native, prefetched, python):
        for name, x, y, z in zip(("power", "ray timestamps", "azimuths", "valid"), a, b, c):
            if not (x.dtype == y.dtype == z.dtype and np.array_equal(x, y)
                    and np.array_equal(x, z)):
                raise AssertionError(f"{path}: {name} differs between the decode routes")
    print(f"loader: {len(paths)} scans equal across decode_png_native, NativeRadarLoader("
          f"raw_u8=True, num_workers=2) and the python decoder (power, ray timestamps, "
          f"azimuths, valid, bit for bit)")
    print(f"scan decode, one thread, ms per scan over {len(paths)} scans in turns: native "
          f"median {np.median(native_ms):.3f} (min {min(native_ms):.3f}, max "
          f"{max(native_ms):.3f}); python (data.png + decode_polar_scan) median "
          f"{np.median(python_ms):.3f} (min {min(python_ms):.3f}, max {max(python_ms):.3f}); "
          f"NativeRadarLoader with 2 workers, drained without other work: "
          f"{1e3 * prefetch_s / len(paths):.3f} ms per scan; host clock [{name_power}]")


# ---------------------------------------------------------------------------
# phase 15: the multi-device layer (navtech_radar_slam_torch/parallel/)
# ---------------------------------------------------------------------------

MESH_RANKS = 2                 # gloo ranks sharing cuda:0
MESH_SEARCH_ROWS = (2048, 8192)  # bank rows per rank (bench_scaling.py's shard sizes)
MESH_SOLVE_NODES = 1024        # pose-graph nodes per rank
#: distributed vs single-device solve, positions (m; the JAX suite's band):
#: the two sum the matvec in different orders, and three GN steps of 64 CG
#: iterations leave about 1 % of the move (the line prints the
#: difference); the solve must move the poses at least 10x this
MESH_SOLVE_ATOL = 5e-2
MESH_STREAMS = 64              # sharded odometry streams (32 per rank)
MESH_TIMEOUT_S = 600.0         # the process group's collective timeout


def _search_cfgs(cfg: SlamConfig) -> dict:
    sc = cfg.scancontext
    return {"full": dataclasses.replace(sc, search_mode="full"),
            "ringkey": dataclasses.replace(sc, search_mode="ringkey")}


def _search_num_valids(n_rows: int, t: int, excl: int) -> list:
    """Slot s sees n_rows + excl - t + 1 + s keyframes: the last slot's
    searchable bound is the whole bank."""
    return [n_rows + excl - t + 1 + s for s in range(t)]


def mesh_rank(mesh, work: str) -> dict:
    """One gloo rank on cuda:0: the sharded search (full and ring-key, T = 1
    and 16, at each MESH_SEARCH_ROWS per rank), one distributed solve, one
    sharded batched odometry step, and the mesh engine streamed over the 60
    SLAM scans; each with its launches and times."""
    from navtech_radar_slam_torch.models import posegraph as pg_mod
    from navtech_radar_slam_torch.parallel import dist_pgo, sharded_bank, sharded_odometry

    dev = mesh.device
    d = mesh.size
    z = np.load(os.path.join(work, "inputs.npz"))
    cfg = SlamConfig()
    out = {"rank": mesh.rank}

    # 1. the sharded search
    bank_all = torch.as_tensor(z["bank"], device=dev)
    queries = torch.as_tensor(z["queries"], device=dev)
    excl = cfg.scancontext.num_exclude_recent
    search = {}
    launches = defaultdict(int)
    for rows in MESH_SEARCH_ROWS:
        n = rows * d
        lo, hi = mesh.block(n)
        local = bank_all[lo:hi].contiguous()
        # the searches' launches alone: counted from 0 here, read before the
        # timing launches below
        reset_counts()
        for mode, scfg in _search_cfgs(cfg).items():
            detect = sharded_bank.make_sharded_loop_detector_batch(mesh, scfg,
                                                                   cfg.parallel.shard_top_k)
            for t in (1, SLOTS):
                cand = detect(queries[:t], local, _search_num_valids(n, t, excl))
                search[(rows, mode, t)] = cand._asdict()
        for k, v in read_counts().items():
            launches[k] += v
        # device time per launch on this rank's block, one rank at a time
        for r in range(d):
            mesh.barrier()
            if r == mesh.rank:
                search[(rows, "k2t_ms")] = (
                    device_ms(lambda: sc_corr.sc_shift_distances_multi_cuda(queries, local)),
                    device_ms(lambda: sc_corr.sc_shift_distances_multi_cuda(queries[:1], local)),
                    # the earlier design: one query slot a block
                    device_ms(lambda: sc_corr._launch_multi(queries, local, 1)),
                    sc_corr.multi_geometry(SLOTS, local.shape[0], False)[1])
        mesh.barrier()
        search[(rows, "bank_bytes")] = local.numel() * local.element_size()
    out["search"] = search
    out["search_launches"] = dict(launches)

    # the collectives alone, at the shapes the mesh paths give them
    best = torch.zeros((SLOTS, 3), device=dev)
    vec = torch.zeros(MESH_SOLVE_NODES * d * 6, device=dev)
    packet = torch.zeros(9 * SLOTS, device=dev)
    flag = torch.ones((), device=dev)
    # (median of 20 calls, each fenced by CUDA events: a collective through
    # gloo includes its host copies)
    out["collective_ms"] = {
        "all_gather (16, 3) search result": median_ms(lambda: mesh.all_gather(best), 20),
        f"all_reduce ({vec.numel()},) matvec": median_ms(lambda: mesh.all_reduce_sum(vec), 20),
        f"broadcast ({packet.numel()},) decision packet": median_ms(
            lambda: mesh.broadcast(packet), 20),
        "all_reduce MAX () CG flag": median_ms(lambda: mesh.agree_max(flag), 20),
    }

    # 2. one distributed solve at MESH_SOLVE_NODES x d nodes
    g = pg_mod.GraphArrays(*(torch.as_tensor(z[f"graph_{i}"], device=dev) for i in range(10)))
    pcfg = dataclasses.replace(cfg.pgo, max_nodes=MESH_SOLVE_NODES * d, gn_iters=3)
    solve = dist_pgo.make_distributed_solver(mesh, pcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["solve_poses"] = solve(g)
    torch.cuda.synchronize()
    out["solve_ms"] = 1e3 * (time.perf_counter() - t0)

    # 3. the sharded batched odometry step, 32 streams a rank
    step, shard = sharded_odometry.make_sharded_batched_odometry(mesh, cfg)
    az = torch.as_tensor(default_azimuths(cfg), device=dev)
    u8 = torch.as_tensor(z["odo_u8"], device=dev)
    offsets = torch.as_tensor(np.arange(MESH_STREAMS) % STREAM_OFFSETS, device=dev)
    prev_all, curr_all = u8[offsets], u8[offsets + 1]
    torch.cuda.synchronize()
    reset_counts()
    carry = sharded_odometry.make_sharded_extract(mesh, cfg)(shard(prev_all), az)
    t0 = time.perf_counter()
    carry, res, feats = step(shard(curr_all), az, carry, shard(torch.zeros(MESH_STREAMS, 3)))
    torch.cuda.synchronize()
    out["odo_ms"] = 1e3 * (time.perf_counter() - t0)
    out["odo_launches"] = read_counts()
    out["odo_block"] = mesh.block(MESH_STREAMS)
    out["odo"] = {"res": res._asdict(), "carry": carry._asdict(), "feats": feats._asdict()}
    # the one-device batched step on this rank's streams alone, for the check
    # that the split changes nothing but the batch size
    lo, hi = out["odo_block"]
    own = make_batched_odometry_step(cfg, device=dev)
    c_own, r_own, f_own = own(curr_all[lo:hi], az, extract_scan_features_batched(
        prev_all[lo:hi], az, cfg), torch.zeros(hi - lo, 3, device=dev))
    out["odo_own"] = {"res": r_own._asdict(), "carry": c_own._asdict(),
                      "feats": f_own._asdict()}

    # 4. the mesh engine, streamed over the SLAM scans (chunks of CHUNK, two
    # in flight), every counter reset just before and read just after
    scans = np.load(os.path.join(work, "slam_scans.npy"), mmap_mode="r")
    eng = slam_mod.SlamEngine(cfg, mesh=mesh)
    stage = defaultdict(float)
    eng._refine_graph = timed(stage, "refine", eng._refine_graph)
    eng._dispatch_segment = timed(stage, "segment", eng._dispatch_segment)
    torch.cuda.synchronize()
    mesh.barrier()
    reset_counts()
    steps = []
    t_run = time.perf_counter()
    for c0 in range(0, len(scans), CHUNK):
        t0 = time.perf_counter()
        chunk = np.array(scans[c0:c0 + CHUNK])
        eng.begin_chunk(chunk, timestamps=[i * 0.25 for i in range(c0, c0 + len(chunk))])
        if eng.inflight_chunks >= 2:
            eng.finish_chunk()
        torch.cuda.synchronize()
        steps.append(1e3 * (time.perf_counter() - t0) / len(chunk))
    eng.current_pose()
    torch.cuda.synchronize()
    out["engine_whole_ms"] = 1e3 * (time.perf_counter() - t_run) / len(scans)
    out["engine_step_ms"] = float(np.median(steps))
    out["engine_stage_ms"] = {k: 1e3 * v for k, v in stage.items()}
    out["engine_launches"] = read_counts()
    out["engine_traj"] = eng.trajectory()
    out["engine_loops"] = [(e.prev_idx, e.curr_idx) for e in eng.loops]
    out["engine_counts"] = dict(eng.dispatch_counts)
    out["engine_keyframes"] = eng.num_keyframes
    out["engine_bank"] = (tuple(eng.bank.shape), eng.bank.numel() * eng.bank.element_size(),
                          eng._bank_start)
    return out


def nccl_world1(mesh) -> dict:
    """One all_reduce and one all_gather through the port's Mesh on NCCL at
    world size 1."""
    x = torch.arange(4, dtype=torch.float32, device=mesh.device)
    return {"nccl": ".".join(map(str, torch.cuda.nccl.version())), "backend": mesh.backend,
            "all_reduce": mesh.all_reduce_sum(x), "all_gather": mesh.all_gather(x)}


def nccl_two_on_one_card(mesh) -> dict:
    """What NCCL does with two ranks on one card (a collective forces its
    communicator up)."""
    return {"all_reduce": mesh.all_reduce_sum(torch.ones(4, device=mesh.device))}


def mesh_phase(cfg: SlamConfig, sim: RadarSimulator, live_bank: torch.Tensor,
               odo_scans: list, slam_scan_list: list, gt_slam: np.ndarray,
               stream_loops: list, stream_traj: np.ndarray, dev, name_power: str) -> dict:
    """Phase 15: NCCL at world size 1 and refused for two ranks on one card,
    then MESH_RANKS gloo ranks on cuda:0 (``parallel.launch``) against the
    single-device paths on the same inputs.  Returns the launches of the
    mesh paths, summed over the ranks."""
    from navtech_radar_slam_torch.models import posegraph as pg_mod
    from navtech_radar_slam_torch.parallel.launch import launch

    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        # NCCL, world size 1
        t0 = time.perf_counter()
        one = launch(nccl_world1, 1, backend="nccl", devices=["cuda:0"], timeout=120.0)
        print(f"NCCL {one['nccl']} at world size 1 through the port's Mesh: all_reduce "
              f"{one['all_reduce'].tolist()}, all_gather {one['all_gather'].tolist()} "
              f"({time.perf_counter() - t0:.1f} s with the rank's start) [{name_power}]")
        if (one["backend"] != "nccl" or not np.array_equal(one["all_reduce"], np.arange(4))
                or not np.array_equal(one["all_gather"], np.arange(4)[None])):
            raise AssertionError(f"NCCL at world size 1: {one}")

        # NCCL with two ranks on cuda:0, before the gloo ranks start
        try:
            launch(nccl_two_on_one_card, 2, backend="nccl", devices=["cuda:0", "cuda:0"],
                   timeout=120.0)
            refused = None
        except RuntimeError as err:
            refused = str(err)
        first = (refused or "not refused").strip().splitlines()[-1]
        print(f"NCCL, two ranks on cuda:0: {first}")
        if refused is None or "Duplicate GPU" not in refused:
            raise AssertionError(f"NCCL took two ranks on one card: {refused}")

        # the inputs, made once and read by every rank
        d, excl = MESH_RANKS, cfg.scancontext.num_exclude_recent
        n_big = MESH_SEARCH_ROWS[-1] * d
        rng = np.random.default_rng(29)
        reps = -(-n_big // live_bank.shape[0])
        bank = all_live_bank(live_bank.repeat(reps, 1, 1)[:n_big].contiguous(),
                             live_bank.shape[0])
        # queries: rows spread over the smaller bank, rolled by a few columns
        picks = np.sort(rng.choice(MESH_SEARCH_ROWS[0] * d - 2 * excl, SLOTS, replace=False))
        queries = torch.roll(bank[torch.as_tensor(picks, device=dev)], shifts=3, dims=2)
        n_nodes = MESH_SOLVE_NODES * d
        pcfg = dataclasses.replace(cfg.pgo, max_nodes=n_nodes, gn_iters=3)
        # a noisy chain of unit steps turning 0.01 rad a node, loop factors
        # every 64 nodes at the true relative pose; each initial pose is off
        # the odometry chain by ~0.1 m and 0.01 rad, so that the solve must
        # move the poses far more than the two solves may differ
        graph = pg_mod.PoseGraph(pcfg, device=dev)
        unit = se2_to_se3_np(np.array([1.0, 0.0, 0.01])).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        gt_chain = [pose]
        graph.add_node(pose)
        for k in range(1, n_nodes):
            gt_chain.append(gt_chain[-1] @ unit)
            meas = se2_to_se3_np(np.array([1.0 + rng.normal(0, 0.05), rng.normal(0, 0.05),
                                           0.01 + rng.normal(0, 0.01)])).astype(np.float32)
            pose = pose @ meas
            jitter = se2_to_se3_np(rng.normal(0, [0.1, 0.1, 0.01])).astype(np.float32)
            graph.add_node(pose @ jitter, odom_meas=meas)
        for j in range(64, n_nodes, 64):
            graph.add_loop(j - 64, j, (np.linalg.inv(gt_chain[j - 64]) @ gt_chain[j]
                                       ).astype(np.float32))
        # the odometry streams as uint8 scans: stream b steps from scan b % 16
        odo_u8 = (np.clip(np.stack(odo_scans[:STREAM_OFFSETS + 1]), 0, 1) * 255).astype(np.uint8)
        np.savez(os.path.join(work, "inputs.npz"), bank=bank.cpu().numpy(),
                 queries=queries.cpu().numpy(), odo_u8=odo_u8,
                 **{f"graph_{i}": x.cpu().numpy() for i, x in enumerate(graph.g)})
        np.save(os.path.join(work, "slam_scans.npy"), np.stack(slam_scan_list))

        t0 = time.perf_counter()
        ranks = launch(mesh_rank, d, work, backend="gloo", devices="cuda:0", all_ranks=True,
                       timeout=MESH_TIMEOUT_S)
        mesh_s = time.perf_counter() - t0
        print(f"mesh: {d} gloo ranks on cuda:0 (CUDA tensors copied through the host), "
              f"{mesh_s:.1f} s with the ranks' start; one card measures no scaling "
              f"[{name_power}]")

        # 1. the sharded search against the single-device K2-T search
        err = 0.0
        for rows in MESH_SEARCH_ROWS:
            n = rows * d
            whole = bank[:n]
            rkeys = scancontext.ring_key(whole)
            for mode, scfg in _search_cfgs(cfg).items():
                for t in (1, SLOTS):
                    nvs = _search_num_valids(n, t, excl)
                    k0 = nvs[0] - 1
                    if mode == "full":
                        want = scancontext.detect_loop_multi(queries[:t], whole, k0, t, scfg)
                    else:
                        want = scancontext.detect_loop_ringkey_multi(queries[:t], whole, rkeys,
                                                                     k0, scfg)
                    got = [r["search"][(rows, mode, t)] for r in ranks]
                    for other in got[1:]:
                        for key, v in other.items():
                            if not np.array_equal(v, got[0][key]):
                                raise AssertionError(f"mesh search {rows} {mode} T={t}: ranks "
                                                     f"differ in {key}")
                    g_idx, w_idx = got[0]["idx"], want.idx.cpu().numpy()
                    e = float(np.abs(got[0]["dist"] - want.dist.cpu().numpy()).max())
                    err = max(err, e)
                    print(f"  sharded search, {rows} rows a rank ({n} in all), {mode}, T = {t}: "
                          f"idx equal to the single-device K2-T search "
                          f"{bool(np.array_equal(g_idx, w_idx))} ({int((g_idx >= 0).sum())} "
                          f"found), dist max abs err {e:.3g}")
                    if not np.array_equal(g_idx, w_idx) or e > SC_ATOL:
                        raise AssertionError(f"mesh search {rows} {mode} T={t}: idx {g_idx} vs "
                                             f"{w_idx}, dist err {e}")
            k2t = [r["search"][(rows, "k2t_ms")] for r in ranks]
            nbytes = [r["search"][(rows, "bank_bytes")] for r in ranks]
            print(f"  K2-T device ms per launch, each rank's {rows}-row block: 16 queries "
                  f"{', '.join('%.5f' % x[0] for x in k2t)} ({k2t[0][3]} slots a block; the "
                  f"earlier design, one slot a block: {', '.join('%.5f' % x[2] for x in k2t)});"
                  f" one query {', '.join('%.5f' % x[1] for x in k2t)}; bank bytes per rank "
                  f"{nbytes} [{name_power}]")
        search_k2t = sum(r["search_launches"]["sc_corr_multi"] for r in ranks)
        print(f"  the searches launched K2-T {[r['search_launches']['sc_corr_multi'] for r in ranks]}"
              f" times on the ranks")
        for name in ranks[0]["collective_ms"]:
            print(f"  collective {name}: {', '.join('%.4f' % r['collective_ms'][name] for r in ranks)}"
                  f" ms per call (CUDA events, median of 20) [{name_power}]")

        # 2. the distributed solve against the single-device solve
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = pg_mod.make_solver(pcfg)(graph.g).poses
        torch.cuda.synchronize()
        single_ms = 1e3 * (time.perf_counter() - t0)
        got = ranks[0]["solve_poses"]
        if any(not np.array_equal(r["solve_poses"], got) for r in ranks[1:]):
            raise AssertionError("the distributed solve differs between ranks")
        dpos = float(np.abs(got[:, :3, 3] - single.cpu().numpy()[:, :3, 3]).max())
        moved = float(np.abs(got[:, :3, 3] - graph.g.poses.cpu().numpy()[:, :3, 3]).max())
        print(f"  distributed solve, {n_nodes} nodes, {graph.num_loops} loops: positions within "
              f"{dpos:.3g} m of the single-device solve (limit {MESH_SOLVE_ATOL}; moved up to "
              f"{moved:.3g} m); "
              f"{', '.join('%.1f' % r['solve_ms'] for r in ranks)} ms on the ranks, "
              f"single device {single_ms:.1f} ms; host clock [{name_power}]")
        if (not dpos < MESH_SOLVE_ATOL or not moved >= 10 * MESH_SOLVE_ATOL
                or not np.isfinite(got).all()):
            raise AssertionError(f"distributed solve off the single-device one by {dpos} m "
                                 f"(limit {MESH_SOLVE_ATOL}), moved the poses {moved} m "
                                 f"(at least {10 * MESH_SOLVE_ATOL})")

        # 3. the sharded odometry against the unsharded batched step
        az = torch.as_tensor(default_azimuths(cfg), device=dev)
        step = make_batched_odometry_step(cfg, device=dev)
        u8 = torch.as_tensor(odo_u8, device=dev)
        offsets = torch.as_tensor(np.arange(MESH_STREAMS) % STREAM_OFFSETS, device=dev)
        prev = extract_scan_features_batched(u8[offsets], az, cfg)
        carry, res, feats = step(u8[offsets + 1], az, prev,
                                 torch.zeros(MESH_STREAMS, 3, device=dev))
        whole = {"res": res._asdict(), "carry": carry._asdict(), "feats": feats._asdict()}
        n_own, diffs = 0, {}
        for r in ranks:
            lo, hi = r["odo_block"]
            for part, leaves in r["odo"].items():
                for key, v in leaves.items():
                    if v is None:
                        continue
                    n_own += not np.array_equal(v, r["odo_own"][part][key])
                    w = whole[part][key][lo:hi].cpu().numpy()
                    if not np.array_equal(v, w):
                        if v.dtype.kind == "f":
                            both = np.isfinite(v) & np.isfinite(w)
                            e = float(np.abs(v[both] - w[both]).max()) if both.any() else 0.0
                            diffs[f"{part}.{key}"] = (int((v != w).sum()), e)
                        else:
                            diffs[f"{part}.{key}"] = (int((v != w).sum()), None)
        ok_same = all(np.array_equal(r["odo"]["res"]["ok"],
                                     whole["res"]["ok"][slice(*r["odo_block"])].cpu().numpy())
                      for r in ranks)
        rel_err = max(float(np.abs(r["odo"]["res"]["rel_pose"] - whole["res"]["rel_pose"][
            slice(*r["odo_block"])].cpu().numpy()).max()) for r in ranks)
        k1b = [r["odo_launches"]["cen_peaks_batched"] for r in ranks]
        print(f"  sharded odometry, {MESH_STREAMS} streams ({MESH_STREAMS // d} a rank): leaves "
              f"not bit-equal to the one-device step on the rank's own {MESH_STREAMS // d} "
              f"streams {n_own}; against the unsharded {MESH_STREAMS}-stream step: leaves "
              f"differing (elements, max abs err) {diffs or 'none'}, ok equal {ok_same}, "
              f"rel_pose max abs err {rel_err:.3g}; K1 x {MESH_STREAMS // d} launches {k1b} "
              f"(seed + step); step {', '.join('%.1f' % r['odo_ms'] for r in ranks)} ms on the "
              f"ranks [{name_power}]")
        # the batched step gives each stream the same bits at any batch size,
        # so the split into ranks changes no leaf
        if n_own or k1b != [2] * d or not ok_same or diffs:
            raise AssertionError(f"sharded odometry: {n_own} leaves differ from the rank's own "
                                 f"step, leaves {diffs} from the unsharded step, ok equal "
                                 f"{ok_same}, rel_pose off by {rel_err}, K1 x B {k1b}")

        # 4. the mesh engine against the single-device streamed run
        trajs = [r["engine_traj"] for r in ranks]
        if any(not np.array_equal(t_, trajs[0]) for t_ in trajs[1:]):
            raise AssertionError("the mesh engine's trajectories differ between ranks")
        lm = ranks[0]["engine_loops"]
        matched = lambda a, bs: any(abs(a[0] - b[0]) <= 2 and abs(a[1] - b[1]) <= 2 for b in bs)
        n_m = sum(matched(a, stream_loops) for a in lm)
        n_s = sum(matched(b, lm) for b in stream_loops)
        gt_rel = np.asarray([se2_between_np(gt_slam[0], g_) for g_ in gt_slam[:N_SLAM_SCANS]])
        path = float(np.sum(np.linalg.norm(np.diff(gt_rel[:, :2], axis=0), axis=1)))
        traj = trajs[0]
        ate = float(np.sqrt(np.mean(np.sum((traj[:, :2, 3] - gt_rel[:len(traj), :2]) ** 2,
                                           axis=1))))
        dtraj = float(np.abs(traj[:, :3, 3] - stream_traj[:, :3, 3]).max())
        launches = {k: sum(r["engine_launches"][k] for r in ranks) for k in ranks[0]["engine_launches"]}
        print(f"  mesh engine, streamed, SlamConfig(): {ranks[0]['engine_keyframes']} keyframes, "
              f"{len(lm)} loops {lm}; matched to the single-device run's {n_m}/{len(lm)} and "
              f"{n_s}/{len(stream_loops)}; positions within {dtraj:.3g} m of it; ATE {ate:.4f} m "
              f"over a {path:.2f} m path; dispatch counts {ranks[0]['engine_counts']}; launches "
              f"(both ranks) {launches}; bank per rank {[r['engine_bank'] for r in ranks]} "
              f"(shape, bytes, first row)")
        print(f"  mesh engine ms per scan: whole run "
              f"{', '.join('%.3f' % r['engine_whole_ms'] for r in ranks)}, median chunk step "
              f"{', '.join('%.3f' % r['engine_step_ms'] for r in ranks)} on the ranks; sums "
              f"segments {', '.join('%.1f' % r['engine_stage_ms'].get('segment', 0) for r in ranks)}"
              f", refine (all) {', '.join('%.1f' % r['engine_stage_ms'].get('refine', 0) for r in ranks)}"
              f" ms; host clock after synchronize [{name_power}]")
        if (ranks[0]["engine_keyframes"] != N_SLAM_SCANS or not lm
                or n_m < len(lm) // 2 or n_s < len(stream_loops) // 2 or dtraj > 0.1
                or not ate < 0.01 * path):
            raise AssertionError(f"mesh engine: loops {lm} vs {stream_loops}, positions off by "
                                 f"{dtraj} m, ATE {ate} m over {path} m")
        if (launches["sc_corr_multi"] == 0 or launches["nn_dist_multi"] == 0
                or launches["cen_peaks"] != d * (N_SLAM_SCANS + 1)):
            raise AssertionError(f"mesh engine launches {launches}")
        total = {k: launches[k] + sum(r["odo_launches"][k] for r in ranks)
                 for k in launches}
        total["sc_corr_multi"] += search_k2t
        return total
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 18: the Cartesian utilities, the SCManager interface and the
# multi-session query (outside the engine)
# ---------------------------------------------------------------------------

def host_syncs(fn) -> tuple:
    """(fn's result, the synchronizing CUDA operations it made), counted
    from torch.cuda.set_sync_debug_mode's warnings (not its one-time note
    that the mode is a prototype)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def cartesian_phase(x: torch.Tensor, cfg: SlamConfig, dev, name_power: str) -> None:
    """Phase 18 (a): polar_to_cartesian of one full-size scan to the
    configured 512 x 512 image at 0.5 m, then patch_descriptors at the scan's
    1024 features (extract_scan_features' xy), on the card and on CPU copies
    of the same inputs: max abs err <= CART_ATOL and the same zeros."""
    fc = cfg.features
    az = torch.as_tensor(default_azimuths(cfg), device=dev)
    xy = extract_scan_features(x, az, cfg).xy
    cart = polar_to_cartesian(x, fc, cfg.radar)
    patches = patch_descriptors(cart, xy, fc)
    runs = {
        "polar_to_cartesian": (cart, polar_to_cartesian(x.cpu(), fc, cfg.radar),
                               lambda: polar_to_cartesian(x, fc, cfg.radar)),
        "patch_descriptors": (patches, patch_descriptors(cart.cpu(), xy.cpu(), fc),
                              lambda: patch_descriptors(cart, xy, fc)),
    }
    torch.cuda.synchronize()
    for name, (got, want, call) in runs.items():
        got = got.cpu()
        err = float((got - want).abs().max())
        zeros = int(((got == 0) != (want == 0)).sum())
        for _ in range(5):
            call()
        ms = median_ms(call, TIMED_RUNS)
        wall, busy, n_kernels, _, _, markers = device_busy(call)
        seen = "no device events" if busy is None else f"busy {busy:.4f} ms"
        print(f"{name} {tuple(got.shape)} on the card against the CPU: max abs err {err:.3g}, "
              f"zeros differing {zeros} (zeros {int((want == 0).sum())}); median {ms:.4f} ms "
              f"of {TIMED_RUNS} CUDA-event-timed calls; one call under torch.profiler "
              f"{wall:.3f} ms wall, device kernels {n_kernels}, {seen} (marker kernels kept "
              f"{markers} of {PROFILE_MARKERS}) [{name_power}]")
        if not err <= CART_ATOL or zeros:
            raise AssertionError(f"{name} on the card differs from the CPU: {err} > "
                                 f"{CART_ATOL} or {zeros} zeros differ")


def manager_run(scfg, clouds: list, clouds_cpu: list, capacity: int) -> tuple:
    """One manager on the card (no device given) and one on the CPU fed the
    same clouds, a detect after every insert past SC_MANAGER_FIRST_DETECT:
    every (index, yaw) the CPU's, no host sync and no K2 launch an insert,
    one of each a detect.  Returns the two managers."""
    gm = scancontext.ScanContextManager(scfg, capacity=capacity)
    cm = scancontext.ScanContextManager(scfg, capacity=capacity, device="cpu")
    if gm.bank.device.type != "cuda":
        raise AssertionError(f"ScanContextManager without device= is on {gm.bank.device}")
    found, per_insert, per_detect = 0, set(), set()
    for i, (xy, xy_cpu) in enumerate(zip(clouds, clouds_cpu)):
        before = sc_corr.launch_count
        _, syncs = host_syncs(lambda: gm.makeAndSaveScancontextAndKeys(xy))
        per_insert.add((syncs, sc_corr.launch_count - before))
        cm.makeAndSaveScancontextAndKeys(xy_cpu)
        if i < SC_MANAGER_FIRST_DETECT:
            continue
        before = sc_corr.launch_count
        got, syncs = host_syncs(gm.detectLoopClosureID)
        per_detect.add((syncs, sc_corr.launch_count - before))
        want = cm.detectLoopClosureID()
        found += got[0] >= 0
        if got != want:
            raise AssertionError(f"ScanContextManager ({scfg.search_mode}) after {i + 1} "
                                 f"inserts: the card's (index, yaw) {got}, the CPU's {want}")
    cells = int((gm.bank.cpu() != cm.bank).sum())
    n_detects = len(clouds) - SC_MANAGER_FIRST_DETECT
    print(f"  {scfg.search_mode} mode: {len(clouds)} inserts, {n_detects} detects, loops "
          f"{found}; (host syncs, K2 launches) an insert {sorted(per_insert)}, "
          f"a detect {sorted(per_detect)}; every (index, yaw) equal to the CPU manager's; "
          f"bank cells differing {cells}")
    if per_insert != {(0, 0)} or per_detect != {(1, 1)}:
        raise AssertionError(f"ScanContextManager ({scfg.search_mode}): (host syncs, K2 "
                             f"launches) an insert {per_insert}, a detect {per_detect}; "
                             f"expected (0, 0) and (1, 1)")
    return gm, cm


def sc_manager_phase(cfg: SlamConfig, sim: RadarSimulator, query: torch.Tensor,
                     live_bank: torch.Tensor, k2_ms: float, dev, name_power: str) -> dict:
    """Phase 18 (b, c): the SCManager interface over the 400 landmark
    clouds of ``sc_inputs`` in "full" and "ringkey" mode, a 60-cloud second
    session through saveScancontextAndKeys and
    detectLoopClosureIDBetweenSession, and detect_loop_between_sessions on
    the all-live bank at 0, 1, 400 and 4096 valid rows against the plain
    version; every counter reset just before and read just after.  Returns
    the launches."""
    capacity = cfg.keyframes.max_keyframes
    poses = sc_poses()
    clouds = [landmark_cloud(sim, p, dev) for p in poses]
    clouds_cpu = [c.cpu() for c in clouds]
    torch.cuda.synchronize()
    print(f"ScanContextManager(capacity={capacity}) on the card beside one on the CPU, "
          f"{len(clouds)} landmark clouds:")
    reset_counts()
    managers = {}
    for mode in ("full", "ringkey"):
        scfg = dataclasses.replace(cfg.scancontext, search_mode=mode)
        managers[mode] = manager_run(scfg, clouds, clouds_cpu, capacity)

    # a second session near 60 of the first session's poses
    scfg = managers["full"][0].cfg
    rng = np.random.default_rng(29)
    rows = np.sort(rng.choice(len(poses), SESSION_B_CLOUDS, replace=False))
    ang = rng.uniform(0.0, 2.0 * np.pi, SESSION_B_CLOUDS)
    rad = rng.uniform(0.0, 0.5, SESSION_B_CLOUDS)
    poses_b = poses[rows] + np.column_stack([rad * np.cos(ang), rad * np.sin(ang),
                                             rng.uniform(-0.5, 0.5, SESSION_B_CLOUDS)])
    sm = scancontext.ScanContextManager(scfg, capacity=capacity)
    saves = set()
    for pose in poses_b:
        xy = landmark_cloud(sim, pose, dev)
        n = xy.shape[0]
        desc = scancontext.make_scancontext(xy, torch.zeros(n, device=dev),
                                            torch.ones(n, dtype=torch.bool, device=dev), scfg)
        before = sc_corr.launch_count
        _, syncs = host_syncs(lambda: sm.saveScancontextAndKeys(desc))
        saves.add((syncs, sc_corr.launch_count - before))
    gm, cm = managers["full"]
    queries, found, at_row = set(), 0, 0
    for j in range(SESSION_B_CLOUDS):
        q, q_cpu = sm.bank[j], sm.bank[j].cpu()
        before = sc_corr.launch_count
        got, syncs = host_syncs(lambda: gm.detectLoopClosureIDBetweenSession(q))
        queries.add((syncs, sc_corr.launch_count - before))
        want = cm.detectLoopClosureIDBetweenSession(q_cpu)
        found += got[0] >= 0
        at_row += got[0] == rows[j]
        if got != want:
            raise AssertionError(f"second session, query {j}: the card's (index, yaw) {got}, "
                                 f"the CPU's {want}")
    print(f"  second session: {SESSION_B_CLOUDS} descriptors made on the card, saved with "
          f"saveScancontextAndKeys ((host syncs, K2 launches) a save {sorted(saves)}), each "
          f"queried through the first manager's detectLoopClosureIDBetweenSession "
          f"({sorted(queries)} a query): found {found}, at the row drawn near {at_row}; every "
          f"(index, yaw) equal to the CPU manager's")
    if saves != {(0, 0)} or queries != {(1, 1)} or sm.num != SESSION_B_CLOUDS:
        raise AssertionError(f"second session: saves {saves}, queries {queries} (expected "
                             f"(0, 0) and (1, 1)), {sm.num} rows saved")

    # detect_loop_between_sessions on the all-live bank against the plain version
    scored = []
    k2 = sc_corr.sc_shift_distances_cuda

    def recorded_k2(q, b):
        scored.append(b.shape[0])
        return k2(q, b)

    query_cpu, live_cpu = query.cpu(), live_bank.cpu()
    sc_corr.sc_shift_distances_cuda = recorded_k2
    try:
        for n in (0, 1, 400, live_bank.shape[0]):
            before = len(scored)
            got = scancontext.detect_loop_between_sessions(query, live_bank, n, scfg)
            want = scancontext.detect_loop_between_sessions(query_cpu, live_cpu, n, scfg)
            g = [float(v) for v in got]
            w = [float(v) for v in want]
            dist_ok = (g[1] == w[1] == float("inf")) or abs(g[1] - w[1]) <= SC_ATOL
            print(f"  detect_loop_between_sessions, {n} of {live_bank.shape[0]} rows valid: "
                  f"(idx, dist, yaw, found) {g} / plain {w}; K2 bank rows {scored[before:]}")
            if g[0] != w[0] or g[2] != w[2] or g[3] != w[3] or not dist_ok:
                raise AssertionError(f"detect_loop_between_sessions at {n} rows differs from "
                                     f"the plain version: {g} / {w}")
            if scored[before:] != [max(n, 1)]:
                raise AssertionError(f"detect_loop_between_sessions at {n} rows: K2 launches "
                                     f"on {scored[before:]} rows, expected [{max(n, 1)}]")
    finally:
        sc_corr.sc_shift_distances_cuda = k2
    launches = read_counts()
    want_k2 = 2 * (len(clouds) - SC_MANAGER_FIRST_DETECT) + SESSION_B_CLOUDS + 4
    others = {k: v for k, v in launches.items() if k != "sc_corr" and v}
    print(f"  launches {launches}: K2 {want_k2} expected (one a detect, a between-session "
          f"query and a detect_loop_between_sessions call)")
    if launches["sc_corr"] != want_k2 or others:
        raise AssertionError(f"phase 18 launched {launches}, expected K2 {want_k2} and "
                             f"nothing else")
    # the call's host work outlasts its device work, so its device time is
    # read from the profiler's trace of one call
    def call():
        return scancontext.detect_loop_between_sessions(query, live_bank, live_bank.shape[0],
                                                        scfg)

    for _ in range(5):
        call()
    wall_ms = median_ms(call, TIMED_RUNS)
    wall, busy, n_kernels, k2_trace, n_k2, markers = device_busy(call, "sc_corr_kernel")
    seen = ("no device events" if busy is None else
            f"busy {busy:.5f} ms, its K2 kernel {k2_trace:.5f} ms ({n_k2} launch)")
    print(f"detect_loop_between_sessions at {tuple(live_bank.shape)} (all valid): median "
          f"{wall_ms:.4f} ms of {TIMED_RUNS} CUDA-event-timed calls; one call under "
          f"torch.profiler {wall:.3f} ms wall, device kernels {n_kernels}, {seen} (marker "
          f"kernels kept {markers} of {PROFILE_MARKERS}); K2 alone at that bank {k2_ms:.5f} ms "
          f"by CUDA events (phase 17) [{name_power}]")
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
    for label, b in (("all live", live_bank), ("400 rows", live_bank[:400]),
                     ("30-row prefix", prefix)):
        check_k2t_bits(label, queries, b)

    # 9. K3-T against its plain version: 16 slots at (1024, 8192)
    src_t = torch.as_tensor(rng.uniform(-150, 150, (SLOTS, 1024, 2)), dtype=torch.float32,
                            device=dev)
    tgt_t = torch.as_tensor(rng.uniform(-150, 150, (SLOTS, 8192, 2)), dtype=torch.float32,
                            device=dev)
    # masks that differ per slot: a slot's share of invalid targets from 0 to 0.9
    tv_t = torch.as_tensor(rng.random((SLOTS, 8192)) >= np.linspace(0, 0.9, SLOTS)[:, None],
                           device=dev)
    half_slots = torch.arange(SLOTS, device=dev) % 2 == 0
    # valid targets as a prefix of each slot's 8192, as submaps pack them
    prefix_valid = torch.arange(8192, device=dev) < torch.as_tensor(
        rng.integers(0, 8193, (SLOTS, 1)), device=dev)
    print("K3-T vs plain (one launch for all slots):")
    k3t_err = max(
        check_k3t("masks differing per slot", src_t, tgt_t, tv_t),
        check_k3t("every target tied across the chunks", src_t,
                  tgt_t[:, :1024].repeat(1, 8, 1), tv_t),
        check_k3t("half the slots masked off", src_t, tgt_t, tv_t, half_slots),
        check_k3t("every slot masked off", src_t, tgt_t, tv_t, torch.zeros_like(half_slots)),
        check_k3t("valid targets a prefix, half the slots masked off", src_t, tgt_t,
                  prefix_valid, half_slots),
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
    stream_launches, stream_loops, stream_med, stream_whole, stream_traj = streaming_path(
        cfg, gt_slam, slam_scan_list, dev, name_power, scan_loops, scan_traj)
    print(f"full SLAM, ms per scan: per-scan median {scan_med:.3f} / whole run "
          f"{scan_whole:.3f}, streamed median {stream_med:.3f} / whole run "
          f"{stream_whole:.3f}; one call, host clock [{name_power}]")

    # 12. K1 x B against its plain version
    print("K1 x B vs plain (one launch for all scans):")
    batch = torch.as_tensor(np.stack(slam_scan_list + scans[:STREAMS - N_SLAM_SCANS]),
                            device=dev)
    batch[1] = inputs["packed4"]
    batch[2] = 0.0
    k1b_err = max(
        check_k1b("B = 1", x[None].contiguous(), cfg),
        check_k1b("B = 2", batch[3:5].contiguous(), cfg),
        check_k1b("B = 3", batch[3:6].contiguous(), cfg),
        check_k1b("B = 5, scan 1 through the 4-bit wire format, scan 2 all zero",
                  batch[:5].contiguous(), cfg),
        check_k1b("B = 33", batch[7:40].contiguous(), cfg),
        check_k1b("B = 64, scan 1 through the 4-bit wire format, scan 2 all zero", batch, cfg),
    )

    # 13. the batched odometry path
    batched_launches, batched_med, batched_step = batched_path(cfg, gt, scans, dev, name_power)
    print(f"odometry, ms per step: one stream (RadarOdometry.process) median {step_ms:.3f}, "
          f"{STREAMS} streams (make_batched_odometry_step) median {batched_med:.3f}; one call, "
          f"host clock [{name_power}]")

    # 14. the command line: a chunked run, a resume, a second session
    cli_launches = cli_path(cfg, name_power)

    # 15. the multi-device layer: NCCL at world size 1 and for two ranks on
    # one card, then two gloo ranks on cuda:0 against the single-device paths
    mesh_launches = mesh_phase(cfg, sim, live_bank, scans, slam_scan_list, gt_slam,
                               stream_loops, stream_traj, dev, name_power)

    # 16. kernel times at the main path's shapes
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
    shared_ms, shared_plain, pa, pb = kernel_vs_plain(
        lambda: sc_corr.sc_shift_distances_multi_cuda(queries, live_bank),
        lambda: scancontext.sc_shift_distance_matrix_multi_plain(queries, live_bank))
    print(f"K2-T sc_shift_distances_multi {tuple(queries.shape)} x {tuple(live_bank.shape)} "
          f"(shared bank, all live): kernel {shared_ms:.4f} ms, plain {shared_plain:.4f} ms "
          f"(halves {pa:.4f} / {pb:.4f}), median of {TIMED_RUNS} CUDA-event-timed runs each "
          f"[{name_power}]")
    k3t_ms, k3t_plain, pa, pb = kernel_vs_plain(
        lambda: nn_dist.nearest_neighbors_multi_cuda(src_t, tgt_t, tv_t),
        lambda: icp.nearest_neighbors_plain(src_t, tgt_t, tv_t))
    print(f"K3-T nearest_neighbors_multi {tuple(src_t.shape)} x {tuple(tgt_t.shape)}: "
          f"kernel {k3t_ms:.4f} ms, plain {k3t_plain:.4f} ms (halves {pa:.4f} / {pb:.4f}), "
          f"median of {TIMED_RUNS} CUDA-event-timed runs each [{name_power}]")
    k1b_ms, k1b_plain, pa, pb = kernel_vs_plain(
        lambda: cen_peaks.cen2019_scores_batched_cuda(batch, cfg.features, cfg.radar),
        lambda: cen2019.cen2019_scores_batched(batch, cfg.features, cfg.radar))
    print(f"K1 x B cen2019_scores_batched {tuple(batch.shape)}: kernel {k1b_ms:.4f} ms, plain "
          f"{k1b_plain:.4f} ms (halves {pa:.4f} / {pb:.4f}), median of {TIMED_RUNS} "
          f"CUDA-event-timed runs each [{name_power}]")

    # 17. device time per launch against the bound, at the main path's shapes
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
    # K1 x B and K2-T in this run's design against the earlier one (the
    # resident K1 x B; K2-T with one query slot a block), in turns
    for b in K1B_REPORT_SIZES:
        xb = batch[:b].contiguous()
        b_ms, b_by = bound(b * 8 * na * nbp, b * na * nbp * (2 * ntaps + 17))
        new_ms = device_ms(lambda: cen_peaks.cen2019_scores_batched_cuda(xb, fc, cfg.radar))
        old_ms = device_ms(lambda: cen_peaks._launch(xb, fc, cfg.radar, "k1b", "resident"))
        print(f"cen2019_scores_batched at B = {b} ({cen_peaks.design_for(b)} design): device "
              f"{new_ms:.5f} ms per launch, bound {1e3 * b_ms:.3f} us by {b_by}, share "
              f"{b_ms / new_ms:.4f}; the earlier design (resident) {old_ms:.5f} ms, share "
              f"{b_ms / old_ms:.4f}" + (f"; {EARLIER_K1B_MS} ms before this design (PERF.md)"
                                         if b == STREAMS else "") + f" [{name_power}]")
    for n in K2T_REPORT_ROWS:
        b = live_bank[:n]
        b_ms, b_by = bound(*k2t_work(queries, b))
        qgroup = sc_corr.multi_geometry(SLOTS, n, False)[1]
        new_ms = device_ms(lambda: sc_corr.sc_shift_distances_multi_cuda(queries, b))
        old_ms = device_ms(lambda: sc_corr._launch_multi(queries, b, 1))
        print(f"sc_shift_distances_multi {tuple(queries.shape)} x {tuple(b.shape)} (shared bank, "
              f"{qgroup} slots a block): device {new_ms:.5f} ms per launch, bound "
              f"{1e3 * b_ms:.3f} us by {b_by}, share {b_ms / new_ms:.4f}; the earlier design "
              f"(one slot a block) {old_ms:.5f} ms, share {b_ms / old_ms:.4f}"
              + (f"; {EARLIER_K2T_MS} ms before the query groups (PERF.md)" if n == 30 else "")
              + f" [{name_power}]")
    n_valid_t = int(tv_t.sum())
    k3t_half_ms = device_ms(lambda: nn_dist.nearest_neighbors_multi_cuda(src_t, tgt_t, tv_t,
                                                                         half_slots))
    half_ms, _ = bound(SLOTS // 2 * (8 * nq + 9 * nt + 12 * nq),
                       5 * nq * int(tv_t[half_slots].sum()))
    print(f"nearest_neighbors_multi {tuple(src_t.shape)} x {tuple(tgt_t.shape)} with half the "
          f"slots masked off: device {k3t_half_ms:.5f} ms per launch, bound {1e3 * half_ms:.3f} "
          f"us, instruction floor {2e3 * half_ms:.3f} us [{name_power}]")
    # every target valid, as on the ICP path (phases 11 and 14 print the
    # valid targets of their launches)
    all_valid = torch.ones_like(tv_t)
    k3t_full_ms = device_ms(lambda: nn_dist.nearest_neighbors_multi_cuda(src_t, tgt_t, all_valid))
    full_ms, _ = bound(SLOTS * (8 * nq + 9 * nt + 12 * nq), 5 * nq * SLOTS * nt)
    print(f"nearest_neighbors_multi {tuple(src_t.shape)} x {tuple(tgt_t.shape)} with every "
          f"target valid: device {k3t_full_ms:.5f} ms per launch, bound {1e3 * full_ms:.3f} us, "
          f"instruction floor {2e3 * full_ms:.3f} us [{name_power}]")
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
        "cen2019_scores_batched": (
            lambda: cen_peaks.cen2019_scores_batched_cuda(batch, fc, cfg.radar),
            # K1's count for each of the 64 scans (11.06 MB a scan)
            batch.shape[0] * 8 * na * nbp, batch.shape[0] * na * nbp * (2 * ntaps + 17),
            k1b_ms, k1b_plain, k1b_err, "cen_peaks_batched", "cen_peaks", "cen_peaks.py:121"),
    }
    #: the path whose launches a kernel's report gives (the per-scan SLAM
    #: path for the rest)
    main_path = {"sc_corr_multi": stream_launches, "nn_dist_multi": stream_launches,
                 "cen_peaks_batched": batched_launches}
    report = []
    for name, (launch, n_bytes, n_ops, ms, plain, err, counter, src_name,
               tpu) in specs.items():
        odo_n = odo_launches.get(counter, 0)
        dev_ms = device_ms(launch)
        b_ms, b_by = bound(n_bytes, n_ops)
        per_call = kernels_per_call(name, launch)
        main = main_path.get(counter, launches)
        # K3's 5 operations a pair are separate FSUB / FMUL / FADD, which
        # issue at half the FMA-counted peak: the floor beside the bound
        floor = (f", instruction floor {2e3 * b_ms:.3f} us"
                 if counter in ("nn_dist", "nn_dist_multi") else "")
        earlier = {"nn_dist_multi": EARLIER_K3T_MS, "sc_corr_multi": EARLIER_K2T_MS,
                   "cen_peaks_batched": EARLIER_K1B_MS}.get(counter)
        if earlier is not None:
            floor += f", the earlier design {earlier} ms ({dev_ms / earlier:.4f} of it)"
        print(f"{name}: device {dev_ms:.5f} ms per launch (CUDA events over "
              f"{DEVICE_LAUNCHES} back-to-back launches), bound {1e3 * b_ms:.3f} us by "
              f"{b_by}{floor} ({n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.2f} Mop), share "
              f"{b_ms / dev_ms:.4f}; wrapper-inclusive {ms:.4f} ms; launches odometry "
              f"{odo_n}, SLAM per scan {launches[counter]}, streamed "
              f"{stream_launches[counter]}, batched {batched_launches[counter]}, CLI "
              f"{cli_launches[counter]}, mesh (both ranks) {mesh_launches[counter]}; device "
              f"work per call (CUDA graph capture): {per_call[0]} kernel, {per_call[1]} other "
              f"nodes [{name_power}]")
        if per_call != (1, 0):
            raise AssertionError(f"{name}: one call put {per_call[0]} kernels and "
                                 f"{per_call[1]} other nodes on the device, expected one kernel")
        if main[counter] == 0:
            raise AssertionError(f"{name}: no launch on its main path")
        report.append({
            "name": name, "route": "cuda",
            "source": f"navtech_radar_slam_torch/csrc/{src_name}.cu",
            "replaces": f"navtech_radar_slam_tpu/ops/pallas/{tpu}",
            "launches": main[counter], "launches_odometry": odo_n,
            "launches_slam": launches[counter], "launches_streaming": stream_launches[counter],
            "launches_batched": batched_launches[counter],
            "launches_cli": cli_launches[counter], "launches_mesh": mesh_launches[counter],
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })

    # one odometry step of each path under the profiler: the K1 (K1 x B)
    # kernel's device ms in the trace as a share of the busy time, and its
    # device ms from the readings above beside it
    one = RadarOdometry(cfg, device=dev)
    one.process(scans[0])
    k1_dev = {r["name"]: r["device_ms"] for r in report}
    for label, fn, k1_name in (("one RadarOdometry.process (scan 1 after scan 0)",
                                lambda: one.process(scans[1]), "cen2019_scores"),
                               (f"one batched step (B = {STREAMS})", batched_step,
                                "cen2019_scores_batched")):
        wall, busy, n_kernels, k1_trace, n_k1, markers = device_busy(fn, "cen2019_")
        k1 = k1_dev[k1_name]
        if busy is None:
            seen = "not measured (no device events)"
        elif n_k1:
            seen = (f"{busy:.3f} ms, share {busy / wall:.4f}; its {k1_name} kernel in the trace "
                    f"{k1_trace:.5f} ms ({n_k1} launch): {k1_trace / busy:.4f} of the busy "
                    f"time, {k1_trace / wall:.4f} of the wall; {k1:.5f} ms by CUDA events")
        else:
            seen = (f"{busy:.3f} ms, share {busy / wall:.4f}; the trace holds no {k1_name} "
                    f"kernel, so the busy time and kernel count leave it out ({k1:.5f} ms by "
                    f"CUDA events)")
        print(f"{label} under torch.profiler: {wall:.3f} ms wall, device kernels {n_kernels}, "
              f"busy {seen}; marker kernels the trace kept {markers} of {PROFILE_MARKERS} "
              f"[{name_power}]")

    # 18. the Cartesian utilities, the SCManager interface and the
    # multi-session query
    cartesian_phase(x, cfg, dev, name_power)
    k2_report = next(r for r in report if r["name"] == "sc_shift_distances")
    sc_launches = sc_manager_phase(cfg, sim, query, live_bank, k2_report["device_ms"], dev,
                                   name_power)
    for r in report:
        r["launches_sc_manager"] = sc_launches[specs[r["name"]][6]]

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
