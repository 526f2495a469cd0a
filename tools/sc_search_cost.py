#!/usr/bin/env python3
"""What the ScanContext key arithmetic costs on the card: the loop-search
ops alone and the per-scan SLAM engine around them.  Meant for holding two
checkouts of the port against each other in one call on one GPU.

    python3 tools/sc_search_cost.py [--root DIR] [--label NAME]
                                    [--scans 60] [--cache scans.npy]

imports ``navtech_radar_slam_torch`` from DIR (default: the checkout that
holds this script) and prints, at ``SlamConfig()`` on cuda:0:

  * for ``ring_key`` of one descriptor (a keyframe insert's key),
    ``detect_loop`` and ``detect_loop_ringkey`` on the 4,096-row bank of
    chip_smoke.py's phase 6 (400 landmark descriptors live, query row 399)
    and ``detect_loop_ringkey_multi`` for 16 slots (rows 384-399): the
    median ms of 30 calls on the host clock, each fenced by synchronize,
    and the device kernels and busy ms of one call (torch.profiler);
  * ``SlamEngine.process`` over ``--scans`` motion-distorted full-size
    scans of chip_smoke.py's circuit, in "full" and in "ringkey" mode: the
    median keyframe step (``_add_keyframe`` less the pose-graph refine in
    it, as chip_smoke.py prints it) over the scans that add a keyframe, the
    median and whole-run ms per scan (host clock after synchronize), then
    in a second run the device kernels of each scan (one torch.profiler
    session a scan): their sum, and the sums over keyframe and other scans;
  * the card's name and power limit (nvidia-smi), and one JSON line of all
    of it last.

``--cache`` keeps the rendered scans in a .npy file, so later runs in the
same call skip the simulator.  Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

MARKERS = 1000      # marker kernels opening each profiler session
TIMED_CALLS = 30


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def kernels_of(torch, fn) -> tuple:
    """(fn's result, device kernels, busy ms, marker kernels kept) of one
    call under torch.profiler.  The session opens with MARKERS sleep
    kernels, which the counts leave out: a session can lose its first
    device events."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    kept = sum(e.count for e in events if "spin_kernel" in e.key)
    events = [e for e in events if "spin_kernel" not in e.key]

    def us(e) -> float:
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    return out, sum(e.count for e in events), 1e-3 * sum(us(e) for e in events), kept


def host_ms(torch, fn) -> float:
    """Median ms of TIMED_CALLS calls on the host clock, each fenced by
    synchronize, after 5 warm-up calls."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def search_ops(torch, sc, cfg, sim, dev) -> dict:
    """The loop-search ops on phase 6's 400-live bank."""
    rng = np.random.default_rng(7)
    poses = np.column_stack([rng.uniform(-60, 60, 400), rng.uniform(-60, 60, 400),
                             rng.uniform(-np.pi, np.pi, 400)])
    bank = torch.zeros((cfg.keyframes.max_keyframes, cfg.scancontext.num_ring,
                        cfg.scancontext.num_sector), device=dev)
    for i, pose in enumerate(poses):
        r, b, _ = sim.visible_landmarks(pose)
        xy = torch.as_tensor(np.column_stack([r * np.cos(b), r * np.sin(b)]),
                             dtype=torch.float32, device=dev)
        n = xy.shape[0]
        bank[i] = sc.make_scancontext(xy, torch.zeros(n, device=dev),
                                      torch.ones(n, dtype=torch.bool, device=dev),
                                      cfg.scancontext)
    keys = sc.ring_key(bank)
    full = cfg.scancontext
    ring = dataclasses.replace(full, search_mode="ringkey")
    ops = {
        "ring_key, one descriptor": lambda: sc.ring_key(bank[5]),
        "detect_loop, 400 valid": lambda: sc.detect_loop(bank[399], bank, 400, full),
        "detect_loop_ringkey, 400 valid": lambda: sc.detect_loop_ringkey(
            bank[399], bank, keys, 400, ring),
        "detect_loop_ringkey_multi, 16 slots": lambda: sc.detect_loop_ringkey_multi(
            bank[384:400], bank, keys, 384, ring),
    }
    out = {}
    for name, fn in ops.items():
        ms = host_ms(torch, fn)
        _, n_kernels, busy, kept = kernels_of(torch, fn)
        out[name] = {"host_ms": ms, "kernels": n_kernels, "busy_ms": busy, "markers_kept": kept}
    return out


def engine_run(torch, slam_mod, cfg, scans, dev, profiled: bool) -> dict:
    """One SlamEngine.process run over ``scans``: per-scan ms and keyframe
    steps (host clock), or, ``profiled``, per-scan device kernels."""
    eng = slam_mod.SlamEngine(cfg, device=dev)
    stage = defaultdict(float)

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage[name] += time.perf_counter() - t0
            stage[name + "_calls"] += 1
            return out
        return wrapper

    eng._refine_graph = timed("refine", eng._refine_graph)
    eng._add_keyframe = timed("keyframe", eng._add_keyframe)
    per_scan, kf_scan, kernels = [], [], []
    t_run = time.perf_counter()
    for i, scan in enumerate(scans):
        stage.clear()
        if profiled:
            _, n, _, _ = kernels_of(torch, lambda: eng.process(scan, timestamp=i * 0.25))
            kernels.append(n)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.process(scan, timestamp=i * 0.25)
            torch.cuda.synchronize()
            per_scan.append(1e3 * (time.perf_counter() - t0))
        kf_scan.append((stage["keyframe_calls"] > 0,
                        1e3 * (stage["keyframe"] - stage["refine"])))
    eng.trajectory()
    torch.cuda.synchronize()
    whole = 1e3 * (time.perf_counter() - t_run)
    is_kf = np.asarray([k for k, _ in kf_scan])
    out = {"keyframes": int(eng.num_keyframes), "loops": int(eng.graph.num_loops),
           "keyframe_scans": int(is_kf.sum())}
    if profiled:
        k = np.asarray(kernels)
        out.update(kernels=int(k.sum()), kernels_keyframe_scans=int(k[is_kf].sum()),
                   kernels_other_scans=int(k[~is_kf].sum()))
    else:
        steps = np.asarray([ms for k, ms in kf_scan[1:] if k])   # scan 0 seeds the carry
        out.update(ms_per_scan_median=float(np.median(per_scan[1:])),
                   ms_per_scan_whole_run=whole / len(scans),
                   keyframe_step_ms_median=float(np.median(steps)) if len(steps) else None,
                   keyframe_step_ms_sum=float(steps.sum()))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--scans", type=int, default=60)
    ap.add_argument("--cache", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sc_search_cost.py needs a CUDA device")
    from navtech_radar_slam_torch.config import SlamConfig
    from navtech_radar_slam_torch.data import RadarSimulator
    from navtech_radar_slam_torch.models import slam as slam_mod
    from navtech_radar_slam_torch.ops import scancontext as sc
    if any(m == "jax" or m.startswith(("jax.", "navtech_radar_slam_tpu")) for m in sys.modules):
        raise AssertionError("JAX or the JAX package was imported")

    dev = torch.device("cuda:0")
    cfg = SlamConfig()
    sim = RadarSimulator(cfg.radar)
    name_power = card()
    print(f"{args.label or args.root}: navtech_radar_slam_torch from "
          f"{os.path.dirname(sc.__file__)} [{name_power}]", flush=True)
    if args.cache and os.path.exists(args.cache):
        scans = list(np.load(args.cache))
    else:
        gt = sim.circuit_trajectory(args.scans + 1, radius=10.0, speed=6.0)
        scans = [sim.render(gt[i], noise_seed=i, end_pose=gt[i + 1]) for i in range(args.scans)]
        if args.cache:
            np.save(args.cache, np.stack(scans))

    result = {"label": args.label, "card": name_power, "ops": search_ops(torch, sc, cfg, sim, dev)}
    for name, r in result["ops"].items():
        print(f"  {name}: {r['host_ms']:.4f} ms median of {TIMED_CALLS} (host clock, "
              f"synchronized), one call {r['kernels']} device kernels, busy {r['busy_ms']:.5f} ms "
              f"(markers kept {r['markers_kept']} of {MARKERS})", flush=True)
    for mode in ("full", "ringkey"):
        mcfg = dataclasses.replace(cfg, scancontext=dataclasses.replace(
            cfg.scancontext, search_mode=mode))
        timed = engine_run(torch, slam_mod, mcfg, scans, dev, profiled=False)
        counted = engine_run(torch, slam_mod, mcfg, scans, dev, profiled=True)
        result[f"engine_{mode}"] = {"timed": timed, "profiled": counted}
        print(f"  SlamEngine.process, {mode} mode, {len(scans)} scans: {timed['keyframes']} "
              f"keyframes, {timed['loops']} loops; keyframe step median "
              f"{timed['keyframe_step_ms_median']:.3f} ms over {timed['keyframe_scans']} "
              f"keyframe scans (sum {timed['keyframe_step_ms_sum']:.1f}); ms per scan median "
              f"{timed['ms_per_scan_median']:.3f}, whole run {timed['ms_per_scan_whole_run']:.3f} "
              f"(host clock after synchronize); device kernels {counted['kernels']} "
              f"({counted['kernels_keyframe_scans']} in keyframe scans, "
              f"{counted['kernels_other_scans']} in the others; the profiled run "
              f"{counted['keyframes']} keyframes, {counted['loops']} loops) [{name_power}]",
              flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
