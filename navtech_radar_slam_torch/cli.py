"""Command-line entry point of the PyTorch port, the reference's launch
contract (launch/navtech_radar_slam_mulran.launch, sc_pgo.launch: seq_dir,
do_slam, keyframe_meter_gap=0.2, sc_dist_thres=0.45):

    python -m navtech_radar_slam_torch.cli --seq_dir <MulRan sequence> \\
        [--do_slam true] [--keyframe_meter_gap 0.2] [--sc_dist_thres 0.45] \\
        [--chunk 16] [--device cuda|cpu] ...

A copy of ``navtech_radar_slam_tpu/cli.py`` with the same flags and
defaults, but:

  * ``--device {cuda,cpu}`` (default cuda) in place of ``--platform``; with
    cuda and no card it raises, it never falls back to the CPU;
  * ``--mesh N`` with N > 1 launches N ranks itself (``parallel.launch``),
    one engine each on a ``parallel.mesh.Mesh``: with ``--device cpu`` over
    gloo, with ``--device cuda`` over NCCL with rank r on ``cuda:r`` (it
    raises before launching when fewer than N cards are visible).  Rank 0
    alone prints and writes the outputs, snapshots, loop dumps and
    checkpoints; ``--resume`` keeps the mesh;
  * ``--save_plot true`` (the default) needs matplotlib, checked when the
    arguments are parsed;
  * the run's pending loops are committed before ``stats.json`` is built, so
    its loop count is the final one;
  * ``--profile_dir`` writes a torch.profiler Chrome trace.

Outputs in ``--output_dir``: trajectory_tum.txt, odometry_tum.txt,
map_points.csv, loops.csv, final.npz (and checkpoint.npz with
``--checkpoint_every``), stats.json (with ATE / RTE and loop recall when
the sequence ships global_pose.csv), result_map.png, and with ``--live``
the live_path_tum.txt / live_map.csv snapshots.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np


def _bool(s: str) -> bool:
    return str(s).lower() in ("1", "true", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="navtech_radar_slam_torch",
        description="Radar SLAM on MulRan-format sequences, PyTorch on an NVIDIA GPU",
    )
    p.add_argument("--seq_dir", required=True,
                   help="sequence directory (MulRan layout or a dir of polar PNGs)")
    p.add_argument("--do_slam", type=_bool, default=True,
                   help="enable loop closure + PGO (launch arg do_slam)")
    p.add_argument("--keyframe_meter_gap", type=float, default=None,
                   help="keyframe translation gate (sc_pgo.launch:3)")
    p.add_argument("--sc_dist_thres", type=float, default=None,
                   help="ScanContext loop threshold (sc_pgo.launch:4)")
    p.add_argument("--config", default=None, help="JSON config file (SlamConfig)")
    p.add_argument("--max_scans", type=int, default=0, help="0 = all")
    p.add_argument("--output_dir", default="slam_output")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="save engine checkpoint every N scans (0 = off)")
    p.add_argument("--resume", default=None, help="checkpoint to resume from")
    p.add_argument("--prior_session", default=None,
                   help="checkpoint of a PRIOR session to attach as a searchable prior "
                        "map (multi-session); the first inter-session loop rebases this "
                        "session into the prior's frame")
    p.add_argument("--use_gps", type=_bool, default=False)
    p.add_argument("--no_native_loader", action="store_true",
                   help="read the scans with the numpy PNG decoder on the main thread "
                        "instead of the native loader (C++ decode on prefetch threads)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace here")
    p.add_argument("--status_every", type=int, default=50)
    p.add_argument("--save_plot", type=_bool, default=True,
                   help="write result_map.png (map + path + loop chords); needs matplotlib")
    p.add_argument("--mesh", type=int, default=0,
                   help="ranks to shard the descriptor bank and the pose-graph solve over "
                        "(0 or 1: one device); the CLI launches them itself: gloo on the "
                        "CPU, NCCL with one card per rank on cuda")
    p.add_argument("--chunk", type=int, default=0,
                   help="stream N scans per chunk (odometry of the chunk on the device, "
                        "keyframes in fused segments; 0 = per scan). GPS works in chunk "
                        "mode too: fixes associate per keyframe timestamp.")
    p.add_argument("--prewarm", type=_bool, default=True,
                   help="run every streaming program once before the first scan (kernel "
                        "libraries, solver and segment buckets, packers); chunk mode only")
    p.add_argument("--loop_debug_dir", default=None,
                   help="dump loop_<k>_<accepted|rejected>.npz per loop verification "
                        "(query cloud + submap + decision scalars)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the engine runs; cuda raises when there is no card")
    p.add_argument("--pack4", type=_bool, default=True,
                   help="chunk mode: stream scans as 4-bit sqrt-companded packed bytes "
                        "(half the host->device transfer; see data/packing.py). "
                        "false = raw uint8")
    p.add_argument("--live", type=_bool, default=True,
                   help="emit live_path_tum.txt / live_map.csv snapshots at "
                        "MapConfig.path_rate_hz / map_rate_hz (wall clock) during the run")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """``build_parser().parse_args`` plus the checks an argument can fail
    before the run: the plot needs matplotlib."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.save_plot:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            p.error("--save_plot true needs matplotlib, which is not installed; "
                    "pass --save_plot false")
    return args


class LiveOutputs:
    """Periodic trajectory / map snapshots during a run: the offline form of
    the reference's rviz publishers (/aft_pgo_path at path_rate_hz,
    /aft_pgo_map at map_rate_hz, wall clock; a rate of 0 disables that
    stream).  Files are replaced atomically (tmp + rename)."""

    def __init__(self, output_dir: str, cfg, eng):
        self.dir = output_dir
        self.cfg = cfg
        self.eng = eng
        now = time.time()
        pr, mr = cfg.map.path_rate_hz, cfg.map.map_rate_hz
        self._path_period = 1.0 / pr if pr > 0 else None
        self._map_period = 1.0 / mr if mr > 0 else None
        self._next_path = now + (self._path_period or 0.0)
        self._next_map = now + (self._map_period or 0.0)

    def _atomic_write(self, name: str, writer):
        tmp = os.path.join(self.dir, "." + name + ".tmp")
        writer(tmp)
        os.replace(tmp, os.path.join(self.dir, name))

    def poll(self):
        from navtech_radar_slam_torch.data.mulran import save_trajectory_tum

        if self.eng.num_keyframes == 0:
            return
        now = time.time()
        if self._path_period is not None and now >= self._next_path:
            # drain=False: a snapshot never forces the deferred loop commits
            traj = self.eng.trajectory(drain=False)
            self._atomic_write("live_path_tum.txt",
                               lambda p: save_trajectory_tum(p, self.eng.kf_times, traj))
            self._next_path = now + self._path_period
        if self._map_period is not None and now >= self._next_map:
            pts = self.eng.aggregate_map(drain=False)
            self._atomic_write("live_map.csv", lambda p: np.savetxt(
                p, pts, delimiter=",", header="x,y", comments=""))
            self._next_map = now + self._map_period


def make_config(args):
    from navtech_radar_slam_torch.config import SlamConfig

    if args.config:
        with open(args.config) as f:
            cfg = SlamConfig.from_json(f.read())
    else:
        cfg = SlamConfig()
    if args.keyframe_meter_gap is not None:
        cfg = cfg.replace(keyframes=dataclasses.replace(
            cfg.keyframes, keyframe_meter_gap=args.keyframe_meter_gap))
    if args.sc_dist_thres is not None:
        cfg = cfg.replace(scancontext=dataclasses.replace(
            cfg.scancontext, sc_dist_thres=args.sc_dist_thres))
    cfg = cfg.replace(do_slam=args.do_slam)
    if args.use_gps:
        cfg = cfg.replace(pgo=dataclasses.replace(cfg.pgo, use_gps=True))
    return cfg


def scan_stream(args, cfg):
    """(generator of (power, azimuths, ray_valid, timestamp), scans, loader
    name).  The native loader (``runtime``: C++ decode on two prefetch
    threads) unless ``--no_native_loader`` is given or its library cannot be
    built, in which case the reason goes to stderr and the numpy decoder
    reads in line.  Power is the raw uint8 image (the device casts /255: a
    quarter of the float upload); ray_valid is the sensor's per-azimuth
    validity byte, which the engine applies on the device; the timestamp is
    the file name's."""
    from navtech_radar_slam_torch.data.mulran import MulranRadarDataset

    ds = MulranRadarDataset(args.seq_dir, cfg.radar, raw_u8=True)
    n = len(ds) if args.max_scans <= 0 else min(len(ds), args.max_scans)

    if not args.no_native_loader:
        from navtech_radar_slam_torch import runtime

        if runtime.native_available():
            paths = [os.path.join(ds.scan_dir, f) for f in ds.scan_files[:n]]
            # chunk mode reads two chunks back to back (two in flight): the
            # queue holds both, so they are decoded while the engine works
            loader = runtime.NativeRadarLoader(paths, cfg.radar, raw_u8=True,
                                               queue_capacity=max(8, 2 * args.chunk))

            def gen_native():
                try:
                    for i, (power, _, az, valid) in enumerate(loader):
                        yield power, az, valid, ds.timestamp(i)
                finally:
                    loader.close()

            return gen_native(), n, "native"
        print(f"native loader unavailable; reading with the python loader:\n"
              f"{runtime.build_error()}", file=sys.stderr)

    def gen_py():
        for i in range(n):
            s = ds[i]
            yield s.power, s.azimuths, s.valid, s.timestamp

    return gen_py(), n, "python"


def load_gps(seq_dir: str):
    """(times, altitudes) of ``<seq_dir>/gps.csv``, or None (reported on
    stderr) when it is missing, unreadable or holds no usable fix."""
    from navtech_radar_slam_torch.data.mulran import load_gps_csv

    gps_path = os.path.join(seq_dir, "gps.csv")
    if not os.path.exists(gps_path):
        print(f"gps requested but {gps_path} missing; continuing without")
        return None
    try:
        times, alts, skipped = load_gps_csv(gps_path)
    except OSError as e:
        print(f"gps.csv unreadable ({e}); continuing without", file=sys.stderr)
        return None
    if skipped:
        print(f"gps: skipped {skipped} malformed line(s) in {gps_path}", file=sys.stderr)
    if not len(times):
        print("gps.csv held no usable fixes; continuing without", file=sys.stderr)
        return None
    print(f"gps: {len(times)} fixes from {gps_path}")
    return times, alts


#: collective timeout of a --mesh run's process group (s): the longest a rank
#: may wait for the others at one collective
MESH_TIMEOUT_S = 900.0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.mesh > 1:
        return _main_mesh(args, argv)
    return _run(args)


def _main_mesh(args, argv) -> int:
    """Launch ``--mesh N`` ranks, each running ``_run`` on its mesh; rank 0's
    exit code is the run's."""
    import torch

    from navtech_radar_slam_torch.parallel.launch import launch
    from navtech_radar_slam_torch.utils.device import resolve_device

    n = args.mesh
    if args.device == "cuda":
        resolve_device("cuda")
        visible = torch.cuda.device_count()
        if visible < n:
            raise RuntimeError(f"--mesh {n} --device cuda runs rank r on cuda:r (NCCL needs "
                               f"a card per rank): {visible} visible")
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n)]
    else:
        backend, devices = "gloo", "cpu"
    # the host's cores split between the ranks (torch's default of one
    # thread per core in each rank oversubscribes them)
    threads = max(1, (os.cpu_count() or 1) // n)
    print(f"mesh: {n} ranks, {backend} on {args.device}, {threads} torch threads each",
          flush=True)
    return launch(_mesh_rank, n, argv, backend=backend, devices=devices,
                  timeout=MESH_TIMEOUT_S, deadline=None, threads=threads)


def _mesh_rank(mesh, argv) -> int:
    """One rank of a --mesh run: ranks other than 0 print nothing."""
    if mesh.rank != 0:
        sys.stdout = open(os.devnull, "w")
    return _run(parse_args(argv), mesh)


def _run(args, mesh=None) -> int:
    """The run on one device, or as one rank of ``mesh`` (every rank runs
    the engine; rank 0 alone writes)."""
    from navtech_radar_slam_torch.data.packing import pack4
    from navtech_radar_slam_torch.models.slam import SlamEngine
    from navtech_radar_slam_torch.utils import checkpoint as ckpt
    from navtech_radar_slam_torch.utils import profiling
    from navtech_radar_slam_torch.utils.device import resolve_device

    device = mesh.device if mesh is not None else resolve_device(args.device)
    writer = mesh is None or mesh.rank == 0
    cfg = make_config(args)
    if writer:
        os.makedirs(args.output_dir, exist_ok=True)

    if args.resume:
        print(f"resuming from {args.resume}")
        eng = ckpt.load_engine(args.resume, device=device, mesh=mesh)
        start_scan = eng.num_scans
    else:
        eng = SlamEngine(cfg, device=device, mesh=mesh)
        start_scan = 0
        if args.prior_session:
            print(f"attaching prior session {args.prior_session}")
            eng.attach_prior_session(args.prior_session)
            print(f"prior map: {eng.num_keyframes} keyframes")

    if args.loop_debug_dir and writer:
        os.makedirs(args.loop_debug_dir, exist_ok=True)
        eng.loop_debug_dir = args.loop_debug_dir

    stream, total, loader_kind = scan_stream(args, cfg)
    print(f"sequence: {args.seq_dir} ({total} scans, {loader_kind} loader, "
          f"do_slam={cfg.do_slam}, device={device})")

    # MulRan gps.csv (stamp_ns, lat, lon, alt, ...): altitude only, within
    # cfg.pgo.gps_time_window of a scan (laserPosegraphOptimization.cpp:439-451)
    gps = load_gps(args.seq_dir) if cfg.pgo.use_gps else None
    chunk = max(0, args.chunk)
    if chunk > 1 and gps is not None:
        # chunk mode associates the fixes per keyframe inside the segments
        eng.set_gps_table(*gps)

    live = LiveOutputs(args.output_dir, cfg, eng) if args.live and writer else None
    timers = profiling.StageTimers()
    eng.timers = timers
    t0 = time.time()
    processed = 0
    # the warm window (the first chunks or scans) pays the one-time costs;
    # stats.json gives the streaming rate after it separately
    warm_target = 2 * chunk if chunk > 1 else 8
    warm = {"t_end": None, "processed": 0}

    def _warm_mark():
        if warm["t_end"] is None and processed >= warm_target:
            warm["t_end"] = time.time()
            warm["processed"] = processed

    if chunk > 1:
        if args.prewarm:
            tp = time.time()
            exp = min(total, eng.cfg.keyframes.max_keyframes)
            eng.prewarm(exp, chunk, per_scan_azimuths=True, live_outputs=args.live,
                        pack4=args.pack4)
            # the last, shorter chunk has other shapes
            rem = (total - start_scan) % chunk
            if rem:
                eng.prewarm(exp, rem, per_scan_azimuths=True, full=False, pack4=args.pack4)
            print(f"prewarm: {time.time() - tp:.1f}s")
        # two chunks in flight: chunk t + 1 is uploaded and its odometry queued
        # (begin_chunk) before chunk t's results are read (finish_chunk)
        buf = []
        meta = collections.deque()   # (last scan index, scans) per chunk in flight

        def finish_one():
            nonlocal processed
            with timers.time("slam_chunk"):
                eng.finish_chunk()
            last_idx, n_scans = meta.popleft()
            processed += n_scans
            _warm_mark()
            if live is not None:
                with timers.time("live_poll"):
                    live.poll()
            if args.status_every and processed % (
                    args.status_every - args.status_every % chunk or chunk) == 0:
                # the estimate does not drain: current_pose() would finish the
                # younger chunk in flight and stall the pipeline
                pose = eng._pose_estimate()
                print(f"[{last_idx + 1}/{total}] kf={eng.num_keyframes} "
                      f"loops={len(eng.loops)} pose=({pose[0]:.1f}, {pose[1]:.1f}, "
                      f"{pose[2]:.2f}) {processed / (time.time() - t0):.2f} scans/s")
            if args.checkpoint_every and processed % max(
                    chunk, args.checkpoint_every - args.checkpoint_every % chunk) == 0:
                ckpt.save_engine(eng, os.path.join(args.output_dir, "checkpoint.npz"))
                # save_engine finished every chunk in flight: retire their entries
                while len(meta) > eng.inflight_chunks:
                    _, n_extra = meta.popleft()
                    processed += n_extra
                    _warm_mark()

        with profiling.device_trace(args.profile_dir if writer else None):
            for i, (power, azimuths, valid, ts) in enumerate(stream):
                if i < start_scan:
                    continue
                buf.append((power, azimuths, valid, ts))
                if len(buf) == chunk or i == total - 1:
                    powers = np.stack([b[0] for b in buf])
                    if args.pack4:
                        powers = pack4(powers)   # half the upload, unpacked on the device
                    azs = np.stack([b[1] for b in buf])
                    valids = np.stack([b[2] for b in buf])
                    tss = [b[3] for b in buf]
                    buf = []
                    with timers.time("chunk_begin"):
                        eng.begin_chunk(powers, azs, tss, ray_valids=valids,
                                        packed=args.pack4)
                    meta.append((i, len(tss)))
                    if eng.inflight_chunks >= 2:
                        finish_one()
            while meta:
                finish_one()
        return _finalize(args, eng, processed, time.time() - t0, timers, t0, warm, writer)

    with profiling.device_trace(args.profile_dir if writer else None):
        for i, (power, azimuths, valid, ts) in enumerate(stream):
            if i < start_scan:
                continue
            if gps is not None:
                times, alts = gps
                j = int(np.searchsorted(times, ts))
                for cand in (j - 1, j):
                    if 0 <= cand < len(times) and abs(times[cand] - ts) < cfg.pgo.gps_time_window:
                        eng.add_gps(np.array([0.0, 0.0, float(alts[cand])]))
                        break
            with timers.time("slam_step"):
                eng.process(power, azimuths, timestamp=ts, ray_valid=valid)
            processed += 1
            _warm_mark()
            if live is not None:
                with timers.time("live_poll"):
                    live.poll()
            if args.status_every and processed % args.status_every == 0:
                pose = eng.current_pose()
                print(f"[{i + 1}/{total}] kf={eng.num_keyframes} loops={len(eng.loops)} "
                      f"pose=({pose[0]:.1f}, {pose[1]:.1f}, {pose[2]:.2f}) "
                      f"{processed / (time.time() - t0):.2f} scans/s")
            if args.checkpoint_every and processed % args.checkpoint_every == 0:
                ckpt.save_engine(eng, os.path.join(args.output_dir, "checkpoint.npz"))
    return _finalize(args, eng, processed, time.time() - t0, timers, t0, warm, writer)


def _evaluate(args, eng, stats, traj_path: str) -> None:
    """ATE / RTE and loop recall / precision into ``stats`` when the
    sequence ships global_pose.csv (MulRan ground truth)."""
    from navtech_radar_slam_torch import eval as eval_mod
    from navtech_radar_slam_torch.utils import metrics

    gt_path = os.path.join(args.seq_dir, "global_pose.csv")
    if not (os.path.exists(gt_path) and eng.num_keyframes >= 3):
        return
    t_est, se2_est = eval_mod.load_tum_se2(traj_path)
    t_gt, se2_gt = eval_mod.load_gt_se2(gt_path)
    ia, ib = eval_mod.associate(t_est, t_gt, 0.15)
    if len(ia) >= 3:
        stats.ate_rmse = metrics.ate_rmse(se2_est[ia][:, :2], se2_gt[ib][:, :2])
        # 10-keyframe segments where the trajectory allows, else the longest
        r = metrics.rte(se2_est[ia], se2_gt[ib], delta=min(10, len(ia) - 1))
        if not np.isnan(r):
            stats.rte = r
        print(f"ground truth: ATE {stats.ate_rmse:.3f} m, RTE {r:.3f} m over "
              f"{len(ia)} paired poses")
    # loops against the ground-truth revisits, keyframes paired by time
    kf_t = np.asarray(eng.kf_times, np.float64)
    ka, kb = eval_mod.associate(kf_t, t_gt, 0.15)
    if len(ka) == eng.num_keyframes:
        rec, prec = metrics.loop_recall_precision(
            [(e.prev_idx, e.curr_idx) for e in eng.loops], se2_gt[kb][:, :2],
            min_separation=eng.cfg.scancontext.num_exclude_recent)
        # NaN is "undefined": the field stays null, so stats.json is strict JSON
        if not np.isnan(rec):
            stats.loop_recall = rec
        if not np.isnan(prec):
            stats.loop_precision = prec
        if not (np.isnan(rec) and np.isnan(prec)):
            print(f"loops vs ground truth: recall {rec:.2f}, precision {prec:.2f}")


def _finalize(args, eng, processed: int, wall: float, timers, t0: float, warm: dict,
              writer: bool = True) -> int:
    """The run's epilogue: commit the pending loops, then the stats,
    trajectory and map exports, the evaluation, the final checkpoint and
    the plot.  On a mesh every rank drains and takes part in the final
    checkpoint; only the ``writer`` (rank 0) writes."""
    import torch

    from navtech_radar_slam_torch.data.mulran import save_trajectory_tum
    from navtech_radar_slam_torch.utils import checkpoint as ckpt
    from navtech_radar_slam_torch.utils import geometry as geo
    from navtech_radar_slam_torch.utils import metrics

    # drained first, so that stats.json counts every loop the run closed
    traj = eng.trajectory()
    stats = metrics.RunStats(
        num_scans=eng.num_scans,
        num_keyframes=eng.num_keyframes,
        num_loops=len(eng.loops),
        odometry_failures=eng.odometry.num_failures,
        frames_per_sec=processed / wall if wall > 0 else None,
    )
    if warm["t_end"] is not None:
        stats.warmup_s = warm["t_end"] - t0
        steady_n = processed - warm["processed"]
        steady_t = (t0 + wall) - warm["t_end"]
        if steady_n > 0 and steady_t > 0:
            stats.steady_scans_per_sec = steady_n / steady_t
            # the one-time cost: the warm window less the warm scans at the
            # steady rate
            stats.compile_s = max(
                0.0, stats.warmup_s - warm["processed"] / stats.steady_scans_per_sec)
    print("run:", stats.summary())
    print(timers.report())
    map_pts = eng.aggregate_map()
    if not writer:
        ckpt.save_engine(eng, os.path.join(args.output_dir, "final.npz"))
        return 0

    traj_path = os.path.join(args.output_dir, "trajectory_tum.txt")
    save_trajectory_tum(traj_path, eng.kf_times, traj)
    # the raw (pre-PGO) odometry trajectory: the /repub_odom analogue
    odom_se3 = (geo.se2_to_se3(torch.as_tensor(np.asarray(eng.odom_poses), dtype=torch.float32)
                               ).numpy() if eng.odom_poses else np.zeros((0, 4, 4)))
    save_trajectory_tum(os.path.join(args.output_dir, "odometry_tum.txt"), eng.kf_times,
                        odom_se3)
    map_path = os.path.join(args.output_dir, "map_points.csv")
    np.savetxt(map_path, map_pts, delimiter=",", header="x,y", comments="")
    if eng.loops:
        np.savetxt(os.path.join(args.output_dir, "loops.csv"),
                   np.asarray([[e.prev_idx, e.curr_idx, e.sc_dist, e.icp_fitness]
                               for e in eng.loops]),
                   delimiter=",", header="prev_kf,curr_kf,sc_dist,icp_fitness", comments="")
    try:
        _evaluate(args, eng, stats, traj_path)
    except Exception:  # the run's outputs stand without the evaluation
        print("ground-truth eval failed:", file=sys.stderr)
        traceback.print_exc()

    ckpt.save_engine(eng, os.path.join(args.output_dir, "final.npz"))
    with open(os.path.join(args.output_dir, "stats.json"), "w") as f:
        d = {k: (None if isinstance(v, float) and np.isnan(v) else v)
             for k, v in dataclasses.asdict(stats).items()}
        json.dump(d, f, indent=2)
    if args.save_plot:
        from navtech_radar_slam_torch.utils.viz import save_map_plot

        save_map_plot(
            os.path.join(args.output_dir, "result_map.png"), traj, map_pts, loops=eng.loops,
            odometry_xy=np.asarray(eng.odom_poses)[:, :2] if eng.odom_poses else None,
            title=f"{os.path.basename(args.seq_dir.rstrip('/'))}: "
                  f"{eng.num_keyframes} kf, {len(eng.loops)} loops")
    print(f"wrote {traj_path}, {map_path}, final.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
