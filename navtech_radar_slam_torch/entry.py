"""One radar-odometry step at a tiny configuration, on a given device, and
a dry run of the multi-device layer.

The counterpart of ``__graft_entry__.entry()``: ``entry(device)`` returns
``(fn, example_args)`` where ``fn(*example_args)`` runs cen2019 extraction,
constellation matching and the ORORA-style registration for one random
full-size scan against a carry extracted from the same scan.
``dryrun_multichip(n, backend, device)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: on n ranks, one sharded bank search,
one distributed pose-graph solve, one sharded odometry step and one chunk
of the mesh engine.
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


def _dryrun_rank(mesh) -> dict:
    """The four mesh paths of ``dryrun_multichip`` on one rank."""
    from navtech_radar_slam_torch.config import PgoConfig, ScanContextConfig
    from navtech_radar_slam_torch.data import RadarSimulator
    from navtech_radar_slam_torch.models import posegraph as pg
    from navtech_radar_slam_torch.models.slam import SlamEngine
    from navtech_radar_slam_torch.parallel import dist_pgo, sharded_bank, sharded_odometry
    from navtech_radar_slam_torch.utils import geometry as geo

    d, dev = mesh.size, mesh.device
    n = 8 * d
    rng = np.random.default_rng(0)
    sc_cfg = ScanContextConfig(num_exclude_recent=4)
    bank = torch.as_tensor(rng.random((n, sc_cfg.num_ring, sc_cfg.num_sector),
                                      dtype=np.float32), device=dev)
    lo, hi = mesh.block(n)
    detect = sharded_bank.make_sharded_loop_detector(mesh, sc_cfg)
    cand = detect(bank[2], bank[lo:hi], n)
    assert bool(torch.isfinite(cand.dist)), cand

    pgo_cfg = dataclasses.replace(PgoConfig(), max_nodes=n, max_loop_edges=8, gn_iters=2,
                                  cg_iters=16, odom_sigma_rot=0.01, odom_sigma_trans=0.05)
    graph = pg.PoseGraph(pgo_cfg, device=dev)
    pose = np.eye(4, dtype=np.float32)
    graph.add_node(pose)
    step = geo.se2_to_se3_np(np.array([1.0, 0.0, 0.05])).astype(np.float32)
    for _ in range(1, n):
        pose = pose @ step
        graph.add_node(pose, odom_meas=step)
    graph.add_loop(0, n - 1, geo.se2_to_se3_np(np.array([3.0, 1.0, 0.2])).astype(np.float32))
    poses = dist_pgo.make_distributed_solver(mesh, pgo_cfg)(graph.g)
    assert bool(torch.isfinite(poses).all())

    cfg = tiny_cfg()
    na, nb = cfg.radar.num_azimuths, cfg.radar.padded_range_bins
    az = torch.as_tensor(odo_mod.default_azimuths(cfg), device=dev)
    scans = torch.as_tensor(rng.random((d, na, nb), dtype=np.float32))
    sstep, shard = sharded_odometry.make_sharded_batched_odometry(mesh, cfg)
    local = shard(scans)
    carry = sharded_odometry.make_sharded_extract(mesh, cfg)(local, az)
    _, res, _ = sstep(local, az, carry, shard(torch.zeros((d, 3))))
    rels = sharded_odometry.gather_results(mesh, res).rel_pose
    assert rels.shape == (d, 3) and bool(torch.isfinite(rels).all())

    ecfg = dataclasses.replace(
        cfg, keyframes=dataclasses.replace(cfg.keyframes, max_keyframes=2 * d),
        pgo=dataclasses.replace(cfg.pgo, max_nodes=2 * d, max_loop_edges=2 * d, gn_iters=2,
                                cg_iters=16),
        scancontext=dataclasses.replace(cfg.scancontext, num_exclude_recent=2),
        icp=dataclasses.replace(cfg.icp, max_iters=8, max_query_points=256,
                                max_target_points=512))
    sim = RadarSimulator(ecfg.radar)
    n_scans = 8
    gt = sim.circuit_trajectory(n_scans, radius=10.0, speed=6.0)
    eng = SlamEngine(ecfg, mesh=mesh)
    eng.process_chunk(np.stack([sim.render(gt[i], noise_seed=i) for i in range(n_scans)]),
                      timestamps=[i * 0.25 for i in range(n_scans)])
    pose_now = eng.current_pose()
    assert np.isfinite(pose_now).all()
    assert eng.dispatch_counts["kf_segment"] >= 1, dict(eng.dispatch_counts)
    return {"cand_idx": int(cand.idx), "poses": poses[:, :2, 3], "rels": rels,
            "pose": pose_now, "keyframes": eng.num_keyframes}


def dryrun_multichip(n_devices: int, backend: str = "gloo", device: str = "cpu",
                     timeout: float = 600.0) -> list:
    """The multi-device layer once on ``n_devices`` ranks, each checked for
    finite results, and every rank's summary returned.  ``backend`` as the
    caller names it: ``gloo`` with every rank on ``device`` (the CPU, or one
    card shared through the host), or ``nccl`` with rank r on ``cuda:r``."""
    from navtech_radar_slam_torch.parallel.launch import launch

    devices = ([f"cuda:{r}" for r in range(n_devices)] if backend == "nccl"
               else str(resolve_device(device)))
    out = launch(_dryrun_rank, n_devices, backend=backend, devices=devices, all_ranks=True,
                 timeout=timeout)
    print(f"dryrun_multichip({n_devices}, {backend}): sharded bank search + distributed "
          f"PGO + sharded odometry + mesh streaming chunk OK on {n_devices} ranks")
    return out
