"""Rank functions of the port's multi-device tests (test_torch_parallel.py,
test_torch_distributed_multiprocess.py), run on gloo CPU ranks by
``navtech_radar_slam_torch.parallel.launch``.  They import torch and the
port only, so a rank process starts without JAX; configs cross the process
boundary as ``SlamConfig.to_dict()`` dicts and data as numpy."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from navtech_radar_slam_torch.config import PgoConfig, ScanContextConfig, SlamConfig
from navtech_radar_slam_torch.models import posegraph as pg
from navtech_radar_slam_torch.models.slam import SlamEngine
from navtech_radar_slam_torch.ops import scancontext as sc_ops
from navtech_radar_slam_torch.parallel import dist_pgo, sharded_bank, sharded_odometry
from navtech_radar_slam_torch.utils import checkpoint as ckpt

#: the searches' recency exclusion (small, so that a 64-row bank has
#: searchable rows in several shards)
EXCLUDE = 4


def search_cases(mesh, cases: list) -> list:
    """The batched sharded detector for each (mode, queries (T, R, S), num_valids, bank)
    case on this rank's block of the bank, with the shift-distance calls
    this rank made (``sc_shift_distance_matrix_multi``, K2-T's dispatch
    point)."""
    real = sc_ops.sc_shift_distance_matrix_multi
    calls = []

    def counted(q, b):
        calls[-1] += 1
        return real(q, b)

    sc_ops.sc_shift_distance_matrix_multi = counted
    try:
        out = []
        for mode, queries, num_valids, bank in cases:
            cfg = ScanContextConfig(num_exclude_recent=EXCLUDE, search_mode=mode)
            lo, hi = mesh.block(bank.shape[0])
            local = torch.as_tensor(bank[lo:hi])
            calls.append(0)
            detect = sharded_bank.make_sharded_loop_detector_batch(mesh, cfg, shard_top_k=4)
            cand = detect(torch.as_tensor(queries), local, num_valids)
            out.append((cand._asdict(), calls[-1]))
    finally:
        sc_ops.sc_shift_distance_matrix_multi = real
    return out


def _graph(arrays) -> pg.GraphArrays:
    return pg.GraphArrays(*(torch.as_tensor(x) for x in arrays))


def solve_cases(mesh, cases: list) -> list:
    """For each (graph arrays, PgoConfig fields, bucketed, num_nodes): the
    distributed solve's poses, and the poses and step size of its first GN
    step; with ``bucketed`` the bucketed solver's poses too."""
    out = []
    for arrays, cfg_d, bucketed, num_nodes in cases:
        cfg = PgoConfig(**cfg_d)
        g = _graph(arrays)
        res = {"poses": dist_pgo.make_distributed_solver(mesh, cfg)(g)}
        step_g, step = pg._gn_step(g, cfg, cfg.lm_lambda0, dist_pgo.factor_shard(g, cfg, mesh))
        res.update(step_poses=step_g.poses, step=step)
        if bucketed:
            res["bucketed"] = dist_pgo.make_bucketed_distributed_solver(mesh, cfg)(
                g, num_nodes, 0).poses
        out.append(res)
    return out


def solve_and_cost(mesh, cases: list, cost: tuple) -> tuple:
    """``solve_cases`` and ``bucket_cost`` in one launch."""
    return solve_cases(mesh, cases), bucket_cost(mesh, *cost)


def bucket_cost(mesh, arrays, cfg_d: dict, num_nodes: int) -> tuple:
    """Least seconds of the bucketed and of the full-capacity distributed
    solve over 3 runs of each, taken in turns so that both see the same
    load (both warmed once)."""
    cfg = PgoConfig(**cfg_d)
    g = _graph(arrays)
    bucketed = dist_pgo.make_bucketed_distributed_solver(mesh, cfg)
    full = dist_pgo.make_distributed_solver(mesh, cfg)
    runs = (lambda: bucketed(g, num_nodes, 0), lambda: full(g))
    best = [float("inf"), float("inf")]
    for i in range(4):
        for j, fn in enumerate(runs):
            t0 = time.perf_counter()
            fn()
            if i:   # the first turn warms
                best[j] = min(best[j], time.perf_counter() - t0)
    return tuple(best)


def odometry_step(mesh, cfg_d: dict, prev_scans: np.ndarray, curr_scans: np.ndarray) -> dict:
    """One sharded batched step: this rank's block of the streams, seeded by
    the sharded extraction, and the result leaves gathered whole."""
    from navtech_radar_slam_torch.models.odometry import default_azimuths

    cfg = SlamConfig.from_dict(cfg_d)
    step, shard = sharded_odometry.make_sharded_batched_odometry(mesh, cfg)
    extract = sharded_odometry.make_sharded_extract(mesh, cfg)
    az = torch.as_tensor(default_azimuths(cfg))
    prev = shard(torch.as_tensor(prev_scans))
    carry = extract(prev, az)
    twists = shard(torch.zeros((prev_scans.shape[0], 3)))
    new_carry, res, feats = step(shard(torch.as_tensor(curr_scans)), az, carry, twists)
    return {"block": mesh.block(prev_scans.shape[0]), "streams": prev.shape[0],
            "res": res._asdict(), "carry": new_carry._asdict(), "feats": feats._asdict(),
            "gathered": sharded_odometry.gather_results(mesh, res)._asdict()}


def _engine_record(eng: SlamEngine) -> dict:
    return {"traj": eng.trajectory(), "loops": [(e.prev_idx, e.curr_idx) for e in eng.loops],
            "counts": dict(eng.dispatch_counts), "bank": eng.bank.clone(),
            "bank_whole": eng.bank_whole(), "bank_start": eng._bank_start,
            "cap": eng.cfg.keyframes.max_keyframes, "num_keyframes": eng.num_keyframes}


def run_engine(eng: SlamEngine, scans: np.ndarray, chunk: int, first: int = 0,
               save_at: int = 0, path: str = "") -> dict:
    """Scans ``first`` .. through ``eng``, per scan (``chunk`` 0) or in
    chunks, saving a checkpoint to ``path`` once ``save_at`` scans are in."""
    saved = None
    if chunk:
        for i in range(first, len(scans), chunk):
            stop = min(i + chunk, len(scans))
            eng.process_chunk(scans[i:stop], timestamps=[j * 0.25 for j in range(i, stop)])
            if save_at and stop == save_at:
                ckpt.save_engine(eng, path)
                saved = eng.trajectory(drain=False)
    else:
        for i in range(first, len(scans)):
            eng.process(scans[i], timestamp=i * 0.25)
            if save_at and i + 1 == save_at:
                ckpt.save_engine(eng, path)
                saved = eng.trajectory(drain=False)
    rec = _engine_record(eng)
    rec["saved_traj"] = saved
    return rec


def engine_cases(mesh, cfg_d: dict, scans: np.ndarray, chunk: int, save_at: int, path: str,
                 which: tuple) -> dict:
    """The mesh engine's cases named in ``which``: per scan, chunked (with a
    checkpoint at ``save_at``), and the resume of the chunked run's
    checkpoint."""
    cfg = SlamConfig.from_dict(cfg_d)
    out = {}
    if "per_scan" in which:
        out["per_scan"] = run_engine(SlamEngine(cfg, mesh=mesh), scans, 0)
    if "chunked" in which:
        out["chunked"] = run_engine(SlamEngine(cfg, mesh=mesh), scans, chunk, save_at=save_at,
                                    path=path)
    if "resumed" in which:
        eng = ckpt.load_engine(path, mesh=mesh)
        loaded = _engine_record(eng)
        out["resumed"] = run_engine(eng, scans, chunk, first=eng.num_scans)
        out["resumed"]["loaded"] = loaded
        out["resumed"]["mesh_kept"] = eng.mesh is mesh and eng._sharded
    return out


def two_process_problem(mesh, bank: np.ndarray, graph_arrays, cfg_d: dict) -> dict:
    """tests/distributed_worker.py's problem: one sharded search for bank
    row 5 (recency exclusion 4) and one distributed solve."""
    lo, hi = mesh.block(bank.shape[0])
    detect = sharded_bank.make_sharded_loop_detector(
        mesh, ScanContextConfig(num_exclude_recent=EXCLUDE))
    cand = detect(torch.as_tensor(bank[5]), torch.as_tensor(bank[lo:hi]), bank.shape[0])
    poses = dist_pgo.make_distributed_solver(mesh, PgoConfig(**cfg_d))(_graph(graph_arrays))
    return {"rank": mesh.rank, "size": mesh.size, "cand_idx": int(cand.idx),
            "cand_dist": float(cand.dist), "poses": poses}


def pgo_fields(cfg) -> dict:
    """A PgoConfig (of either package) as the fields ``PgoConfig(**d)`` takes."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


if __name__ == "__main__":
    # PYTHONPATH=. python tests/torch_parallel_ranks.py [runs]: bucket_cost's
    # bucketed and full-capacity seconds and their ratio on 4 gloo CPU ranks,
    # on the graph and config that test_torch_parallel.py::
    # test_bucketed_distributed_refine_cheaper_than_full times
    import sys

    from navtech_radar_slam_torch.parallel.launch import launch
    from test_torch_parallel import BASE_PGO, SOLVES, _chain

    import torch_parallel_ranks

    fields = dict(BASE_PGO, max_nodes=4096, max_loop_edges=8, gn_iters=1, cg_iters=16,
                  cg_tol=0.0)
    rng = np.random.default_rng(0)
    for nmax, lmax, nodes, loops, _, _ in SOLVES.values():   # the fixture's earlier draws
        _chain(rng, PgoConfig(**dict(BASE_PGO, max_nodes=nmax, max_loop_edges=lmax)), nodes,
               loops)
    arrays, n = _chain(rng, PgoConfig(**fields), 40, [(0, 16), (16, 32)])
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 3):
        t_bucket, t_full = launch(torch_parallel_ranks.bucket_cost, 4, arrays, fields, n,
                                  threads=1)
        print(f"bucket {t_bucket:.4f} s, full {t_full:.4f} s, ratio {t_bucket / t_full:.3f}",
              flush=True)
