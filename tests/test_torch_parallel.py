"""The port's multi-device layer (``navtech_radar_slam_torch.parallel``)
against the JAX package's (``navtech_radar_slam_tpu.parallel``), case for
case with tests/test_parallel.py, on gloo CPU ranks started by
``parallel.launch`` (one torch thread each).  The JAX side runs on the
conftest's virtual CPU devices with ``make_mesh(d)`` at the port's world
size: d = 4, and d = 2 for the engine.  Each launch runs a module's cases
at once (a rank process takes seconds to start), while the JAX references
and the single-device port runs go on in a thread of this process.

Tolerances:
  * sharded search (:36), full and ring-key, T = 1 and 16, the live rows
    ending inside a shard, on a shard boundary and nowhere searchable: idx
    equal to JAX's sharded detector, dist within 2e-5, yaw within 1e-6;
    in full mode idx equal to the port's single-device detect; ranks with
    no searchable row launch nothing;
  * distributed solve (:60, :162 loop-heavy, :342 bucketed, :382 bucket
    cost, and the ``max_loop_edges % d != 0`` fallback): poses within
    POSE_ATOL (1e-4) of JAX's distributed solver, the first GN step's size
    within rtol 1e-3, positions within the JAX band (5e-2) of the
    single-device solve, every rank's poses bit-equal;
  * sharded odometry (:260): each stream bit-equal to the port's unsharded
    batched step, rel_pose within 1e-4 of JAX's sharded step;
  * mesh engine (:117 per scan, :424 chunked, :214 / :488 growth) at
    test_torch_slam.small_cfg from a capacity that grows twice (so the
    per-scan and chunked runs are the growth cases too): at least half the loops matched within ±2
    keyframes each way against the single-device port engine, trajectory
    within 0.1 m, every rank's trajectory bit-equal, JAX's dispatch
    structure (kf_segment equal, kf_insert_split <= 12, total <= 2x);
    after growth each rank holds exactly its block of the grown bank (its
    capacity the single-device engine's);
  * resume: a mesh run's checkpoint loads back onto its mesh (each rank
    its block, the state bit-equal to the run's at the save), the resumed
    mesh run matches the single-device resume of the same file within the
    engine band, and the JAX package loads the file too.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from navtech_radar_slam_tpu.config import PgoConfig as JPgoConfig
from navtech_radar_slam_tpu.config import ScanContextConfig as JScConfig
from navtech_radar_slam_tpu.data import RadarSimulator
from navtech_radar_slam_tpu.models import posegraph as jpg
from navtech_radar_slam_tpu.parallel import mesh as jmesh
from navtech_radar_slam_tpu.parallel import dist_pgo as jdist
from navtech_radar_slam_tpu.parallel import sharded_bank as jsb
from navtech_radar_slam_tpu.parallel.sharded_odometry import (make_sharded_batched_odometry,
                                                              make_sharded_extract)
from navtech_radar_slam_tpu.utils import checkpoint as jckpt
from navtech_radar_slam_torch.config import PgoConfig, ScanContextConfig, SlamConfig
from navtech_radar_slam_torch.models import odometry as todo
from navtech_radar_slam_torch.models import posegraph as tpg
from navtech_radar_slam_torch.models.slam import SlamEngine
from navtech_radar_slam_torch.ops import scancontext as tsc
from navtech_radar_slam_torch.parallel.launch import launch
from navtech_radar_slam_torch.utils import checkpoint as tckpt
from navtech_radar_slam_torch.utils import geometry as tgeo
from test_torch_posegraph import POSE_ATOL
from test_torch_slam import N_SCANS, small_cfg
from torch_parity_util import one_torch_thread, tiny_cfg  # noqa: F401 (fixture)

D = 4          # ranks of the search, solve and odometry cases
D_ENGINE = 2   # ranks of the engine cases
N_BANK = 64    # 16 rows a shard at D = 4
T_MULTI = 16
#: (live rows, the last query's num_valid): the searchable bound num_valid -
#: 4 ends inside shard 2, exactly on the boundary of shards 2 and 3, and
#: below every row
LAYOUTS = {"inside": (40, 40), "boundary": (52, 52), "none": (40, 3)}
MODES = ("full", "ringkey")
TS = (1, T_MULTI)


def _in_thread(fn):
    """Start ``fn`` in a thread (the JAX references and single-device runs,
    while the ranks run); ``.result()`` joins it."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(fn)
    pool.shutdown(wait=False)
    return fut


# ---------------------------------------------------------------------------
# sharded search
# ---------------------------------------------------------------------------

def _cloud(seed, n=300):
    rng = np.random.default_rng(seed)
    r = rng.uniform(5.0, 75.0, size=n)
    th = rng.uniform(0, 2 * np.pi, size=n)
    return np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)


def _desc(xy):
    cfg = ScanContextConfig()
    x = torch.as_tensor(xy)
    return tsc.make_scancontext(x, torch.zeros(len(x)), torch.ones(len(x), dtype=torch.bool),
                                cfg).numpy()


@pytest.fixture(scope="module")
def search():
    """Every search case once on D ranks, JAX's sharded detectors at the same
    D meanwhile."""
    scenes = [_desc(_cloud(i)) for i in range(56)]
    cases, keys = [], []
    for layout, (live, nv) in LAYOUTS.items():
        bank = np.zeros((N_BANK, 20, 60), np.float32)
        bank[:live] = np.stack(scenes[:live])
        for t in TS:
            # revisits of scenes 7, 8, ... rotated by 0.5 rad and more
            qs = []
            for s in range(t):
                a = 0.5 + 0.1 * s
                rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]], np.float32)
                qs.append(_desc(_cloud(7 + s) @ rot.T))
            nvs = [max(nv - t + 1 + s, 1) for s in range(t)]
            for mode in MODES:
                cases.append((layout, mode, np.stack(qs), nvs, bank))
                keys.append((layout, t, mode))

    def jax_side():
        m = jmesh.make_mesh(D)
        out = []
        for layout, mode, qs, nvs, bank in cases:
            cfg = JScConfig(num_exclude_recent=ranks.EXCLUDE, search_mode=mode)
            bank_j = jax.device_put(jnp.asarray(bank), jmesh.bank_sharding(m))
            if len(nvs) == 1:
                c = jsb.make_sharded_loop_detector(m, cfg, shard_top_k=4)(
                    jnp.asarray(qs[0]), bank_j, jnp.asarray(nvs[0]))
            else:
                c = jsb.make_sharded_loop_detector_batch(m, cfg, shard_top_k=4)(
                    jnp.asarray(qs), bank_j, jnp.asarray(nvs, jnp.int32))
            out.append({k: np.atleast_1d(np.asarray(v)) for k, v in c._asdict().items()})
        return out

    fut = _in_thread(jax_side)
    per_rank = launch(ranks.search_cases, D, [c[1:] for c in cases], threads=1,
                      all_ranks=True, timeout=300)
    got = [list(r) for r in zip(*per_rank)]
    return dict(zip(keys, zip(cases, got, fut.result())))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_search_matches_jax_and_single_device(search, layout, t, mode):
    (_, _, qs, nvs, bank), per_rank, want = search[(layout, t, mode)]
    cands = [c for c, _ in per_rank]
    got = {k: np.atleast_1d(v) for k, v in cands[0].items()}
    for other in cands[1:]:
        for k in got:
            np.testing.assert_array_equal(np.atleast_1d(other[k]), got[k], err_msg=k)
    np.testing.assert_array_equal(got["idx"], want["idx"])
    np.testing.assert_array_equal(got["found"], want["found"])
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["yaw"], want["yaw"], rtol=0, atol=1e-6)
    if layout != "none":
        assert got["found"].any()
    else:
        assert not got["found"][0]
    # a rank whose rows are all past the last query's bound launches nothing
    cfg = ScanContextConfig(num_exclude_recent=ranks.EXCLUDE)
    bound = max(tsc.ringkey_searchable_bound(nv, cfg) if mode == "ringkey"
                else nv - ranks.EXCLUDE for nv in nvs)
    for r, (_, calls) in enumerate(per_rank):
        want_calls = 1 if r == 0 or bound > r * N_BANK // D else 0
        assert calls == want_calls, (r, calls)
    if mode == "full":
        single = [int(tsc.detect_loop(torch.as_tensor(q), torch.as_tensor(bank), nv, cfg).idx)
                  for q, nv in zip(qs, nvs)]
        np.testing.assert_array_equal(got["idx"], single)


# ---------------------------------------------------------------------------
# distributed solve
# ---------------------------------------------------------------------------

def _chain(rng, cfg, n_nodes, loops):
    """A noisy unit-step chain with loop factors (i, j) at their true
    relative poses: the port's PoseGraph on the CPU, as numpy arrays."""
    graph = tpg.PoseGraph(cfg, device="cpu")
    pose = np.eye(4, dtype=np.float32)
    graph.add_node(pose)
    gt = [pose]
    unit = tgeo.se2_to_se3_np(np.array([1.0, 0.0, 0.0])).astype(np.float32)
    for _ in range(1, n_nodes):
        gt.append(gt[-1] @ unit)
        meas = tgeo.se2_to_se3_np(np.array([1.0 + rng.normal(0, 0.05), rng.normal(0, 0.05),
                                            rng.normal(0, 0.01)])).astype(np.float32)
        pose = pose @ meas
        graph.add_node(pose, odom_meas=meas)
    for i, j in loops:
        graph.add_loop(i, j, (np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32))
    return tuple(x.numpy() for x in graph.g), graph.num_nodes


def _jax_graph(arrays):
    a = list(arrays)
    for i in (1, 4, 5):   # num_nodes, loop_i, loop_j are int32 in JAX
        a[i] = np.asarray(a[i], np.int32)
    return jpg.GraphArrays(*(jnp.asarray(x) for x in a))


def _shard_factors(g, m):
    sh = jmesh.bank_sharding(m)
    return g._replace(**{k: jax.device_put(getattr(g, k), sh) for k in (
        "odom_meas", "odom_valid", "gps_meas", "gps_valid")})


#: the JAX cases' solver, with CG stopping at a relative residual of 1e-4
#: within 40 iterations (a CG cut short far from that leaves the two
#: packages' rounding differences unconverged, past POSE_ATOL)
BASE_PGO = dict(gn_iters=6, cg_iters=40, cg_tol=1e-4, odom_sigma_rot=0.01,
                odom_sigma_trans=0.05)
SOLVES = {
    # name: (max_nodes, max_loop_edges, nodes, loops, preconditioner, bucketed)
    "basic": (64, 8, 40, [(0, 16), (0, 32), (0, 39)], "chain", False),
    "loop_heavy": (64, 32, 60, [(j - 4, j) for j in range(4, 60, 2)], "chain", False),
    "bucketed": (256, 8, 40, [(0, 16), (16, 32)], "chain", True),
    "loops_on_rank0": (64, 6, 40, [(0, 16), (0, 32), (0, 39)], "chain", False),
    "jacobi": (64, 8, 40, [(0, 16), (0, 32), (0, 39)], "jacobi", False),
}


@pytest.fixture(scope="module")
def solves():
    rng = np.random.default_rng(0)
    cases, cfgs = [], {}
    for name, (nmax, lmax, nodes, loops, precond, bucketed) in SOLVES.items():
        fields = dict(BASE_PGO, max_nodes=nmax, max_loop_edges=lmax, preconditioner=precond)
        arrays, n = _chain(rng, PgoConfig(**fields), nodes, loops)
        cfgs[name] = fields
        cases.append((arrays, fields, bucketed, n))
    # a 64-node bucket of the engine's default 4096-node capacity
    cost_fields = dict(BASE_PGO, max_nodes=4096, max_loop_edges=8, gn_iters=1, cg_iters=16,
                       cg_tol=0.0)
    cost_arrays, cost_n = _chain(rng, PgoConfig(**cost_fields), 40, [(0, 16), (16, 32)])

    def jax_side(part):
        m = jmesh.make_mesh(D)
        out = []
        for (arrays, fields, bucketed, n) in part:
            cfg = JPgoConfig(**fields)
            g = _jax_graph(arrays)
            shard_loops = cfg.max_loop_edges % D == 0
            gs = _shard_factors(g, m)
            if shard_loops:
                sh = jmesh.bank_sharding(m)
                gs = gs._replace(**{k: jax.device_put(getattr(g, k), sh) for k in (
                    "loop_i", "loop_j", "loop_meas", "loop_valid")})
            # JAX's GN step as make_distributed_solver's shard_map runs it,
            # iterated with that solver's early exit (one compile a case)
            from jax import shard_map
            from jax.sharding import PartitionSpec as P
            lp = P(jmesh.BANK_AXIS) if shard_loops else P()
            step = jax.jit(shard_map(
                lambda *a: jdist._sharded_gn_step(*a, cfg=cfg, axis=jmesh.BANK_AXIS,
                                                  lam=cfg.lm_lambda0, shard_loops=shard_loops),
                mesh=m, in_specs=(P(), P(), P(jmesh.BANK_AXIS), P(jmesh.BANK_AXIS), lp, lp,
                                  lp, lp, P(jmesh.BANK_AXIS), P(jmesh.BANK_AXIS)),
                out_specs=(P(), P()), check_vma=False))
            # the poses placed as the step returns them (replicated), so
            # that the second step does not compile again
            rep = jmesh.replicated(m)
            gs = gs._replace(poses=jax.device_put(gs.poses, rep),
                             num_nodes=jax.device_put(gs.num_nodes, rep))
            poses, res = gs.poses, {}
            for it in range(cfg.gn_iters):
                poses, size = step(poses, gs.num_nodes, gs.odom_meas, gs.odom_valid,
                                   gs.loop_i, gs.loop_j, gs.loop_meas, gs.loop_valid,
                                   gs.gps_meas, gs.gps_valid)
                if it == 0:
                    res.update(step_poses=np.asarray(poses), step=float(size))
                if float(size) < jpg._GN_STEP_TOL:
                    break
            res["poses"] = np.asarray(poses)
            if bucketed:
                res["bucketed"] = np.asarray(jdist.make_bucketed_distributed_solver(m, cfg)(
                    gs, n, 0).poses)
            out.append(res)
        return out

    def single_side():
        return [tpg.make_solver(PgoConfig(**fields))(tpg.GraphArrays(
            *(torch.as_tensor(x) for x in arrays))).poses.numpy()
            for arrays, fields, _, _ in cases]

    # JAX's compiles take most of its side: two threads of cases
    half = len(cases) // 2
    futs = [_in_thread(lambda: jax_side(cases[:half])),
            _in_thread(lambda: jax_side(cases[half:]))]
    fut_single = _in_thread(single_side)
    per_rank = launch(ranks.solve_and_cost, D, cases, (cost_arrays, cost_fields, cost_n),
                      threads=1, all_ranks=True, timeout=300)
    want, single = futs[0].result() + futs[1].result(), fut_single.result()
    return {name: (cases[i], [g[0][i] for g in per_rank], want[i], single[i])
            for i, name in enumerate(SOLVES)}, per_rank[0][1]


@pytest.mark.parametrize("name", list(SOLVES))
def test_distributed_solve_matches_jax_and_single_device(solves, name):
    (arrays, fields, bucketed, n), per_rank, want, single = solves[0][name]
    got = per_rank[0]
    for other in per_rank[1:]:
        for k in ("poses", "step_poses", "bucketed"):
            if k in got:
                np.testing.assert_array_equal(other[k], got[k], err_msg=k)
    np.testing.assert_allclose(got["poses"][:n], want["poses"][:n], rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(got["step_poses"][:n], want["step_poses"][:n], rtol=0,
                               atol=POSE_ATOL)
    np.testing.assert_allclose(float(got["step"]), want["step"], rtol=1e-3)
    np.testing.assert_allclose(got["poses"][:n, :3, 3], single[:n, :3, 3], rtol=0, atol=5e-2)
    if bucketed:
        np.testing.assert_allclose(got["bucketed"][:n], want["bucketed"][:n], rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(got["bucketed"][:n, :3, 3], got["poses"][:n, :3, 3],
                                   rtol=0, atol=5e-2)
        # the padding past the 64-node bucket stays exactly identity
        np.testing.assert_array_equal(got["bucketed"][64:],
                                      np.broadcast_to(np.eye(4, dtype=np.float32),
                                                      (fields["max_nodes"] - 64, 4, 4)))


def test_bucketed_distributed_refine_cheaper_than_full(solves):
    """A 64-node bucket over a 4096-node capacity runs at bucket cost (the
    eager matvec's cost is mostly per-op overhead on the CPU, so a 1024-node
    capacity, JAX's case, is too close to the bucket to tell them apart)."""
    t_bucket, t_full = solves[1]
    assert t_bucket < 0.8 * t_full, (t_bucket, t_full)


# ---------------------------------------------------------------------------
# sharded odometry
# ---------------------------------------------------------------------------

B_STREAMS = 8


@pytest.fixture(scope="module")
def odometry():
    cfg = tiny_cfg()
    sim = RadarSimulator(cfg.radar)
    gt = sim.circuit_trajectory(B_STREAMS + 1, radius=10.0, speed=6.0)
    prev = np.stack([sim.render(gt[i], noise_seed=i) for i in range(B_STREAMS)])
    curr = np.stack([sim.render(gt[i + 1], noise_seed=100 + i) for i in range(B_STREAMS)])
    az = todo.default_azimuths(cfg)

    def jax_side():
        m = jmesh.make_mesh(D)
        sstep, shard = make_sharded_batched_odometry(m, cfg)
        carry = make_sharded_extract(m, cfg)(shard(jnp.asarray(prev)), jnp.asarray(az))
        _, res, _ = sstep(shard(jnp.asarray(curr)), jnp.asarray(az), carry,
                          shard(jnp.zeros((B_STREAMS, 3), jnp.float32)))
        return {k: np.asarray(v) for k, v in res._asdict().items()}

    fut = _in_thread(jax_side)
    got = launch(ranks.odometry_step, D, cfg.to_dict(), prev, curr, threads=1,
                 all_ranks=True, timeout=300)
    tcfg = SlamConfig.from_dict(cfg.to_dict())
    step = todo.make_batched_odometry_step(tcfg, device="cpu")
    carry0 = todo.extract_scan_features_batched(torch.as_tensor(prev), torch.as_tensor(az), tcfg)
    carry, res, feats = step(torch.as_tensor(curr), torch.as_tensor(az), carry0,
                             torch.zeros(B_STREAMS, 3))
    whole = {"res": res._asdict(), "carry": carry._asdict(), "feats": feats._asdict()}
    return got, whole, fut.result()


def test_sharded_odometry_matches_unsharded_and_jax(odometry):
    got, whole, want = odometry
    for r, rank in enumerate(got):
        lo, hi = rank["block"]
        assert (lo, hi) == (r * B_STREAMS // D, (r + 1) * B_STREAMS // D)
        assert rank["streams"] == B_STREAMS // D
        for part in ("res", "carry", "feats"):
            for k, v in rank[part].items():
                if v is not None:
                    # bit-equal: the batched step is batch-invariant
                    np.testing.assert_array_equal(v, whole[part][k][lo:hi].numpy(),
                                                  err_msg=f"rank {r} {part}.{k}")
        for k, v in rank["gathered"].items():
            np.testing.assert_array_equal(v, whole["res"][k].numpy(), err_msg=k)
    gathered = got[0]["gathered"]
    assert gathered["ok"].all() and want["ok"].all()
    np.testing.assert_allclose(gathered["rel_pose"], want["rel_pose"], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the mesh engine
# ---------------------------------------------------------------------------

CHUNK = 8
SAVE_AT = 16


def _engine_cfg():
    """small_cfg from a capacity of 8 keyframes and nodes, so that both the
    per-scan and the chunked run grow it twice (JAX's growth cases start
    from 16 for 40 and 48 scans).  The loop-edge capacity stays small_cfg's:
    growth comes from the keyframe count alone, so the chunked segment plan
    does not hang on which loops closed, and the segment counts of the mesh
    and the single-device run stay comparable."""
    base = small_cfg()
    return dataclasses.replace(
        base, keyframes=dataclasses.replace(base.keyframes, max_keyframes=8),
        pgo=dataclasses.replace(base.pgo, max_nodes=8))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The mesh engine per scan and chunked (with its checkpoint and the
    resume) on D_ENGINE ranks in two launches side by side, the
    single-device port engine's at the same config in a thread meanwhile.
    Both runs grow the capacity, so the growth cases read them too."""
    cfg = _engine_cfg()
    sim = RadarSimulator(cfg.radar)
    gt = sim.circuit_trajectory(N_SCANS + 2, radius=5.0, speed=6.0)
    scans = np.stack([sim.render(gt[i], noise_seed=i) for i in range(N_SCANS)])
    tmp = tmp_path_factory.mktemp("mesh")
    mesh_ckpt, single_ckpt = str(tmp / "mesh.npz"), str(tmp / "single.npz")
    tcfg = SlamConfig.from_dict(cfg.to_dict())

    def single():
        # the chunked run saves where the mesh run does (a save drains the
        # pending decisions, which shapes the later segments)
        return {"per_scan": ranks.run_engine(SlamEngine(tcfg, device="cpu"), scans, 0),
                "chunked": ranks.run_engine(SlamEngine(tcfg, device="cpu"), scans, CHUNK,
                                            save_at=SAVE_AT, path=single_ckpt)}

    def mesh(which):
        return _in_thread(lambda: launch(
            ranks.engine_cases, D_ENGINE, cfg.to_dict(), scans, CHUNK, SAVE_AT, mesh_ckpt,
            which, threads=1, all_ranks=True, timeout=600))

    fut_single = _in_thread(single)
    fut_a = mesh(("per_scan",))
    fut_b = mesh(("chunked", "resumed"))
    per_rank = [dict(a, **b) for a, b in zip(fut_a.result(), fut_b.result())]
    ref = fut_single.result()
    # the single-device resume of the mesh run's checkpoint
    eng = tckpt.load_engine(mesh_ckpt, device="cpu")
    ref["resumed"] = ranks.run_engine(eng, scans, CHUNK, first=eng.num_scans)
    return per_rank, ref, mesh_ckpt


def _matched(a, bs):
    return any(abs(a[0] - b[0]) <= 2 and abs(a[1] - b[1]) <= 2 for b in bs)


def _assert_engine_band(got, want):
    """JAX's mesh band: loops of each side matched by the other's for at
    least half, trajectories within 0.1 m."""
    lm, ls = got["loops"], want["loops"]
    assert lm and ls
    assert sum(_matched(a, ls) for a in lm) >= len(lm) // 2, (lm, ls)
    assert sum(_matched(b, lm) for b in ls) >= len(ls) // 2, (lm, ls)
    np.testing.assert_allclose(got["traj"][:, :3, 3], want["traj"][:, :3, 3], rtol=0,
                               atol=0.1)


def _assert_ranks_equal(per_rank, case):
    for other in per_rank[1:]:
        np.testing.assert_array_equal(other[case]["traj"], per_rank[0][case]["traj"])
        assert other[case]["loops"] == per_rank[0][case]["loops"]


def _assert_blocks(per_rank, case, n_kf, ref_bank):
    """Each rank holds exactly its block of the (grown) bank, and the bank
    is the single-device engine's."""
    cap = per_rank[0][case]["cap"]
    whole = per_rank[0][case]["bank_whole"]
    assert whole.shape[0] == cap
    for r, rank in enumerate(per_rank):
        assert rank[case]["cap"] == cap
        assert rank[case]["bank"].shape[0] == cap // D_ENGINE
        assert rank[case]["bank_start"] == r * cap // D_ENGINE
        np.testing.assert_array_equal(rank[case]["bank"], whole[r * cap // D_ENGINE:
                                                                (r + 1) * cap // D_ENGINE])
    np.testing.assert_array_equal(whole[:n_kf], ref_bank[:n_kf])
    assert not whole[n_kf:].any()


def test_engine_with_mesh_matches_single_device(engines):
    per_rank, ref, _ = engines
    got = per_rank[0]["per_scan"]
    _assert_engine_band(got, ref["per_scan"])
    _assert_ranks_equal(per_rank, "per_scan")
    _assert_blocks(per_rank, "per_scan", got["num_keyframes"], ref["per_scan"]["bank"])
    # the per-keyframe mesh path: insert, sharded search, verification
    counts = got["counts"]
    assert counts["kf_insert_split"] == 3 * N_SCANS and "kf_step" not in counts
    assert counts["sharded_detect"] == counts["verify"] == ref["per_scan"]["counts"][
        "decision_fetch"]


def test_engine_mesh_chunked_matches_single_device(engines):
    per_rank, ref, _ = engines
    got, want = per_rank[0]["chunked"], ref["chunked"]
    _assert_engine_band(got, want)
    _assert_ranks_equal(per_rank, "chunked")
    _assert_blocks(per_rank, "chunked", got["num_keyframes"], want["bank"])
    dm, ds = got["counts"], want["counts"]
    assert dm["kf_segment"] >= 1 and dm["kf_segment"] == ds["kf_segment"], (dm, ds)
    assert dm.get("kf_insert_split", 0) <= 3 * 4, dm
    assert sum(dm.values()) <= 2 * sum(ds.values()), (dm, ds)


@pytest.mark.parametrize("case", ["per_scan_growth", "chunked_growth"])
def test_engine_mesh_growth_keeps_blocks(engines, case):
    per_rank, ref, _ = engines
    run = case[:-len("_growth")]
    got = per_rank[0][run]
    assert got["cap"] >= 32   # grown twice from 8
    assert got["cap"] == ref[run]["cap"]
    assert got["num_keyframes"] == ref[run]["num_keyframes"] == N_SCANS
    _assert_ranks_equal(per_rank, run)
    _assert_blocks(per_rank, run, got["num_keyframes"], ref[run]["bank"])
    _assert_engine_band(got, ref[run])
    if run == "chunked":
        assert got["counts"]["kf_segment"] >= 2


def test_engine_mesh_resume_keeps_the_mesh(engines):
    per_rank, ref, path = engines
    for r, rank in enumerate(per_rank):
        res = rank["resumed"]
        assert res["mesh_kept"]
        loaded = res["loaded"]
        # the loaded state is the run's at the save, each rank its block
        np.testing.assert_array_equal(loaded["traj"], rank["chunked"]["saved_traj"])
        cap = loaded["cap"]
        assert loaded["bank"].shape[0] == cap // D_ENGINE
        assert loaded["bank_start"] == r * cap // D_ENGINE
        np.testing.assert_array_equal(loaded["bank"], np.load(path)["bank"][
            r * cap // D_ENGINE:(r + 1) * cap // D_ENGINE])
    _assert_ranks_equal(per_rank, "resumed")
    got = per_rank[0]["resumed"]
    assert got["num_keyframes"] == ref["resumed"]["num_keyframes"]
    _assert_engine_band(got, ref["resumed"])
    # either package loads the file
    jeng = jckpt.load_engine(path)
    assert jeng.num_keyframes == per_rank[0]["resumed"]["loaded"]["num_keyframes"]
    np.testing.assert_array_equal(np.asarray(jeng.bank), np.load(path)["bank"])
