"""Parity of the port's ScanContext search with the JAX package's
(``ops/scancontext.py``).

Tolerances: descriptors identical (a scatter-max of the same bins); the
plain ``sc_shift_distance_matrix`` against the TPU kernel in interpret mode
at atol 2e-5 (the JAX suite's bound, tests/test_pallas_kernels.py); the
detectors give the same index, found flag and yaw."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.config import RadarConfig, ScanContextConfig
from navtech_radar_slam_tpu.data import RadarSimulator
from navtech_radar_slam_tpu.ops import scancontext as jsc
from navtech_radar_slam_tpu.ops.pallas import sc_shift_distances_pallas
from navtech_radar_slam_torch import state
from navtech_radar_slam_torch.ops import scancontext as tsc
from navtech_radar_slam_torch.ops.kernels import sc_corr
from navtech_radar_slam_torch.utils.ordered import halving_sum
from torch_parity_util import cuda_device, np_, one_torch_thread, t  # noqa: F401 (fixtures)

CFG = ScanContextConfig()
SC_ATOL = 2e-5


def _cloud(seed, n=250, shift=(0.0, 0.0), rot=0.0):
    """A radar-like feature cloud; shifted / rotated copies of one seed are
    revisits of one place."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(5, 75, n)
    th = rng.uniform(0, 2 * np.pi, n) + rot
    return (np.stack([r * np.cos(th), r * np.sin(th)], -1) + shift).astype(np.float32)


def _descs(clouds, cfg=CFG):
    """The same clouds through both make_scancontext's; asserts identity."""
    out = []
    for xy in clouds:
        n = len(xy)
        valid = np.ones(n, bool)
        valid[::7] = False
        want = np.asarray(jsc.make_scancontext(jnp.asarray(xy), jnp.zeros(n),
                                               jnp.asarray(valid), cfg))
        got = np_(tsc.make_scancontext(t(xy), torch.zeros(n), t(valid), cfg))
        np.testing.assert_array_equal(got, want)
        out.append(want)
    return np.stack(out)


def _bank(n=40, cap=64):
    """A padded bank: n live rows (a few revisits of row 3's place), zeros
    after."""
    clouds = [_cloud(i) for i in range(n)]
    clouds[n - 1] = _cloud(3, shift=(0.5, -0.4), rot=0.3)
    bank = np.zeros((cap, CFG.num_ring, CFG.num_sector), np.float32)
    bank[:n] = _descs(clouds)
    return bank


@pytest.mark.parametrize("max_desc", [512, 100, 0])
def test_descriptors_identical(max_desc):
    """Descriptor and keys, with and without the strongest-K cap; includes
    points beyond max_radius and at the origin."""
    cfg = dataclasses.replace(CFG, max_desc_features=max_desc)
    xy = np.concatenate([_cloud(5, 300), [[0.0, 0.0], [90.0, 0.0], [-79.9, 0.1]]])
    d = _descs([xy.astype(np.float32)], cfg)[0]
    np.testing.assert_allclose(np_(tsc.ring_key(t(d))), np.asarray(jsc.ring_key(d)),
                               atol=1e-6)
    np.testing.assert_allclose(np_(tsc.sector_key(t(d))), np.asarray(jsc.sector_key(d)),
                               atol=1e-6)


def test_plain_distance_matrix_matches_tpu_kernel():
    bank = _bank(24, 24)
    query = bank[5]
    want = np.asarray(sc_shift_distances_pallas(jnp.asarray(query), jnp.asarray(bank),
                                                interpret=True))
    got = np_(tsc.sc_shift_distance_matrix(t(query), t(bank)))
    np.testing.assert_allclose(got, want, atol=SC_ATOL)
    assert got[5].min() < 1e-5          # the self-match
    assert (got[:, :] <= 1.0 + 1e-6).all()


def test_all_shift_and_ratio_distances_match_jax():
    bank = _bank(30, 30)
    query = _descs([_cloud(3, rot=0.45)])[0]
    dj, sj = jsc.sc_distance_all_shifts(jnp.asarray(query), jnp.asarray(bank))
    dt, st = tsc.sc_distance_all_shifts(t(query), t(bank))
    np.testing.assert_allclose(np_(dt), np.asarray(dj), atol=SC_ATOL)
    np.testing.assert_array_equal(np_(st), np.asarray(sj))
    dj, sj = jsc.sc_distance_ratio_shifts(jnp.asarray(query), jnp.asarray(bank), CFG)
    dt, st = tsc.sc_distance_ratio_shifts(t(query), t(bank), CFG)
    np.testing.assert_allclose(np_(dt), np.asarray(dj), atol=SC_ATOL)
    np.testing.assert_array_equal(np_(st), np.asarray(sj))
    for shift in (0, 7, 30, 31, 59):
        assert float(tsc.shift_to_yaw(torch.tensor(shift), CFG)) == pytest.approx(
            float(jsc.shift_to_yaw(jnp.asarray(shift), CFG)), abs=1e-7)


def _same_candidate(got, want):
    assert int(got.idx) == int(want.idx)
    assert bool(got.found) == bool(want.found)
    assert float(got.yaw) == pytest.approx(float(want.yaw), abs=1e-6)
    if bool(want.found):
        assert float(got.dist) == pytest.approx(float(want.dist), abs=SC_ATOL)


@pytest.mark.parametrize("num_valid", [40, 25, 10, 12, 13])
def test_detect_loop_matches_jax(num_valid, monkeypatch):
    """The query is keyframe num_valid - 1: a revisit of row 3 at 40, no
    searchable revisit below that; 10 and 12 leave nothing searchable, 13
    one row.  Only the searchable prefix of the padded bank is scored (one
    row when none is searchable), and the candidate is JAX's, which scores
    the whole bank."""
    cfg = dataclasses.replace(CFG, num_exclude_recent=12)
    bank = _bank(40)
    query = bank[num_valid - 1]
    want = jsc.detect_loop(jnp.asarray(query), jnp.asarray(bank), jnp.asarray(num_valid), cfg)
    scored = []
    all_shifts = tsc.sc_distance_all_shifts

    def recording(q, b):
        scored.append(b.shape[0])
        return all_shifts(q, b)

    monkeypatch.setattr(tsc, "sc_distance_all_shifts", recording)
    got = tsc.detect_loop(t(query), t(bank), num_valid, cfg)
    _same_candidate(got, want)
    assert bool(got.found) == (num_valid == 40)
    assert scored == [max(num_valid - 12, 1)]


@pytest.mark.parametrize("period,ratio", [(30, 0.1), (1, 0.0), (8, 0.1)])
def test_detect_loop_ringkey_matches_jax(period, ratio):
    cfg = dataclasses.replace(CFG, num_exclude_recent=12, tree_making_period=period,
                              search_ratio=ratio)
    bank = _bank(40)
    keys = bank.mean(axis=-1)
    query = bank[39]
    want = jsc.detect_loop_ringkey(jnp.asarray(query), jnp.asarray(bank), jnp.asarray(keys),
                                   jnp.asarray(40), cfg)
    got = tsc.detect_loop_ringkey(t(query), t(bank), t(keys), 40, cfg)
    _same_candidate(got, want)
    for nv in (13, 40, 45, 100):
        assert tsc.ringkey_searchable_bound(nv, cfg) == int(
            jsc.ringkey_searchable_bound(jnp.asarray(nv), cfg))


def test_ring_key_candidates_tie_order():
    """Equal ring-key distances come out lowest index first, as
    jax.lax.top_k orders them."""
    keys = np.zeros((12, CFG.num_ring), np.float32)
    keys[[2, 5, 9]] = 1.0
    q = np.zeros(CFG.num_ring, np.float32)
    wi, wd = jsc.ring_key_candidates(jnp.asarray(q), jnp.asarray(keys), 10)
    gi, gd = tsc.ring_key_candidates(t(q), t(keys), 10)
    np.testing.assert_array_equal(np_(gi), np.asarray(wi))
    np.testing.assert_allclose(np_(gd), np.asarray(wd))


def test_kernel_wrapper_takes_only_cuda_tensors():
    bank = t(_bank(4, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc_corr.sc_shift_distances_cuda(bank[0], bank)


@pytest.mark.parametrize("n", [1, 30, 4096, 4097, 8192])
def test_sc_corr_launch_geometry_covers_every_row_once(n):
    """The blocks of one launch cover rows 0 .. n - 1, each exactly once:
    block b takes rows [b * rows, (b + 1) * rows) and drops those >= n."""
    variant, rows, blocks = sc_corr.launch_geometry(n)
    assert rows == sc_corr.BLOCK_ROWS[variant]
    assert variant == (n >= sc_corr.TILE_MIN_ROWS)
    covered = np.zeros(n, int)
    for b in range(blocks):
        covered[b * rows:min((b + 1) * rows, n)] += 1
    assert (covered == 1).all() and (blocks - 1) * rows < n


def _live_bank(n, seed=0):
    """n live rows: the 40 descriptors of ``_bank`` under seeded circular
    column rolls, every copy past the first 40 with a tenth of its cells
    cleared, so no two rows tie."""
    rng = np.random.default_rng(seed)
    base = _bank(40, 40)
    rows = [np.roll(base[i % 40], int(rng.integers(0, CFG.num_sector)), axis=-1)
            for i in range(n)]
    for row in rows[40:]:
        row[rng.random(row.shape) < 0.1] = 0.0
    return np.stack(rows).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,case", [(1, "live"), (7, "live"), (30, "live"), (129, "live"),
                                    (4096, "live"), (4097, "live"), (64, "zero rows"),
                                    (30, "zero query")])
def test_sc_corr_kernel_matches_plain_on_cuda(n, case, cuda_device):  # noqa: F811
    """K2 against its plain version on the card: one launch per call, atol
    2e-5, the same best row and shift.  The query is row k rolled by 17
    columns (with five empty columns in the "zero rows" case, where twenty
    bank rows are all zero too), so row k's distance at shift 17 is ~0; an
    all-zero query gives 1 everywhere."""
    bank = _live_bank(n)
    k, roll = n // 2, 17
    query = np.roll(bank[k], roll, axis=-1)
    if case == "zero rows":
        bank[10:20] = 0.0
        bank[50:] = 0.0
        query[:, 5:10] = 0.0
    if case == "zero query":
        query[:] = 0.0
    bank, query = t(bank, cuda_device), t(query, cuda_device)
    before = sc_corr.launch_count
    got = sc_corr.sc_shift_distances_cuda(query, bank)
    torch.cuda.synchronize()
    assert sc_corr.launch_count == before + 1
    want = tsc.sc_shift_distance_matrix_plain(query, bank)
    np.testing.assert_allclose(np_(got), np_(want), atol=SC_ATOL)
    if case == "zero query":
        assert (np_(got) == 1.0).all()
        return
    assert float(got[k, roll]) < 1e-5
    assert int(torch.argmin(got)) == int(torch.argmin(want)) == k * CFG.num_sector + roll
    if case == "zero rows":
        assert (np_(got[10:20]) == 1.0).all() and (np_(got[50:]) == 1.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((40, 10, 30), 0), ((40, 20, 60), 1)])
def test_sc_corr_kernel_scalar_staging_on_cuda(shape, offset, cuda_device):  # noqa: F811
    """The kernel's 4-byte staging path: S not a multiple of 4 (the columns
    padded to 32), and a contiguous bank 4 bytes off 16-byte alignment."""
    rng = np.random.default_rng(5)
    n, nr, ns = shape
    flat = rng.uniform(0, 3, n * nr * ns + offset).astype(np.float32)
    flat[rng.random(flat.shape) < 0.2] = 0.0
    bank = t(flat, cuda_device)[offset:].view(n, nr, ns)
    query = t(np.roll(np_(bank[7]), 5, axis=-1), cuda_device)
    got = sc_corr.sc_shift_distances_cuda(query, bank)
    want = tsc.sc_shift_distance_matrix_plain(query, bank)
    np.testing.assert_allclose(np_(got), np_(want), atol=SC_ATOL)
    assert int(torch.argmin(got)) == int(torch.argmin(want)) == 7 * ns + 5


@pytest.mark.cuda
def test_sc_corr_kernel_empty_and_wide_banks(cuda_device):  # noqa: F811
    """An empty bank gives a (0, S) result with no launch; more than 64
    sectors raise."""
    before = sc_corr.launch_count
    out = sc_corr.sc_shift_distances_cuda(torch.zeros((20, 60), device=cuda_device),
                                          torch.zeros((0, 20, 60), device=cuda_device))
    assert tuple(out.shape) == (0, 60) and sc_corr.launch_count == before
    with pytest.raises(ValueError, match="sectors"):
        sc_corr.sc_shift_distances_cuda(torch.zeros((20, 65), device=cuda_device),
                                        torch.zeros((3, 20, 65), device=cuda_device))


# K2-T with one shared bank: the host's choice of query slots a block, and
# on the card each slot bit-equal to K2 for that query.
@pytest.mark.parametrize("t_slots", [1, 3, 16, 17])
@pytest.mark.parametrize("n", [1, 30, 255, 256, 400, 2048, 4096, 4097, 8192])
@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
def test_k2t_multi_geometry(t_slots, n, per_slot):
    """One K2-T launch covers every (slot, row) once: the variant is K2's
    for n (it fixes the order of every sum); per-slot banks and shared banks
    under SHARED_MIN_ROWS rows run one slot a block; larger shared banks run
    query groups of near-equal size, as few as keep SHARED_TARGET_BLOCKS
    blocks in the launch."""
    variant, qgroup, bx, by = sc_corr.multi_geometry(t_slots, n, per_slot)
    k2_variant, rows, k2_blocks = sc_corr.launch_geometry(n)
    assert (variant, bx) == (k2_variant, k2_blocks)
    if per_slot or n < sc_corr.SHARED_MIN_ROWS or t_slots == 1:
        assert qgroup == 1
    covered = np.zeros(t_slots, int)
    for g in range(by):
        covered[g * qgroup:min((g + 1) * qgroup, t_slots)] += 1
    assert (covered == 1).all() and (by - 1) * qgroup < t_slots
    if qgroup > 1:
        assert bx * (by - 1) < sc_corr.SHARED_TARGET_BLOCKS or by == t_slots
        assert bx * by <= max(sc_corr.SHARED_TARGET_BLOCKS + bx, bx)


def _k2t_queries(bank, t_slots, seed=3):
    """t_slots queries: bank rows rolled by seeded shifts, every fourth with
    five empty columns."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, len(bank), t_slots)
    q = np.stack([np.roll(bank[r], int(rng.integers(0, CFG.num_sector)), axis=-1)
                  for r in rows])
    q[::4, :, 5:10] = 0.0
    return q.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("t_slots", [1, 3, 16, 17])
@pytest.mark.parametrize("n", [1, 30, 400, 4097])
def test_k2t_shared_bank_equals_k2_per_slot_on_cuda(t_slots, n, cuda_device):  # noqa: F811
    """K2-T on one shared bank, at the host's query groups and, through the
    test hook, at 2 and 16 slots a block: one launch per call, each slot bit-equal (``torch.equal``)
    to K2 for that query on the bank."""
    bank = t(_live_bank(n), cuda_device)
    queries = t(_k2t_queries(np_(bank), t_slots), cuda_device)
    one = [sc_corr.sc_shift_distances_cuda(q, bank) for q in queries]
    for qgroup in (None, 2, 16):
        before = sc_corr.multi_launch_count
        got = (sc_corr.sc_shift_distances_multi_cuda(queries, bank) if qgroup is None
               else sc_corr._launch_multi(queries, bank, qgroup))
        torch.cuda.synchronize()
        assert sc_corr.multi_launch_count == before + 1
        for s in range(t_slots):
            assert torch.equal(got[s], one[s]), (qgroup, s)


@pytest.mark.cuda
def test_k2t_per_slot_banks_unchanged_on_cuda(cuda_device):  # noqa: F811
    """Per-slot banks keep one slot a block: each slot bit-equal to K2 on its
    own bank, and a query group is refused for them."""
    rng = np.random.default_rng(9)
    base = _live_bank(30)
    banks = np.stack([np.roll(base, int(rng.integers(0, 60)), axis=-1) for _ in range(5)])
    bank = t(banks, cuda_device)
    queries = t(_k2t_queries(base, 5), cuda_device)
    got = sc_corr.sc_shift_distances_multi_cuda(queries, bank)
    for s in range(5):
        assert torch.equal(got[s], sc_corr.sc_shift_distances_cuda(queries[s], bank[s])), s
    with pytest.raises(ValueError, match="qgroup"):
        sc_corr._launch_multi(queries, bank, 2)


# -- the multi-session API and the SCManager interface ---------------------

def _plain_desc(xy):
    n = len(xy)
    return np.asarray(jsc.make_scancontext(jnp.asarray(xy), jnp.zeros(n),
                                           jnp.ones(n, bool), CFG))


@pytest.mark.parametrize("num_valid", [0, 1, 10, 16])
def test_detect_loop_between_sessions_matches_jax(num_valid, monkeypatch):
    """``test_between_sessions``'s setting: ten live rows of a 16-row bank,
    the query a rotated revisit of row 8.  Only the first max(num_valid, 1)
    rows are scored; the candidate is JAX's, which scores the whole bank
    (at 0: idx -1, dist +inf, the yaw of row 0's best shift)."""
    bank = np.zeros((16, CFG.num_ring, CFG.num_sector), np.float32)
    bank[:10] = np.stack([_plain_desc(_cloud(200 + i, 400)) for i in range(10)])
    query = _plain_desc(_cloud(208, 400, rot=0.2))
    want = jsc.detect_loop_between_sessions(jnp.asarray(query), jnp.asarray(bank),
                                            jnp.asarray(num_valid), CFG)
    scored = []
    all_shifts = tsc.sc_distance_all_shifts

    def recording(q, b):
        scored.append(b.shape[0])
        return all_shifts(q, b)

    monkeypatch.setattr(tsc, "sc_distance_all_shifts", recording)
    got = tsc.detect_loop_between_sessions(t(query), t(bank), num_valid, CFG)
    _same_candidate(got, want)
    assert scored == [max(num_valid, 1)]
    assert bool(got.found) == (num_valid > 8) and (int(got.idx) == 8) == (num_valid > 8)
    if num_valid == 0:
        assert float(got.dist) == float(want.dist) == float("inf")


def _port_desc(xy):
    """The port's descriptor of a cloud on the CPU (``_plain_desc``'s twin,
    with no JAX call)."""
    n = len(xy)
    return np_(tsc.make_scancontext(t(xy), torch.zeros(n), torch.ones(n, dtype=torch.bool), CFG))


def _mode_cfg(mode):
    return dataclasses.replace(CFG, search_mode=mode.split("_")[0],
                               tree_making_period=1 if mode == "ringkey_fresh" else 30)


def _managers(mode):
    cfg = _mode_cfg(mode)
    return (cfg, jsc.ScanContextManager(cfg, capacity=64),
            tsc.ScanContextManager(cfg, capacity=64, device="cpu"))


@pytest.mark.parametrize("mode,points", [
    pytest.param("full", 400, id="full"),
    pytest.param("ringkey", 400, id="ringkey"),
    pytest.param("ringkey_fresh", 400, id="ringkey_fresh"),
    pytest.param("ringkey", 60, id="ringkey-60"),
    pytest.param("ringkey_fresh", 60, id="ringkey_fresh-60"),
])
def test_scmanager_matches_jax(mode, points):
    """``test_scmanager_api_parity``'s 35 + 1 clouds (35 scenes and a rotated
    revisit of scene 2) into both managers: a
    detect after every insert from the 31st gives the same (index, yaw);
    the banks agree; a port manager loaded from the JAX manager's arrays
    answers alike; the between-session query, the threshold setter and the
    capacity limit behave as JAX's.  Sparse clouds (60 points) make ring
    and sector keys that tie exactly, where XLA's float32 sums and the
    port's float64 ones may pick another of the tied candidates or
    alignments: there a detect may differ, and both packages' answers must
    then be exact-arithmetic optima (``_a_tie_broken_apart``)."""
    cfg, jm, tm = _managers(mode)
    clouds = [_cloud(300 + i, points) for i in range(35)]
    clouds.append(_cloud(302, points, rot=0.5))
    for i, c in enumerate(clouds):
        want = np.asarray(jm.makeAndSaveScancontextAndKeys(jnp.asarray(c)))
        np.testing.assert_array_equal(np_(tm.makeAndSaveScancontextAndKeys(c)), want)
        if i >= 30:
            got, want = tm.detectLoopClosureID(), jm.detectLoopClosureID()
            if got != pytest.approx(want, abs=1e-6):
                assert points == 60 and mode != "full", (i, got, want)
                _a_tie_broken_apart(tm, jm, got, want)
    got = tm.detectLoopClosureID()
    assert tm.num == jm.num == 36
    if mode != "ringkey":       # ring-key staleness hides row 2 at 36 inserts
        assert got[0] == 2 and abs(got[1] - 0.5) < 2 * np.pi / cfg.num_sector + 1e-6
    np.testing.assert_allclose(np_(tm.bank), np.asarray(jm.bank), atol=SC_ATOL)
    np.testing.assert_allclose(np_(tm.ring_keys), np.asarray(jm.ring_keys), atol=SC_ATOL)

    loaded = tsc.ScanContextManager(cfg, capacity=64, device="cpu")
    state.load_scmanager_state(loaded, {"bank": np.asarray(jm.bank),
                                        "ring_keys": np.asarray(jm.ring_keys), "num": jm.num})
    assert loaded.detectLoopClosureID() == pytest.approx(jm.detectLoopClosureID(), abs=1e-6)
    back = state.scmanager_state_to_numpy(loaded)
    np.testing.assert_array_equal(back["bank"], np.asarray(jm.bank))
    assert back["num"] == 36

    jo, to = jsc.ScanContextManager(cfg, capacity=16), tsc.ScanContextManager(
        cfg, capacity=16, device="cpu")
    for c in clouds[:8]:
        jo.saveScancontextAndKeys(_plain_desc(c))
        to.saveScancontextAndKeys(_plain_desc(c))
    q = _plain_desc(_cloud(305, points, rot=-0.3))
    want = jo.detectLoopClosureIDBetweenSession(jnp.asarray(q))
    assert to.detectLoopClosureIDBetweenSession(q) == pytest.approx(want, abs=1e-6)
    assert want[0] == 5

    jm.setSCdistThres(0.0)
    tm.setSCdistThres(0.0)
    assert tm.detectLoopClosureID()[0] == jm.detectLoopClosureID()[0] == -1


def _tie_prone_bank(kind):
    """Descriptors whose keys tie: the 60-point clouds of
    ``test_scmanager_matches_jax``, or the simulator's landmarks seen from
    120 seeded poses (~250 points each, 0 / 2 occupancy, as in
    chip_smoke.py's manager phase)."""
    if kind == "sparse-60":
        clouds = [_cloud(300 + i, 60) for i in range(35)] + [_cloud(302, 60, rot=0.5)]
    else:
        sim = RadarSimulator(RadarConfig())
        rng = np.random.default_rng(7)
        poses = np.column_stack([rng.uniform(-60, 60, 120), rng.uniform(-60, 60, 120),
                                 rng.uniform(-np.pi, np.pi, 120)])
        clouds = []
        for pose in poses:
            r, b, _ = sim.visible_landmarks(pose)
            clouds.append(np.column_stack([r * np.cos(b), r * np.sin(b)]).astype(np.float32))
    return np.stack([np_(tsc.make_scancontext(t(c), torch.zeros(len(c)),
                                              torch.ones(len(c), dtype=torch.bool), CFG))
                     for c in clouds])


def _an_exact_optimum(descs, q, searchable, dist, idx, shift, best, k, cfg):
    """Whether (idx, shift, best) is what the two-stage ring-key search
    gives in exact arithmetic with its ties broken some way: keys and
    sector-key costs in float64 from the 0 / 2 descriptors (exact up to
    1e-9), ``dist`` the side's own (N, S) shift distances, equal within
    SC_ATOL.  idx must be among the k nearest ring keys (or tie with the
    k-th), ``shift`` the window minimum of an alignment that ties for the
    best, and ``best`` no worse than any row surely among the candidates."""
    d = descs.astype(np.float64)
    d2 = np.where(searchable, ((d.mean(-1) - d[q].mean(-1)) ** 2).sum(-1), np.inf)
    cut = np.sort(d2)[k - 1]
    sure, maybe = searchable & (d2 < cut - 1e-9), searchable & (d2 <= cut + 1e-9)
    ns = d.shape[-1]
    vb, vq = d.mean(-2), d[q].mean(-2)
    col = (np.arange(ns)[:, None] + np.arange(ns)[None, :]) % ns
    cost = (vb * vb).sum(-1)[:, None] - 2.0 * vb @ vq[col].T          # (N, Z)
    radius = max(1, int(round(0.5 * cfg.search_ratio * ns)))
    circ = np.abs((np.arange(ns)[None, :] - np.arange(ns)[:, None] + ns // 2) % ns - ns // 2)
    window = circ <= radius                                           # (Z, S)

    def window_mins(r):     # the row's window minimum at each alignment tying for best
        aligns = np.flatnonzero(cost[r] <= cost[r].min() + 1e-9)
        return aligns, [dist[r][window[z]].min() for z in aligns]

    if not maybe[idx] or abs(best - max(dist[idx, shift], 0.0)) > SC_ATOL:
        return False
    aligns, mins = window_mins(idx)
    if not any(window[z, shift] and dist[idx, shift] <= m + SC_ATOL
               for z, m in zip(aligns, mins)):
        return False
    return all(best <= max(window_mins(r)[1]) + SC_ATOL for r in np.flatnonzero(sure))


def _a_tie_broken_apart(tm, jm, got, want):
    """The newest ring-key detect of two managers over one bank, where their
    (index, yaw) differ: each is its package's two-stage answer, and both
    answers are exact-arithmetic optima (``_an_exact_optimum``)."""
    cfg, k, q = tm.cfg, tm.cfg.num_candidates, tm.num - 1
    descs = np_(tm.bank)
    np.testing.assert_array_equal(descs, np.asarray(jm.bank))
    searchable = np.arange(tm.capacity) < tsc.ringkey_searchable_bound(tm.num, cfg)
    gi, gd, gs = tsc.ringkey_two_stage_best(tm.bank[q], tm.bank, tm.ring_keys,
                                            t(searchable), k, cfg)
    wi, wd, ws = jsc.ringkey_two_stage_best(jm.bank[q], jm.bank, jm.ring_keys,
                                            jnp.asarray(searchable), k, cfg)
    for (i, d, s), answer, dist in (
            ((gi, gd, gs), got, np_(tsc.sc_shift_distance_matrix(tm.bank[q], tm.bank))),
            ((wi, wd, ws), want, np.asarray(jsc.sc_shift_distance_matrix(jm.bank[q], jm.bank)))):
        i, d, s = int(i), float(d), int(s)
        yaw = float(tsc.shift_to_yaw(torch.tensor(s), cfg))
        assert answer == pytest.approx((i if d < cfg.sc_dist_thres else -1, yaw), abs=1e-6)
        assert _an_exact_optimum(descs, q, searchable, dist, i, s, d, k, cfg), answer


@pytest.mark.parametrize("kind", ["sparse-60", "landmarks"])
def test_ringkey_two_stage_best_multi_matches_jax(kind):
    """The port's T-slot two-stage ring-key search against JAX's
    ``ringkey_two_stage_best`` one slot at a time, slot t querying row
    30 + t over the rows before it.  Every answer of either package is an
    exact-arithmetic optimum of the search, a tie broken some way
    (``_an_exact_optimum``).  On the 60-point clouds the answers are equal.
    On the landmark clouds exact ties among ring-key distances (at the k-th
    candidate) and among sector-key alignments are common, and XLA's float32
    reductions and einsum break some of them otherwise than the port's
    ``halving_sum``, whose order is the same on the card and the CPU."""
    cfg, k = CFG, CFG.num_candidates
    descs = _tie_prone_bank(kind)
    keys = np_(tsc.ring_key(t(descs)))
    slots = np.arange(30, len(descs))
    searchable = np.arange(len(descs))[None, :] < slots[:, None]
    gi, gd, gs = map(np_, tsc.ringkey_two_stage_best_multi(
        t(descs[slots]), t(descs), t(keys), t(searchable), k, cfg))
    one = jax.jit(lambda q, s: jsc.ringkey_two_stage_best(q, jnp.asarray(descs),
                                                          jnp.asarray(keys), s, k, cfg))
    want = [tuple(np.asarray(x) for x in one(jnp.asarray(descs[q]), jnp.asarray(s)))
            for q, s in zip(slots, searchable)]
    jdist = np.asarray(jax.jit(jax.vmap(jsc.sc_shift_distance_matrix, in_axes=(0, None)))(
        jnp.asarray(descs[slots]), jnp.asarray(descs)))
    gdist = np_(tsc.sc_shift_distance_matrix_multi(t(descs[slots]), t(descs)))
    differing = 0
    for j, q in enumerate(slots):
        wi, wd, ws = want[j]
        assert _an_exact_optimum(descs, q, searchable[j], gdist[j], gi[j], gs[j], gd[j], k,
                                 cfg), (q, "port")
        assert _an_exact_optimum(descs, q, searchable[j], jdist[j], int(wi), int(ws),
                                 float(wd), k, cfg), (q, "jax")
        differing += (gi[j], gs[j]) != (int(wi), int(ws)) or abs(gd[j] - float(wd)) > SC_ATOL
    assert differing == 0 if kind == "sparse-60" else differing > 0


def test_scmanager_empty_capacity_and_state_checks():
    """An empty bank gives (-1, 0.0); a full one refuses both inserts with
    JAX's error; the state loader refuses another capacity."""
    cfg = CFG
    jm = jsc.ScanContextManager(cfg, capacity=2)
    tm = tsc.ScanContextManager(cfg, capacity=2, device="cpu")
    assert tm.detectLoopClosureID() == jm.detectLoopClosureID() == (-1, 0.0)
    for c in (_cloud(1, 400), _cloud(2, 400)):
        jm.makeAndSaveScancontextAndKeys(jnp.asarray(c))
        tm.makeAndSaveScancontextAndKeys(c)
    for mgr, xy in ((jm, jnp.asarray(_cloud(3, 400))), (tm, _cloud(3, 400))):
        with pytest.raises(RuntimeError, match="capacity exceeded"):
            mgr.makeAndSaveScancontextAndKeys(xy)
        with pytest.raises(RuntimeError, match="capacity exceeded"):
            mgr.saveScancontextAndKeys(np.zeros((cfg.num_ring, cfg.num_sector), np.float32))
    assert tm.num == jm.num == 2
    big = tsc.ScanContextManager(cfg, capacity=4, device="cpu")
    with pytest.raises(ValueError, match="capacity|holds"):
        state.load_scmanager_state(big, state.scmanager_state_to_numpy(tm))


def test_scmanager_runs_on_the_card_by_default():
    """Without ``device=`` the manager is on the card: it raises where there
    is none."""
    if torch.cuda.is_available():
        assert tsc.ScanContextManager(CFG, capacity=4).bank.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsc.ScanContextManager(CFG, capacity=4)


def test_keys_are_exact_means():
    """Ring and sector keys of occupancy descriptors (values 0 and 2: exact
    sums) are the sum times the float32 reciprocal of the count, JAX's
    means bit for bit, for one descriptor and a batch alike; the keys, the
    ring-key d2 and the sector-key alignment sum in float64 by
    ``halving_sum``, whose adds come in one order fixed by the length alone
    (the same bits on every device, a row alone as in a batch)."""
    descs = _descs([_cloud(i) for i in range(6)])
    rk, sk = np_(tsc.ring_key(t(descs))), np_(tsc.sector_key(t(descs)))
    np.testing.assert_array_equal(rk, descs.sum(-1) * np.float32(1 / CFG.num_sector))
    np.testing.assert_array_equal(sk, descs.sum(-2) * np.float32(1 / CFG.num_ring))
    np.testing.assert_array_equal(rk, np.asarray(jsc.ring_key(jnp.asarray(descs))))
    np.testing.assert_array_equal(sk, np.asarray(jsc.sector_key(jnp.asarray(descs))))
    np.testing.assert_array_equal(np_(tsc.ring_key(t(descs[3]))), rk[3])
    x = np.random.default_rng(0).random((3, 37), dtype=np.float32)
    want = np.pad(x, ((0, 0), (0, 64 - 37)))
    while want.shape[-1] > 1:
        half = want.shape[-1] // 2
        want = want[:, :half] + want[:, half:]
    np.testing.assert_array_equal(np_(halving_sum(t(x))), want[:, 0])
    np.testing.assert_array_equal(np_(halving_sum(t(x[1]))), want[1, 0])
    x = x.astype(np.float64)
    np.testing.assert_allclose(np_(tsc._ordered_sum(t(x))), x.sum(-1), rtol=1e-15)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,points", [("full", 400), ("ringkey_fresh", 400),
                                         ("ringkey", 60), ("ringkey_fresh", 60)])
def test_scmanager_on_cuda_matches_cpu(mode, points, cuda_device):  # noqa: F811
    """The manager on the card against the one on the CPU: the same (index,
    yaw) at every detect, one K2 launch a detect and none an insert, the
    same between-session answers (one K2 launch each).  Sparse clouds (60
    points) make keys that tie exactly, which a float32 reduction broke
    differently on the card and the CPU."""
    cfg = _mode_cfg(mode)
    cm = tsc.ScanContextManager(cfg, capacity=64, device="cpu")
    gm = tsc.ScanContextManager(cfg, capacity=64, device=cuda_device)
    clouds = [_cloud(300 + i, points) for i in range(35)]
    clouds.append(_cloud(302, points, rot=0.5))
    for i, c in enumerate(clouds):
        cm.makeAndSaveScancontextAndKeys(c)
        before = sc_corr.launch_count
        gm.makeAndSaveScancontextAndKeys(t(c, cuda_device))
        assert sc_corr.launch_count == before
        if i >= 30:
            want = cm.detectLoopClosureID()
            assert gm.detectLoopClosureID() == pytest.approx(want, abs=1e-6), i
            assert sc_corr.launch_count == before + 1
    assert gm.detectLoopClosureID()[0] == (2 if mode != "ringkey" else -1)
    np.testing.assert_allclose(np_(gm.bank), np_(cm.bank), atol=SC_ATOL)
    for k, phi in ((5, -0.3), (20, 0.8)):
        q = _port_desc(_cloud(300 + k, points, rot=phi))
        before = sc_corr.launch_count
        got = gm.detectLoopClosureIDBetweenSession(t(q, cuda_device))
        assert sc_corr.launch_count == before + 1
        assert got == pytest.approx(cm.detectLoopClosureIDBetweenSession(q), abs=1e-6)
    for n in (0, 1, 36, 64):
        before = sc_corr.launch_count
        got = tsc.detect_loop_between_sessions(gm.bank[0], gm.bank, n, cfg)
        want = tsc.detect_loop_between_sessions(cm.bank[0], cm.bank, n, cfg)
        assert sc_corr.launch_count == before + 1
        _same_candidate(got, want)
