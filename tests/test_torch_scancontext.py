"""Parity of the port's ScanContext search with the JAX package's
(``ops/scancontext.py``).

Tolerances: descriptors identical (a scatter-max of the same bins); the
plain ``sc_shift_distance_matrix`` against the TPU kernel in interpret mode
at atol 2e-5 (the JAX suite's bound, tests/test_pallas_kernels.py); the
detectors give the same index, found flag and yaw."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.config import ScanContextConfig
from navtech_radar_slam_tpu.ops import scancontext as jsc
from navtech_radar_slam_tpu.ops.pallas import sc_shift_distances_pallas
from navtech_radar_slam_torch.ops import scancontext as tsc
from navtech_radar_slam_torch.ops.kernels import sc_corr
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
