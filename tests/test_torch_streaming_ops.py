"""Parity of the port's T-slot ops of the streaming segment with the JAX
package's ``jax.vmap`` of the same functions (``models/slam.py``'s
``_make_kf_segment``), and the card tests of K2-T and K3-T.

Tolerances: the plain K2-T against the vmapped TPU kernel in interpret
mode at atol 2e-5 with the same best row and shift per slot (the JAX
suite's bound, tests/test_pallas_kernels.py); the plain K3-T with
identical indices, and d² within 1 ulp (XLA may contract the interpreted
kernel body's dx*dx + dy*dy into a multiply-add; the port never does, as
in test_torch_icp.py); batched voxel masks identical; the T-slot
detectors the same index, flag and yaw per slot; T-slot verification the
same decision per slot with the pose within 1e-3 (the ICP parity of
test_torch_icp.py).  On the card, K2-T and K3-T slot t equal the
single-query kernels bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.data import RadarSimulator
from navtech_radar_slam_tpu.models import slam as jslam
from navtech_radar_slam_tpu.ops import scancontext as jsc
from navtech_radar_slam_tpu.ops.pallas import (nearest_neighbors_pallas,
                                               sc_shift_distances_pallas)
from navtech_radar_slam_tpu.ops.voxel import voxel_dedup_mask as jvoxel
from navtech_radar_slam_torch.models import slam as tslam
from navtech_radar_slam_torch.ops import icp as ticp
from navtech_radar_slam_torch.ops import scancontext as tsc
from navtech_radar_slam_torch.ops.kernels import nn_dist, sc_corr
from navtech_radar_slam_torch.ops.voxel import voxel_dedup_mask as tvoxel
from test_torch_slam import small_cfg
from torch_parity_util import cuda_device, np_, one_torch_thread, t  # noqa: F401 (fixtures)

SC_ATOL = 2e-5
CFG = small_cfg()
SCC = dataclasses.replace(CFG.scancontext, num_exclude_recent=12)


def _clouds(n, seed=0, k=250):
    """n radar-like clouds: 40 places, a few later clouds revisiting
    earlier places (shifted and rotated), with every 7th point invalid."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(5, 75, (40, k)), rng.uniform(0, 2 * np.pi, (40, k))
    xy = np.zeros((n, k, 2), np.float32)
    for i in range(n):
        place = i % 40 if i < 40 else (i * 7) % 20
        r, th = base[0][place], base[1][place] + (0.3 if i >= 40 else 0.0)
        shift = (0.5, -0.4) if i >= 40 else (0.0, 0.0)
        xy[i] = np.stack([r * np.cos(th), r * np.sin(th)], -1) + shift
    valid = np.ones((n, k), bool)
    valid[:, ::7] = False
    return xy, valid


def _bank(n=48, cap=64):
    """A padded bank of n live descriptors (rows 40 .. n - 1 revisit
    earlier places), zeros after, and the clouds behind it."""
    xy, valid = _clouds(n)
    bank = np.zeros((cap, SCC.num_ring, SCC.num_sector), np.float32)
    bank[:n] = np_(tsc.make_scancontext(t(xy), torch.zeros(xy.shape[1]), t(valid), SCC))
    return bank


def _vmapped_k2(queries, bank, per_slot):
    fn = jax.vmap(lambda q, b: sc_shift_distances_pallas(q, b, interpret=True),
                  in_axes=(0, 0 if per_slot else None))
    return np.asarray(fn(jnp.asarray(queries), jnp.asarray(bank)))


def _same_best(got, want):
    """Per slot: the same best (row, shift) of the (T, N, S) matrices."""
    ns = got.shape[-1]
    g = got.reshape(got.shape[0], -1).argmin(-1)
    w = want.reshape(want.shape[0], -1).argmin(-1)
    np.testing.assert_array_equal(g // ns, w // ns)
    np.testing.assert_array_equal(g % ns, w % ns)


def test_make_scancontext_batched_matches_vmap():
    xy, valid = _clouds(6)
    want = jax.vmap(lambda a, v: jsc.make_scancontext(a, jnp.zeros(a.shape[0]), v, SCC))(
        jnp.asarray(xy), jnp.asarray(valid))
    got = tsc.make_scancontext(t(xy), torch.zeros(xy.shape[1]), t(valid), SCC)
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    # the row means: another summation order, so within an ulp or two
    np.testing.assert_allclose(np_(tsc.ring_key(got)),
                               np.asarray(jax.vmap(jsc.ring_key)(want)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
def test_plain_k2t_matches_vmapped_tpu_kernel(per_slot):
    bank = _bank()
    queries = bank[[45, 3, 47, 60]]          # revisits, a live row, a zero row
    b = np.stack([np.roll(bank[:20], s, axis=-1) for s in (0, 5, 11, 30)]) if per_slot \
        else bank[:48]
    got = np_(tsc.sc_shift_distance_matrix_multi(t(queries), t(b)))
    want = _vmapped_k2(queries, b, per_slot)
    assert got.shape == want.shape == (4, b.shape[-3], SCC.num_sector)
    np.testing.assert_allclose(got, want, rtol=0, atol=SC_ATOL)
    _same_best(got, want)
    # slot t is the single-query plain version's matrix
    for s in range(4):
        single = np_(tsc.sc_shift_distance_matrix_plain(t(queries[s]),
                                                        t(b[s] if per_slot else b)))
        np.testing.assert_allclose(got[s], single, rtol=0, atol=SC_ATOL)


def test_plain_k3t_matches_vmapped_tpu_kernel():
    rng = np.random.default_rng(3)
    n_slots, nq, nt = 3, 200, 700
    src = rng.uniform(-150, 150, (n_slots, nq, 2)).astype(np.float32)
    tgt = rng.uniform(-150, 150, (n_slots, nt, 2)).astype(np.float32)
    valid = rng.random((n_slots, nt)) >= np.asarray([0.2, 0.6, 0.0])[:, None]
    tgt[:, 9] = tgt[:, 4]                      # ties: index 4 must win
    src[:, 0] = tgt[:, 4] + np.float32(0.25)
    valid[:, [4, 9]] = True
    fn = jax.vmap(lambda a, b, v: nearest_neighbors_pallas(a, b, v, interpret=True))
    wd, wi = (np.asarray(x) for x in fn(jnp.asarray(src), jnp.asarray(tgt),
                                        jnp.asarray(valid)))
    gd, gi = (np_(x) for x in ticp.nearest_neighbors_multi(t(src), t(tgt), t(valid)))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=2e-7, atol=0)
    assert (gi[:, 0] == 4).all()
    for s in range(n_slots):
        sd, si = ticp.nearest_neighbors_plain(t(src[s]), t(tgt[s]), t(valid[s]))
        np.testing.assert_array_equal(gi[s], np_(si))
        np.testing.assert_array_equal(gd[s], np_(sd))


def test_masked_plain_k3t_matches_vmapped_tpu_kernel():
    """The slot mask of K3-T's plain version: on a selected slot the
    vmapped TPU kernel's result (identical indices, d² within 1 ulp), on a
    masked slot (+inf, 0) for every query, what an all-invalid slot gives."""
    rng = np.random.default_rng(4)
    n_slots, nq, nt = 4, 150, 600
    src = rng.uniform(-150, 150, (n_slots, nq, 2)).astype(np.float32)
    tgt = rng.uniform(-150, 150, (n_slots, nt, 2)).astype(np.float32)
    valid = rng.random((n_slots, nt)) >= np.asarray([0.3, 0.0, 0.8, 0.5])[:, None]
    tgt[:, 9] = tgt[:, 4]                      # ties: index 4 must win
    src[:, 0] = tgt[:, 4] + np.float32(0.25)
    valid[:, [4, 9]] = True
    mask = np.asarray([True, False, True, False])
    fn = jax.vmap(lambda a, b, v: nearest_neighbors_pallas(a, b, v, interpret=True))
    wd, wi = (np.asarray(x) for x in fn(jnp.asarray(src), jnp.asarray(tgt),
                                        jnp.asarray(valid)))
    gd, gi = (np_(x) for x in ticp.nearest_neighbors_multi(t(src), t(tgt), t(valid),
                                                           t(mask)))
    np.testing.assert_array_equal(gi[mask], wi[mask])
    np.testing.assert_allclose(gd[mask], wd[mask], rtol=2e-7, atol=0)
    assert (gi[mask, 0] == 4).all()
    assert np.isinf(gd[~mask]).all() and (gi[~mask] == 0).all()
    # a masked slot is an all-invalid one; a selected slot is unchanged
    ad, ai = (np_(x) for x in ticp.nearest_neighbors_plain(
        t(src), t(tgt), t(valid & mask[:, None])))
    np.testing.assert_array_equal(gd, ad)
    np.testing.assert_array_equal(gi, ai)
    ud, ui = (np_(x) for x in ticp.nearest_neighbors_plain(t(src), t(tgt), t(valid)))
    np.testing.assert_array_equal(gd[mask], ud[mask])
    np.testing.assert_array_equal(gi[mask], ui[mask])


@pytest.mark.parametrize("voxel", [0.4, 1.0, 0.0])
def test_voxel_mask_batched_matches_vmap(voxel):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-20, 20, (5, 300, 2)).astype(np.float32)
    pts[:, ::3] = np.round(pts[:, ::3])                # cell collisions
    valid = rng.random((5, 300)) > 0.2
    want = jax.vmap(lambda p, v: jvoxel(p, v, voxel))(jnp.asarray(pts), jnp.asarray(valid))
    got = tvoxel(t(pts), t(valid), voxel)
    np.testing.assert_array_equal(np_(got), np.asarray(want))


def _same_candidates(got, want, active):
    np.testing.assert_array_equal(np_(got.idx)[active], np.asarray(want.idx)[active])
    np.testing.assert_array_equal(np_(got.found)[active], np.asarray(want.found)[active])
    np.testing.assert_allclose(np_(got.yaw)[active], np.asarray(want.yaw)[active], atol=1e-6)
    found = np.asarray(want.found) & active
    np.testing.assert_allclose(np_(got.dist)[found], np.asarray(want.dist)[found],
                               atol=SC_ATOL)


@pytest.mark.parametrize("k0,m", [(40, 8), (8, 8), (30, 5), (0, 4)])
def test_detect_loop_multi_matches_vmapped_jax(k0, m, monkeypatch):
    """Slot t is keyframe k0 + t with num_valid = k0 + t + 1; one K2-T call
    scores max(k0 + m - 12, 1) rows for every slot.  (8, 8) and (0, 4)
    leave some or all slots nothing searchable."""
    n_slots = 8
    bank = _bank()
    queries = bank[k0:k0 + n_slots]
    num_kfs = k0 + 1 + np.arange(n_slots)
    want = jax.vmap(lambda q, nv: jsc.detect_loop(q, jnp.asarray(bank), nv, SCC))(
        jnp.asarray(queries), jnp.asarray(num_kfs))
    scored = []
    multi = tsc.sc_shift_distance_matrix_multi

    def recording(q, b):
        scored.append(tuple(b.shape[:-2]))
        return multi(q, b)

    monkeypatch.setattr(tsc, "sc_shift_distance_matrix_multi", recording)
    got = tsc.detect_loop_multi(t(queries), t(bank), k0, m, SCC)
    active = np.arange(n_slots) < m
    _same_candidates(got, want, active)
    assert scored == [(max(k0 + m - 12, 1),)]
    if k0 == 40:
        assert np_(got.found).any()


@pytest.mark.parametrize("period,ratio", [(30, 0.1), (1, 0.0), (8, 0.1)])
def test_detect_loop_ringkey_multi_matches_vmapped_jax(period, ratio):
    cfg = dataclasses.replace(SCC, tree_making_period=period, search_ratio=ratio)
    bank = _bank()
    keys = bank.mean(axis=-1)
    k0, n_slots = 40, 8
    queries = bank[k0:k0 + n_slots]
    num_kfs = k0 + 1 + np.arange(n_slots)
    want = jax.vmap(lambda q, nv: jsc.detect_loop_ringkey(
        q, jnp.asarray(bank), jnp.asarray(keys), nv, cfg))(jnp.asarray(queries),
                                                           jnp.asarray(num_kfs))
    got = tsc.detect_loop_ringkey_multi(t(queries), t(bank), t(keys), k0, cfg)
    _same_candidates(got, want, np.ones(n_slots, bool))
    assert np_(got.found).any()


def _verify_state():
    """Keyframe clouds of a simulator circuit (landmarks in each pose's
    sensor frame, no rendering), the graph poses, the odometry path, and
    the revisit candidates of keyframes 22 .. 25."""
    sim = RadarSimulator(CFG.radar)
    gt = sim.circuit_trajectory(30, radius=5.0, speed=6.0)
    k = CFG.features.max_features
    m = CFG.keyframes.max_keyframes
    clouds = np.zeros((m, k, 2), np.float32)
    valid = np.zeros((m, k), bool)
    for i, pose in enumerate(gt):
        r, b, _ = sim.visible_landmarks(pose)
        n = min(len(r), k)
        clouds[i, :n] = np.stack([r * np.cos(b), r * np.sin(b)], -1)[:n]
        valid[i, :n] = True
    rng = np.random.default_rng(5)
    poses = np.zeros((m, 3), np.float32)
    rel = np.stack([gt[:, 0] - gt[0, 0], gt[:, 1] - gt[0, 1], gt[:, 2] - gt[0, 2]], -1)
    poses[:30] = rel + rng.normal(0, [0.05, 0.05, 0.005], rel.shape)
    steps = np.linalg.norm(np.diff(rel[:, :2], axis=0), axis=1)
    path = np.zeros(m, np.float32)
    path[1:30] = np.cumsum(steps)
    path[30:] = path[29]
    return clouds, valid, poses, path


def test_verify_candidate_multi_matches_vmapped_jax():
    """Slots: two revisits found (candidates 1 and 2 for keyframes 22 and
    23), a revisit whose candidate was not found, a wrong candidate found
    (keyframe 11 for 25), and an inactive tail slot.  The T-slot ICP runs
    all found slots in lockstep; the not-found and inactive slots give the
    empty result."""
    clouds, valid, poses, path = _verify_state()
    ks = np.asarray([22, 23, 24, 25, 26])
    cand = dict(idx=np.asarray([1, 2, -1, 11, 5], np.int64),
                dist=np.asarray([0.1, 0.12, np.inf, 0.3, 0.2], np.float32),
                yaw=np.asarray([0.0, 0.05, 0.0, 0.1, 0.0], np.float32),
                found=np.asarray([True, True, False, True, True]))
    active = np.asarray([True, True, True, True, False])
    num_kfs = ks + 1
    jc = jsc.LoopCandidate(**{key: jnp.asarray(v) for key, v in cand.items()})
    want = jax.vmap(lambda c, xy, v, nk: jslam._verify_candidate(
        c, jnp.asarray(clouds), jnp.asarray(valid), jnp.asarray(poses), xy, v, nk, CFG,
        path_cum=jnp.asarray(path), session_start=0))(
        jc, jnp.asarray(clouds[ks]), jnp.asarray(valid[ks]), jnp.asarray(num_kfs))
    tc = tsc.LoopCandidate(**{key: t(v) for key, v in cand.items()})
    got = tslam._verify_candidate_multi(
        tc, t(clouds), t(valid), t(poses), t(clouds[ks]), t(valid[ks]), t(num_kfs),
        t(active), CFG, path_cum=t(path), session_start=0)
    on = active
    np.testing.assert_array_equal(np_(got.accepted)[on], np.asarray(want.accepted)[on])
    np.testing.assert_allclose(np_(got.rel_pose)[on], np.asarray(want.rel_pose)[on],
                               atol=1e-3)
    assert np_(got.accepted)[:2].all() and not np_(got.accepted)[2:].any()
    for s in (2, 4):   # no candidate, inactive: the empty result
        assert np.isinf(np_(got.fitness)[s]) and not np_(got.accepted)[s]
        np.testing.assert_array_equal(np_(got.rel_pose)[s], np.zeros(3))
    # a found slot ends where the single-problem path ends
    one = tslam._verify_candidate(
        tsc.LoopCandidate(*(x[0] for x in tc)), t(clouds), t(valid), t(poses),
        t(clouds[22]), t(valid[22]), 23, CFG, path_cum=t(path), session_start=0)
    np.testing.assert_allclose(np_(got.rel_pose)[0], np_(one.rel_pose), atol=1e-5)
    assert bool(one.accepted) == bool(got.accepted[0])


def test_verify_candidate_multi_slot_mask_changes_no_kept_value(monkeypatch):
    """The T-slot ICP masks K3-T to the unconverged slots (and to the active
    ones for the final fitness): every slot that runs ends bit for bit where
    a run computing every slot on every call ends, and no kept value is
    NaN; the JAX comparison is test_verify_candidate_multi_matches_vmapped_jax."""
    clouds, valid, poses, path = _verify_state()
    ks = np.asarray([22, 23, 24, 25, 26])
    cand = tsc.LoopCandidate(
        idx=t(np.asarray([1, 2, -1, 11, 5], np.int64)),
        dist=t(np.asarray([0.1, 0.12, np.inf, 0.3, 0.2], np.float32)),
        yaw=t(np.asarray([0.0, 0.05, 0.0, 0.1, 0.0], np.float32)),
        found=t(np.asarray([True, True, False, True, True])))
    active = t(np.asarray([True, True, True, True, False]))
    masks = []
    nn = ticp.nearest_neighbors_multi

    def recorded(src, tgt, tgt_valid, slot_mask=None):
        masks.append(None if slot_mask is None else np_(slot_mask).copy())
        return nn(src, tgt, tgt_valid, slot_mask)

    def run():
        return tslam._verify_candidate_multi(
            cand, t(clouds), t(valid), t(poses), t(clouds[ks]), t(valid[ks]),
            t(ks + 1), active, CFG, path_cum=t(path), session_start=0)

    monkeypatch.setattr(ticp, "nearest_neighbors_multi", recorded)
    masked = run()
    # the masks narrow as slots converge; the final call computes every
    # slot that runs (found and active)
    runs = np_(cand.found & active)
    assert all(m is not None for m in masks) and (masks[-1] == runs).all()
    assert (masks[0] == runs).all() and any(m.sum() < runs.sum() for m in masks[:-1])
    monkeypatch.setattr(ticp, "nearest_neighbors_multi",
                        lambda src, tgt, tgt_valid, slot_mask=None: nn(src, tgt, tgt_valid))
    every = run()
    for name, a, b in zip(masked._fields, masked, every):
        assert torch.equal(a, b), name
        if a.is_floating_point():
            assert not torch.isnan(a).any(), name


def test_icp_multi_with_no_active_slot_runs_no_iteration(monkeypatch):
    """Every slot starts converged: the first check stops the loop, and
    only the final-fitness call of K3-T remains."""
    calls = []
    nn = ticp.nearest_neighbors_multi

    def counting(*args):
        calls.append(1)
        return nn(*args)

    monkeypatch.setattr(ticp, "nearest_neighbors_multi", counting)
    src = torch.zeros((3, 8, 2))
    res = ticp.icp_se2_multi(src, torch.ones((3, 8), dtype=torch.bool), src,
                             torch.ones((3, 8), dtype=torch.bool), torch.zeros((3, 3)),
                             CFG.icp, torch.zeros(3, dtype=torch.bool))
    assert len(calls) == 1 and res.rel_pose.shape == (3, 3)


def test_multi_kernel_wrappers_take_only_cuda_tensors():
    bank = torch.zeros((4, 20, 60))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc_corr.sc_shift_distances_multi_cuda(bank[:2], bank)
    x = torch.zeros((2, 8, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        nn_dist.nearest_neighbors_multi_cuda(x, x, torch.ones((2, 8), dtype=torch.bool))


# -- on the card ---------------------------------------------------------------

def _card_banks(n_slots, per_slot, dev):
    bank = _bank()
    rng = np.random.default_rng(n_slots)
    queries = np.stack([np.roll(bank[(7 * s) % 48], int(rng.integers(0, 60)), axis=-1)
                        for s in range(n_slots)])
    if per_slot:
        b = np.stack([np.roll(bank[:30], int(rng.integers(0, 60)), axis=-1)
                      for _ in range(n_slots)])
    else:
        b = bank[:48]
    return t(queries, dev), t(b, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("n_slots", [1, 3, 16])
def test_k2t_kernel_matches_plain_on_cuda(n_slots, per_slot, cuda_device):  # noqa: F811
    """K2-T on the card: one launch per call, atol 2e-5 with the same best
    row and shift per slot, and slot t bit-equal to the single-query K2."""
    queries, bank = _card_banks(n_slots, per_slot, cuda_device)
    before = sc_corr.multi_launch_count
    got = sc_corr.sc_shift_distances_multi_cuda(queries, bank)
    torch.cuda.synchronize()
    assert sc_corr.multi_launch_count == before + 1
    want = tsc.sc_shift_distance_matrix_multi_plain(queries, bank)
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=SC_ATOL)
    _same_best(np_(got), np_(want))
    for s in range(n_slots):
        one = sc_corr.sc_shift_distances_cuda(queries[s], bank[s] if per_slot else bank)
        np.testing.assert_array_equal(np_(got[s]), np_(one))


@pytest.mark.cuda
def test_k2t_kernel_raises_on_cuda(cuda_device):  # noqa: F811
    q = torch.zeros((3, 20, 60), device=cuda_device)
    with pytest.raises(ValueError, match="do not match"):
        sc_corr.sc_shift_distances_multi_cuda(q, torch.zeros((2, 5, 20, 60), device=cuda_device))
    with pytest.raises(ValueError, match="sectors"):
        sc_corr.sc_shift_distances_multi_cuda(torch.zeros((3, 20, 65), device=cuda_device),
                                              torch.zeros((5, 20, 65), device=cuda_device))
    with pytest.raises(TypeError, match="float32"):
        sc_corr.sc_shift_distances_multi_cuda(q.double(), torch.zeros((5, 20, 60),
                                                                      device=cuda_device))
    before = sc_corr.multi_launch_count
    out = sc_corr.sc_shift_distances_multi_cuda(q, torch.zeros((0, 20, 60), device=cuda_device))
    assert out.shape == (3, 0, 60) and sc_corr.multi_launch_count == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [1, 3, 16])
def test_k3t_kernel_matches_plain_on_cuda(n_slots, cuda_device):  # noqa: F811
    """K3-T on the card: one launch per call, identical indices and d², and
    slot t bit-equal to the single-problem K3; masks differ per slot."""
    rng = np.random.default_rng(n_slots)
    nq, nt = 1024, 8192
    src = t(rng.uniform(-150, 150, (n_slots, nq, 2)).astype(np.float32), cuda_device)
    tgt = t(rng.uniform(-150, 150, (n_slots, nt, 2)).astype(np.float32), cuda_device)
    valid = t(rng.random((n_slots, nt)) >= rng.uniform(0, 0.9, (n_slots, 1)), cuda_device)
    before = nn_dist.multi_launch_count
    gd, gi = nn_dist.nearest_neighbors_multi_cuda(src, tgt, valid)
    torch.cuda.synchronize()
    assert nn_dist.multi_launch_count == before + 1
    wd, wi = ticp.nearest_neighbors_plain(src, tgt, valid)
    np.testing.assert_array_equal(np_(gi), np_(wi))
    np.testing.assert_array_equal(np_(gd), np_(wd))
    for s in range(n_slots):
        od, oi = nn_dist.nearest_neighbors_cuda(src[s], tgt[s], valid[s])
        np.testing.assert_array_equal(np_(gd[s]), np_(od))
        np.testing.assert_array_equal(np_(gi[s]), np_(oi))


@pytest.mark.cuda
def test_k3t_kernel_ties_and_raises_on_cuda(cuda_device):  # noqa: F811
    """Every target repeated in each of the 8 chunks, per slot: the first
    valid one wins; an all-invalid slot gives +inf and index 0."""
    rng = np.random.default_rng(9)
    base = rng.uniform(-150, 150, (3, 1024, 2)).astype(np.float32)
    tgt = t(np.tile(base, (1, 8, 1)), cuda_device)
    src = t(rng.uniform(-150, 150, (3, 512, 2)).astype(np.float32), cuda_device)
    valid = torch.ones((3, 8192), dtype=torch.bool, device=cuda_device)
    valid[1, :1024] = False
    valid[2] = False
    gd, gi = nn_dist.nearest_neighbors_multi_cuda(src, tgt, valid)
    wd, wi = ticp.nearest_neighbors_plain(src, tgt, valid)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np_(gi), np_(wi))
    np.testing.assert_array_equal(np_(gd), np_(wd))
    assert (np_(gi[0]) < 1024).all() and ((np_(gi[1]) >= 1024) & (np_(gi[1]) < 2048)).all()
    assert np.isinf(np_(gd[2])).all() and (np_(gi[2]) == 0).all()
    with pytest.raises(ValueError, match="contiguous"):
        nn_dist.nearest_neighbors_multi_cuda(src, tgt[:2], valid[:2])
    with pytest.raises(TypeError, match="bool"):
        nn_dist.nearest_neighbors_multi_cuda(src, tgt, valid.float())


@pytest.mark.cuda
def test_masked_k3t_kernel_matches_plain_on_cuda(cuda_device):  # noqa: F811
    """The slot mask on the card: 16 slots at (1024, 8192) with masks that
    differ per slot and half the slots masked off, exact against the masked
    plain version (the same indices, d² and +inf entries); a selected slot
    bit-equal to the unmasked launch and to K3; one launch a call."""
    rng = np.random.default_rng(21)
    n_slots, nq, nt = 16, 1024, 8192
    src = t(rng.uniform(-150, 150, (n_slots, nq, 2)).astype(np.float32), cuda_device)
    tgt = t(rng.uniform(-150, 150, (n_slots, nt, 2)).astype(np.float32), cuda_device)
    valid = t(rng.random((n_slots, nt)) >= np.linspace(0, 0.9, n_slots)[:, None], cuda_device)
    mask = t(np.arange(n_slots) % 2 == 0, cuda_device)
    before = nn_dist.multi_launch_count
    gd, gi = nn_dist.nearest_neighbors_multi_cuda(src, tgt, valid, mask)
    torch.cuda.synchronize()
    assert nn_dist.multi_launch_count == before + 1
    wd, wi = ticp.nearest_neighbors_plain(src, tgt, valid, mask)
    np.testing.assert_array_equal(np_(gi), np_(wi))
    np.testing.assert_array_equal(np_(gd), np_(wd))
    assert torch.isinf(gd[~mask]).all() and (gi[~mask] == 0).all()
    ud, ui = nn_dist.nearest_neighbors_multi_cuda(src, tgt, valid)
    np.testing.assert_array_equal(np_(gd[mask]), np_(ud[mask]))
    np.testing.assert_array_equal(np_(gi[mask]), np_(ui[mask]))
    od, oi = nn_dist.nearest_neighbors_cuda(src[0], tgt[0], valid[0])
    np.testing.assert_array_equal(np_(gd[0]), np_(od))
    np.testing.assert_array_equal(np_(gi[0]), np_(oi))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties_across_chunks", "all_slots_masked",
                                  "all_targets_invalid", "prefix_valid"])
def test_masked_k3t_kernel_edge_cases_on_cuda(case, cuda_device):  # noqa: F811
    """Ties of every target across the 8 chunks (the first valid copy wins,
    in a selected slot beside masked ones), every slot masked, every target
    invalid in selected slots, and valid targets as a prefix (how the
    submap packs them): exact against the masked plain version."""
    rng = np.random.default_rng(22)
    n_slots = 4
    base = rng.uniform(-150, 150, (n_slots, 1024, 2)).astype(np.float32)
    tgt = t(np.tile(base, (1, 8, 1)), cuda_device)
    src = t(rng.uniform(-150, 150, (n_slots, 700, 2)).astype(np.float32), cuda_device)
    valid = torch.ones((n_slots, 8192), dtype=torch.bool, device=cuda_device)
    valid[1, :1024] = False
    mask = torch.tensor([True, True, False, True], device=cuda_device)
    if case == "all_slots_masked":
        mask[:] = False
    elif case == "all_targets_invalid":
        valid[:] = False
    elif case == "prefix_valid":
        valid[:] = torch.arange(8192, device=cuda_device) < torch.tensor(
            [[3000], [1], [8192], [4097]], device=cuda_device)
    gd, gi = nn_dist.nearest_neighbors_multi_cuda(src, tgt, valid, mask)
    wd, wi = ticp.nearest_neighbors_plain(src, tgt, valid, mask)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np_(gi), np_(wi))
    np.testing.assert_array_equal(np_(gd), np_(wd))
    if case == "ties_across_chunks":
        assert (np_(gi[0]) < 1024).all() and ((np_(gi[1]) >= 1024) & (np_(gi[1]) < 2048)).all()
    if case in ("all_slots_masked", "all_targets_invalid"):
        assert torch.isinf(gd).all() and (gi == 0).all()


@pytest.mark.cuda
def test_masked_k3t_kernel_refuses_a_bad_mask_on_cuda(cuda_device):  # noqa: F811
    x = torch.zeros((2, 64, 2), device=cuda_device)
    v = torch.ones((2, 64), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="slot_mask"):
        nn_dist.nearest_neighbors_multi_cuda(x, x, v, torch.ones(2, device=cuda_device))
    with pytest.raises(ValueError, match="slot_mask"):
        nn_dist.nearest_neighbors_multi_cuda(x, x, v, torch.ones(3, dtype=torch.bool,
                                                                  device=cuda_device))
    with pytest.raises(ValueError, match="slot_mask"):
        nn_dist.nearest_neighbors_multi_cuda(x, x, v, torch.ones(2, dtype=torch.bool))
