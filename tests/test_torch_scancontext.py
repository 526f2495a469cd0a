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
from torch_parity_util import cuda_device, np_, t  # noqa: F401 (fixture)

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


@pytest.mark.parametrize("num_valid", [40, 25, 10])
def test_detect_loop_matches_jax(num_valid):
    """The query is keyframe num_valid - 1: a revisit of row 3 at 40, no
    searchable revisit below that; 10 leaves nothing searchable."""
    cfg = dataclasses.replace(CFG, num_exclude_recent=12)
    bank = _bank(40)
    query = bank[num_valid - 1]
    want = jsc.detect_loop(jnp.asarray(query), jnp.asarray(bank), jnp.asarray(num_valid), cfg)
    got = tsc.detect_loop(t(query), t(bank), num_valid, cfg)
    _same_candidate(got, want)
    assert bool(got.found) == (num_valid == 40)


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


@pytest.mark.cuda
def test_sc_corr_kernel_matches_plain_on_cuda(cuda_device):  # noqa: F811
    """K2 against its plain version on the card at a full-width bank (4096
    rows, 40 live); one launch per call; the same best row and shift."""
    bank = torch.zeros((4096, CFG.num_ring, CFG.num_sector), device=cuda_device)
    bank[:64] = t(_bank(40, 64), cuda_device)
    query = bank[39].clone()
    before = sc_corr.launch_count
    got = sc_corr.sc_shift_distances_cuda(query, bank)
    torch.cuda.synchronize()
    assert sc_corr.launch_count == before + 1
    want = tsc.sc_shift_distance_matrix_plain(query, bank)
    np.testing.assert_allclose(np_(got), np_(want), atol=SC_ATOL)
    assert int(torch.argmin(got.min(dim=1).values)) == int(torch.argmin(want.min(dim=1).values))
