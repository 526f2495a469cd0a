"""Parity of the port's loop ICP with the JAX package's (``ops/icp.py``).

Tolerances: the plain nearest-neighbour search against the TPU kernel in
interpret mode gives identical indices, and d² within 1 ulp of the ~1e4 m²
values (XLA may contract the kernel body's dx*dx + dy*dy into a
multiply-add; the port never does).  ``icp_se2`` on the planted pairs of
tests/test_icp.py against the JAX XLA path: pose atol 1e-3, the same
``accepted``.  JAX's CPU path takes d² in the |a|²+|b|²-2ab expansion,
~1e-2 m² off at 150 m, which moves borderline correspondences."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.config import IcpConfig
from navtech_radar_slam_tpu.ops import icp as jicp
from navtech_radar_slam_tpu.ops.pallas import nearest_neighbors_pallas
from navtech_radar_slam_tpu.utils import geometry as jgeo
from navtech_radar_slam_torch.ops import icp as ticp
from navtech_radar_slam_torch.ops.kernels import nn_dist
from torch_parity_util import cuda_device, np_, one_torch_thread, t  # noqa: F401 (fixtures)

CFG = dataclasses.replace(IcpConfig(), max_iters=50)


def _pad(arr, n):
    out = np.zeros((n, 2), np.float32)
    out[: len(arr)] = arr
    valid = np.zeros(n, bool)
    valid[: len(arr)] = True
    return out, valid


def _nn_inputs(seed, nq, nt, frac_invalid):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-150, 150, (nq, 2)).astype(np.float32)
    tgt = rng.uniform(-150, 150, (nt, 2)).astype(np.float32)
    tgt[7] = tgt[3]                                  # a tie: index 3 must win
    src[0] = tgt[3] + np.float32(0.25)
    valid = rng.random(nt) >= frac_invalid
    valid[3] = valid[7] = True
    return src, tgt, valid


@pytest.mark.parametrize("nq,nt,frac", [(300, 1000, 0.2), (64, 2048, 0.0), (100, 50, 0.9)])
def test_plain_nn_matches_tpu_kernel(nq, nt, frac):
    src, tgt, valid = _nn_inputs(nq + nt, nq, nt, frac)
    dj, ij = nearest_neighbors_pallas(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid),
                                      interpret=True)
    dt, it = ticp.nearest_neighbors(t(src), t(tgt), t(valid))
    np.testing.assert_array_equal(np_(it), np.asarray(ij))
    np.testing.assert_allclose(np_(dt), np.asarray(dj), rtol=2e-7, atol=0)
    assert int(it[0]) == 3


def test_plain_nn_with_no_valid_target():
    src, tgt, _ = _nn_inputs(0, 16, 64, 0.0)
    valid = np.zeros(64, bool)
    dj, ij = nearest_neighbors_pallas(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid),
                                      interpret=True)
    dt, it = ticp.nearest_neighbors(t(src), t(tgt), t(valid))
    assert np.isinf(np_(dt)).all() and np.isinf(np.asarray(dj)).all()
    np.testing.assert_array_equal(np_(it), np.asarray(ij))
    assert (np_(it) == 0).all()


def test_weighted_horn_matches_jax(rng):
    src = rng.uniform(-50, 50, (200, 2)).astype(np.float32)
    dst = src @ np.asarray([[0.9, 0.43], [-0.43, 0.9]], np.float32) + [3.0, -1.0]
    w = (rng.random(200) > 0.3).astype(np.float32)
    want = np.asarray(jicp._weighted_se2_horn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    got = np_(ticp._weighted_se2_horn(t(src), t(dst), t(w)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def _planted(rng, n_tgt, pose_true, noise=0.0, world=None):
    tgt = rng.uniform(-60, 60, (n_tgt, 2)).astype(np.float32) if world is None else world
    inv = np.asarray(jgeo.se2_inv(jnp.asarray(pose_true)))
    src = np.asarray(jgeo.se2_apply(jnp.asarray(inv), jnp.asarray(tgt)))
    return src + rng.normal(0, noise, src.shape).astype(np.float32), tgt


def _both(src, sv, tgt, tv, init, cfg=CFG):
    want = jicp.icp_se2(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(tgt), jnp.asarray(tv),
                        jnp.asarray(init, jnp.float32), cfg)
    got = ticp.icp_se2(t(src), t(sv), t(tgt), t(tv), t(np.asarray(init, np.float32)), cfg)
    return got, want


def _check(got, want, pose_atol=1e-3):
    np.testing.assert_allclose(np_(got.rel_pose), np.asarray(want.rel_pose), atol=pose_atol)
    assert bool(got.accepted) == bool(want.accepted)
    assert int(got.num_corr) == int(want.num_corr)


@pytest.mark.parametrize("metric", ["whitened", "pcl"])
def test_icp_recovers_transform_like_jax(metric):
    """tests/test_icp.py::test_icp_recovers_transform, in both fitness
    metrics."""
    rng = np.random.default_rng(0)
    pose_true = np.array([2.0, -1.5, 0.25], np.float32)
    src_np, tgt_np = _planted(rng, 400, pose_true, noise=0.02)
    src, sv = _pad(src_np, 512)
    tgt, tv = _pad(tgt_np, 512)
    cfg = dataclasses.replace(CFG, fitness_metric=metric,
                              fitness_thresh=0.3 if metric == "pcl" else CFG.fitness_thresh)
    got, want = _both(src, sv, tgt, tv, np.zeros(3), cfg)
    _check(got, want)
    assert bool(got.accepted) and bool(got.converged)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=2e-2)


def test_icp_large_rotation_with_yaw_init_like_jax():
    rng = np.random.default_rng(1)
    pose_true = np.array([1.0, 0.5, 2.1], np.float32)
    src_np, tgt_np = _planted(rng, 500, pose_true)
    src, sv = _pad(src_np, 512)
    tgt, tv = _pad(tgt_np, 512)
    got, want = _both(src, sv, tgt, tv, np.array([0.0, 0.0, 2.1 - 0.08]))
    _check(got, want)
    assert abs(float(got.rel_pose[2]) - 2.1) < 0.02


def test_icp_rejects_unrelated_clouds_like_jax():
    rng = np.random.default_rng(2)
    a, av = _pad(rng.uniform(-60, 60, (400, 2)).astype(np.float32), 512)
    b, bv = _pad(np.random.default_rng(99).uniform(-60, 60, (400, 2)).astype(np.float32), 512)
    got, want = _both(a, av, b, bv, np.zeros(3))
    assert not bool(got.accepted) and not bool(want.accepted)
    assert float(got.fitness) > CFG.fitness_thresh


def test_icp_partial_overlap_like_jax():
    """The loop use case: a scan against a much larger submap."""
    rng = np.random.default_rng(3)
    world = rng.uniform(-150, 150, size=(3000, 2)).astype(np.float32)
    near = world[np.linalg.norm(world - np.array([40, 20]), axis=1) < 60]
    pose_true = np.array([-1.0, 2.0, 0.15], np.float32)
    src_np, _ = _planted(rng, 0, pose_true, world=near)
    src, sv = _pad(src_np, 1024)
    tgt, tv = _pad(world, 4096)
    got, want = _both(src, sv, tgt, tv, np.array([0.0, 0.0, 0.12]))
    _check(got, want)
    np.testing.assert_allclose(np_(got.rel_pose), pose_true, atol=0.05)


def test_kernel_wrapper_takes_only_cuda_tensors():
    src, tgt, valid = _nn_inputs(0, 8, 16, 0.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nn_dist.nearest_neighbors_cuda(t(src), t(tgt), t(valid))


@pytest.mark.cuda
def test_nn_dist_kernel_matches_plain_on_cuda(cuda_device):  # noqa: F811
    """K3 against its plain version on the card at the ICP's full shapes:
    identical indices and bit-equal d²; one launch per call; an all-invalid
    target set gives inf and index 0."""
    src, tgt, valid = (t(x, cuda_device) for x in _nn_inputs(5, 1024, 8192, 0.2))
    before = nn_dist.launch_count
    gd, gi = nn_dist.nearest_neighbors_cuda(src, tgt, valid)
    torch.cuda.synchronize()
    assert nn_dist.launch_count == before + 1
    wd, wi = ticp.nearest_neighbors_plain(src, tgt, valid)
    np.testing.assert_array_equal(np_(gi), np_(wi))
    np.testing.assert_array_equal(np_(gd), np_(wd))
    nd, ni = nn_dist.nearest_neighbors_cuda(src, tgt, torch.zeros_like(valid))
    assert torch.isinf(nd).all() and (ni == 0).all()


@pytest.mark.parametrize("nq,nt", [(1024, 8192), (1, 1), (33, 2047), (1024, 8193),
                                   (1, 0), (300, 255), (5, 100_000)])
def test_nn_dist_launch_geometry(nq, nt):
    """The host side of K3's grid: query tiles of 32, at most 8 target
    chunks (one cluster), every target in exactly one chunk, no chunk below
    256 targets unless there is only one; at the ICP's (1024, 8192)
    exactly 32 tiles of 8 chunks of 1024: 256 blocks, under two for each of
    the H100's 132 SMs, where 32-query tiles timed faster on the card than
    the earlier 16-query tiles' 512 blocks (chip_smoke.py's K3 line; 16 x
    the blocks for K3-T's 16 slots)."""
    tiles, chunks, chunk_len = nn_dist.launch_geometry(nq, nt)
    assert tiles == -(-nq // nn_dist.QUERY_TILE) and tiles * nn_dist.QUERY_TILE >= nq
    assert 1 <= chunks <= nn_dist.MAX_CHUNKS and chunk_len >= 1
    assert chunks * chunk_len >= nt
    if nt > 0:
        assert (chunks - 1) * chunk_len < nt
    if chunks > 1:
        assert chunk_len >= nn_dist.MIN_CHUNK
    if (nq, nt) == (1024, 8192):
        assert (tiles, chunks, chunk_len) == (32, 8, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 33, 1024])
@pytest.mark.parametrize("nt", [1, 2047, 8192, 8193])
def test_nn_dist_kernel_shapes_on_cuda(cuda_device, nq, nt):  # noqa: F811
    """K3 equals its plain version bit for bit across the chunk and tile
    edges: a single target, a ragged last chunk, the ICP's shape and one
    target past it."""
    rng = np.random.default_rng(nq * 10_007 + nt)
    src = t(rng.uniform(-150, 150, (nq, 2)).astype(np.float32), cuda_device)
    tgt = t(rng.uniform(-150, 150, (nt, 2)).astype(np.float32), cuda_device)
    valid = t(rng.random(nt) >= 0.2 if nt > 1 else np.ones(nt, bool), cuda_device)
    gd, gi = nn_dist.nearest_neighbors_cuda(src, tgt, valid)
    wd, wi = ticp.nearest_neighbors_plain(src, tgt, valid)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np_(gi), np_(wi))
    np.testing.assert_array_equal(np_(gd), np_(wd))


@pytest.mark.cuda
def test_nn_dist_kernel_first_index_wins_across_chunks_on_cuda(cuda_device):  # noqa: F811
    """Duplicate targets in different chunks (cluster ranks) and slices: the
    first valid index wins, as in argmin."""
    nt = 8192
    _, _, chunk_len = nn_dist.launch_geometry(1024, nt)
    rng = np.random.default_rng(17)
    tgt = rng.uniform(-150, 150, (nt, 2)).astype(np.float32)
    valid = np.ones(nt, bool)
    groups = [  # indices holding one point; the first valid one must win
        [3 * chunk_len + 5, 6 * chunk_len + 1, 7 * chunk_len + 900],
        [chunk_len - 1, chunk_len, 2 * chunk_len + 31],
        [40, 41, 4 * chunk_len + 40],
        [2 * chunk_len + 7, 5 * chunk_len + 7],      # the first is invalid
    ]
    valid[groups[3][0]] = False
    src = rng.uniform(-150, 150, (1024, 2)).astype(np.float32)
    pts = np.asarray([[200.0, 200.0], [-200.0, 200.0], [200.0, -200.0], [-200.0, -200.0]],
                     np.float32)
    for g, p in zip(groups, pts):
        tgt[g] = p
    src[:4] = pts + np.float32(0.5)   # outside the other targets' square
    gd, gi = nn_dist.nearest_neighbors_cuda(t(src, cuda_device), t(tgt, cuda_device),
                                            t(valid, cuda_device))
    wd, wi = ticp.nearest_neighbors_plain(t(src, cuda_device), t(tgt, cuda_device),
                                          t(valid, cuda_device))
    torch.cuda.synchronize()
    assert np_(gi)[:4].tolist() == [groups[0][0], groups[1][0], groups[2][0], groups[3][1]]
    np.testing.assert_array_equal(np_(gi), np_(wi))
    np.testing.assert_array_equal(np_(gd), np_(wd))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nt", [(1, 1), (33, 2047), (1024, 8192), (1024, 8193)])
def test_nn_dist_kernel_all_invalid_on_cuda(cuda_device, nq, nt):  # noqa: F811
    """No valid target: +inf and index 0 for every query."""
    rng = np.random.default_rng(nt)
    src = t(rng.uniform(-150, 150, (nq, 2)).astype(np.float32), cuda_device)
    tgt = t(rng.uniform(-150, 150, (nt, 2)).astype(np.float32), cuda_device)
    gd, gi = nn_dist.nearest_neighbors_cuda(src, tgt, torch.zeros(nt, dtype=torch.bool,
                                                                  device=cuda_device))
    torch.cuda.synchronize()
    assert torch.isinf(gd).all() and (gd > 0).all() and (gi == 0).all()
