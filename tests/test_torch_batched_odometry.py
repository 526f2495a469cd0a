"""Parity of the port's batched odometry (``make_batched_odometry_step``,
K1 x B, the batched top-k and extraction) with the JAX package's
``make_batched_odometry_step`` and with the port's own one-stream step.

Three streams, each with its own speckle seed and its own stretch of a
circuit; stream 1's second step is a blank scan, so that its registration
fails and its twist carries.  The CPU runs the plain versions; the
``cuda``-marked tests hold the kernel against them on the card."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.data import RadarSimulator
from navtech_radar_slam_tpu.data.packing import pack4
from navtech_radar_slam_tpu.models import odometry as jodo
from navtech_radar_slam_tpu.ops import cen2019 as jcen
from navtech_radar_slam_torch.models import odometry as todo
from navtech_radar_slam_torch.ops import cen2019 as tcen
from navtech_radar_slam_torch.ops import features as tfeat
from navtech_radar_slam_torch.ops import registration as treg
from navtech_radar_slam_torch.ops.kernels import cen_peaks
from torch_parity_util import (  # noqa: F401 (cuda_device, one_torch_thread: fixtures)
    SCAN_FIELDS, cuda_device, np_, one_torch_thread, t, tiny_cfg,
)

CFG = tiny_cfg()
B = 3
STEPS = 2
BLANK = (1, 2)   # (stream, scan) of the blank scan
FIELDS = ("azimuth_idx", "range_bin", "power", "valid")


@pytest.fixture(scope="module")
def streams():
    """(B, STEPS + 1, NA, NBp) float32 scans: stream b starts 2b poses into
    a circuit and has noise seeds 100 b + i; one scan is blank."""
    sim = RadarSimulator(CFG.radar)
    gt = sim.circuit_trajectory(2 * B + STEPS + 1, radius=10.0, speed=6.0)
    out = np.stack([np.stack([sim.render(gt[2 * b + i], noise_seed=100 * b + i)
                              for i in range(STEPS + 1)]) for b in range(B)])
    out[BLANK] = 0.0
    return out


def _wire(scans: np.ndarray, packed: bool) -> np.ndarray:
    if not packed:
        return scans
    return pack4((np.clip(scans, 0, 1) * 255).astype(np.uint8))


def _assert_stream_close(got_res, want_res, got_carry, want_carry, b, tag):
    """Stream b of two steps' outputs: the same ok and inlier count,
    rel_pose within 1e-3 m / 1e-4 rad, the carry's validity equal and xy
    within 1e-4 m."""
    assert bool(got_res.ok[b]) == bool(want_res.ok[b]), tag
    assert int(got_res.num_inliers[b]) == int(want_res.num_inliers[b]), tag
    g, w = np_(got_res.rel_pose[b]), np_(want_res.rel_pose[b])
    np.testing.assert_allclose(g[:2], w[:2], rtol=0, atol=1e-3, err_msg=tag)
    assert abs(float(g[2]) - float(w[2])) < 1e-4, tag
    np.testing.assert_array_equal(np_(got_carry.valid[b]), np_(want_carry.valid[b]), err_msg=tag)
    np.testing.assert_allclose(np_(got_carry.xy[b]), np_(want_carry.xy[b]), rtol=0, atol=1e-4,
                               err_msg=tag)


@pytest.mark.parametrize("motion,packed", [(True, False), (False, False), (True, True)],
                         ids=["motion_comp", "no_motion_comp", "packed"])
def test_batched_step_matches_jax(streams, motion, packed):
    """The port's batched step against the JAX package's, stream by stream,
    over two steps with the twist carried as a caller carries it (the
    result when ok, else the previous twist)."""
    cfg = dataclasses.replace(CFG, features=dataclasses.replace(
        CFG.features, motion_compensation=motion))
    scans = _wire(streams, packed)
    az = todo.default_azimuths(cfg)
    jextract = jax.jit(jax.vmap(functools.partial(jodo.extract_scan_features, cfg=cfg),
                                in_axes=(0, None)))
    jstep = jodo.make_batched_odometry_step(cfg)
    tstep = todo.make_batched_odometry_step(cfg, device="cpu")
    jprev = jextract(jnp.asarray(scans[:, 0]), jnp.asarray(az))
    tprev = todo.extract_scan_features_batched(t(scans[:, 0]), t(az), cfg, packed=packed)
    for name in SCAN_FIELDS:
        assert getattr(tprev, name).shape[0] == B, name
    np.testing.assert_array_equal(np_(tprev.valid), np.asarray(jprev.valid))
    jtw = jnp.zeros((B, 3), jnp.float32)
    ttw = torch.zeros(B, 3)
    for i in range(1, STEPS + 1):
        jcurr, jres, jout = jstep(jnp.asarray(scans[:, i]), jnp.asarray(az), jprev, jtw)
        tcurr, tres, tout = tstep(t(scans[:, i]), t(az), tprev, ttw, packed=packed)
        for b in range(B):
            tag = f"step {i}, stream {b}"
            _assert_stream_close(tres, jres, tcurr, jcurr, b, tag)
            np.testing.assert_allclose(np_(tout.xy[b]), np.asarray(jout.xy[b]), rtol=0,
                                       atol=1e-3, err_msg=tag)
        assert bool(tres.ok[BLANK[0]]) is (i != BLANK[1])
        carried = ttw[BLANK[0]].clone()
        jtw = jnp.where(jres.ok[:, None], jres.rel_pose, jtw)
        ttw = torch.where(tres.ok[:, None], tres.rel_pose, ttw)
        if i == BLANK[1]:
            assert torch.equal(ttw[BLANK[0]], carried) and bool(carried.abs().sum() > 0)
        jprev, tprev = jcurr, tcurr


@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
def test_batched_step_matches_one_stream_step(streams, packed):
    """The batched step against the port's ``odometry_step`` on each stream
    alone, from the same carry, with invalid rays in one stream: the same
    ok and inlier count, rel_pose within 1e-3 m / 1e-4 rad, the carry and
    the de-skewed positions within 1e-4 m."""
    scans = _wire(streams, packed)
    az = t(todo.default_azimuths(CFG))
    ray_valids = np.ones((B, CFG.radar.num_azimuths), bool)
    ray_valids[2, 100:180] = False
    rv = t(ray_valids)
    step = todo.make_batched_odometry_step(CFG, device="cpu")
    prev = todo.extract_scan_features_batched(t(scans[:, 0]), az, CFG, rv, packed)
    for b in range(B):
        one = todo.extract_scan_features(t(scans[b, 0]), az, CFG, rv[b], packed)
        for name in SCAN_FIELDS:
            assert torch.equal(getattr(prev, name)[b], getattr(one, name)), (b, name)
    twists = t(np.asarray([[1.0, 0.1, 0.02], [0.5, 0.0, -0.01], [0.0, 0.0, 0.0]], np.float32))
    for i in range(1, STEPS + 1):
        curr, res, out = step(t(scans[:, i]), az, prev, twists, rv, packed)
        ones = [todo.odometry_step(t(scans[b, i]), az, todo.ScanFeatures(*[x[b] for x in prev]),
                                   twists[b], CFG, rv[b], packed) for b in range(B)]
        want_carry, want_res, want_out = (
            type(part[0])(*[torch.stack(f) for f in zip(*part)]) for part in zip(*ones))
        for b in range(B):
            tag = f"step {i}, stream {b}"
            _assert_stream_close(res, want_res, curr, want_carry, b, tag)
            np.testing.assert_allclose(np_(out.xy[b]), np_(want_out.xy[b]), rtol=0, atol=1e-4,
                                       err_msg=tag)
        assert bool(res.ok[BLANK[0]]) is (i != BLANK[1])
        twists = torch.where(res.ok[:, None], res.rel_pose, twists)
        prev = curr


def _matchset(rng, M=128, n_out=40, dup=12):
    """A synthetic match set (b = R a + t + noise, outliers, padded slots),
    with ``dup`` correspondences repeated, whose scores then (nearly) tie."""
    a = rng.uniform(-60, 60, (M, 2))
    th = rng.uniform(-0.2, 0.2)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    b = a @ R.T + rng.uniform(-2, 2, 2) + rng.normal(0, 0.05, (M, 2))
    b[:n_out] = rng.uniform(-60, 60, (n_out, 2))
    a[M - dup:], b[M - dup:] = a[M - 2 * dup:M - dup], b[M - 2 * dup:M - dup]
    valid = np.ones(M, bool)
    valid[-3:] = False
    a[~valid], b[~valid] = 0.0, 0.0
    f32 = np.float32
    return dict(src_xy=a.astype(f32), dst_xy=b.astype(f32),
                src_range=np.linalg.norm(a, axis=-1).astype(f32),
                dst_range=np.linalg.norm(b, axis=-1).astype(f32),
                weight=np.ones(M, f32), valid=valid, src_frac=rng.random(M).astype(f32),
                dst_frac=rng.random(M).astype(f32))


def test_vmapped_spectral_scores_are_batch_invariant():
    """``spectral_inlier_scores`` under ``torch.func.vmap`` over five match
    sets (one of them twice) equals the one-stream scores bit for bit: the
    stable top-k of the scores picks the TIMs, so a last-bit difference
    between near-equal scores would change the registration."""
    rng = np.random.default_rng(3)
    sets = [_matchset(rng, n_out=n) for n in (0, 20, 40, 60, 100)]
    sets.append(sets[2])
    batch = tfeat.MatchSet(**{k: t(np.stack([s[k] for s in sets])) for k in sets[0]})
    cfg = CFG.registration
    got = torch.func.vmap(functools.partial(treg.spectral_inlier_scores, cfg=cfg))(batch)
    for i, s in enumerate(sets):
        one = treg.spectral_inlier_scores(tfeat.MatchSet(**{k: t(v) for k, v in s.items()}), cfg)
        assert torch.equal(got[i], one), i
        assert bool((one[-3:] == 0).all()) and float(one.max()) > 0


@pytest.mark.parametrize("n", [1, 6, 33])
def test_batched_descriptors_do_not_depend_on_batch_size(n):
    """``_descriptors_batched`` runs calls of one shape (32 streams at 64
    features, the last call padded with featureless streams): each of the
    first ``n`` streams gets the bits it gets in a batch of 40 (two calls),
    within 1e-6 of ``constellation_descriptors`` on the stream alone; a
    padded stream is never returned."""
    rng = np.random.default_rng(8)
    k = 64
    xy = t(rng.uniform(-40, 40, (40, k, 2)).astype(np.float32))
    power = t(rng.uniform(0, 1, (40, k)).astype(np.float32))
    valid = t(rng.random((40, k)) < 0.8)
    whole = todo._descriptors_batched(xy, power, valid, CFG)
    got = todo._descriptors_batched(xy[:n], power[:n], valid[:n], CFG)
    assert got.shape == (n, k, CFG.features.desc_grid ** 2)
    assert torch.equal(got, whole[:n])
    for b in range(n):
        one = tfeat.constellation_descriptors(xy[b], power[b], valid[b], CFG.features)
        np.testing.assert_allclose(np_(got[b]), np_(one), rtol=0, atol=1e-6)


def _tied_scores(rng, n_scans=4, na=12, nb=40):
    """(n_scans, na, nb) score maps with coarse values (many ties) and -inf
    elsewhere; scan 1 has 5 finite entries, scan 2 none."""
    vals = rng.integers(1, 6, (n_scans, na, nb)).astype(np.float32) / 5.0
    keep = rng.random((n_scans, na, nb)) < 0.3
    keep[1] = False
    keep[1].flat[rng.choice(na * nb, 5, replace=False)] = True
    keep[2] = False
    return np.where(keep, vals, -np.inf).astype(np.float32)


def test_batched_topk_equals_one_scan_topk():
    """The batched top-k equals ``_finalize_topk_scores`` scan by scan (and
    JAX's), ties lowest flat index first, the tail of a scan with fewer
    than k finite entries (and of one with none) padded alike."""
    scores = _tied_scores(np.random.default_rng(4))
    k = 60
    got = tcen._finalize_topk_scores_batched(t(scores), k)
    for b in range(scores.shape[0]):
        one = tcen._finalize_topk_scores(t(scores[b]), k)
        want = jcen._finalize_topk_scores(jnp.asarray(scores[b]), k)
        for name in FIELDS:
            assert torch.equal(getattr(got, name)[b], getattr(one, name)), (b, name)
            np.testing.assert_array_equal(np_(getattr(got, name)[b]),
                                          np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.valid[1].sum()) == 5 and not bool(got.valid[2].any())


@pytest.mark.parametrize("detector", ["cen2019", "cen2018"])
def test_batched_scores_and_features_equal_one_scan(streams, detector):
    """``cen2019_scores_batched`` is the twin scan by scan, and the batched
    extraction's features are the one-scan extraction's, exactly (the
    blank scan gives no feature)."""
    fcfg = dataclasses.replace(CFG.features, detector=detector)
    x = t(streams[:, 2])
    if detector == "cen2019":
        maps = tcen.cen2019_scores_batched(x, fcfg, CFG.radar)
        for b in range(B):
            assert torch.equal(maps[b], tcen.cen2019_scores(x[b], fcfg, CFG.radar)), b
    got = tcen.extract_features_batched(x, fcfg, CFG.radar)
    for b in range(B):
        one = tcen.extract_features(x[b], fcfg, CFG.radar)
        for name in FIELDS:
            assert torch.equal(getattr(got, name)[b], getattr(one, name)), (b, name)
    assert not bool(got.valid[BLANK[0]].any()) and bool(got.valid[0].any())


def test_batched_wrapper_refuses_what_the_kernel_does_not_take(streams):
    """K1 x B takes only a contiguous float32 (B, NA, NBp) CUDA tensor with
    B >= 1: it raises, and never hands a CPU tensor to the plain version."""
    x = t(np.ascontiguousarray(streams[:, 1]))
    before = cen_peaks.batched_launch_count
    with pytest.raises(ValueError, match="CUDA tensor"):
        cen_peaks.cen2019_scores_batched_cuda(x, CFG.features, CFG.radar)
    with pytest.raises(ValueError, match="contiguous"):
        cen_peaks.cen2019_scores_batched_cuda(x.transpose(1, 2), CFG.features, CFG.radar)
    with pytest.raises(ValueError, match="contiguous"):
        cen_peaks.cen2019_scores_batched_cuda(x[0], CFG.features, CFG.radar)
    with pytest.raises(TypeError, match="float32"):
        cen_peaks.cen2019_scores_batched_cuda(x.double(), CFG.features, CFG.radar)
    with pytest.raises(ValueError, match="B = 0"):
        cen_peaks.cen2019_scores_batched_cuda(x[:0], CFG.features, CFG.radar)
    assert cen_peaks.batched_launch_count == before


def test_batched_step_runs_on_the_card_by_default(monkeypatch, streams):
    """Without a card the default step raises; a step on the CPU refuses an
    input on another device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        todo.make_batched_odometry_step(CFG)
    step = todo.make_batched_odometry_step(CFG, device="cpu")
    az = t(todo.default_azimuths(CFG))
    prev = todo.extract_scan_features_batched(t(streams[:, 0]), az, CFG)
    with pytest.raises(ValueError, match="twists is on meta"):
        step(t(streams[:, 1]), az, prev, torch.zeros(B, 3, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("n_scans", [1, 3, 17])
def test_batched_kernel_matches_twin_on_cuda(streams, cuda_device, n_scans):
    """K1 x B against the plain version on the card, exactly (the same peak
    positions and values), one launch per call; B = 1 is K1 bit for bit,
    and each scan of a batch is K1 of that scan bit for bit."""
    idx = np.arange(n_scans) % B
    x = t(streams[idx, np.arange(n_scans) % (STEPS + 1)], cuda_device).contiguous()
    before = cen_peaks.batched_launch_count
    got = cen_peaks.cen2019_scores_batched_cuda(x, CFG.features, CFG.radar)
    torch.cuda.synchronize()
    assert cen_peaks.batched_launch_count == before + 1
    want = tcen.cen2019_scores_batched(x, CFG.features, CFG.radar)
    g, w = np_(got), np_(want)
    assert np.isfinite(w).sum() > 0
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    np.testing.assert_array_equal(g[np.isfinite(w)], w[np.isfinite(w)])
    for b in range(n_scans):
        assert torch.equal(got[b], cen_peaks.cen2019_scores_cuda(x[b].contiguous(), CFG.features,
                                                                 CFG.radar)), b


@pytest.mark.cuda
def test_batched_kernel_row_past_the_limit_raises_on_cuda(cuda_device):
    """A batch whose rows are one bin past the card's K1 limit raises, as K1
    does, and launches nothing."""
    rcfg = dataclasses.replace(CFG.radar, num_range_bins=7035)
    before = cen_peaks.batched_launch_count
    with pytest.raises(ValueError, match="7034 bins"):   # an H100's limit at 400 rows
        cen_peaks.cen2019_scores_batched_cuda(torch.zeros((2, 400, 7035), device=cuda_device),
                                              CFG.features, rcfg)
    assert cen_peaks.batched_launch_count == before


@pytest.mark.cuda
def test_batched_step_is_batch_size_invariant_on_cuda(cuda_device):
    """The default config at full size, B = 64 streams in one step against
    the same streams in two steps of B = 32 (as two mesh ranks run them):
    ``rel_pose``, ``ok``, the de-skewed xy and every other leaf of the seed
    and the step bit-equal (``torch.equal``).  CUDA chose the order of some
    batched sums by the batch size (the weighted median's prefix sum, the
    Gauss-Newton polish's einsum, and the descriptor matmul past 65,535
    products)."""
    from navtech_radar_slam_torch.config import SlamConfig
    from navtech_radar_slam_torch.data import RadarSimulator as PortSimulator

    cfg = SlamConfig()
    sim = PortSimulator(cfg.radar)
    gt = sim.circuit_trajectory(17)
    scans = np.stack([sim.render(gt[i], noise_seed=i) for i in range(17)])
    idx = np.arange(64) % 16
    prev, curr = (t(scans[idx + i], cuda_device) for i in (0, 1))
    az = t(todo.default_azimuths(cfg), cuda_device)
    step = todo.make_batched_odometry_step(cfg, device=cuda_device)

    def run(sl):
        seed = todo.extract_scan_features_batched(prev[sl], az, cfg)
        out = step(curr[sl], az, seed, torch.zeros((prev[sl].shape[0], 3), device=cuda_device))
        return [seed] + list(out)

    whole = run(slice(0, 64))
    halves = [run(slice(0, 32)), run(slice(32, 64))]
    torch.cuda.synchronize()
    for part, (w, a, b) in enumerate(zip(whole, *halves)):
        for name, x, y, z in zip(w._fields, w, a, b):
            if x is not None:
                assert torch.equal(x, torch.cat([y, z])), (part, name)
    assert whole[3].xy.shape == (64, cfg.features.max_features, 2)
