"""Parity of the port's odometry front-end with the JAX package: scan
decoding and extraction, one step from a shared carry, a short run of
``RadarOdometry``, the streamed sequence, and the entry point."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.data.packing import pack4
from navtech_radar_slam_tpu.models import odometry as jodo
from navtech_radar_slam_tpu.utils import geometry as jgeo
from navtech_radar_slam_torch import entry, state
from navtech_radar_slam_torch.models import odometry as todo
from navtech_radar_slam_torch.utils import geometry as tgeo
from torch_parity_util import (  # noqa: F401 (one_torch_thread: fixture)
    SCAN_FIELDS, jax_odometry_carry, np_, one_torch_thread, peak_set, sim_scans, t, tiny_cfg,
    tuple_np,
)

CFG = tiny_cfg()


@pytest.fixture(scope="module")
def scans():
    return sim_scans(CFG, 6, seed0=200)


def _wire(scan, kind):
    u8 = (np.clip(scan, 0, 1) * 255).astype(np.uint8)
    return {"float": scan, "uint8": u8, "packed": pack4(u8)}[kind]


@pytest.mark.parametrize("kind,with_ray_valid", [
    ("float", False), ("uint8", False), ("packed", False), ("uint8", True),
    ("packed", True),
])
def test_extract_scan_features_matches_jax(scans, kind, with_ray_valid):
    """Float, uint8 and packed 4-bit input, with and without invalid rays:
    the decode is bit-identical, so the features are the same points;
    descriptors agree to 1e-5 (contraction order)."""
    power = _wire(scans[1][0], kind)
    az = todo.default_azimuths(CFG)
    rv = None
    if with_ray_valid:
        rv = np.ones(CFG.radar.num_azimuths, bool)
        rv[50:90] = False
    want = tuple_np(jax.jit(lambda p, a, r: jodo.extract_scan_features(p, a, CFG, r))(
        jnp.asarray(power), jnp.asarray(az), None if rv is None else jnp.asarray(rv)))
    got = tuple_np(todo.extract_scan_features(
        t(power), t(az), CFG, None if rv is None else t(rv), packed=kind == "packed"))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() > 100
    if with_ray_valid:
        rows = np.round(got["ray_frac"] * CFG.radar.num_azimuths - 0.5).astype(int)
        assert not ((rows >= 50) & (rows < 90) & got["valid"]).any()
    for name in ("xy", "ranges"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["power"], want["power"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["ray_frac"], want["ray_frac"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(got["desc"], want["desc"], rtol=0, atol=1e-5)


def test_decode_is_bit_identical_to_jax(scans):
    u8 = _wire(scans[1][0], "uint8")
    packed = pack4(u8)
    na, nbp = CFG.radar.num_azimuths, CFG.radar.padded_range_bins
    # the JAX code decodes inside extract_scan_features; reproduce its two
    # expressions on the same arrays
    want_u8 = np.asarray(jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0))
    p = jnp.asarray(packed)
    q = jnp.stack([(p >> 4).astype(jnp.float32), (p & 0xF).astype(jnp.float32)],
                  axis=-1).reshape(na, nbp)
    want_p = np.asarray(jnp.square(q * (1.0 / 15.0)))
    np.testing.assert_array_equal(np_(todo.decode_power(t(u8))), want_u8)
    np.testing.assert_array_equal(np_(todo.decode_power(t(packed), packed=True)), want_p)
    with pytest.raises(TypeError):
        todo.decode_power(t(u8).to(torch.int16))


def test_odometry_step_from_jax_carry(scans):
    """One step from the JAX RadarOdometry's carry moved across with
    state.py: rel_pose within 1e-3 m / 1e-4 rad, the same ok."""
    gt, sc = scans
    jo = jodo.RadarOdometry(CFG)
    jo.process(sc[0])
    jo.process(sc[1])
    carry = jax_odometry_carry(jo)

    to = todo.RadarOdometry(CFG, device="cpu")
    to.load_state(carry)
    back = to.to_numpy()
    for k in SCAN_FIELDS:
        np.testing.assert_array_equal(back["prev"][k], carry["prev"][k])
    np.testing.assert_array_equal(back["last_rel"], carry["last_rel"])

    jo.process(sc[2])
    to.process(sc[2])
    want = np.asarray(jo.last_result.rel_pose)
    got = np_(to.last_result.rel_pose)
    assert bool(to.last_ok) == bool(jo.last_ok) is True
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-3)
    assert abs(got[2] - want[2]) < 1e-4
    np.testing.assert_allclose(to.pose, jo.pose, rtol=0, atol=1e-3)


def test_radar_odometry_run_matches_jax(scans):
    """Five scans through both accumulators: per-step increments within
    1e-3 m / 1e-4 rad, the same ok flags, poses within 2e-3 m."""
    gt, sc = scans
    jo, to = jodo.RadarOdometry(CFG), todo.RadarOdometry(CFG, device="cpu")
    for s in sc[:5]:
        pj, _ = jo.process(s)
        pt, _ = to.process(s)
        assert to.last_ok == jo.last_ok
        np.testing.assert_allclose(to.last_applied_rel[:2], jo.last_applied_rel[:2],
                                   rtol=0, atol=1e-3)
        assert abs(to.last_applied_rel[2] - jo.last_applied_rel[2]) < 1e-4
        np.testing.assert_allclose(pt, pj, rtol=0, atol=2e-3)
    assert to.num_scans == jo.num_scans == 5
    assert to.num_failures == jo.num_failures == 0


@pytest.mark.parametrize("doppler", [False, True])
def test_deskew_and_pair_registration_match_jax(scans, doppler):
    """De-skewed feature views (motion, and Doppler when on) with rebuilt
    descriptors, and the pair registration of two carries, against JAX."""
    cfg = dataclasses.replace(CFG, features=dataclasses.replace(
        CFG.features, doppler_compensation=doppler))
    gt, sc = scans
    az = todo.default_azimuths(cfg)
    twist = np.asarray([1.2, -0.1, 0.03], np.float32)
    jextract = jax.jit(lambda p, a: jodo.extract_scan_features(p, a, cfg))
    jf = [jextract(jnp.asarray(s), jnp.asarray(az)) for s in sc[:2]]
    tf = [todo.extract_scan_features(t(s), t(az), cfg) for s in sc[:2]]

    want = tuple_np(jax.jit(lambda f, w: jodo.deskew_features(f, w, cfg))(
        jf[1], jnp.asarray(twist)))
    got = tuple_np(todo.deskew_features(tf[1], t(twist), cfg))
    np.testing.assert_allclose(got["xy"], want["xy"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["ranges"], want["ranges"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["desc"], want["desc"], rtol=0, atol=1e-5)

    jr = jax.jit(lambda a, b: jodo.register_feature_pair(a, b, cfg))(*jf)
    tr = todo.register_feature_pair(*tf, cfg)
    assert bool(tr.ok) == bool(jr.ok) is True
    np.testing.assert_allclose(np_(tr.rel_pose)[:2], np.asarray(jr.rel_pose)[:2],
                               rtol=0, atol=1e-3)
    assert abs(float(tr.rel_pose[2]) - float(jr.rel_pose[2])) < 1e-4


def test_make_odometry_step_matches_jax(scans):
    """The bound step against JAX's ``make_odometry_step`` on one pair from
    the same carry (the port's extraction of scan 0, moved to JAX field by
    field), the ground-truth increment as the twist: the same ok and
    points, rel_pose within 1e-3 m / 1e-4 rad; an input on another device
    raises."""
    gt, sc = scans
    az = todo.default_azimuths(CFG)
    prev = todo.extract_scan_features(t(sc[0]), t(az), CFG)
    jprev = jodo.ScanFeatures(**{k: jnp.asarray(np_(getattr(prev, k))) for k in SCAN_FIELDS})
    twist = tgeo.se2_between_np(gt[0], gt[1]).astype(np.float32)
    jcurr, jres, jout = jodo.make_odometry_step(CFG)(jnp.asarray(sc[1]), jnp.asarray(az),
                                                     jprev, jnp.asarray(twist))
    step = todo.make_odometry_step(CFG, device="cpu")
    curr, res, out = step(t(sc[1]), t(az), prev, t(twist))
    assert bool(res.ok) == bool(jres.ok) is True
    got, want = np_(res.rel_pose), np.asarray(jres.rel_pose)
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-3)
    assert abs(got[2] - want[2]) < 1e-4
    np.testing.assert_array_equal(np_(curr.valid), np.asarray(jcurr.valid))
    np.testing.assert_allclose(np_(curr.xy), np.asarray(jcurr.xy), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np_(out.xy), np.asarray(jout.xy), rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="twist is on meta"):
        step(t(sc[1]), t(az), prev, torch.zeros(3, device="meta"))


def test_odometry_sequence_matches_stepwise(scans):
    """The streamed chunk loop gives the per-scan increments of the host
    accumulator (same arithmetic, so 1e-6)."""
    gt, sc = scans
    to = todo.RadarOdometry(CFG, device="cpu")
    rels_step = []
    for s in sc:
        to.process(s)
        rels_step.append(to.last_applied_rel.copy())
    az = t(todo.default_azimuths(CFG))
    prev = todo.extract_scan_features(t(sc[0]), az, CFG)
    seq = todo.make_odometry_sequence(CFG, return_features=True)
    out = seq(torch.stack([t(s) for s in sc[1:]]), az, prev, torch.zeros(3),
              torch.tensor(0))
    _, _, coast, rels, oks, n_inl, xys, valids = out
    assert bool(oks.all()) and int(coast) == 0
    np.testing.assert_allclose(np_(rels), np.asarray(rels_step[1:]), rtol=0, atol=1e-6)
    assert xys.shape == (len(sc) - 1, CFG.features.max_features, 2)
    assert valids.dtype == torch.bool and (n_inl >= CFG.registration.min_inliers).all()


def test_sequence_coasts_like_the_host():
    """Failed registrations: the increment coasts on the last one and is
    zeroed after max_coast_frames, as RadarOdometry.process does."""
    cfg = tiny_cfg()
    rng = np.random.default_rng(0)
    noise = [rng.random((cfg.radar.num_azimuths, cfg.radar.padded_range_bins),
                        dtype=np.float32) * 0.01 for _ in range(8)]
    az = t(todo.default_azimuths(cfg))
    prev = todo.extract_scan_features(t(noise[0]), az, cfg)
    seq = todo.make_odometry_sequence(cfg)
    twist0 = torch.tensor([0.5, 0.0, 0.01])
    _, twist, coast, rels, oks, _ = seq(torch.stack([t(n) for n in noise[1:]]), az,
                                        prev, twist0, torch.tensor(0))
    n_fail = int((~oks).sum())
    assert n_fail == 7, "pure noise should not register"
    limit = cfg.registration.max_coast_frames
    np.testing.assert_allclose(np_(rels[:limit]), np.tile(np_(twist0), (limit, 1)))
    assert float(rels[limit:].abs().sum()) == 0.0 and int(coast) == 7


def test_entry_runs_on_cpu():
    fn, args = entry.entry("cpu")
    rel, n_inl, xy = fn(*args)
    assert rel.shape == (3,) and bool(torch.isfinite(rel).all())
    assert xy.shape == (entry.tiny_cfg().features.max_features, 2)
    assert int(n_inl) >= 0


def test_se2_numpy_helpers_match_jax():
    rng = np.random.default_rng(6)
    for _ in range(5):
        a = rng.uniform([-50, -50, -3], [50, 50, 3])
        b = rng.uniform([-50, -50, -3], [50, 50, 3])
        np.testing.assert_array_equal(tgeo.se2_mul_np(a, b), jgeo.se2_mul_np(a, b))
        np.testing.assert_array_equal(tgeo.se2_between_np(a, b), jgeo.se2_between_np(a, b))
        np.testing.assert_array_equal(tgeo.se2_to_se3_np(a), jgeo.se2_to_se3_np(a))


def test_state_round_trip(scans):
    gt, sc = scans
    to = todo.RadarOdometry(CFG, device="cpu")
    to.process(sc[0])
    to.process(sc[1])
    d = to.to_numpy()
    feats = state.scan_features_from_numpy(d["prev"], "cpu")
    assert feats.valid.dtype == torch.bool and feats.xy.dtype == torch.float32
    for k in SCAN_FIELDS:
        np.testing.assert_array_equal(state.to_numpy(feats)[k], d["prev"][k])
    fresh = todo.RadarOdometry(CFG, device="cpu")
    fresh.load_state(d)
    p1, _ = to.process(sc[2])
    p2, _ = fresh.process(sc[2])
    np.testing.assert_array_equal(p1, p2)
    assert peak_set(to.prev.xy[:, 0], to.prev.xy[:, 1], to.prev.valid) == \
        peak_set(fresh.prev.xy[:, 0], fresh.prev.xy[:, 1], fresh.prev.valid)
