"""Parity of the port's cen2019 / cen2018 detector with the JAX package.

The twin ``cen2019_scores`` is held against the TPU kernel in interpret
mode (as tests/test_pallas_kernels.py runs it); the feature sets against
the JAX XLA path; the CUDA kernel against the twin on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.config import SlamConfig
from navtech_radar_slam_tpu.data import RadarSimulator
from navtech_radar_slam_tpu.data.packing import pack4, unpack4_reference
from navtech_radar_slam_tpu.ops import cen2019 as jcen
from navtech_radar_slam_tpu.ops.pallas.cen_peaks import cen2019_scores_pallas
from navtech_radar_slam_torch.models.odometry import decode_power
from navtech_radar_slam_torch.ops import cen2019 as tcen
from navtech_radar_slam_torch.ops.kernels import cen_peaks
from torch_parity_util import (  # noqa: F401 (one_torch_thread: fixture)
    assert_score_maps_close, np_, one_torch_thread, peak_set, t,
)

CFG = SlamConfig()


@pytest.fixture(scope="module")
def scan():
    sim = RadarSimulator(CFG.radar)
    return sim.render(np.asarray([5.0, -3.0, 0.7]), noise_seed=3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def test_run_peaks_basic():
    power = torch.tensor([[0.1, 0.5, 0.9, 0.4, 0.0, 0.3, 0.7, 0.2]])
    mask = torch.tensor([[False, True, True, True, False, True, True, False]])
    peaks = tcen.run_peaks(power, mask)
    assert peaks[0].tolist() == [False, False, True, False, False, False, True, False]


def test_run_peaks_ties_take_first():
    peaks = tcen.run_peaks(torch.full((1, 3), 0.5), torch.ones((1, 3), dtype=torch.bool))
    assert int(peaks.sum()) == 1 and bool(peaks[0, 0])


def test_run_peaks_empty_mask():
    peaks = tcen.run_peaks(torch.zeros((4, 16)), torch.zeros((4, 16), dtype=torch.bool))
    assert int(peaks.sum()) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_run_peaks_random_matches_jax(seed):
    """Random masks and coarsely quantised powers (many in-run ties): the
    peak maps are exactly equal."""
    rng = np.random.default_rng(seed)
    power = (rng.integers(0, 6, (8, 257)) / 5.0).astype(np.float32)
    mask = rng.random((8, 257)) > 0.3
    want = np.asarray(jax.jit(jcen.run_peaks)(jnp.asarray(power), jnp.asarray(mask)))
    got = np_(tcen.run_peaks(t(power), t(mask)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_segmented_running_max_matches_jax(reverse):
    rng = np.random.default_rng(5)
    v = rng.standard_normal((4, 300)).astype(np.float32)
    reset = rng.random((4, 300)) > 0.8
    scan_max = jax.jit(jcen._segmented_running_max, static_argnames="reverse")
    want = np.asarray(scan_max(jnp.asarray(v), jnp.asarray(reset), reverse=reverse))
    got = np_(tcen._segmented_running_max(t(v), t(reset), reverse=reverse))
    np.testing.assert_array_equal(got, want)


def test_cen2019_scores_match_pallas_interpret(scan):
    want = np.asarray(cen2019_scores_pallas(jnp.asarray(scan), CFG.features, CFG.radar,
                                            interpret=True))
    got = np_(tcen.cen2019_scores(t(scan), CFG.features, CFG.radar))
    assert_score_maps_close(got, want)


def _assert_features_close(got, want, frac=0.01, atol=1e-5):
    """Feature sets agree: same count, positions differ in at most ``frac``
    (borderline mask flips from the sum order), powers to ``atol``."""
    g_set = peak_set(got.azimuth_idx, got.range_bin, got.valid)
    w_set = peak_set(want.azimuth_idx, want.range_bin, want.valid)
    assert len(g_set) == len(w_set)
    sym = g_set.symmetric_difference(w_set)
    assert len(sym) <= frac * len(w_set), f"{len(sym)} differing peaks"
    gv, wv = np_(got.valid), np_(want.valid)
    np.testing.assert_allclose(np.sort(np_(got.power)[gv]), np.sort(np_(want.power)[wv]),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("detector", ["cen2019", "cen2018"])
def test_features_match_jax(scan, detector):
    fcfg = dataclasses.replace(CFG.features, detector=detector)
    want = jax.jit(lambda p: jcen.extract_features(p, fcfg, CFG.radar))(jnp.asarray(scan))
    got = tcen.extract_features(t(scan), fcfg, CFG.radar)
    _assert_features_close(got, want)


def test_features_to_xy_matches_jax(scan):
    rng = np.random.default_rng(2)
    na = CFG.radar.num_azimuths
    az = np.sort(rng.uniform(0, 2 * np.pi, na)).astype(np.float32)
    want_f = jax.jit(lambda p: jcen.cen2019_features(p, CFG.features, CFG.radar))(
        jnp.asarray(scan))
    got_f = tcen.cen2019_features(t(scan), CFG.features, CFG.radar)
    want = np.asarray(jcen.features_to_xy(want_f, jnp.asarray(az), CFG.radar))
    got = np_(tcen.features_to_xy(got_f, t(az), CFG.radar))
    # the feature sets are identical here; xy agree to 1e-4 m (sin/cos of
    # two libraries at ranges up to 200 m)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_topk_tie_order_matches_jax():
    """A tie-heavy 4-bit scan at a budget that cuts through tied scores: the
    kept features and their order are those of ``jax.lax.top_k`` (equal
    values lowest index first).  Each azimuth is repeated four times, so
    inner rows of a block have identical peaks with identical smoothed
    power."""
    sim = RadarSimulator(CFG.radar)
    u8 = (np.clip(sim.render(np.asarray([1.0, 2.0, 0.3]), noise_seed=11), 0, 1)
          * 255).astype(np.uint8)
    u8 = np.repeat(u8[::4], 4, axis=0)
    power = unpack4_reference(pack4(u8))
    scores = np_(tcen.cen2019_scores(t(power), CFG.features, CFG.radar))
    finite = np.sort(scores[np.isfinite(scores)])[::-1]
    # the first budget past 100 whose last kept score ties the next one
    ties = np.nonzero(finite[100:-1] == finite[101:])[0]
    assert len(ties) > 0, "the scan has no tied scores"
    k = 101 + int(ties[0])
    want = jcen._finalize_topk_scores(jnp.asarray(scores), k)
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(scores.reshape(-1)), k)[1])
    got = tcen._finalize_topk_scores(t(scores), k)
    nb = scores.shape[1]
    np.testing.assert_array_equal(np_(got.azimuth_idx) * nb + np_(got.range_bin), want_idx)
    for name in ("azimuth_idx", "range_bin", "power", "valid"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_finalize_topk_pads_like_jax():
    """Fewer finite scores than k: the tail is az = rb = 0, power 0, invalid."""
    scores = np.full((4, 8), -np.inf, np.float32)
    scores[1, 3], scores[2, 5], scores[0, 7] = 0.5, 0.7, 0.5
    want = jcen._finalize_topk_scores(jnp.asarray(scores), 6)
    got = tcen._finalize_topk_scores(t(scores), 6)
    for name in ("azimuth_idx", "range_bin", "power", "valid"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_kernel_wrapper_takes_only_cuda_tensors(scan):
    """The kernel wrapper launches or raises: a CPU tensor is refused, not
    sent to the plain version."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        cen_peaks.cen2019_scores_cuda(t(scan), CFG.features, CFG.radar)


@pytest.mark.cuda
def test_cen2019_kernel_matches_twin_on_cuda(scan, cuda_device):
    """K1 against its twin on the card, float and 4-bit input; each kernel
    call adds one launch."""
    u8 = (np.clip(scan, 0, 1) * 255).astype(np.uint8)
    for power in (scan, unpack4_reference(pack4(u8))):
        x = t(power, cuda_device)
        before = cen_peaks.launch_count
        got = cen_peaks.cen2019_scores_cuda(x, CFG.features, CFG.radar)
        torch.cuda.synchronize()
        assert cen_peaks.launch_count == before + 1
        want = tcen.cen2019_scores(x, CFG.features, CFG.radar)
        assert_score_maps_close(np_(got), np_(want))
        k = CFG.features.max_features
        g = tcen._finalize_topk_scores(got, k)
        w = tcen._finalize_topk_scores(want, k)
        g_set = peak_set(g.azimuth_idx, g.range_bin, g.valid)
        w_set = peak_set(w.azimuth_idx, w.range_bin, w.valid)
        assert len(g_set ^ w_set) <= 0.01 * len(w_set)


# An H100 SXM's limits, as cen2019_device_limits reads them: SMs, shared
# memory per SM, reserved per block, opt-in per block, threads per SM.
H100 = (132, 233472, 1024, 232448, 2048)


def test_cen2019_launch_geometry():
    """The host side of K1's one cooperative launch at the main path's
    shapes: a block per row with 28 KB of shared memory, four blocks on an
    SM for 400 rows, and rows up to 7,034 bins there (the four-launch design
    took 6,144)."""
    ntaps = tcen.smoothing_taps(CFG.features).numel()
    assert ntaps == cen_peaks.FIXED_TAPS == 13
    assert cen_peaks.smem_bytes(3456) == 8 * 3456 + 4 * 12 + 4 * 256
    per_sm = -(-400 // H100[0])
    assert per_sm == 4
    assert per_sm * (cen_peaks.smem_bytes(3456) + H100[2]) <= H100[1]
    bins = cen_peaks.max_row_bins(400, ntaps, *H100)
    assert bins == 7034 and bins >= CFG.radar.padded_range_bins
    assert per_sm * (cen_peaks.smem_bytes(bins) + H100[2]) <= H100[1]
    assert per_sm * (cen_peaks.smem_bytes(bins + 1) + H100[2]) > H100[1]
    # wider smoothing pads more zeros
    assert cen_peaks.max_row_bins(400, 25, *H100) == 7034 - 6
    # one block per SM: the opt-in limit of one block sets the row
    assert cen_peaks.max_row_bins(132, ntaps, *H100) == (232448 - 1024 - 48) // 8
    # eight blocks of 256 threads fill an SM's 2048 threads; nine do not fit
    assert cen_peaks.max_row_bins(8 * 132, ntaps, *H100) > 0
    assert cen_peaks.max_row_bins(8 * 132 + 1, ntaps, *H100) == 0


def _assert_kernel_equals_twin(x, rcfg=CFG.radar, fcfg=CFG.features):
    got = cen_peaks.cen2019_scores_cuda(x, fcfg, rcfg)
    want = tcen.cen2019_scores(x, fcfg, rcfg)
    torch.cuda.synchronize()
    g, w = np_(got), np_(want)
    assert np.isfinite(w).sum() > 0
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    np.testing.assert_array_equal(g[np.isfinite(w)], w[np.isfinite(w)])


@pytest.mark.cuda
def test_cen2019_kernel_row_above_old_limit_on_cuda(scan, cuda_device):
    """K1 on 400 rows of 6,912 bins, past the four-launch design's 6,144:
    the same map as the twin, and one bin past the card's limit raises.
    Also with 7 taps (a 1-bin sigma), which takes the kernel's run-time tap
    count."""
    wide = np.ascontiguousarray(np.concatenate([scan, scan[::-1]], axis=1))
    rcfg = dataclasses.replace(CFG.radar, num_range_bins=2 * CFG.radar.num_range_bins)
    assert wide.shape == (400, 6912)
    _assert_kernel_equals_twin(t(wide, cuda_device), rcfg)
    narrow = dataclasses.replace(CFG.features, smooth_sigma_bins=1.0)
    assert tcen.smoothing_taps(narrow).numel() == 7
    _assert_kernel_equals_twin(t(wide, cuda_device), rcfg, narrow)
    with pytest.raises(ValueError, match="7034 bins"):   # an H100's limit at 400 rows
        cen_peaks.cen2019_scores_cuda(torch.zeros((400, 7035), device=cuda_device),
                                      CFG.features, rcfg)


@pytest.mark.cuda
def test_cen2019_kernel_through_4bit_path_on_cuda(scan, cuda_device):
    """K1 on a scan that came over the 4-bit wire format and was decoded on
    the card (many tied smoothed powers): the same map as the twin."""
    u8 = (np.clip(scan, 0, 1) * 255).astype(np.uint8)
    x = decode_power(t(pack4(u8), cuda_device), packed=True)
    assert x.shape == scan.shape and x.dtype == torch.float32
    _assert_kernel_equals_twin(x)


# K1 x B's two designs: the host's choices, and each scan of a batch bit for
# bit K1's map of that scan on the card.


@pytest.mark.parametrize("nscans", [1, 2, 5, 33, 64])
def test_k1b_design_crossover(nscans):
    """A batch below STREAM_MIN_SCANS takes the resident design (K1 is
    B = 1), from there the streamed one."""
    assert cen_peaks.STREAM_MIN_SCANS >= 2
    want = "streamed" if nscans >= cen_peaks.STREAM_MIN_SCANS else "resident"
    assert cen_peaks.design_for(nscans) == want
    assert cen_peaks.design_for(1) == "resident"


@pytest.mark.parametrize("nscans", [64, 5, 33])
def test_k1b_stream_buffers(nscans):
    """The streamed launch's scratch holds sm and |grad| for RING_SCANS scans
    (a few, not B), its stats four floats and a flag a row and three counts
    a scan; the ring is at least two scans, so no scan waits on its own
    slot's previous scan in its own phase."""
    scratch, stats = cen_peaks.stream_buffers(nscans, 400, 3456)
    ring = cen_peaks.RING_SCANS
    assert ring >= 2
    assert scratch == 2 * ring * 400 * 3456
    assert stats == nscans * (5 * 400 + 3)
    if nscans > ring:
        assert scratch < 2 * nscans * 400 * 3456


def test_k1b_stream_smem_fits_many_blocks():
    """A streamed block of 128 threads holds two rows: at 3456 bins 28.3 KB
    with its 16-byte padding, so the shared memory of an H100 SM holds seven
    such blocks and not eight; the rows are padded on both sides by the
    smoothing radius rounded up to 4."""
    got = cen_peaks.stream_smem_bytes(3456)
    assert got == 4 * (8 + 3456 + 8 + 8 + 3456) + 4 * cen_peaks.STREAM_THREADS
    assert cen_peaks.STREAM_THREADS * 2 == cen_peaks.THREADS
    assert 7 * (got + H100[2]) <= H100[1] < 8 * (got + H100[2])
    assert cen_peaks.stream_smem_bytes(3457) == got + 4 * 4 + 4
    # 25 taps: a radius of 12, padded to 12 on each side (13 taps: 6, to 8)
    assert cen_peaks.stream_smem_bytes(3456, 25) == got + 4 * 2 * 4


@pytest.fixture(scope="module")
def batch_scans():
    """33 full-size scans of a circuit; scan 1 came over the 4-bit wire
    format, scan 2 is all zero."""
    sim = RadarSimulator(CFG.radar)
    gt = sim.circuit_trajectory(33)
    scans = np.stack([sim.render(gt[i], noise_seed=i) for i in range(33)])
    u8 = (np.clip(scans[1], 0, 1) * 255).astype(np.uint8)
    scans[1] = unpack4_reference(pack4(u8))
    scans[2] = 0.0
    return scans


@pytest.mark.cuda
@pytest.mark.parametrize("nscans", [1, 2, 5, 33])
def test_k1b_equals_k1_scan_by_scan_on_cuda(batch_scans, cuda_device, nscans):
    """K1 x B in the design the host picks (one launch, counted), then each
    design forced through the test hook: every scan bit-equal
    (``torch.equal``) to K1 on that scan alone, the all-zero scan with no
    peak; and the batch against the plain ``cen2019_scores_batched``: the
    same peak positions and values."""
    x = t(batch_scans[:nscans], cuda_device).contiguous()
    one = [cen_peaks.cen2019_scores_cuda(s.contiguous(), CFG.features, CFG.radar) for s in x]
    before = cen_peaks.batched_launch_count
    got = cen_peaks.cen2019_scores_batched_cuda(x, CFG.features, CFG.radar)
    assert cen_peaks.batched_launch_count == before + 1
    runs = {None: got}
    for design in ("resident", "streamed"):
        runs[design] = cen_peaks._launch(x, CFG.features, CFG.radar, "k1b", design)
    torch.cuda.synchronize()
    for design, got in runs.items():
        for b in range(nscans):
            assert torch.equal(got[b], one[b]), (design, b)
        if nscans > 2:
            assert not bool(torch.isfinite(got[2]).any())
    want = np_(tcen.cen2019_scores_batched(x, CFG.features, CFG.radar))
    g = np_(got)
    assert np.isfinite(want).sum() > 0
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(want))
    np.testing.assert_array_equal(g[np.isfinite(want)], want[np.isfinite(want)])


@pytest.mark.cuda
def test_k1b_streamed_takes_runtime_taps_on_cuda(batch_scans, cuda_device):
    """The streamed design with 7 taps (a 1-bin sigma: the run-time tap
    count) on 5 scans: each bit-equal to K1."""
    narrow = dataclasses.replace(CFG.features, smooth_sigma_bins=1.0)
    x = t(batch_scans[:5], cuda_device).contiguous()
    got = cen_peaks._launch(x, narrow, CFG.radar, "k1b", "streamed")
    for b in range(5):
        assert torch.equal(got[b], cen_peaks.cen2019_scores_cuda(x[b].contiguous(), narrow,
                                                                 CFG.radar)), b
