"""Kernel K4 (``ops/kernels/descriptors.py``, the constellation descriptors
of a batch of scans in one CUDA launch): the wrapper's refusals and the CPU
path, which never reaches the kernel's library, run here; the
``cuda``-marked tests hold the kernel against its plain twin
(``ops.features.constellation_descriptors_plain``) on the card, and each
scan's rows bit-equal across batch sizes, places in the batch, and the
per-scan and batched paths.  The JAX parity of the plain form is
``tests/test_torch_features.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from navtech_radar_slam_torch.config import FeatureConfig, SlamConfig
from navtech_radar_slam_torch.data import RadarSimulator
from navtech_radar_slam_torch.models import odometry as todo
from navtech_radar_slam_torch.ops import features as tfeat
from navtech_radar_slam_torch.ops.kernels import descriptors


@pytest.fixture
def cuda_device():
    """The card, for the ``cuda``-marked tests; skips without one (a CUDA
    kernel has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _scan(seed: int, k: int, radius: float = 180.0):
    """A scan's features: k points over a disc (uniform in area), one at the
    sensor (the radial frame's fallback), two coincident, a fifth of them
    invalid; power in [0.05, 1)."""
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.random(k))
    th = rng.uniform(0.0, 2.0 * np.pi, k)
    xy = np.stack([r * np.cos(th), r * np.sin(th)], axis=-1).astype(np.float32)
    xy[0] = 0.0
    if k > 3:
        xy[3] = xy[2]
    power = rng.uniform(0.05, 1.0, k).astype(np.float32)
    valid = rng.random(k) > 0.2
    valid[:4] = True
    return xy, power, valid


def _batch(seeds, k: int, device="cpu", blank=()):
    """(B, K, 2), (B, K), (B, K) tensors of ``_scan`` for each seed; the
    scans at ``blank`` have no valid feature."""
    xy, power, valid = (np.stack(a) for a in zip(*(_scan(s, k) for s in seeds)))
    for b in blank:
        valid[b] = False
    return tuple(torch.as_tensor(a, device=device) for a in (xy, power, valid))


def _fcfg(grid: int, window: float = 64.0) -> FeatureConfig:
    return FeatureConfig(desc_grid=grid, desc_window=window)


def _dense_reference(xy, power, valid, fcfg) -> np.ndarray:
    """The descriptors of one scan in float64 numpy, pair by pair over the
    P x P cell centres, as the docstring of ``constellation_descriptors``
    defines them."""
    xy, power, valid = (np.asarray(a, np.float64) for a in (xy, power, valid))
    p = fcfg.desc_grid
    cell = fcfg.desc_window / p
    rng = np.linalg.norm(xy, axis=-1)
    far = rng > 1e-6
    c = np.where(far, xy[:, 0] / np.maximum(rng, 1e-6), 1.0)
    s = np.where(far, xy[:, 1] / np.maximum(rng, 1e-6), 0.0)
    d = xy[None, :, :] - xy[:, None, :]
    dx = c[:, None] * d[..., 0] + s[:, None] * d[..., 1]
    dy = -s[:, None] * d[..., 0] + c[:, None] * d[..., 1]
    gx, gy = dx / cell + p / 2 - 0.5, dy / cell + p / 2 - 0.5
    w = valid[None, :] * valid[:, None] * power[None, :]
    w = w * np.exp(-0.5 * (dx * dx + dy * dy) / (fcfg.desc_window * 0.5) ** 2)
    cells = np.arange(p)
    bx = np.maximum(0.0, 1.0 - np.abs(gx[..., None] - cells))
    by = np.maximum(0.0, 1.0 - np.abs(gy[..., None] - cells))
    desc = np.einsum("ij,ijy,ijx->iyx", w, by, bx).reshape(len(xy), p * p)
    desc = desc - desc.mean(axis=1, keepdims=True)
    return desc / np.maximum(np.linalg.norm(desc, axis=1, keepdims=True), 1e-6)


# ---------------------------------------------------------------- the host side


def _refused(fn, *args, **kw):
    before = descriptors.launch_count
    with pytest.raises((TypeError, ValueError)) as info:
        fn(*args, **kw)
    assert descriptors.launch_count == before
    return str(info.value)


def test_wrapper_refuses_a_cpu_tensor():
    """A CPU batch is refused (the kernel has no CPU mode), with no launch."""
    xy, power, valid = _batch([1, 2], 16)
    msg = _refused(descriptors.constellation_descriptors_cuda, xy, power, valid, _fcfg(16))
    assert "CUDA tensors" in msg


@pytest.mark.parametrize("which", ["xy", "power", "valid"])
def test_wrapper_refuses_a_wrong_dtype(which):
    args = dict(zip(("xy", "power", "valid"), _batch([1, 2], 16)))
    args[which] = args[which].to(torch.uint8 if which == "valid" else torch.float64)
    with pytest.raises(TypeError, match="float32 xy and power and a bool mask"):
        descriptors.constellation_descriptors_cuda(**args, fcfg=_fcfg(16))


@pytest.mark.parametrize("case", ["power_k", "valid_b", "xy_width", "xy_2d", "strided"])
def test_wrapper_refuses_mismatched_shapes(case):
    xy, power, valid = _batch([1, 2], 16)
    if case == "power_k":
        power = torch.cat([power, power[:, :1]], dim=1)
    elif case == "valid_b":
        valid = torch.cat([valid, valid[:1]])
    elif case == "xy_width":
        xy = torch.cat([xy, xy[..., :1]], dim=-1)
    elif case == "xy_2d":
        xy, power, valid = xy[0], power[0], valid[0]
    else:
        xy = xy.transpose(0, 1)
        power, valid = power.t(), valid.t()
    msg = _refused(descriptors.constellation_descriptors_cuda, xy, power, valid, _fcfg(16))
    assert "contiguous (B, K, 2), (B, K) and (B, K)" in msg


def test_wrapper_refuses_an_empty_batch():
    xy, power, valid = _batch([1], 16)
    msg = _refused(descriptors.constellation_descriptors_cuda, xy[:0], power[:0], valid[:0],
                   _fcfg(16))
    assert "B = 0" in msg


@pytest.mark.parametrize("grid,refused", [(33, True), (64, True), (32, False), (6, False)])
def test_wrapper_grid_limit(grid, refused):
    """P² above MAX_CELLS (1,024: P <= 32) is refused before the device is
    looked at; a grid within it gets as far as the device check."""
    xy, power, valid = _batch([1], 16)
    msg = _refused(descriptors.constellation_descriptors_cuda, xy, power, valid, _fcfg(grid))
    assert ("1 to 1024 cells" in msg) == refused
    assert ("CUDA tensors" in msg) == (not refused)


def test_reciprocals_are_float32_division_by_a_scalar():
    """The factors the kernel multiplies by: float32(1) / float32(d), exact
    at the configured 4 m cells and 1,024 m² falloff."""
    fc = SlamConfig().features
    assert descriptors.reciprocal(fc.desc_window / fc.desc_grid) == 0.25
    assert descriptors.reciprocal((fc.desc_window * 0.5) ** 2) == 1.0 / 1024.0
    assert descriptors.reciprocal(6.0) == float(np.float32(1.0) / np.float32(6.0))
    assert descriptors.reciprocal(6.0) != 1.0 / 6.0


def test_source_constants_match_the_wrapper():
    """The cell limit the wrapper checks the built library against is the
    source's, and the build takes no fast math."""
    src = (descriptors.LIBRARY.source).read_text()
    assert f"constexpr int kMaxCells = {descriptors.MAX_CELLS};" in src
    assert "use_fast_math" not in " ".join(descriptors.LIBRARY._flags)


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a card, where loading the kernel's library fails."""
    def refuse():
        raise AssertionError("the CPU path loaded the K4 library")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(descriptors.LIBRARY, "load", refuse)
    return descriptors.launch_count


@pytest.mark.parametrize("k,grid,window", [(64, 16, 64.0), (48, 8, 48.0), (40, 6, 64.0)])
def test_cpu_path_is_the_plain_form(no_card, k, grid, window):
    """On the CPU ``constellation_descriptors`` and ``_descriptors_batched``
    run the plain form: never the library, the same rows as the plain form
    and as a float64 evaluation of the definition (1e-5), an invalid
    feature's row zero, a scan with no valid feature all zeros."""
    fcfg = _fcfg(grid, window)
    cfg = dataclasses.replace(SlamConfig(), features=fcfg)
    xy, power, valid = _batch([3, 4, 5], k, blank=(1,))
    batched = todo._descriptors_batched(xy, power, valid, cfg)
    assert batched.shape == (3, k, grid * grid)
    for b in range(3):
        one = tfeat.constellation_descriptors(xy[b], power[b], valid[b], fcfg)
        plain = tfeat.constellation_descriptors_plain(xy[b], power[b], valid[b], fcfg)
        assert torch.equal(one, plain)
        np.testing.assert_allclose(batched[b].numpy(), one.numpy(), rtol=0, atol=1e-6)
        want = _dense_reference(xy[b], power[b], valid[b], fcfg)
        np.testing.assert_allclose(one.numpy(), want, rtol=0, atol=1e-5)
        assert not one[~valid[b]].any()
    assert not batched[1].any()
    assert descriptors.launch_count == no_card


@pytest.mark.parametrize("nscans,place", [(1, 0), (3, 2), (33, 0), (40, 32)])
def test_cpu_batched_rows_do_not_depend_on_b(no_card, nscans, place):
    """On the CPU ``_descriptors_batched`` runs calls of at most
    DESC_STREAMS streams, the last one short: a scan's rows are the same
    bits at any B and at any place in the batch, on either side of a call's
    boundary."""
    fcfg = _fcfg(16)
    cfg = dataclasses.replace(SlamConfig(), features=fcfg)
    pool = _batch(range(48), 64, blank=(9,))
    want = todo._descriptors_batched(*(x[5:6] for x in pool), cfg)[0]
    idx = torch.arange(nscans) + 7
    idx[place] = 5
    got = todo._descriptors_batched(*(x[idx] for x in pool), cfg)
    assert got.shape == (nscans, 64, 256)
    assert torch.equal(got[place], want)
    assert descriptors.launch_count == no_card


def test_cpu_extraction_never_loads_the_library(no_card):
    """The per-scan and batched extraction of two simulator scans on the CPU
    (K = 256) reach the descriptors' plain form only."""
    base = SlamConfig()
    cfg = dataclasses.replace(base, features=dataclasses.replace(base.features,
                                                                 max_features=256))
    sim = RadarSimulator(cfg.radar)
    gt = sim.circuit_trajectory(2, radius=10.0, speed=6.0)
    scans = torch.as_tensor(np.stack([sim.render(gt[i], noise_seed=i) for i in range(2)]))
    az = torch.as_tensor(todo.default_azimuths(cfg))
    batched = todo.extract_scan_features_batched(scans, az, cfg)
    for b in range(2):
        one = todo.extract_scan_features(scans[b], az, cfg)
        assert torch.equal(one.xy, batched.xy[b])
        np.testing.assert_allclose(one.desc.numpy(), batched.desc[b].numpy(), rtol=0,
                                   atol=1e-6)
    assert bool(batched.valid.any())
    assert descriptors.launch_count == no_card


# ---------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("grid,window", [(16, 64.0), (8, 48.0), (6, 64.0)])
@pytest.mark.parametrize("k", [1024, 256, 64])
def test_kernel_matches_twin_on_cuda(cuda_device, k, grid, window):
    """K4 against its plain twin on the card, three scans in one launch
    (some features invalid, one scan with none valid, two coincident points,
    one at the sensor): max abs gap <= 2e-6, and bit-equal (the cells sum in
    cuBLAS's order, the epilogue in ATen's; a last-bit difference flips a
    matcher's near-ties), an invalid feature's row and the blank scan zeros,
    and one launch."""
    fcfg = _fcfg(grid, window)
    xy, power, valid = _batch([10 + k, 11 + k, 12 + k], k, cuda_device, blank=(1,))
    before = descriptors.launch_count
    got = descriptors.constellation_descriptors_cuda(xy, power, valid, fcfg)
    torch.cuda.synchronize()
    assert descriptors.launch_count == before + 1
    assert got.shape == (3, k, grid * grid)
    for b in range(3):
        want = tfeat.constellation_descriptors_plain(xy[b], power[b], valid[b], fcfg)
        gap = float((got[b] - want).abs().max())
        assert gap <= 2e-6, (b, gap)
        assert torch.equal(got[b], want), (b, int((got[b] != want).any(dim=1).sum()))
        assert not bool(got[b][~valid[b]].any())
    assert not bool(got[1].any())
    assert bool(got[0].any()) and bool(torch.isfinite(got).all())


@pytest.mark.cuda
def test_kernel_is_batch_invariant_on_cuda(cuda_device):
    """A scan's rows are the same bits at B = 1, 8 and 512, and at two places
    in each batch (the full-size K = 1024, P = 16)."""
    fcfg = SlamConfig().features
    k = fcfg.max_features
    pool = _batch(range(520), k, cuda_device)
    scans = (0, 7)
    alone = [descriptors.constellation_descriptors_cuda(
        *(x[s:s + 1] for x in pool), fcfg)[0] for s in scans]
    for nscans, places in ((8, (0, 5)), (512, (3, 400))):
        for s, want in zip(scans, alone):
            for at in places:
                idx = (torch.arange(nscans, device=cuda_device) + 11) % 520
                idx[at] = s
                got = descriptors.constellation_descriptors_cuda(
                    *(x[idx].contiguous() for x in pool), fcfg)
                assert torch.equal(got[at], want), (nscans, s, at)


@pytest.mark.cuda
def test_per_scan_and_batched_paths_bit_equal_on_cuda(cuda_device):
    """``constellation_descriptors`` of each scan alone and
    ``_descriptors_batched`` of the batch give the same bits, one launch
    each."""
    cfg = SlamConfig()
    xy, power, valid = _batch(range(40, 45), cfg.features.max_features, cuda_device,
                              blank=(2,))
    before = descriptors.launch_count
    batched = todo._descriptors_batched(xy, power, valid, cfg)
    assert descriptors.launch_count == before + 1
    for b in range(5):
        one = tfeat.constellation_descriptors(xy[b], power[b], valid[b], cfg.features)
        assert torch.equal(one, batched[b]), b
    assert descriptors.launch_count == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("nscans", [1, 64, 512])
def test_one_launch_per_batched_call_on_cuda(cuda_device, nscans):
    """``_descriptors_batched`` is one K4 launch whatever B, and no hat
    tensor: the call's peak memory is its output and inputs, far below the
    2 GB a (32, 1024, 1024, 16) hat tensor took."""
    cfg = SlamConfig()
    xy, power, valid = _batch(range(nscans), cfg.features.max_features, cuda_device)
    todo._descriptors_batched(xy, power, valid, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    before = descriptors.launch_count
    out = todo._descriptors_batched(xy, power, valid, cfg)
    torch.cuda.synchronize()
    assert descriptors.launch_count == before + 1
    assert torch.cuda.max_memory_allocated() - start <= out.numel() * 4 + (1 << 20)
