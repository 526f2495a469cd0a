"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a fixed seed and handed to both the JAX
reference (on the CPU, as the JAX suite runs it) and the port; outputs come
back as numpy for the comparison.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu.config import SlamConfig
from navtech_radar_slam_tpu.data import RadarSimulator

SCAN_FIELDS = ("xy", "desc", "power", "valid", "ranges", "ray_frac")


def tiny_cfg() -> SlamConfig:
    """The parity-test size: the feature, match and solver budgets of
    ``__graft_entry__._tiny_cfg`` (scans stay 400 x 3456)."""
    c = SlamConfig()
    return dataclasses.replace(
        c,
        features=dataclasses.replace(c.features, max_features=256, max_matches=128),
        registration=dataclasses.replace(
            c.registration, spectral_top_k=128, gnc_max_iters=8, cote_iters=4,
            refine_iters=4,
        ),
    )


def np_(x) -> np.ndarray:
    """JAX array or torch tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def j(x) -> jnp.ndarray:
    return jnp.asarray(x)


def t(x, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(device)


def tuple_np(nt) -> dict:
    """A NamedTuple of JAX arrays or tensors -> dict of numpy (None kept)."""
    return {k: (None if v is None else np_(v)) for k, v in nt._asdict().items()}


def jax_odometry_carry(odo) -> dict:
    """A JAX ``RadarOdometry``'s carry in the layout of
    ``navtech_radar_slam_torch.state``."""
    return {
        "prev": None if odo.prev is None else {
            k: np.asarray(getattr(odo.prev, k)) for k in SCAN_FIELDS},
        "pose": np.asarray(odo.pose, np.float64),
        "last_rel": np.asarray(odo.last_rel, np.float64),
        "coast": odo._coast,
        "num_scans": odo.num_scans,
        "num_failures": odo.num_failures,
    }


def sim_scans(cfg: SlamConfig, n: int, seed0: int = 0, radius: float = 10.0,
              speed: float = 6.0):
    """``n`` full-size simulator scans along a circuit, distinct speckle."""
    sim = RadarSimulator(cfg.radar)
    gt = sim.circuit_trajectory(n, radius=radius, speed=speed)
    return gt, [sim.render(gt[i], noise_seed=seed0 + i) for i in range(n)]


def peak_set(az, rb, valid) -> set:
    v = np_(valid).astype(bool)
    return set(zip(np_(az)[v].tolist(), np_(rb)[v].tolist()))


def assert_score_maps_close(a: np.ndarray, b: np.ndarray, frac: float = 0.01,
                            atol: float = 1e-5) -> None:
    """Two cen2019 score maps (finite at peaks, -inf elsewhere) agree: the
    peak positions differ in at most ``frac`` of the peaks and the values at
    common peaks agree to ``atol``.  The per-azimuth and whole-scan sums are
    taken in another order by each implementation, which can flip a
    borderline h > mean(h) decision (the tolerance of the JAX suite's own
    kernel parity test, tests/test_pallas_kernels.py)."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    n_diff = int((fa ^ fb).sum())
    assert fa.sum() > 0
    assert n_diff <= frac * fa.sum(), f"{n_diff} of {fa.sum()} peaks differ"
    both = fa & fb
    np.testing.assert_allclose(a[both], b[both], rtol=0, atol=atol)


@pytest.fixture
def cuda_device():
    """The card, for the ``cuda``-marked tests; skips without one (a CUDA
    kernel has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread for a module's tests, restored after.  The
    suite runs in several worker processes at once, and torch's default of
    one OpenMP thread per core in each of them oversubscribes the cores
    (idle OpenMP threads spin), which slows every worker many times over;
    the CPU tests' tensors are small, so one thread costs them little.
    Import it into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
