"""The port's own copies of the configuration and the data helpers agree
with the JAX package's, and the entry points default to the card."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from navtech_radar_slam_torch import config as tconfig
from navtech_radar_slam_torch import entry as tentry
from navtech_radar_slam_torch.data import packing as tpacking
from navtech_radar_slam_torch.data import synthetic as tsynthetic
from navtech_radar_slam_torch.models import odometry as todo
from navtech_radar_slam_torch.models import posegraph as tpg
from navtech_radar_slam_torch.models import slam as tslam
from navtech_radar_slam_torch.utils.device import resolve_device
from navtech_radar_slam_tpu import config as jconfig
from navtech_radar_slam_tpu.data import packing as jpacking
from navtech_radar_slam_tpu.data import synthetic as jsynthetic

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("name", ["config1_odometry_only.json",
                                  "config2_loop_detection.json",
                                  "config3_full_slam.json"])
def test_config_files_load_alike(name):
    text = (CONFIGS / name).read_text()
    got = tconfig.SlamConfig.from_json(text)
    want = jconfig.SlamConfig.from_json(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfig.SlamConfig.from_json(got.to_json()) == got


def test_config_defaults_and_classes_alike():
    assert dataclasses.asdict(tconfig.SlamConfig()) == dataclasses.asdict(jconfig.SlamConfig())
    names = [n for n, v in vars(jconfig).items()
             if dataclasses.is_dataclass(v) and v.__module__ == jconfig.__name__]
    assert "SlamConfig" in names and "RadarConfig" in names
    for n in names:
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jconfig, n))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tconfig, n))]
        assert jf == tf, n
    assert tconfig.SlamConfig().radar.padded_range_bins == jconfig.SlamConfig().radar.padded_range_bins


@pytest.mark.parametrize("seed,pose,end", [
    (3, (5.0, -3.0, 0.7), None),
    (3, (5.0, -3.0, 0.7), (5.4, -2.9, 0.75)),
    (11, (-20.0, 12.5, -2.1), None),
    (11, (-20.0, 12.5, -2.1), (-19.2, 12.0, -2.0)),
])
def test_simulator_renders_identical_scans(seed, pose, end):
    rj = jsynthetic.RadarSimulator(jconfig.SlamConfig().radar)
    rt = tsynthetic.RadarSimulator(tconfig.SlamConfig().radar)
    end_pose = None if end is None else np.asarray(end)
    a = rj.render(np.asarray(pose), noise_seed=seed, end_pose=end_pose)
    b = rt.render(np.asarray(pose), noise_seed=seed, end_pose=end_pose)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(rj.circuit_trajectory(12), rt.circuit_trajectory(12))


def test_packing_identical_bytes():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (400, 3456), dtype=np.uint8)
    pj, pt = jpacking.pack4(u8), tpacking.pack4(u8)
    assert pj.dtype == pt.dtype and pj.tobytes() == pt.tobytes()
    uj, ut = jpacking.unpack4_reference(pj), tpacking.unpack4_reference(pt)
    assert uj.dtype == ut.dtype and uj.tobytes() == ut.tobytes()


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda: todo.RadarOdometry(tconfig.SlamConfig()),
    lambda: tslam.SlamEngine(tconfig.SlamConfig()),
    lambda: tpg.PoseGraph(tconfig.SlamConfig().pgo),
    lambda: tpg.empty_graph(tconfig.SlamConfig().pgo),
    lambda: tentry.entry(),
], ids=["RadarOdometry", "SlamEngine", "PoseGraph", "empty_graph", "entry"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, make):
    """Without a card and without ``device``, an entry point raises; it never
    carries on on the CPU.  Whether a card is there is decided here, inside
    the test (monkeypatched off), never at import."""
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")


def test_entry_points_take_the_cpu_when_asked():
    cfg = tconfig.SlamConfig()
    assert todo.RadarOdometry(cfg, device="cpu").device == torch.device("cpu")
    assert tpg.PoseGraph(cfg.pgo, device="cpu").device == torch.device("cpu")
    assert tpg.empty_graph(cfg.pgo, device="cpu").poses.device == torch.device("cpu")
