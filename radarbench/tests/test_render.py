"""The device renderer against the port's host simulator, the pools' seeds,
and the fleet's closed lap."""

import dataclasses
import math

import numpy as np
import torch

from navtech_radar_slam_torch.config import RadarConfig
from navtech_radar_slam_torch.data.synthetic import RadarSimulator, SimConfig
from radarbench import harness, render
from radarbench.runners import fleet

WORLD = harness.traffic("fleet_lap512")["world"]
RADAR = harness.config("mulran_kaist_odometry")["radar"]


def test_noise_free_render_equals_the_host_simulator():
    sc = SimConfig(noise_floor=0.0, speckle=0.0)
    sim = RadarSimulator(RadarConfig(), sc)
    poses = sim.circuit_trajectory(4, radius=61.1, speed=6.0)
    want = np.stack([sim.render(poses[i], end_pose=poses[i + 1]) for i in range(3)])
    p = torch.as_tensor(poses)
    got = render.render_clean(torch.as_tensor(sim.landmarks), torch.as_tensor(sim.reflect),
                              p[:3].clone(), p[1:].clone(), RADAR, dataclasses.asdict(sc))
    render.add_noise(got, torch.Generator(), RADAR, dataclasses.asdict(sc))
    assert (want > 0).sum() > 10_000
    np.testing.assert_array_equal(got.numpy(), want)


def test_circuit_equals_the_host_simulators():
    sim = RadarSimulator(RadarConfig())
    np.testing.assert_allclose(render.circuit(9, 10.0, 6.0, 4.0, "cpu").numpy(),
                               sim.circuit_trajectory(9, radius=10.0, speed=6.0), atol=1e-12)


def _pool(seed):
    poses = render.circuit(4, 20.0, 6.0, 4.0, "cpu")
    return render.render_pool(seed, poses[:-1], poses[1:].clone(), RADAR, WORLD)


def test_pools_are_set_by_the_seed_and_differ_across_seeds():
    a, b, c = _pool(2**33 + 5), _pool(2**33 + 5), _pool(2**33 + 6)
    assert a.dtype == torch.uint8 and a.shape == (3, 400, 3456)
    assert torch.equal(a, b)
    assert (a != c).float().mean() > 0.3
    assert int(a[:, :, 3360:].max()) == 0 and int(a[:, :, :40].max()) == 0


def test_the_fleet_lap_closes():
    traffic = harness.traffic("fleet_lap512")
    poses = fleet.lap_poses(traffic, RADAR["scan_rate_hz"], "cpu").numpy()
    assert len(poses) == traffic["lap_scans"] + 1
    np.testing.assert_allclose(poses[-1, :2], poses[0, :2], atol=1e-9)
    assert abs(math.remainder(poses[-1, 2] - poses[0, 2], 2 * math.pi)) < 1e-9
    steps = np.linalg.norm(np.diff(poses[:, :2], axis=0), axis=1)
    np.testing.assert_allclose(steps, steps[0], rtol=1e-9)
    assert abs(steps[0] - traffic["speed_mps"] / RADAR["scan_rate_hz"]) < 1e-3
    b = np.arange(traffic["streams"])
    assert len(set(fleet.scan_index(b, 7, traffic["lap_scans"]))) == traffic["streams"]
