"""Two gloo ranks of the port, mirroring tests/test_distributed_multiprocess.py:
on the inputs of tests/distributed_worker.py::build_inputs, one sharded
bank search and one distributed solve across a real process boundary
(``parallel.launch``), and the command line's ``--mesh 2 --device cpu``.

Both ranks must find bank row 5 and agree (the same candidate and
bit-equal poses), and the poses must be within 5e-2 of the JAX
single-process solver (the JAX test's band).  The CLI runs its two ranks
itself: rank 0 alone prints and writes (a rank other than 0 writes
nothing), and the trajectory is within the engine band (0.1 m) of the
single-device CLI's on the same written scans.
"""

import concurrent.futures
import json
import os
import sys

import numpy as np
import pytest

import torch_parallel_ranks as ranks
from navtech_radar_slam_torch import cli as tcli
from navtech_radar_slam_torch.data.make_sequence import write_sequence
from navtech_radar_slam_torch.parallel.launch import launch
from navtech_radar_slam_torch.parallel.mesh import Mesh
from test_torch_slam import small_cfg
from torch_parity_util import one_torch_thread  # noqa: F401 (fixture)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import distributed_worker as dw  # noqa: E402

CLI_SCANS = 12


def test_two_process_distributed_matches_single_process():
    import torch

    from navtech_radar_slam_tpu.models import posegraph as pg

    bank, steps = dw.build_inputs()
    cfg = dw.pgo_cfg()
    graph = dw.build_graph(steps, cfg)
    arrays = [np.asarray(x) for x in graph.g]
    for i in (1, 4, 5):   # num_nodes, loop_i, loop_j: the port's int64
        arrays[i] = arrays[i].astype(np.int64)
    # the JAX single-process solve in a thread while the ranks run
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ref = pool.submit(lambda: np.asarray(pg.make_solver(cfg)(graph.g).poses))
    pool.shutdown(wait=False)
    r0, r1 = launch(ranks.two_process_problem, 2, bank, arrays, ranks.pgo_fields(cfg),
                    threads=1, all_ranks=True, timeout=300)
    assert (r0["rank"], r1["rank"], r0["size"]) == (0, 1, 2)
    assert r0["cand_idx"] == r1["cand_idx"] == 5
    assert r0["cand_dist"] == r1["cand_dist"]
    np.testing.assert_array_equal(r0["poses"], r1["poses"])
    ref_poses = ref.result()
    np.testing.assert_allclose(r0["poses"][:40, :2, 3], ref_poses[:40, :2, 3],
                               rtol=0, atol=5e-2)
    assert torch.get_num_threads() == 1


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    write_sequence(str(root / "seq"), num_scans=CLI_SCANS, radius=5.0, speed=6.0)
    (root / "cfg.json").write_text(small_cfg().to_json())
    return root


def _argv(seq, out, *extra):
    return ["--seq_dir", str(seq / "seq"), "--config", str(seq / "cfg.json"),
            "--output_dir", str(out), "--save_plot", "false", "--device", "cpu",
            "--chunk", "4", "--checkpoint_every", "8", "--status_every", "4", *extra]


def test_cli_mesh_two_ranks(seq, tmp_path, capfd):
    """``--mesh 2 --device cpu``: the run's outputs, printed and written once
    (rank 0), the trajectory in the engine band of the one-device run's."""
    assert tcli.main(_argv(seq, tmp_path / "mesh", "--mesh", "2")) == 0
    out = capfd.readouterr().out
    assert "mesh: 2 ranks, gloo on cpu" in out
    assert out.count("run: ") == 1 and out.count("wrote ") == 1, out
    # prewarm leaves the engine's state as it was: the one-device run skips it
    assert tcli.main(_argv(seq, tmp_path / "one", "--prewarm", "false")) == 0
    for name in ("trajectory_tum.txt", "odometry_tum.txt", "map_points.csv", "stats.json",
                 "final.npz", "checkpoint.npz"):
        assert (tmp_path / "mesh" / name).exists(), name
    tm = np.loadtxt(tmp_path / "mesh" / "trajectory_tum.txt")
    t1 = np.loadtxt(tmp_path / "one" / "trajectory_tum.txt")
    assert tm.shape == t1.shape and len(tm) >= 8
    np.testing.assert_array_equal(tm[:, 0], t1[:, 0])
    np.testing.assert_allclose(tm[:, 1:4], t1[:, 1:4], rtol=0, atol=0.1)
    stats = json.loads((tmp_path / "mesh" / "stats.json").read_text())
    assert stats["num_scans"] == CLI_SCANS
    z = np.load(tmp_path / "mesh" / "final.npz")
    assert z["bank"].shape[0] == small_cfg().keyframes.max_keyframes


def test_cli_rank_other_than_0_writes_nothing(seq, tmp_path, capfd):
    """One rank's run with rank 1 (a mesh of size 1 runs the one-device
    engine): no output directory, no checkpoint, nothing printed."""
    import torch

    out = tmp_path / "rank1"
    mesh = Mesh(group=None, rank=1, size=1, device=torch.device("cpu"), backend="gloo")
    real = sys.stdout
    try:
        assert tcli._mesh_rank(mesh, _argv(seq, out, "--loop_debug_dir",
                                           str(tmp_path / "dumps"), "--max_scans", "8",
                                           "--checkpoint_every", "4")) == 0
    finally:
        sys.stdout = real
    assert not out.exists() and not (tmp_path / "dumps").exists()
    assert capfd.readouterr().out == ""
