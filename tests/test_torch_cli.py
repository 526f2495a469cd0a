"""The port's command line (``navtech_radar_slam_torch.cli``) against the
JAX CLI, mirroring tests/test_cli.py: both CLIs on the same written 6-scan
sequence per scan and with ``--chunk 4`` (the same keyframes, TUM
positions within 5e-3 m, the same stats.json apart from the time fields),
``--resume`` (:76), a malformed gps.csv (:319); and the port's own rules:
the pending loops are committed before stats.json is written, ``--mesh 2
--device cuda`` with fewer than two cards and ``--device cuda`` without a
card raise, ``--save_plot`` without matplotlib fails at argument time.
(``--mesh 2 --device cpu`` runs in test_torch_distributed_multiprocess.py.)

The sequences are written by the port's ``make_sequence.write_sequence``
(full-size MulRan PNGs); the engine runs at ``test_torch_slam.small_cfg``
through ``--config``, on the CPU (``--device cpu``).  In stats.json the
counts are equal and ATE / RTE within the 5e-3 m of the positions.
"""

import json
import sys

import numpy as np
import pytest
import torch

from navtech_radar_slam_tpu import cli as jcli
from navtech_radar_slam_torch import cli as tcli
from navtech_radar_slam_torch.data.make_sequence import write_sequence
from navtech_radar_slam_torch.utils import checkpoint as tckpt
from test_torch_slam import N_SCANS, small_cfg
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse fixture)

TIME_FIELDS = ("frames_per_sec", "warmup_s", "compile_s", "steady_scans_per_sec")


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """A 6-scan sequence with GPS, a 25-scan one that closes loops, and the
    small config as a file."""
    root = tmp_path_factory.mktemp("cli")
    write_sequence(str(root / "short"), num_scans=6, radius=5.0, speed=6.0, gps=True)
    write_sequence(str(root / "lap"), num_scans=N_SCANS, radius=5.0, speed=6.0)
    (root / "cfg.json").write_text(small_cfg().to_json())
    return root


def _argv(seq, name, out, *extra):
    return ["--seq_dir", str(seq / name), "--config", str(seq / "cfg.json"),
            "--output_dir", str(out), "--save_plot", "false", *extra]


@pytest.mark.parametrize("mode", [[], ["--chunk", "4", "--prewarm", "false"]],
                         ids=["per_scan", "chunk4"])
def test_cli_matches_jax(seq, tmp_path, mode):
    """Both CLIs on one sequence (GPS on): the same keyframes and TUM
    stamps, positions within 5e-3 m, the same stats.json but for the time
    fields."""
    extra = ["--use_gps", "true", "--status_every", "2", *mode]
    assert jcli.main(_argv(seq, "short", tmp_path / "j", *extra)) == 0
    assert tcli.main(_argv(seq, "short", tmp_path / "t", "--device", "cpu", *extra)) == 0
    tj = np.loadtxt(tmp_path / "j" / "trajectory_tum.txt")
    tt = np.loadtxt(tmp_path / "t" / "trajectory_tum.txt")
    assert tt.shape == tj.shape and len(tt) >= 5
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    np.testing.assert_allclose(tt[:, 1:4], tj[:, 1:4], rtol=0, atol=5e-3)
    sj = json.loads((tmp_path / "j" / "stats.json").read_text())
    st = json.loads((tmp_path / "t" / "stats.json").read_text())
    assert st.keys() == sj.keys()
    for key in st:
        if key in TIME_FIELDS:
            continue
        if isinstance(sj[key], float):
            assert st[key] == pytest.approx(sj[key], abs=5e-3), key
        else:
            assert st[key] == sj[key], key
    assert st["num_scans"] == 6 and st["odometry_failures"] == 0
    assert st["ate_rmse"] is not None
    for name in ("odometry_tum.txt", "map_points.csv", "final.npz"):
        assert (tmp_path / "t" / name).exists(), name


def test_cli_resume(seq, tmp_path):
    """A run stopped after 3 scans (traced by torch.profiler) resumes from
    its final.npz (chunked, so the prewarm of a shorter last chunk runs) to
    the end of the sequence."""
    assert tcli.main(_argv(seq, "short", tmp_path / "o1", "--device", "cpu",
                           "--max_scans", "3", "--profile_dir", str(tmp_path / "trace"))) == 0
    assert (tmp_path / "trace" / "trace.json").exists()
    first = tckpt.load_engine(str(tmp_path / "o1" / "final.npz"), device="cpu")
    assert first.num_scans == 3
    assert tcli.main(_argv(seq, "short", tmp_path / "o2", "--device", "cpu", "--chunk", "2",
                           "--resume", str(tmp_path / "o1" / "final.npz"))) == 0
    again = tckpt.load_engine(str(tmp_path / "o2" / "final.npz"), device="cpu")
    assert again.num_scans == 6 and again.num_keyframes >= first.num_keyframes


def test_cli_stats_count_the_drained_loops(seq, tmp_path):
    """A chunked run that closes loops, with the debug dumps, checkpoints
    and live snapshots on: stats.json counts the loops of final.npz (the
    pending ones committed first)."""
    out, dumps = tmp_path / "out", tmp_path / "loops"
    assert tcli.main(_argv(seq, "lap", out, "--device", "cpu", "--chunk", "8", "--prewarm",
                           "false", "--checkpoint_every", "16", "--loop_debug_dir",
                           str(dumps))) == 0
    stats = json.loads((out / "stats.json").read_text())
    z = np.load(out / "final.npz")
    assert stats["num_loops"] == len(z["loop_events"]) == int(z["num_loops"]) >= 1
    assert stats["num_scans"] == N_SCANS and (out / "checkpoint.npz").exists()
    assert list(dumps.glob("loop_*_accepted.npz"))
    assert (out / "loops.csv").exists() and (out / "live_path_tum.txt").exists()


def test_cli_survives_malformed_gps(seq, tmp_path):
    (tmp_path / "polar_oxford_form").symlink_to(seq / "short" / "polar_oxford_form")
    (tmp_path / "gps.csv").write_text("header,line\nnot,a,number\n")
    out = tmp_path / "out"
    assert tcli.main(["--seq_dir", str(tmp_path), "--output_dir", str(out), "--config",
                      str(seq / "cfg.json"), "--use_gps", "true", "--do_slam", "false",
                      "--save_plot", "false", "--live", "false", "--device", "cpu"]) == 0
    assert (out / "stats.json").exists()


def test_cli_refuses_what_is_not_ported(seq, tmp_path, monkeypatch):
    """``--mesh 2 --device cuda`` raises before launching where fewer than
    two cards are visible (NCCL needs one per rank), naming the count;
    ``--device cuda`` raises where there is no card, and never runs on the
    CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="1 visible"):
        tcli.main(_argv(seq, "short", tmp_path / "m", "--device", "cuda", "--mesh", "2"))
    assert not (tmp_path / "m").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(_argv(seq, "short", tmp_path / "c", "--device", "cuda"))
    assert not (tmp_path / "c" / "stats.json").exists()


def test_save_plot_needs_matplotlib(seq, tmp_path, monkeypatch, capsys):
    """Without matplotlib, ``--save_plot true`` fails when the arguments are
    parsed, before any scan."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit):
        tcli.main(["--seq_dir", str(seq / "short"), "--output_dir", str(tmp_path / "p"),
                   "--device", "cpu"])
    assert "matplotlib" in capsys.readouterr().err
    assert not (tmp_path / "p").exists()
