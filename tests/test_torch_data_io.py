"""The port's data I/O against the JAX package's: the PNG codec (against
OpenCV, which only this test imports), the MulRan reader
(``data/mulran.py``), the sequence writer (``data/make_sequence.py``), the
metrics, ``eval.main`` and the TUM writer.

Tolerances: pixels, CSV numbers, decoded scans and written files are equal
exactly; the metrics are the same numpy code on the same inputs, equal to
the last bit.
"""

import contextlib
import io
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from navtech_radar_slam_tpu import eval as jeval
from navtech_radar_slam_tpu.config import RadarConfig as JRadarConfig
from navtech_radar_slam_tpu.data import make_sequence as jseq
from navtech_radar_slam_tpu.data import mulran as jmulran
from navtech_radar_slam_tpu.utils import metrics as jmetrics
from navtech_radar_slam_tpu.utils import viz as jviz
from navtech_radar_slam_torch import eval as teval
from navtech_radar_slam_torch.config import RadarConfig
from navtech_radar_slam_torch.data import make_sequence as tseq
from navtech_radar_slam_torch.data import mulran as tmulran
from navtech_radar_slam_torch.data import png
from navtech_radar_slam_torch.utils import metrics as tmetrics
from navtech_radar_slam_torch.utils import viz as tviz

N_SCANS = 3
WRITER_ARGS = dict(num_scans=N_SCANS, radius=12.0, speed=6.0, dropouts=[(1, 1)],
                   dropout_atten=0.2, gps=True, seed=3)


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """The same full-size sequence written by both writers (JAX's with
    OpenCV, the port's with its own encoder)."""
    root = tmp_path_factory.mktemp("seqs")
    gt_j = jseq.write_sequence(str(root / "jax"), **WRITER_ARGS)
    gt_t = tseq.write_sequence(str(root / "torch"), **WRITER_ARGS)
    np.testing.assert_array_equal(gt_t, gt_j)
    return root / "jax", root / "torch"


def _scan_paths(seq_dir):
    scan_dir = seq_dir / "polar_oxford_form"
    return [scan_dir / f for f in sorted(os.listdir(scan_dir))]


# -- the PNG codec -----------------------------------------------------------

def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind: int, row: np.ndarray, up: np.ndarray) -> np.ndarray:
    """PNG's forward filter ``kind`` on one 8-bit greyscale row, pixel by
    pixel (the specification's reference form)."""
    out = np.zeros(len(row), np.uint8)
    for i, x in enumerate(row.astype(int)):
        a = int(row[i - 1]) if i else 0
        b = int(up[i])
        c = int(up[i - 1]) if i else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out[i] = (x - pred) % 256
    return out


def _png(raw: bytes, width: int, height: int, depth: int = 8, color: int = 0,
         interlace: int = 0) -> bytes:
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    rows, up = [], np.zeros(img.shape[1], np.uint8)
    for row, kind in zip(img, kinds):
        rows.append(np.concatenate([[kind], _filter_row(kind, row, up)]).astype(np.uint8))
        up = row
    return _png(np.stack(rows).tobytes(), img.shape[1], img.shape[0])


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4, 3, 2, 4, 1]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_every_filter_type_decodes_exactly(tmp_path, kinds):
    """Hand-built PNGs whose rows use one filter type, or all five in turn,
    decode to the image exactly, as OpenCV decodes them."""
    rng = np.random.default_rng(len(kinds) * 7 + kinds[0])
    img = rng.integers(0, 256, (9, 37), dtype=np.uint8)
    img[:, 20:] = np.cumsum(img[:, 20:] // 16, axis=1, dtype=np.uint8)   # smooth runs
    data = _filtered_png(img, (kinds * 9)[:9])
    np.testing.assert_array_equal(png.decode_png(data), img)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)


def test_decoder_reads_opencv_scans(sequences):
    """Every scan the JAX writer wrote with OpenCV decodes byte-equal to
    ``cv2.imread``."""
    for path in _scan_paths(sequences[0]):
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        got = png.read_png(str(path))
        assert got.shape == (400, 3371)
        np.testing.assert_array_equal(got, want)


def test_opencv_reads_the_port_encoder(sequences, tmp_path):
    """OpenCV decodes the port's PNGs exactly: the written scans and an
    image with every byte value."""
    for path in _scan_paths(sequences[1]):
        np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED),
                                      png.read_png(str(path)))
    img = np.arange(256 * 3, dtype=np.int64).reshape(12, 64).astype(np.uint8)
    png.write_png(str(tmp_path / "all.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "all.png"),
                                             cv2.IMREAD_UNCHANGED), img)


@pytest.mark.parametrize("case", ["colour", "16-bit", "interlaced", "crc", "not-png"])
def test_decoder_refuses_what_it_does_not_read(case):
    raw = bytes(4 * 5)
    data = {
        "colour": _png(bytes(4 * (3 * 4 + 1)), 4, 4, color=2),
        "16-bit": _png(bytes(4 * (2 * 4 + 1)), 4, 4, depth=16),
        "interlaced": _png(raw, 4, 4, interlace=1),
        "crc": _png(raw, 4, 4)[:-5] + b"\x00" + _png(raw, 4, 4)[-4:],
        "not-png": b"GIF89a" + raw,
    }[case]
    with pytest.raises(ValueError):
        png.decode_png(data)


# -- the sequence writer and the reader ---------------------------------------

def test_write_sequence_matches_jax(sequences):
    """The same file names and pixels, and the same numbers in
    global_pose.csv and gps.csv, as the JAX writer's."""
    seq_j, seq_t = sequences
    names_j = [p.name for p in _scan_paths(seq_j)]
    assert names_j == [p.name for p in _scan_paths(seq_t)] and len(names_j) == N_SCANS
    for pj, pt in zip(_scan_paths(seq_j), _scan_paths(seq_t)):
        np.testing.assert_array_equal(png.read_png(str(pt)), png.read_png(str(pj)))
    for name in ("global_pose.csv", "gps.csv"):
        np.testing.assert_array_equal(np.loadtxt(seq_t / name, delimiter=","),
                                      np.loadtxt(seq_j / name, delimiter=","))


def test_make_sequence_main_matches_jax(tmp_path):
    """The writers' command lines, with a dropout, a stamp offset and GPS,
    write the same files."""
    argv = ["--scans", "2", "--radius", "8", "--dropout", "1:1", "--stamp_offset_s", "3",
            "--gps", "--seed", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jseq.main(["--out", str(tmp_path / "j"), *argv]) == 0
        assert tseq.main(["--out", str(tmp_path / "t"), *argv]) == 0
    paths_j, paths_t = _scan_paths(tmp_path / "j"), _scan_paths(tmp_path / "t")
    assert [p.name for p in paths_t] == [p.name for p in paths_j]
    for pj, pt in zip(paths_j, paths_t):
        np.testing.assert_array_equal(png.read_png(str(pt)), png.read_png(str(pj)))
    for name in ("global_pose.csv", "gps.csv"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


@pytest.mark.parametrize("raw_u8", [True, False], ids=["raw_u8", "float"])
def test_dataset_matches_jax(sequences, raw_u8):
    """``MulranRadarDataset`` and ``decode_polar_scan`` give the JAX reader's
    scans: power, per-ray stamps, azimuths, validity and scan stamps."""
    ds_j = jmulran.MulranRadarDataset(str(sequences[0]), JRadarConfig(), raw_u8=raw_u8)
    ds_t = tmulran.MulranRadarDataset(str(sequences[0]), RadarConfig(), raw_u8=raw_u8)
    assert len(ds_t) == len(ds_j) == N_SCANS and ds_t.scan_files == ds_j.scan_files
    for sj, st in zip(ds_j, ds_t):
        assert st.power.dtype == sj.power.dtype
        for field in ("power", "ray_timestamps", "azimuths", "valid"):
            np.testing.assert_array_equal(getattr(st, field), getattr(sj, field), field)
        assert st.timestamp == sj.timestamp
    # an image without the metadata columns: power only, evenly spread rays
    img = np.random.default_rng(0).integers(0, 256, (400, 3000), dtype=np.uint8)
    sj = jmulran.decode_polar_scan(img, JRadarConfig(), 5.0, raw_u8=raw_u8)
    st = tmulran.decode_polar_scan(img, RadarConfig(), 5.0, raw_u8=raw_u8)
    for field in ("power", "ray_timestamps", "azimuths", "valid"):
        np.testing.assert_array_equal(getattr(st, field), getattr(sj, field), field)


def test_csv_readers_match_jax(sequences, tmp_path):
    seq = sequences[0]
    for got, want in zip(tmulran.load_global_pose_csv(str(seq / "global_pose.csv")),
                         jmulran.load_global_pose_csv(str(seq / "global_pose.csv"))):
        np.testing.assert_array_equal(got, want)
    bad = tmp_path / "gps.csv"
    bad.write_text("# comment\nstamp,lat,lon,alt\n1600000000000000000,36.1,127.3,85.5\n"
                   "1600000000100000000,36.1\n1600000000200000000,36.1,127.3,nan\n"
                   "garbage,,\n1600000000300000000,36.2,127.4,86.0,0.1\n\n")
    for path in (bad, seq / "gps.csv"):
        got, want = tmulran.load_gps_csv(str(path)), jmulran.load_gps_csv(str(path))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


# -- metrics, eval and the TUM writer ------------------------------------------

def _trajectories(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0.5, 0.1, (n, 3)), axis=0)
    th = 0.4
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    est = gt.copy()
    est[:, :2] = gt[:, :2] @ rot.T + np.array([5.0, -3.0]) + rng.normal(0, 0.05, (n, 2))
    est[:, 2] += rng.normal(0, 0.01, n)
    return est, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    est, gt = _trajectories(seed)
    xy, gxy = est[:, :2], gt[:, :2]
    assert tmetrics.ate_rmse(xy, gxy) == jmetrics.ate_rmse(xy, gxy)
    assert tmetrics.ate_rmse(xy, gxy, align=False) == jmetrics.ate_rmse(xy, gxy, align=False)
    assert tmetrics.rte(est, gt, delta=7) == jmetrics.rte(est, gt, delta=7)
    assert tmetrics.relative_pose_error(xy, gxy) == jmetrics.relative_pose_error(xy, gxy)
    assert tmetrics.path_length(gxy) == jmetrics.path_length(gxy)
    for got, want in zip(tmetrics.align_se2(xy, gxy), jmetrics.align_se2(xy, gxy)):
        np.testing.assert_array_equal(got, want)
    # revisits: a lap of 40 keyframes twice over
    ang = np.linspace(0, 4 * np.pi, 80, endpoint=False)
    kf_xy = np.stack([10 * np.cos(ang), 10 * np.sin(ang)], axis=1)
    pairs = [(i, i + 40) for i in range(0, 40, 3 + seed)] + [(5, 9), (2, 60)]
    assert (tmetrics.loop_recall_precision(pairs, kf_xy, min_separation=30)
            == jmetrics.loop_recall_precision(pairs, kf_xy, min_separation=30))
    stats = dict(num_scans=9, num_keyframes=7, num_loops=2, ate_rmse=0.25, rte=0.5,
                 loop_recall=0.5, frames_per_sec=3.0, warmup_s=1.5)
    assert tmetrics.RunStats(**stats).summary() == jmetrics.RunStats(**stats).summary()


def _tum(path, t, xy, yaw):
    with open(path, "w") as f:
        for i in range(len(t)):
            f.write(f"{t[i]:.6f} {xy[i, 0]} {xy[i, 1]} 0 0 0 {np.sin(yaw[i] / 2)} "
                    f"{np.cos(yaw[i] / 2)}\n")


def _eval_json(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip())


def test_eval_main_and_tum_writer_match_jax(sequences, tmp_path):
    """``eval.main`` prints the JAX eval's JSON against a TUM and a MulRan
    ground truth; ``save_trajectory_tum`` writes the JAX writer's text."""
    est, gt = _trajectories(2)
    t = 1_600_000_000.0 + np.arange(len(gt)) * 0.25
    _tum(tmp_path / "est.txt", t, est[:, :2], est[:, 2])
    _tum(tmp_path / "gt.txt", t + 0.01, gt[:, :2], gt[:, 2])
    argv = ["--traj", str(tmp_path / "est.txt"), "--gt", str(tmp_path / "gt.txt"),
            "--rte_delta", "5"]
    out = _eval_json(teval.main, argv)
    assert out == _eval_json(jeval.main, argv) and out["pairs"] == len(gt)

    ts, poses = tmulran.load_global_pose_csv(str(sequences[0] / "global_pose.csv"))
    poses = poses.copy()
    poses[:, :2, 3] += np.random.default_rng(4).normal(0, 0.1, (len(poses), 2))
    tmulran.save_trajectory_tum(str(tmp_path / "t.txt"), ts, poses)
    jmulran.save_trajectory_tum(str(tmp_path / "j.txt"), ts, poses)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    argv = ["--traj", str(tmp_path / "t.txt"), "--gt", str(sequences[0] / "global_pose.csv"),
            "--rte_delta", "1"]
    assert _eval_json(teval.main, argv) == _eval_json(jeval.main, argv)


def test_map_plot_matches_jax(tmp_path):
    """``viz.save_map_plot`` draws the JAX plot: the same pixels."""
    from navtech_radar_slam_torch.models.slam import LoopEvent

    rng = np.random.default_rng(5)
    ang = np.linspace(0, 2 * np.pi, 30)
    traj = np.tile(np.eye(4), (30, 1, 1))
    traj[:, 0, 3], traj[:, 1, 3] = 10 * np.cos(ang), 10 * np.sin(ang)
    pts = rng.uniform(-15, 15, (500, 2))
    loops = [LoopEvent(2, 27, 0.2, 0.5, np.zeros(3))]
    for mod, name in ((tviz, "t.png"), (jviz, "j.png")):
        mod.save_map_plot(str(tmp_path / name), traj, pts, odometry_xy=traj[:, :2, 3] + 0.3,
                          loops=loops, title="circuit")
    got = cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_UNCHANGED)
    assert got is not None and got.shape[0] > 500
    np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))
