"""The port's native scan loader (``navtech_radar_slam_torch.runtime``)
against the port's Python decoder (``data/png.py::read_png`` +
``data/mulran.py::decode_polar_scan``) and the JAX package's native loader,
mirroring tests/test_runtime.py case for case, and the port's CLI on it.

Scans come from three writers: the port's ``write_png`` (filter 0 on every
row), OpenCV at an explicit compression level (adaptive row filters: on
these noise scans it picks all five) and ``filtered_png`` here, which
cycles the five filters row by row.

Every array is compared bit for bit, with one exception: in float mode the
JAX native loader multiplies the bytes by 1/255, where both Python decoders
and the port's native loader divide by 255, so its float power is held to
1 ulp (and the port's to the bytes / 255 exactly).
"""

import os
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from navtech_radar_slam_torch import cli as tcli
from navtech_radar_slam_torch import runtime
from navtech_radar_slam_torch.config import RadarConfig, SlamConfig
from navtech_radar_slam_torch.data.make_sequence import write_sequence
from navtech_radar_slam_torch.data.mulran import decode_polar_scan
from navtech_radar_slam_torch.data.png import SIGNATURE, _chunk, read_png, write_png
from navtech_radar_slam_torch.ops.kernels import build
from navtech_radar_slam_torch.runtime import NativeRadarLoader, decode_png_native
from navtech_radar_slam_torch.runtime import loader as loader_mod
from test_torch_slam import small_cfg
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = RadarConfig()
STAMP_US = 1_600_000_000_000_000
INVALID_ROWS = (7, 100)


@pytest.fixture(scope="module", autouse=True)
def native():
    """The port's library, built here from its source; a failed build fails
    every test of this file with the compiler's output."""
    assert runtime.native_available(), runtime.build_error()


@pytest.fixture(scope="module")
def jax_runtime():
    """The JAX package's native loader (its prebuilt library)."""
    from navtech_radar_slam_tpu import runtime as jrt

    if not jrt.native_available():
        pytest.skip("the JAX package's native loader is not built")
    return jrt


def mulran_image(rng, stamp_us=STAMP_US, width=None):
    """A polar scan in the oxford / MulRan form (11 meta columns, as
    tests/test_runtime.py writes it): (image, power); rows INVALID_ROWS
    carry validity 0."""
    na, nb = CFG.num_azimuths, CFG.num_range_bins
    img = np.zeros((na, CFG.meta_columns + nb), np.uint8)
    power = (rng.random((na, nb)) * 255).astype(np.uint8)
    img[:, CFG.meta_columns:] = power
    stamps = (stamp_us + 100 * np.arange(na)).astype("<i8")
    img[:, :8] = stamps.view(np.uint8).reshape(na, 8)
    enc = (np.arange(na) / na * 5600).astype("<u2")
    img[:, 8:10] = enc.view(np.uint8).reshape(na, 2)
    img[:, 10] = 255
    img[list(INVALID_ROWS), 10] = 0
    return img, power


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 greyscale image with row r under filter r % 5
    (None, Sub, Up, Average, Paeth)."""
    x = img.astype(np.int32)
    left = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft)]
    kinds = np.arange(len(x)) % 5
    rows = np.empty((len(x), x.shape[1] + 1), np.uint8)
    rows[:, 0] = kinds
    for k in range(5):
        rows[kinds == k, 1:] = ((x - preds[k]) % 256)[kinds == k]
    h, w = img.shape
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_scan(path, img, writer: str) -> str:
    path = str(path)
    if writer == "png":
        write_png(path, img)
    elif writer == "cv2":
        cv2 = pytest.importorskip("cv2")
        # an explicit level turns on libpng's adaptive filters (without
        # one OpenCV writes Sub on every row)
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, 3])
    else:
        with open(path, "wb") as f:
            f.write(filtered_png(img))
    return path


def row_filters(path) -> set:
    data = open(path, "rb").read()
    pos, idat = len(SIGNATURE), b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(CFG.num_azimuths, -1)[:, 0].tolist())


def python_decode(path, raw_u8):
    s = decode_polar_scan(read_png(path), CFG, 0.0, raw_u8=raw_u8)
    return s.power, s.ray_timestamps, s.azimuths, s.valid


def assert_same(got, want):
    for name, g, w in zip(("power", "timestamps", "azimuths", "valid"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


WRITERS = ("png", "cv2", "filters")


def test_writers_cover_the_row_filters(tmp_path, rng):
    img, _ = mulran_image(rng)
    assert row_filters(write_scan(tmp_path / "a.png", img, "png")) == {0}
    assert row_filters(write_scan(tmp_path / "b.png", img, "cv2")) == {0, 1, 2, 3, 4}
    assert row_filters(write_scan(tmp_path / "c.png", img, "filters")) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("raw_u8", [False, True], ids=["float", "raw_u8"])
@pytest.mark.parametrize("writer", WRITERS)
def test_native_decode_matches_python(tmp_path, rng, writer, raw_u8):
    img, power = mulran_image(rng)
    p = write_scan(tmp_path / f"{STAMP_US}.png", img, writer)
    got = decode_png_native(p, CFG, raw_u8=raw_u8)
    assert got[0].shape == (CFG.num_azimuths, CFG.padded_range_bins)
    assert_same(got, python_decode(p, raw_u8))
    want = power if raw_u8 else power.astype(np.float32) / 255
    np.testing.assert_array_equal(got[0][:, :CFG.num_range_bins], want)
    assert not got[0][:, CFG.num_range_bins:].any()
    assert abs(got[1][0] - STAMP_US * 1e-6) < 1e-3
    assert abs(got[1][10] - got[1][0] - 10 * 100e-6) < 1e-6
    assert got[3].sum() == CFG.num_azimuths - len(INVALID_ROWS)


@pytest.mark.parametrize("writer", WRITERS)
def test_native_matches_jax_loader(tmp_path, rng, writer, jax_runtime):
    """The port's native outputs against the JAX native loader's on one
    file: bytes, azimuths, validity and timestamps bit for bit."""
    from navtech_radar_slam_tpu.config import RadarConfig as JaxRadarConfig

    img, _ = mulran_image(rng)
    p = write_scan(tmp_path / f"{STAMP_US}.png", img, writer)
    jcfg = JaxRadarConfig()
    with_jax = next(jax_runtime.NativeRadarLoader([p], jcfg, raw_u8=True))
    ours = next(NativeRadarLoader([p], CFG, raw_u8=True))
    assert_same(ours, with_jax)
    assert_same(decode_png_native(p, CFG, raw_u8=True), with_jax)
    jf = jax_runtime.decode_png_native(p, jcfg)
    tf = decode_png_native(p, CFG)
    for name, g, w in zip(("timestamps", "azimuths", "valid"), tf[1:], jf[1:]):
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    np.testing.assert_array_equal(tf[0], ours[0].astype(np.float32) / 255)
    np.testing.assert_array_max_ulp(tf[0], jf[0], maxulp=1)


@pytest.mark.parametrize("writer", WRITERS)
def test_scan_without_metadata(tmp_path, rng, writer, jax_runtime):
    """An image no wider than num_range_bins is all power: centred
    azimuths, every ray valid, as both other decoders read it."""
    from navtech_radar_slam_tpu.config import RadarConfig as JaxRadarConfig

    img = (rng.random((CFG.num_azimuths, 300)) * 255).astype(np.uint8)
    p = write_scan(tmp_path / "1.png", img, writer)
    for raw_u8 in (False, True):
        assert_same(decode_png_native(p, CFG, raw_u8=raw_u8), python_decode(p, raw_u8))
    with_jax = next(jax_runtime.NativeRadarLoader([p], JaxRadarConfig(), raw_u8=True))
    assert_same(decode_png_native(p, CFG, raw_u8=True), with_jax)


@pytest.mark.parametrize("raw_u8", [False, True], ids=["float", "raw_u8"])
def test_prefetcher_order_and_content(tmp_path, rng, raw_u8):
    paths = []
    for i in range(6):
        img, _ = mulran_image(rng, stamp_us=STAMP_US + i)
        paths.append(write_scan(tmp_path / f"{STAMP_US + i}.png", img, WRITERS[i % 3]))
    loader = NativeRadarLoader(paths, CFG, num_workers=2, queue_capacity=3, raw_u8=raw_u8)
    assert len(loader) == 6
    got = list(loader)
    assert len(got) == 6
    for scan, p in zip(got, paths):
        assert_same(scan, python_decode(p, raw_u8))
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()


def test_prefetcher_under_contention(tmp_path, rng):
    """More workers than cores, a short switch interval and a queue of 2:
    every scan still arrives once, in order, with its own content."""
    img = (rng.random((CFG.num_azimuths, 64)) * 255).astype(np.uint8)
    paths = []
    for i in range(40):
        img[:, 0] = i
        paths.append(write_scan(tmp_path / f"{i:03d}.png", img, "png"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        result = []
        worker = threading.Thread(target=lambda: result.extend(
            int(s[0][0, 0]) for s in NativeRadarLoader(paths, CFG, num_workers=3 * os.cpu_count(),
                                                       queue_capacity=2, raw_u8=True)))
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert result == list(range(40))


def test_native_decode_missing_file(tmp_path):
    with pytest.raises(IOError) as e:
        decode_png_native("/nonexistent/scan.png", CFG)
    assert e.value.filename == "/nonexistent/scan.png"
    loader = NativeRadarLoader([str(tmp_path / "missing.png")], CFG)
    with pytest.raises(FileNotFoundError):
        next(loader)


def _png(width=20, height=400, depth=8, color=0, interlace=0, data=None, rows=None,
         end=True) -> bytes:
    if rows is None:
        rows = np.zeros((height, width + 1), np.uint8).tobytes()
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0,
                                          interlace)),
              _chunk(b"IDAT", zlib.compress(rows) if data is None else data)]
    return SIGNATURE + b"".join(chunks) + (_chunk(b"IEND", b"") if end else b"")


def _flip_crc(blob: bytes) -> bytes:
    b = bytearray(blob)
    b[len(SIGNATURE) + 8] ^= 0xFF      # a byte of IHDR's payload
    return bytes(b)


CORRUPT = {
    "header_only": b"\x89PNG\r\n\x1a\n" + b"\x00" * 64,
    "not_a_png": b"garbage bytes, not an image",
    "bad_crc": _flip_crc(_png()),
    "truncated": _png()[:60],
    "no_iend": _png(end=False),
    "rgb": _png(color=2),
    "depth_16": _png(depth=16),
    "interlaced": _png(interlace=1),
    "stream_cut": _png(data=zlib.compress(bytes(400 * 21))[:-8]),
    "too_much_data": _png(rows=bytes(401 * 21)),
    "too_little_data": _png(rows=bytes(399 * 21)),
    "unknown_filter": _png(rows=bytes([5] + [0] * 20) * 400),
    "wrong_row_count": _png(height=399, rows=bytes(399 * 21)),
}


@pytest.mark.parametrize("kind", list(CORRUPT))
def test_corrupt_files_are_rejected_as_by_python(tmp_path, kind):
    """Each file the Python decoder refuses, the native one refuses too,
    with an OSError naming the file, in both modes and in the loader."""
    p = tmp_path / f"{kind}.png"
    p.write_bytes(CORRUPT[kind])
    with pytest.raises(ValueError):
        python_decode(str(p), True)
    for raw_u8 in (False, True):
        with pytest.raises(IOError) as e:
            decode_png_native(str(p), CFG, raw_u8=raw_u8)
        assert e.value.filename == str(p)
        assert e.value.strerror
    with pytest.raises(IOError):
        next(NativeRadarLoader([str(p)], CFG))


def test_corrupt_scan_mid_sequence_raises(tmp_path, rng):
    """A bad scan in the middle of a sequence raises when its turn comes and
    names that file; the scans before it arrive, and it is not the end of
    the iteration (the JAX loader stops there, silently)."""
    paths = []
    for i in range(5):
        img, _ = mulran_image(rng, stamp_us=STAMP_US + i)
        paths.append(write_scan(tmp_path / f"{STAMP_US + i}.png", img, "png"))
    data = bytearray(open(paths[2], "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(paths[2], "wb").write(bytes(data))
    loader = NativeRadarLoader(paths, CFG, num_workers=2, queue_capacity=2, raw_u8=True)
    first = [next(loader), next(loader)]
    with pytest.raises(IOError) as e:
        next(loader)
    assert e.value.filename == paths[2] and "corrupt PNG chunk" in e.value.strerror
    rest = list(loader)
    assert len(first) + len(rest) == 4
    assert_same(rest[-1], python_decode(paths[4], True))


def test_uint8_feature_extraction_parity(tmp_path, rng):
    """Features from the raw uint8 scan (cast /255 where it runs) equal
    those from the float scan (tests/test_runtime.py:123)."""
    from navtech_radar_slam_torch.models.odometry import extract_scan_features

    img, _ = mulran_image(rng)
    p = write_scan(tmp_path / f"{STAMP_US}.png", img, "png")
    pu, _, az, _ = next(NativeRadarLoader([p], CFG, raw_u8=True))
    pf, _, _, _ = decode_png_native(p, CFG)
    cfg = SlamConfig()
    f_u8 = extract_scan_features(torch.as_tensor(pu), torch.as_tensor(az), cfg)
    f_f32 = extract_scan_features(torch.as_tensor(pf), torch.as_tensor(az), cfg)
    np.testing.assert_array_equal(f_u8.valid.numpy(), f_f32.valid.numpy())
    np.testing.assert_array_equal(f_u8.xy.numpy(), f_f32.xy.numpy())


def test_build_failure_is_reported(tmp_path, monkeypatch, capsys):
    """A source that does not compile: the library reports the compiler's
    output, ``native_available()`` is False with that reason, and the CLI's
    scan source says so on stderr and reads with the Python decoder."""
    bad = tmp_path / "bad.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    lib = build.NativeLibrary("bad", bad, loader_mod.gxx, loader_mod.GXX_FLAGS, ("-lz",),
                              lambda _: None)
    with pytest.raises(RuntimeError, match="error"):
        lib.load()
    assert "bad.cc" in lib.command
    monkeypatch.setattr(loader_mod, "LIBRARY", lib)
    monkeypatch.setattr(loader_mod, "_failure", None)
    assert not runtime.native_available()
    assert "error" in runtime.build_error()
    seq = tmp_path / "seq"
    seq.mkdir()
    p = write_scan(seq / f"{STAMP_US}.png", mulran_image(np.random.default_rng(0))[0], "png")
    args = tcli.parse_args(["--seq_dir", str(seq), "--save_plot", "false"])
    stream, n, kind = tcli.scan_stream(args, SlamConfig())
    assert (n, kind) == (1, "python")
    assert "error" in capsys.readouterr().err
    power, az, valid, ts = next(stream)
    want = python_decode(p, True)
    assert_same((power, az, valid), (want[0], want[2], want[3]))
    assert ts == STAMP_US * 1e-6


@pytest.mark.parametrize("mode", [[], ["--chunk", "3", "--prewarm", "false"]],
                         ids=["per_scan", "chunk3"])
def test_cli_native_and_python_loaders_agree(tmp_path, capsys, mode):
    """The CLI reads with the native loader by default and with the Python
    decoder under --no_native_loader; both runs give the same trajectory
    and map, bit for bit."""
    seq = tmp_path / "seq"
    write_sequence(str(seq), num_scans=6, radius=5.0, speed=6.0)
    (tmp_path / "cfg.json").write_text(small_cfg().to_json())
    out = {}
    for name, extra in (("native", []), ("python", ["--no_native_loader"])):
        argv = ["--seq_dir", str(seq), "--config", str(tmp_path / "cfg.json"), "--output_dir",
                str(tmp_path / name), "--save_plot", "false", "--live", "false",
                "--device", "cpu", *mode, *extra]
        assert tcli.main(argv) == 0
        assert f"6 scans, {name} loader" in capsys.readouterr().out
        out[name] = tmp_path / name
    for f in ("trajectory_tum.txt", "odometry_tum.txt", "map_points.csv"):
        assert (out["native"] / f).read_bytes() == (out["python"] / f).read_bytes(), f
