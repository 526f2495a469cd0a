"""ctypes binding of the native scan loader (``runtime/src/radar_loader.cc``).

The library decodes MulRan polar PNGs and prefetches them in order on
worker threads, so the consumer only copies a ready scan out: the host
side of the reference's C++ file-reading front end.  It decodes with zlib
alone and reads exactly the files the port's Python decoder
(``data/png.py``) reads, 8-bit greyscale and non-interlaced, and gives the
same arrays as ``data/mulran.py::decode_polar_scan`` bit for bit.

It is built at first use with the host compiler (``g++ -O3 -Wall -fPIC
-std=c++17 -pthread -shared ... -lz``) into the git-ignored
``navtech_radar_slam_torch/_build/`` by ``ops.kernels.build.NativeLibrary``.
``native_available()`` is False only when that build or the load failed,
and ``build_error()`` then gives the compiler's reason; callers (the CLI)
read with the Python decoder instead.

A scan that cannot be read or decoded raises ``OSError`` (``IOError``)
with the file as its ``filename``, from ``decode_png_native`` and from
``NativeRadarLoader``'s iteration alike: a bad scan in the middle of a
sequence is an error, never its end.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from navtech_radar_slam_torch.config import RadarConfig
from navtech_radar_slam_torch.ops.kernels.build import NativeLibrary

GXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-pthread", "-shared")
_SOURCE = Path(__file__).resolve().parent / "src" / "radar_loader.cc"
_ERR_CAP = 512

Scan = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found")
    return found


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    create = [c.POINTER(c.c_char_p)] + [c.c_int] * 7
    for name in ("radar_loader_create", "radar_loader_create_u8"):
        getattr(lib, name).restype = c.c_void_p
        getattr(lib, name).argtypes = create
    # handle, power, timestamps, azimuths, valid, index_out, err, err_cap
    nxt = [c.c_void_p] * 5 + [c.POINTER(c.c_int64), c.c_char_p, c.c_int]
    for name in ("radar_loader_next", "radar_loader_next_u8"):
        getattr(lib, name).restype = c.c_int
        getattr(lib, name).argtypes = nxt
    lib.radar_loader_destroy.restype = None
    lib.radar_loader_destroy.argtypes = [c.c_void_p]
    # path, num_azimuths, num_range_bins, padded_range_bins, meta_columns,
    # power, timestamps, azimuths, valid, err, err_cap
    decode = [c.c_char_p] + [c.c_int] * 4 + [c.c_void_p] * 4 + [c.c_char_p, c.c_int]
    for name in ("radar_decode_png", "radar_decode_png_u8"):
        getattr(lib, name).restype = c.c_int
        getattr(lib, name).argtypes = decode


LIBRARY = NativeLibrary("radar_loader", _SOURCE, gxx, GXX_FLAGS, ("-lz",), _bind)
_lock = threading.Lock()
_failure: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    """The built and bound library, or None when its build or load failed
    (the reason in ``_failure``; a failure is not retried)."""
    global _failure
    with _lock:
        if _failure is None:
            try:
                return LIBRARY.load()
            except (RuntimeError, OSError) as e:
                _failure = str(e)
        return None


def native_available() -> bool:
    """Whether the library builds and loads here (builds it on first call)."""
    return _load() is not None


def build_error() -> str:
    """Why the library could not be built or loaded ("" when it was)."""
    _load()
    return _failure or ""


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_failure}")
    return lib


def _alloc(cfg: RadarConfig, raw_u8: bool) -> Scan:
    na, pb = cfg.num_azimuths, cfg.padded_range_bins
    return (np.empty((na, pb), np.uint8 if raw_u8 else np.float32),
            np.empty((na,), np.float64), np.empty((na,), np.float32),
            np.empty((na,), np.uint8))


def _ptrs(bufs: Scan) -> list:
    return [b.ctypes.data for b in bufs]


def _raise(rc: int, err: ctypes.Array, path: str) -> None:
    reason = err.value.decode(errors="replace") or os.strerror(rc)
    raise OSError(rc, reason, path)


def decode_png_native(path: str, cfg: Optional[RadarConfig] = None,
                      raw_u8: bool = False) -> Scan:
    """One scan decoded without the prefetcher: (power (NA, NBp) float32 in
    [0, 1] or, with ``raw_u8``, the raw bytes; ray timestamps (NA,) float64
    s; azimuths (NA,) float32 rad; valid (NA,) bool).  Raises ``OSError``
    naming the file when it cannot be read or decoded."""
    cfg = cfg or RadarConfig()
    lib = _library()
    bufs = _alloc(cfg, raw_u8)
    err = ctypes.create_string_buffer(_ERR_CAP)
    fn = lib.radar_decode_png_u8 if raw_u8 else lib.radar_decode_png
    rc = fn(os.fsencode(path), cfg.num_azimuths, cfg.num_range_bins, cfg.padded_range_bins,
            cfg.meta_columns, *_ptrs(bufs), err, _ERR_CAP)
    if rc != 0:
        _raise(rc, err, os.fspath(path))
    power, ts, az, valid = bufs
    return power, ts, az, valid.astype(bool)


class NativeRadarLoader:
    """Iterator over the scans at ``paths``, in order, decoded ahead on
    ``num_workers`` threads with at most ``queue_capacity`` scans decoded
    or in decode ahead of the consumer.  Yields ``decode_png_native``'s
    tuple per scan; ``raw_u8=True`` yields the raw PNG bytes as power (the
    device casts /255: a quarter of the float upload).  A scan that cannot
    be read or decoded raises ``OSError`` naming its file when its turn
    comes; iteration may go on after it with the next scan."""

    def __init__(self, paths: Sequence[str], cfg: Optional[RadarConfig] = None,
                 num_workers: int = 2, queue_capacity: int = 8, raw_u8: bool = False):
        self._handle = None
        if num_workers < 1 or queue_capacity < 1:
            raise ValueError(f"num_workers ({num_workers}) and queue_capacity "
                             f"({queue_capacity}) must be at least 1")
        self.cfg = cfg or RadarConfig()
        self.raw_u8 = bool(raw_u8)
        self.paths: List[str] = [os.fspath(p) for p in paths]
        self._lib = _library()
        arr = (ctypes.c_char_p * len(self.paths))(*[os.fsencode(p) for p in self.paths])
        create = (self._lib.radar_loader_create_u8 if self.raw_u8
                  else self._lib.radar_loader_create)
        handle = create(arr, len(self.paths), self.cfg.num_azimuths, self.cfg.num_range_bins,
                        self.cfg.padded_range_bins, self.cfg.meta_columns, num_workers,
                        queue_capacity)
        if not handle:
            raise RuntimeError("failed to create the native loader")
        self._handle = handle
        self._consumed = 0

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self):
        return self

    def __next__(self) -> Scan:
        if self._handle is None or self._consumed >= len(self.paths):
            raise StopIteration
        bufs = _alloc(self.cfg, self.raw_u8)
        idx = ctypes.c_int64(-1)
        err = ctypes.create_string_buffer(_ERR_CAP)
        fn = self._lib.radar_loader_next_u8 if self.raw_u8 else self._lib.radar_loader_next
        rc = fn(self._handle, *_ptrs(bufs), ctypes.byref(idx), err, _ERR_CAP)
        if rc == -1:
            raise StopIteration
        self._consumed += 1
        if rc != 0:
            _raise(rc, err, self.paths[idx.value])
        power, ts, az, valid = bufs
        return power, ts, az, valid.astype(bool)

    def close(self) -> None:
        """Stop the workers and free the scans decoded ahead."""
        if self._handle is not None:
            self._lib.radar_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
