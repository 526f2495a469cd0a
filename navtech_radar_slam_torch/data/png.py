"""8-bit greyscale PNG reading and writing on ``zlib`` and numpy.

The MulRan polar scans are 8-bit greyscale PNGs (400 rows × 3371 columns).
The JAX package reads and writes them with OpenCV, which the port does not
need: ``decode_png`` inflates the IDAT stream and undoes the five PNG row
filters (None, Sub and Up vectorised over the row, Average and Paeth pixel
by pixel, since each output depends on its left neighbour through a
non-linear predictor); ``encode_png`` writes filter 0 (None) on every row.
``decode_png`` verifies every chunk's CRC and raises ``ValueError`` on any
file that is not an 8-bit greyscale, non-interlaced PNG.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs verified."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _unfilter_slow(kind: int, row: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Average (3) or Paeth (4) on one row of one byte per pixel."""
    raw = row.tolist()
    above = up.tolist()
    out = [0] * len(raw)
    left = upleft = 0
    for i, (x, b) in enumerate(zip(raw, above)):
        if kind == 3:
            v = (x + ((left + b) >> 1)) & 0xFF
        else:
            p = left + b - upleft
            pa, pb, pc = abs(p - left), abs(p - b), abs(p - upleft)
            pred = left if pa <= pb and pa <= pc else (b if pb <= pc else upleft)
            v = (x + pred) & 0xFF
        out[i] = v
        left, upleft = v, b
    return np.asarray(out, np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (height, width) uint8.  Only 8-bit greyscale,
    non-interlaced images are read; anything else raises ValueError."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, color, compression, filt, interlace = header
    if depth != 8 or color != 0:
        raise ValueError(f"{path}: only 8-bit greyscale PNGs are read (bit depth {depth}, "
                         f"colour type {color})")
    if interlace != 0 or compression != 0 or filt != 0:
        raise ValueError(f"{path}: only non-interlaced PNGs are read (interlace "
                         f"{interlace}, compression {compression}, filter method {filt})")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    if raw.size != height * (width + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {height} rows of "
                         f"{width} pixels")
    rows = raw.reshape(height, width + 1)
    kinds = rows[:, 0]
    if int(kinds.max(initial=0)) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(kinds.max())}")
    img = np.empty((height, width), np.uint8)
    up = np.zeros(width, np.uint8)
    for r in range(height):
        kind, row = int(kinds[r]), rows[r, 1:]
        if kind == 0:
            img[r] = row
        elif kind == 1:
            np.cumsum(row, dtype=np.uint8, out=img[r])        # wraps mod 256
        elif kind == 2:
            np.add(row, up, out=img[r])                       # wraps mod 256
        else:
            img[r] = _unfilter_slow(kind, row, up)
        up = img[r]
    return img


def read_png(path: str) -> np.ndarray:
    """The 8-bit greyscale PNG at ``path`` as (height, width) uint8."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(img: np.ndarray) -> bytes:
    """(height, width) uint8 -> PNG bytes: 8-bit greyscale, filter 0 on
    every row, the image data deflated at zlib's default level."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"encode_png takes a 2-D uint8 image, got {img.dtype} {img.shape}")
    height, width = img.shape
    rows = np.zeros((height, width + 1), np.uint8)
    rows[:, 1:] = img
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
