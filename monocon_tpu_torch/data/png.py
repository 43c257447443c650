"""PNG reading and writing without an image library.

The port's loader reads KITTI's ``image_2`` files with :func:`read_png`:
8-bit RGB or RGBA (the alpha is dropped), not interlaced. The result is the
RGB uint8 array that ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``
gives, bit for bit. Any other kind of PNG raises ``ValueError`` naming the
file.

The stream is inflated with the standard library's ``zlib``. The row
filters are undone by a small C function (``cpp/png_unfilter.cpp``, built
with g++ at its first use into the package's ``build/`` directory and
called through ``ctypes``): Average and Paeth depend on the pixel just
reconstructed to their left, so a numpy version would take a Python step
per byte. Both ``zlib`` and a ``ctypes`` call release the interpreter
lock, so the loader's threads decode files in parallel.

:func:`write_png` writes RGB or RGBA with one filter type on every row.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.native_build import GXX_FLAGS, build_library, gxx

SOURCE = Path(__file__).resolve().parent / "cpp" / "png_unfilter.cpp"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# IHDR colour types of 8-bit samples, by channel count.
_COLOR_TYPES = {2: 3, 6: 4}  # RGB, RGBA

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """Build if needed, then load the unfilter library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(SOURCE, gxx(), GXX_FLAGS)))
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64]
            lib.png_unfilter.restype = ctypes.c_int64
            _lib = lib
    return _lib


def read_png(path) -> np.ndarray:
    """The image at ``path`` as an (H, W, 3) RGB uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + length > len(data):
            raise ValueError(f"{path}: the {kind!r} chunk is cut short")
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, compression, method, interlace = header
    if (depth != 8 or color not in _COLOR_TYPES or compression != 0
            or method != 0 or interlace != 0):
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace "
            f"{interlace}: only 8-bit RGB or RGBA, not interlaced, is read")
    channels = _COLOR_TYPES[color]
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: image data ends early")
    out = np.empty((height, width, channels), np.uint8)
    bad = load().png_unfilter(raw.ctypes.data, out.ctypes.data, height,
                              stride, channels)
    if bad:
        raise ValueError(f"{path}: row {bad - 1} has an unknown filter type")
    return out if channels == 3 else np.ascontiguousarray(out[..., :3])


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, filter_type: int, bpp: int) -> np.ndarray:
    """Apply one PNG filter type to every row of (H, stride) uint8 pixels.
    Each filter predicts from the unfiltered neighbours, so this, unlike
    its inverse, is elementwise."""
    if filter_type not in range(5):
        raise ValueError(f"unknown PNG filter type {filter_type}")
    if filter_type == 0:
        return np.array(rows, np.uint8)
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]            # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                      # up
    if filter_type == 4:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]     # up-left
        predict = _paeth(a, b, c)
    else:
        predict = {1: a, 2: b, 3: (a + b) >> 1}[filter_type]
    return ((x - predict) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, image: np.ndarray, filter_type: int = 0) -> None:
    """Write an (H, W, 3) RGB or (H, W, 4) RGBA uint8 image, every row
    filtered with ``filter_type`` (0 None ... 4 Paeth). The type is a
    parameter so that the reader can be tested on each."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"want an (H, W, 3|4) uint8 image, got {image.dtype} "
                         f"{image.shape}")
    h, w, ch = image.shape
    color = {v: k for k, v in _COLOR_TYPES.items()}[ch]
    rows = filter_rows(image.reshape(h, w * ch), filter_type, ch)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], 1)
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                              0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + _chunk(b"IEND", b""))
