"""RGB <-> HSV on float32 images without OpenCV.

:func:`rgb_to_hsv` and :func:`hsv_to_rgb` are numpy versions of OpenCV's
``cvtColor`` with ``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB`` on float32 images
(H in degrees, S and V unscaled), which the JAX package's
``PhotometricDistortion`` calls. They follow OpenCV's formulas on any input
range, so that the values outside [0, 255] that brightness and contrast
jitter make convert as they do there.

The training loader converts with :func:`rgb_to_hsv_` and
:func:`hsv_to_rgb_`: the same arithmetic in C (``cpp/hsv.cpp``, built with
g++ at its first use and called through ``ctypes``, which releases the
interpreter lock), in place and in one pass over the pixels. The numpy
versions make a dozen passes over strided channel views. The two give the
same bits.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.native_build import GXX_FLAGS, build_library, gxx

SOURCE = Path(__file__).resolve().parent / "cpp" / "hsv.cpp"
FLT_EPSILON = np.finfo(np.float32).eps
# OpenCV's HSV -> RGB table (color_hsv.simd.hpp, ``sector_data``): for each
# hue sector, which of tab = (v, v(1-s), v(1-sf), v(1-s(1-f))) is b, g, r.
_SECTOR_BGR = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))
# tab[k] = v * (1 - s * (A[k] + B[k] * f)); per output channel (r, g, b)
# and sector, the A and B of its tab entry.
_A, _B = (0, 1, 0, 1), (0, 0, 1, -1)
_TAB_A = np.array([[_A[row[k]] for row in _SECTOR_BGR] for k in (2, 1, 0)],
                  np.float32)
_TAB_B = np.array([[_B[row[k]] for row in _SECTOR_BGR] for k in (2, 1, 0)],
                  np.float32)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """OpenCV's ``cvtColor(img, COLOR_RGB2HSV)`` on a float32 (H, W, 3)
    image: V = max, S = (max - min) / (|max| + FLT_EPSILON), H in degrees
    from the channel that holds the max (r first, then g), +360 below 0."""
    img = np.asarray(img, np.float32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    out = np.empty_like(img)
    np.divide(diff, np.abs(v) + FLT_EPSILON, out=out[..., 1])
    # OpenCV takes 60 / (diff + eps) in double and rounds it to float: the
    # same bits as the float32 quotient (double has more than 2 x 24 + 2
    # bits, so rounding twice is innocuous for a division).
    scale = np.float32(60) / (diff + FLT_EPSILON)
    at_r, at_g = v == r, v == g
    h = r - g
    offset = np.full(h.shape, 240, np.float32)
    np.subtract(b, r, out=h, where=at_g)
    offset[at_g] = 120
    np.subtract(g, b, out=h, where=at_r)
    offset[at_r] = 0
    h *= scale
    h += offset
    np.add(h, np.float32(360), out=h, where=h < 0)
    out[..., 0] = h
    out[..., 2] = v
    return out


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """OpenCV's ``cvtColor(img, COLOR_HSV2RGB)`` on a float32 (H, W, 3)
    image, H in degrees: h * 6/360 wrapped into [0, 6), sector = floor(h),
    f = h - sector, and each channel one of tab = (v, v(1-s), v(1-sf),
    v(1-s(1-f))) by the sector. At s == 0 all four are v: gray."""
    img = np.asarray(img, np.float32)
    s, v = img[..., 1], img[..., 2]
    h = np.fmod(img[..., 0] * (np.float32(6) / np.float32(360)), np.float32(6))
    np.add(h, np.float32(6), out=h, where=h < 0)
    sector = np.floor(h)
    h -= sector
    sector = sector.astype(np.int8)
    wrapped = sector >= 6
    sector[wrapped] = 0
    h[wrapped] = 0
    out = np.empty_like(img)
    for c in range(3):
        # tab[k] = v * (1 - s * w) with w = a + b * f in (0, 1, f, 1 - f):
        # each w and each product is exact, so these are tab's bits.
        w = _TAB_A[c][sector]
        w += _TAB_B[c][sector] * h
        w *= s
        np.subtract(np.float32(1), w, out=w)
        np.multiply(v, w, out=out[..., c])
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the HSV library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(SOURCE, gxx(), GXX_FLAGS)))
            for name in ("rgb_to_hsv_f32", "hsv_to_rgb_f32"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
                fn.restype = None
            _lib = lib
    return _lib


def _check(img: np.ndarray) -> None:
    if (img.dtype != np.float32 or img.shape[-1:] != (3,)
            or not img.flags.c_contiguous or not img.flags.writeable):
        raise ValueError(f"want a writeable C-contiguous float32 (..., 3) "
                         f"array, got {img.dtype} {img.shape}")


def rgb_to_hsv_(img: np.ndarray) -> np.ndarray:
    """:func:`rgb_to_hsv` in place, in C; returns ``img``."""
    _check(img)
    load().rgb_to_hsv_f32(img.ctypes.data, img.size // 3)
    return img


def hsv_to_rgb_(img: np.ndarray) -> np.ndarray:
    """:func:`hsv_to_rgb` in place, in C; returns ``img``."""
    _check(img)
    load().hsv_to_rgb_f32(img.ctypes.data, img.size // 3)
    return img
