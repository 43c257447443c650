"""The OpenCV drawing primitives of the visualizer, in numpy.

The card's machine has no OpenCV, so the port draws what
``monocon_tpu/utils/visualizer.py`` draws with ``cv2`` itself:

  * :func:`line`: ``cv2.line(img, p, q, color, 2, cv2.LINE_AA)``;
  * :func:`circle`: ``cv2.circle(img, c, r, color, 2, cv2.LINE_AA)``;
  * :func:`rectangle`: ``cv2.rectangle`` outlined (thickness 2, LINE_AA) or
    filled (thickness -1, LINE_8);
  * :func:`fill_poly`: ``cv2.drawContours(img, [pts], -1, color, -1,
    cv2.LINE_AA)``, a filled polygon with an anti-aliased edge;
  * :func:`add_weighted`: ``cv2.addWeighted``, float32 weights, rounded
    half to even and saturated;
  * :func:`box_points`: ``cv2.boxPoints``.

Each follows OpenCV's own integer algorithm (``drawing.cpp``): a thick
line is the quadrilateral of its two endpoints offset by half the
thickness in 16-bit fixed point, filled by ``FillConvexPoly``'s edge walk,
plus a filled diamond of radius 1 at each end (``EllipseEx``), and
``cv2.line`` first clips its ends to the image grown by the thickness; a
circle is the polyline through ``ellipse2Poly``'s points; a filled polygon
is ``FillEdgeCollection``'s even-odd spans. Every edge is blended with
``LineAA``: its pixels, its slope and filter tables and its end
corrections, and the integer blend ``c += ((color - c) * a + 127) >> 8``
twice per pixel, in OpenCV's order. On random primitives the result is
OpenCV's bit for bit, but for a pixel of a circle now and then (the sine
table's last digits).

Costs are bounded by the pixels a primitive covers inside the canvas: a
segment is clipped to the canvas before its pixels are listed, and a fill
walks only the rows inside the canvas, so coordinates far outside the
image (random weights, boxes behind the camera) cost nothing extra.
Non-finite coordinates draw nothing; int32-extreme ones draw without
raising (OpenCV's own fixed-point arithmetic overflows there, so no
parity is claimed for them).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# Beyond this many pixels from the canvas, fixed-point products may pass
# int64; such shapes are walked in float64 (no parity with OpenCV).
_EXACT_LIMIT = 1 << 24
# Line ends are clipped to this before their int64 cast, so that it cannot
# wrap (OpenCV takes int32 points only: no parity is lost).
_INT_LIMIT = float(1 << 60)

# OpenCV's ``LineAA`` tables (drawing.cpp): the weight of a line's pixel
# by slope (1/32 steps up to 45 degrees) and by the line's distance from
# the pixel (1/32 px steps over the three pixels across it).
_SLOPE_CORR = np.array([
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196,
    198, 201, 203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238,
    242, 246, 250, 254], np.int64)
_FILTER = np.array([
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7,
    5, 5], np.int64)
# sin of whole degrees 0..450 in float32, as OpenCV's SinTable holds them.
_SIN = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(
    np.float32).astype(np.float64)


# ------------------------------------------------------------------ pixels
def _clip_lines(size, x1, y1, x2, y2):
    """OpenCV's ``clipLine`` of each segment to the (w, h) box [0, w-1] x
    [0, h-1], vectorised: ends outside move onto the border along the
    line, offsets computed in double and truncated toward zero. Returns
    (visible, x1, y1, x2, y2), int64."""
    right, bottom = size[0] - 1, size[1] - 1
    x1, y1, x2, y2 = (np.array(v, np.int64) for v in (x1, y1, x2, y2))

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4
                + (y > bottom) * 8).astype(np.int64)

    def moved(a, b0, db, da):
        with np.errstate(all="ignore"):
            return np.trunc((a - b0).astype(np.float64) * db.astype(np.float64)
                            / da.astype(np.float64)).astype(np.int64)

    c1, c2 = code(x1, y1), code(x2, y2)
    clip = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = clip & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(m, x1 + moved(a, y1, x2 - x1, y2 - y1), x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, (x1 < 0) + (x1 > right) * 2, c1)
    m = clip & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(m, x2 + moved(a, y2, x2 - x1, y2 - y1), x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, (x2 < 0) + (x2 > right) * 2, c2)
    clip &= ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = clip & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(m, y1 + moved(a, x1, y2 - y1, x2 - x1), y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = clip & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(m, y2 + moved(a, x2, y2 - y1, x2 - x1), y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def _trunc_div(a, b):
    """C's integer division, truncating toward zero."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def _segments_ink(p, q, shape) -> Tuple[np.ndarray, np.ndarray]:
    """(flat pixel indices, weights 0..255) of OpenCV's one-pixel
    anti-aliased lines (``LineAA``) from ``p[k]`` to ``q[k]`` ((n, 2)
    16-bit fixed point), in OpenCV's integer arithmetic: each clipped to
    the image, walked along its major axis from the first pixel to one
    past the last, three pixels across weighed by the slope and the
    line's sub-pixel position, the first and last two dimmed. In the
    order OpenCV blends them: line by line, step by step."""
    h, w = shape
    none = np.zeros(0, np.int64), np.zeros(0, np.int64)
    p, q = np.asarray(p, np.int64).reshape(-1, 2), np.asarray(
        q, np.int64).reshape(-1, 2)
    ok, x1, y1, x2, y2 = _clip_lines((w << XY_SHIFT, h << XY_SHIFT),
                                     p[:, 0], p[:, 1], q[:, 0], q[:, 1])
    if not ok.any():
        return none
    x1, y1, x2, y2 = x1[ok], y1[ok], x2[ok], y2[ok]
    dx, dy = x2 - x1, y2 - y1
    xmajor = np.abs(dx) > np.abs(dy)
    # Major (m) and minor (n) coordinates, the major one increasing.
    flip = np.where(xmajor, dx < 0, dy < 0)
    m1, n1 = np.where(xmajor, x1, y1), np.where(xmajor, y1, x1)
    m2, n2 = np.where(xmajor, x2, y2), np.where(xmajor, y2, x2)
    m1, m2 = np.where(flip, m2, m1), np.where(flip, m1, m2)
    n1, n2 = np.where(flip, n2, n1), np.where(flip, n1, n2)
    step = _trunc_div((n2 - n1) << XY_SHIFT, np.abs(m2 - m1) | 1)
    m2 = m2 + XY_ONE
    ecount = (m2 >> XY_SHIFT) - (m1 >> XY_SHIFT)
    n1 = n1 + ((step * -(m1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
    slope = (step >> (XY_SHIFT - 5)) & 0x3F
    slope ^= np.where(step < 0, 0x3F, 0)
    slope = np.where(slope & 0x20, 0x100, _SLOPE_CORR[slope & 0x1F])
    i, j = (m1 >> (XY_SHIFT - 7)) & 0x78, (m2 >> (XY_SHIFT - 7)) & 0x78
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    ends = np.stack([
        np.zeros_like(slope), ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF,
        (t1 >> 8) & 0x1FF, ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF,
        ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF,
        ((t1 + t0) >> 8) & 0x1FF, (t2 >> 8) & 0x1FF, ((t2 + t0) >> 8) & 0x1FF,
        slope], 1)
    counts = ecount + 1
    seg = np.repeat(np.arange(len(counts)), counts)
    k = np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)
    major = (m1[seg] >> XY_SHIFT) + k
    acc = n1[seg] + k * step[seg]
    left = ecount[seg] - k
    row = (((k >= 2) + 1) & (k | 2)) * 3 + (((left >= 2) + 1) & (left | 2))
    corr = ends[seg, row]
    dist = (acc >> (XY_SHIFT - 5)) & 31
    minor = (acc >> XY_SHIFT)[:, None] + np.arange(-1, 2)
    weight = (corr[:, None] * np.stack(
        [_FILTER[dist + 32], _FILTER[dist], _FILTER[63 - dist]], 1)
        >> 8) & 0xFF
    xm = np.broadcast_to(xmajor[seg][:, None], minor.shape)
    major = np.broadcast_to(major[:, None], minor.shape)
    xs, ys = np.where(xm, major, minor), np.where(xm, minor, major)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    return (ys * w + xs)[inside], weight[inside]


def _blend(flat: np.ndarray, idx: np.ndarray, weight: np.ndarray,
           color: np.ndarray) -> None:
    """Blend ``color`` into the pixels ``idx`` of ``flat`` ((N, C) uint8)
    as ``LineAA`` does, in order, in integers: for each weight a (0..255)
    twice ``c += ((color - c) a + 127) >> 8``."""
    if not len(idx):
        return
    order = np.argsort(idx, kind="stable")
    idx, weight = idx[order], weight[order].astype(np.int64)[:, None]
    starts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
    rank = np.arange(len(idx)) - np.repeat(starts, np.diff(np.r_[starts,
                                                                 len(idx)]))
    color = color.astype(np.int64)
    # Every pixel's r-th blend at once, for r = 0, 1, ...: the blends
    # grouped by rank, each group a run of by_rank.
    by_rank = np.argsort(rank, kind="stable")
    bounds = np.r_[0, np.cumsum(np.bincount(rank))]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sel = by_rank[lo:hi]
        pixels, a = idx[sel], weight[sel]
        c = flat[pixels].astype(np.int64)
        c += ((color - c) * a + 127) >> 8
        c += ((color - c) * a + 127) >> 8
        flat[pixels] = c


class _Canvas:
    """What one OpenCV call does to an image: the anti-aliased edges to
    blend (segments in 16-bit fixed point, in OpenCV's order) and the
    interior spans to fill (rows, first and last column). Blends onto a
    filled pixel leave it as it is, so painting all blends and then all
    fills gives OpenCV's interleaved order's result."""

    def __init__(self, shape):
        self.shape = shape
        self.p, self.q, self.spans = [], [], []

    def edges(self, p, q) -> None:
        self.p.append(np.asarray(p, np.int64).reshape(-1, 2))
        self.q.append(np.asarray(q, np.int64).reshape(-1, 2))

    def paint(self, img: np.ndarray, color) -> np.ndarray:
        h, w = self.shape
        flat = img.reshape(-1, img.shape[2])
        color = np.asarray(color, np.float64)[: img.shape[2]]
        if self.p:
            _blend(flat, *_segments_ink(np.concatenate(self.p),
                                        np.concatenate(self.q), self.shape),
                   np.rint(color))
        if self.spans:
            ys, x0, x1 = (np.concatenate(c) for c in zip(*self.spans))
            lengths = x1 - x0 + 1
            starts = np.cumsum(lengths) - lengths
            idx = (np.repeat(ys * w + x0 - starts, lengths)
                   + np.arange(int(lengths.sum())))
            flat[idx] = np.asarray(np.rint(color), img.dtype)
        return img


def _spans(rows, x1, x2, w):
    """The rows' spans clipped to the canvas, as arrays."""
    ok = (x2 >= 0) & (x1 < w)
    x1, x2 = np.maximum(x1[ok], 0), np.minimum(x2[ok], w - 1)
    rows = rows[ok]
    keep = x1 <= x2
    return (rows[keep].astype(np.int64), x1[keep].astype(np.int64),
            x2[keep].astype(np.int64))


# ------------------------------------------------------------------ fills
def _fill_convex_spans(v, shape):
    """Row spans (rows, first, last column) of OpenCV's ``FillConvexPoly``
    interior (anti-aliased mode) of the convex polygon ``v``, (n, 2) int64
    in 16-bit fixed point: the edge walk that starts each edge at its
    vertex's x on the row its y rounds to, steps x by the rounded slope per
    row, and fills from the ceiling of the left x to the floor of the
    right x; rows outside the canvas are skipped, not walked."""
    h, w = shape
    n = len(v)
    vx = [int(x) for x in v[:, 0]]
    vy = [int(y) for y in v[:, 1]]
    half = XY_ONE >> 1
    imin = int(np.argmin(vy))
    ymin = (vy[imin] + half) >> XY_SHIFT
    ymax = (max(vy) + half) >> XY_SHIFT
    xmin = (min(vx) + half) >> XY_SHIFT
    xmax = (max(vx) + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return None
    ymax = min(ymax, h - 1)
    # Per edge of the walk: [x, dx, ye, idx, di].
    walk = [[-XY_ONE, 0, ymin, imin, 1], [-XY_ONE, 0, ymin, imin, n - 1]]
    edges = n
    out = []
    y = ymin
    while y <= ymax:
        if y < ymax or y == ymin:
            for e in walk:
                if y < e[2]:
                    continue
                idx0 = e[3]
                idx = (idx0 + e[4]) % n
                while True:
                    if edges <= 0:
                        edges -= 1
                        break
                    edges -= 1
                    ty = (vy[idx] + half) >> XY_SHIFT
                    if ty > y:
                        num = (vx[idx] - vx[idx0]) * 2 + (ty - y)
                        den = 2 * (ty - y)
                        e[0], e[2], e[3] = vx[idx0], ty, idx
                        e[1] = abs(num) // den * (1 if num >= 0 else -1)
                        break
                    idx0 = idx
                    idx = (idx + e[4]) % n
        if edges < 0:
            break
        # The rows until the next edge change (none on the last row) step
        # both edges' x by their slopes.
        next_change = min(walk[0][2], walk[1][2])
        stop = next_change if y < next_change < ymax else ymax + 1
        first, last = max(y, 0), min(stop - 1, h - 1)
        if first <= last:
            rows = np.arange(first, last + 1)
            xa = walk[0][0] + (rows - y) * walk[0][1]
            xb = walk[1][0] + (rows - y) * walk[1][1]
            out.append(_spans(rows,
                              (np.minimum(xa, xb) + XY_ONE - 1) >> XY_SHIFT,
                              np.maximum(xa, xb) >> XY_SHIFT, w))
        for e in walk:
            e[0] += (stop - y) * e[1]
        y = stop
    if not out:
        return None
    return tuple(np.concatenate(c) for c in zip(*out))


def _fill_poly_spans(pts, shape):
    """Row spans of OpenCV's ``FillEdgeCollection`` (anti-aliased mode) of
    the polygon ``pts`` ((n, 2) integer pixels): each edge is active on the
    rows from its upper vertex to before its lower one, its x stepped by
    the truncated fixed-point slope, and the spans run between pairs of
    edges in x order (even-odd), from the ceiling of the left x to the
    floor of the right."""
    h, w = shape
    rows, xs = [], []
    n = len(pts)
    for i in range(n):
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        if y0 == y1:
            continue
        if y0 > y1:
            x0, y0, x1, y1 = x1, y1, x0, y0
        fx0, fx1 = x0 << XY_SHIFT, x1 << XY_SHIFT
        dx = abs(fx1 - fx0) // (y1 - y0) * (1 if fx1 >= fx0 else -1)
        first, last = max(y0, 0), min(y1, h) - 1
        if first > last:
            continue
        r = np.arange(first, last + 1)
        rows.append(r)
        xs.append(fx0 + (r - y0).astype(np.int64) * dx)
    if not rows:
        return None
    rows, xs = np.concatenate(rows), np.concatenate(xs)
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    # Pair the edges of each row in x order: 1st-2nd, 3rd-4th, ...
    rank = np.arange(len(rows)) - np.searchsorted(rows, rows)
    left = np.flatnonzero((rank % 2 == 0)[:-1] & (rows[1:] == rows[:-1]))
    return _spans(rows[left], (xs[left] + XY_ONE - 1) >> XY_SHIFT,
                  xs[left + 1] >> XY_SHIFT, w)


# ------------------------------------------------------------------ shapes
def _fixed(points) -> np.ndarray:
    return np.asarray(points, np.int64) << XY_SHIFT


def _too_far(v) -> bool:
    return bool(np.abs(v).max() >= (_EXACT_LIMIT << XY_SHIFT))


def _convex_outline(v, canvas: _Canvas) -> None:
    """OpenCV's anti-aliased ``FillConvexPoly`` of ``v`` (fixed point):
    the ink of its edges, then its interior."""
    prev = np.roll(v, 1, 0)
    canvas.edges(prev, v)
    if not _too_far(v):
        spans = _fill_convex_spans(v, canvas.shape)
        if spans is not None:
            canvas.spans.append(spans)


# The filled ellipse of radius 1 (fixed point) that OpenCV puts at a thick
# line's ends: ``ellipse2Poly`` at 90-degree steps, closed.
_DIAMOND = np.array([(XY_ONE, 0), (0, XY_ONE), (-XY_ONE, 0), (0, -XY_ONE),
                     (XY_ONE, 0)], np.int64)


def _diamond_spans():
    """The interior spans of ``_DIAMOND`` around pixel (0, 0)."""
    canvas = _Canvas((5, 5))
    _convex_outline(_fixed((2, 2)) + _DIAMOND, canvas)
    rows, x0, x1 = (np.concatenate(c) for c in zip(*canvas.spans))
    return rows - 2, x0 - 2, x1 - 2


_DIAMOND_SPANS = _diamond_spans()


def _thick_segment(p0, p1, caps: int, canvas: _Canvas) -> None:
    """OpenCV's ``ThickLine`` of thickness 2 (fixed-point ends): the quad
    of the ends offset by one pixel across the line, and the ends' caps
    (``caps``: 1 the first, 2 the second, 3 both)."""
    p0, p1 = np.asarray(p0, np.int64), np.asarray(p1, np.int64)
    dx = (int(p0[0]) - int(p1[0])) / XY_ONE
    dy = (int(p1[1]) - int(p0[1])) / XY_ONE
    r2 = dx * dx + dy * dy
    if r2 > np.finfo(np.float64).eps:
        r = XY_ONE / np.sqrt(r2)   # half the thickness, 1 px, in fixed point
        off = np.array([np.rint(dy * r), np.rint(dx * r)], np.int64)
        _convex_outline(np.array([p0 + off, p0 - off, p1 - off, p1 + off]),
                        canvas)
    for k, end in enumerate((p0, p1)):
        if not caps & (k + 1):
            continue
        if end[0] & (XY_ONE - 1) or end[1] & (XY_ONE - 1):
            _convex_outline(end + _DIAMOND, canvas)
            continue
        # On a whole pixel the cap's interior is always the same five
        # pixels: translate them instead of walking the fill.
        diamond = end + _DIAMOND
        canvas.edges(np.roll(diamond, 1, 0), diamond)
        x, y = int(end[0] >> XY_SHIFT), int(end[1] >> XY_SHIFT)
        h, w = canvas.shape
        if -1 <= y < h + 1 and -1 <= x < w + 1:
            rows = _DIAMOND_SPANS[0] + y
            ok = (rows >= 0) & (rows < h)
            canvas.spans.append(_spans(rows[ok], _DIAMOND_SPANS[1][ok] + x,
                                       _DIAMOND_SPANS[2][ok] + x, w))


def _polyline(v, closed: bool, canvas: _Canvas) -> None:
    """OpenCV's ``PolyLine`` of thickness 2 through fixed-point points."""
    n = len(v)
    caps = 2 if closed else 3
    p0 = v[n - 1 if closed else 0]
    for i in range((0 if closed else 1), n):
        _thick_segment(p0, v[i], caps, canvas)
        p0 = v[i]
        caps = 2


def _finite(*values) -> bool:
    return all(np.isfinite(np.asarray(v, np.float64)).all() for v in values)


def lines(img: np.ndarray, starts, ends, color) -> np.ndarray:
    """``cv2.line(img, p, q, color, 2, cv2.LINE_AA)`` for each pair of
    integer points, in place, blended together (up to the rounding of
    successive calls); returns ``img``. As OpenCV's, each line's ends are
    first clipped to the image grown by the thickness on each side."""
    h, w = img.shape[:2]
    m = 2   # the thickness
    p = np.asarray(starts, np.float64).reshape(-1, 2)
    q = np.asarray(ends, np.float64).reshape(-1, 2)
    finite = np.isfinite(p).all(1) & np.isfinite(q).all(1)
    p, q = (np.trunc(np.clip(v[finite], -_INT_LIMIT, _INT_LIMIT)).astype(
        np.int64) + m for v in (p, q))
    visible, x1, y1, x2, y2 = _clip_lines((w + 2 * m, h + 2 * m), p[:, 0],
                                          p[:, 1], q[:, 0], q[:, 1])
    canvas = _Canvas((h, w))
    for k in np.flatnonzero(visible):
        _thick_segment(_fixed((x1[k] - m, y1[k] - m)),
                       _fixed((x2[k] - m, y2[k] - m)), 3, canvas)
    return canvas.paint(img, color)


def line(img: np.ndarray, pt1, pt2, color) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, 2, cv2.LINE_AA)`` in place (integer
    points); returns ``img``."""
    return lines(img, [pt1], [pt2], color)


def circle(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, 2, cv2.LINE_AA)`` in place:
    the polyline of ``ellipse2Poly``'s points (every 5 degrees from a
    radius of 15 px, fewer below), each a thick line."""
    if not _finite(center, radius):
        return img
    c = _fixed(center).astype(np.float64)
    rad = float(abs(int(radius)) << XY_SHIFT)
    step = (int(rad) + (XY_ONE >> 1)) >> XY_SHIFT
    step = 90 if step < 3 else 30 if step < 10 else 18 if step < 15 else 5
    angles = np.minimum(np.arange(0, 360 + step, step), 360)
    pts = np.stack([c[0] + rad * _SIN[450 - angles],
                    c[1] + rad * _SIN[angles]], 1)
    v = np.rint(pts).astype(np.int64)
    v = v[np.r_[True, (v[1:] != v[:-1]).any(1)]]
    if len(v) == 1:
        v = np.repeat(_fixed(center)[None], 2, 0)
    canvas = _Canvas(img.shape[:2])
    _polyline(v, False, canvas)
    return canvas.paint(img, color)


def rectangle(img: np.ndarray, pt1, pt2, color,
              thickness: int = 2) -> np.ndarray:
    """``cv2.rectangle`` in place: thickness -1 fills the pixels between
    the two corners (both included, no anti-aliasing); thickness 2 draws
    the anti-aliased outline."""
    if not _finite(pt1, pt2):
        return img
    if thickness < 0:
        h, w = img.shape[:2]
        (x1, x2), (y1, y2) = (sorted((int(pt1[0]), int(pt2[0]))),
                              sorted((int(pt1[1]), int(pt2[1]))))
        x1, x2, y1, y2 = max(x1, 0), min(x2, w - 1), max(y1, 0), min(y2, h - 1)
        if x1 <= x2 and y1 <= y2:
            # A whole row of the colour, so that numpy copies rows, not
            # one pixel's channels at a time.
            row = np.asarray(np.rint(color), img.dtype)[: img.shape[2]]
            img[y1:y2 + 1, x1:x2 + 1] = np.tile(row, (x2 - x1 + 1, 1))
        return img
    if thickness != 2:
        raise ValueError(f"thickness {thickness}: 2 or -1 (filled)")
    canvas = _Canvas(img.shape[:2])
    _polyline(_fixed([(pt1[0], pt1[1]), (pt2[0], pt1[1]), (pt2[0], pt2[1]),
                      (pt1[0], pt2[1])]), True, canvas)
    return canvas.paint(img, color)


def fill_poly(img: np.ndarray, pts, color) -> np.ndarray:
    """``cv2.drawContours(img, [pts], -1, color, -1, cv2.LINE_AA)`` in
    place: the polygon through the integer points ``pts`` filled (even-odd
    spans) with an anti-aliased edge."""
    pts = np.asarray(pts)
    if len(pts) == 0 or not np.isfinite(pts.astype(np.float64)).all():
        return img
    pts = pts.astype(np.int64).reshape(-1, 2)
    canvas = _Canvas(img.shape[:2])
    canvas.edges(np.roll(pts, 1, 0) << XY_SHIFT, pts << XY_SHIFT)
    if len(pts) >= 2 and not _too_far(pts << XY_SHIFT):
        spans = _fill_poly_spans([(int(x), int(y)) for x, y in pts],
                                 canvas.shape)
        if spans is not None:
            canvas.spans.append(spans)
    return canvas.paint(img, color)


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray,
                 beta: float, gamma: float) -> np.ndarray:
    """``cv2.addWeighted`` of two images of whole values 0..255 (uint8, or
    float32 as ``Normalize(keep_origin=True)`` keeps them), as uint8,
    through a table of its 256 x 256 results (:func:`_weighted_table`)."""
    table = _weighted_table(float(alpha), float(beta), float(gamma))
    return table.reshape(-1)[(src1.astype(np.intp) << 8)
                             | src2.astype(np.intp)]


@functools.lru_cache(maxsize=8)
def _weighted_table(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """``addWeighted``'s result for each pair of uint8 values: ``fma(src1,
    alpha, fma(src2, beta, gamma))`` in float32 as OpenCV's vector loop
    computes it, rounded half to even, saturated. (A uint8 times a float32
    is exact in float64, so each fused multiply-add rounds once, there.)"""
    f = np.float32
    values = np.arange(256, dtype=np.float64)
    inner = (values * f(beta) + f(gamma)).astype(f)
    out = (values[:, None] * f(alpha) + inner[None, :]).astype(f)
    table = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    table.setflags(write=False)
    return table


def box_points(center: Sequence[float], size: Sequence[float],
               angle: float) -> np.ndarray:
    """``cv2.boxPoints((center, size, angle))``: the (4, 2) float32 corners
    of a rotated rectangle, angle in degrees, in float32 arithmetic as
    OpenCV's ``RotatedRect::points``."""
    f = np.float32
    cx, cy = f(center[0]), f(center[1])
    w, h = f(size[0]), f(size[1])
    theta = float(f(angle)) * np.pi / 180.0
    with np.errstate(all="ignore"):
        b = f(np.cos(theta)) * f(0.5)
        a = f(np.sin(theta)) * f(0.5)
        p0 = (cx - a * h - b * w, cy + b * h - a * w)
        p1 = (cx + a * h - b * w, cy - b * h - a * w)
        return np.array([p0, p1,
                         (f(2) * cx - p0[0], cy - b * h + a * w),
                         (f(2) * cx - p1[0], cy + b * h + a * w)], f)
