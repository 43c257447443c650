"""Synthetic mini-KITTI dataset generator (for tests and the smoke run).

Port of ``monocon_tpu/data/synthetic.py``. Writes a directory tree with the
real KITTI layout::

    root/training/{image_2,calib,label_2}/XXXXXX.{png,txt,txt}
    root/ImageSets/{train,val,trainval,test}.txt

Labels, calibrations and ``ImageSets`` are byte-equal to the JAX
generator's for the same arguments: the same random stream draws them. The
images are drawn with numpy alone (no image library): a bilinear
background, filled convex hulls by half-plane tests and one-pixel outlines,
from the same per-sample random stream as the JAX generator's. Their pixels
differ from OpenCV's raster there. They are written by ``png.py`` with the
Paeth filter on every row, the costliest filter to undo, so that reading
them costs about what KITTI's own adaptively filtered files cost.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from .png import write_png

# A realistic KITTI P2 (values in the ballpark of the real sequences).
DEFAULT_P2 = np.array(
    [
        [721.5377, 0.0, 609.5593, 44.85728],
        [0.0, 721.5377, 172.854, 0.2163791],
        [0.0, 0.0, 1.0, 0.002745884],
    ],
    dtype=np.float32,
)

DEFAULT_IMAGE_HW = (375, 1242)


def make_calib_text(p2: Optional[np.ndarray] = None) -> str:
    p2 = DEFAULT_P2 if p2 is None else p2
    p0 = p2.copy()
    p0[0, 3] = 0.0
    p0[1, 3] = 0.0
    p0[2, 3] = 0.0
    p1 = p0.copy()
    p1[0, 3] = -387.5744
    p3 = p0.copy()
    p3[0, 3] = -339.5
    r0 = np.eye(3, dtype=np.float32)
    v2c = np.array(
        [
            [7.53e-03, -9.99e-01, -6.17e-04, -4.07e-03],
            [1.48e-02, 7.28e-04, -9.99e-01, -7.63e-02],
            [9.99e-01, 7.52e-03, 1.48e-02, -2.72e-01],
        ],
        dtype=np.float32,
    )
    i2v = np.array(
        [
            [9.99e-01, 7.55e-03, -2.03e-03, -8.09e-01],
            [-7.85e-03, 9.98e-01, -5.32e-02, 3.20e-01],
            [2.02e-03, 5.32e-02, 9.98e-01, -7.99e-01],
        ],
        dtype=np.float32,
    )

    def fmt(name, mat):
        return name + ": " + " ".join(f"{v:.12e}" for v in mat.flatten())

    return "\n".join(
        [
            fmt("P0", p0),
            fmt("P1", p1),
            fmt("P2", p2),
            fmt("P3", p3),
            fmt("R0_rect", r0),
            fmt("Tr_velo_to_cam", v2c),
            fmt("Tr_imu_to_velo", i2v),
        ]
    ) + "\n"


def make_label_line(
    name: str = "Car",
    truncated: float = 0.0,
    occluded: int = 0,
    alpha: float = -0.2,
    bbox: Sequence[float] = (390.0, 180.0, 510.0, 250.0),
    dim_hwl: Sequence[float] = (1.5, 1.7, 4.1),
    loc: Sequence[float] = (-2.0, 1.8, 25.0),
    ry: float = -0.3,
    score: Optional[float] = None,
) -> str:
    parts = [
        name,
        f"{truncated:.2f}",
        f"{occluded:d}",
        f"{alpha:.2f}",
        *[f"{v:.2f}" for v in bbox],
        *[f"{v:.2f}" for v in dim_hwl],
        *[f"{v:.2f}" for v in loc],
        f"{ry:.2f}",
    ]
    if score is not None:
        parts.append(f"{score:.4f}")
    return " ".join(parts)


def random_scene_labels(rng: np.ndarray, num_objects: int, p2: np.ndarray,
                        image_hw=DEFAULT_IMAGE_HW):
    """Generate physically consistent labels: sample 3D boxes, derive the 2D
    box from the projected corners so geometry round-trips in tests.

    Returns ``(label_lines, draw_specs)`` — the specs carry each labeled
    object's projected corners so ``render_scene`` can draw it (a detector
    can only *generalize* to held-out images if the objects are visually
    rendered, not just described in the label file)."""
    from .geometry import boxes3d_to_corners, corners_to_image_bbox

    names = ["Car", "Pedestrian", "Cyclist"]
    dims = {
        "Car": (1.55, 1.65, 4.0),
        "Pedestrian": (1.75, 0.6, 0.85),
        "Cyclist": (1.72, 0.6, 1.76),
    }
    lines = []
    specs = []
    for _ in range(num_objects):
        name = names[int(rng.integers(0, 3))]
        h, w, l = dims[name]
        h *= float(rng.uniform(0.9, 1.1))
        w *= float(rng.uniform(0.9, 1.1))
        l *= float(rng.uniform(0.9, 1.1))
        z = float(rng.uniform(6.0, 55.0))
        x = float(rng.uniform(-0.04, 0.04)) * z * 10.0
        y = float(rng.uniform(1.4, 2.0))
        ry = float(rng.uniform(-np.pi, np.pi))
        loc = np.array([[x, y, z]])
        corners = boxes3d_to_corners(loc, np.array([[l, h, w]]), np.array([ry]))
        bbox = corners_to_image_bbox(corners, p2)[0]
        bbox[0::2] = np.clip(bbox[0::2], 0, image_hw[1])
        bbox[1::2] = np.clip(bbox[1::2], 0, image_hw[0])
        if (bbox[2] - bbox[0]) < 8 or (bbox[3] - bbox[1]) < 8:
            continue
        alpha = ry - float(np.arctan2(x, z))
        lines.append(
            make_label_line(
                name=name,
                truncated=float(rng.uniform(0, 0.12)),
                occluded=int(rng.integers(0, 2)),
                alpha=alpha,
                bbox=bbox,
                dim_hwl=(h, w, l),
                loc=(x, y, z),
                ry=ry,
            )
        )
        specs.append({"name": name, "corners": corners[0], "z": z})
    if not lines:
        # Fallback: one easy car placed via the actual projection so its
        # box is guaranteed inside this image size.
        loc = np.array([[0.0, 1.6, 12.0]])
        dims = np.array([[4.0, 1.55, 1.65]])
        corners = boxes3d_to_corners(loc, dims, np.array([0.0]))
        bbox = corners_to_image_bbox(corners, p2)[0]
        bbox[0::2] = np.clip(bbox[0::2], 0, image_hw[1])
        bbox[1::2] = np.clip(bbox[1::2], 0, image_hw[0])
        lines = [make_label_line(bbox=bbox, loc=(0.0, 1.6, 12.0),
                                 dim_hwl=(1.55, 1.65, 4.0), ry=0.0,
                                 alpha=0.0)]
        specs = [{"name": "Car", "corners": corners[0], "z": 12.0}]
    # A DontCare region, as in real KITTI files.
    lines.append(
        "DontCare -1 -1 -10 500.00 170.00 590.00 190.00 -1 -1 -1 -1000 -1000 -1000 -10"
    )
    return lines, specs


# Distinct channel-dominant colors per class (RGB) so classification is
# visually learnable from synthetic scenes.
CLASS_COLORS = {
    "Car": (205, 65, 55),
    "Pedestrian": (55, 195, 70),
    "Cyclist": (70, 90, 210),
}
PAETH = 4  # PNG filter type of the written images


def resize_bilinear(src: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h0, w0, C) uint8 -> (h, w, C) uint8, bilinear with half-pixel
    centres and clamped edges."""
    def taps(n_out, n_in):
        x = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0,
                    n_in - 1)
        lo = np.floor(x).astype(np.int64)
        return lo, np.minimum(lo + 1, n_in - 1), (x - lo).astype(np.float32)

    y0, y1, fy = taps(h, src.shape[0])
    x0, x1, fx = taps(w, src.shape[1])
    s = src.astype(np.float32)
    rows = s[y0] * (1 - fy)[:, None, None] + s[y1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return np.rint(out).astype(np.uint8)


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Vertices of the convex hull of (N, 2) integer points, counter-
    clockwise in (x, y) (Andrew's monotone chain)."""
    pts = sorted(set(map(tuple, pts.tolist())))
    if len(pts) < 3:
        return np.asarray(pts, np.int64).reshape(-1, 2)

    def half(points):
        chain = []
        for p in points:
            while len(chain) >= 2 and (
                    (chain[-1][0] - chain[-2][0]) * (p[1] - chain[-2][1])
                    - (chain[-1][1] - chain[-2][1]) * (p[0] - chain[-2][0])
                    <= 0):
                chain.pop()
            chain.append(p)
        return chain[:-1]

    return np.asarray(half(pts) + half(pts[::-1]), np.int64)


def fill_convex(img: np.ndarray, hull: np.ndarray, color) -> None:
    """Paint the pixels inside or on a counter-clockwise convex polygon."""
    if len(hull) < 3:
        return
    h, w = img.shape[:2]
    x0, y0 = np.maximum(hull.min(0), 0)
    x1, y1 = np.minimum(hull.max(0), (w - 1, h - 1))
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    inside = np.ones(ys.shape, bool)
    for (ax, ay), (bx, by) in zip(hull, np.roll(hull, -1, 0)):
        inside &= (bx - ax) * (ys - ay) - (by - ay) * (xs - ax) >= 0
    img[y0:y1 + 1, x0:x1 + 1][inside] = color


def draw_closed_polyline(img: np.ndarray, pts: np.ndarray, color) -> None:
    """One-pixel segments between consecutive points, the last to the
    first; pixels off the image are dropped."""
    h, w = img.shape[:2]
    for p, q in zip(pts, np.roll(pts, -1, 0)):
        n = int(np.abs(q - p).max()) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        xy = np.rint(p + (q - p) * t).astype(np.int64)
        on = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
        img[xy[on, 1], xy[on, 0]] = color


def render_scene(render_rng: np.random.Generator, image_hw, specs,
                 p2: np.ndarray) -> np.ndarray:
    """Draw the labeled objects onto a smooth random background.

    Each object is the filled convex hull of its 8 projected 3D corners in
    its class color (brightness-jittered per instance), with the front face
    outlined darker as an orientation cue, drawn far-to-near so occlusion
    matches depth. The background is a low-frequency field + fine noise."""
    from .geometry import project_to_image

    h, w = image_hw
    base = render_rng.integers(90, 166, size=(6, 8, 3)).astype(np.uint8)
    img = resize_bilinear(base, h, w).astype(np.int16)
    img += render_rng.integers(-12, 13, size=img.shape).astype(np.int16)
    img = np.clip(img, 0, 255).astype(np.uint8)

    for spec in sorted(specs, key=lambda s: -s["z"]):
        uv = project_to_image(spec["corners"], p2)  # (8, 2)
        pts = np.round(uv).astype(np.int64)
        color = np.asarray(CLASS_COLORS[spec["name"]], np.float32)
        color = color * float(render_rng.uniform(0.75, 1.25))
        col = tuple(int(c) for c in np.clip(color, 0, 255))
        fill_convex(img, convex_hull(pts), col)
        edge = tuple(int(c * 0.55) for c in col)
        draw_closed_polyline(img, pts[:4], edge)
    return img


def generate_kitti_dataset(
    root: str,
    num_train: int = 4,
    num_val: int = 2,
    image_hw=DEFAULT_IMAGE_HW,
    max_objects: int = 6,
    seed: int = 0,
) -> None:
    """Write a synthetic KITTI tree with `num_train + num_val` samples."""
    rng = np.random.default_rng(seed)
    training = os.path.join(root, "training")
    for sub in ("image_2", "calib", "label_2"):
        os.makedirs(os.path.join(training, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)

    # Scale the intrinsics to the requested image size (as a camera resize
    # would) so projections land inside the frame for any image_hw.
    p2 = DEFAULT_P2.copy()
    p2[0] *= image_hw[1] / DEFAULT_IMAGE_HW[1]
    p2[1] *= image_hw[0] / DEFAULT_IMAGE_HW[0]

    total = num_train + num_val
    ids = [f"{i:06d}" for i in range(total)]
    for i, sample_id in enumerate(ids):
        with open(os.path.join(training, "calib", f"{sample_id}.txt"), "w") as f:
            f.write(make_calib_text(p2))
        n_obj = int(rng.integers(1, max_objects + 1))
        lines, specs = random_scene_labels(rng, n_obj, p2, image_hw)
        with open(os.path.join(training, "label_2", f"{sample_id}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        # Rendering randomness comes from a per-sample stream so the label
        # content above is a pure function of (seed, sample order).
        img = render_scene(np.random.default_rng((seed, i)), image_hw,
                           specs, p2)
        write_png(os.path.join(training, "image_2", f"{sample_id}.png"),
                  img, filter_type=PAETH)

    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(ids[:num_train]) + "\n")
    with open(os.path.join(root, "ImageSets", "val.txt"), "w") as f:
        f.write("\n".join(ids[num_train:]) + "\n")
    with open(os.path.join(root, "ImageSets", "trainval.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    # 'test' split points at the same images, mirroring KITTI's testing/ dir.
    testing = os.path.join(root, "testing")
    for sub in ("image_2", "calib"):
        os.makedirs(os.path.join(testing, sub), exist_ok=True)
        src_dir = os.path.join(training, sub)
        for sample_id in ids[num_train:]:
            ext = "png" if sub == "image_2" else "txt"
            src = os.path.join(src_dir, f"{sample_id}.{ext}")
            dst = os.path.join(testing, sub, f"{sample_id}.{ext}")
            with open(src, "rb") as fs, open(dst, "wb") as fd:
                fd.write(fs.read())
    with open(os.path.join(root, "ImageSets", "test.txt"), "w") as f:
        f.write("\n".join(ids[num_train:]) + "\n")
