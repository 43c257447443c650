"""The plain reference of the training and evaluation batches.

A frozen numpy copy of what the data layer computes for a KITTI sample:
the PNG decode (``zlib`` and the five row filters undone along
anti-diagonals, every image of a batch at once), the calibration and
label files, the object filters and projections into fixed (30,) slots,
the train augmentations (photometric jitter with OpenCV's float32 HSV
formulas, shift, flip, crop, each drawn from ``default_rng((seed, epoch,
position))`` in the reference's order), the uint8 quantization, the pad
to a multiple of 32, the epoch order (``default_rng((seed, epoch))``) and
the collation onto the static canvas.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

CLASSES = {"Pedestrian": 0, "Cyclist": 1, "Car": 2}
MAX_OBJS = 30
NUM_KPTS = 9
FILTER = {"min_height": 25, "min_depth": 2, "max_depth": 65,
          "max_truncation": 0.5, "max_occlusion": 2}
FLIP_KPT_ORDER = np.array([1, 0, 3, 2, 5, 4, 7, 6, 8])
CORNER_ORDER = np.array([0, 1, 3, 2, 4, 5, 7, 6])
FLT_EPSILON = np.finfo(np.float32).eps
_SECTOR_BGR = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))
_A, _B = (0, 1, 0, 1), (0, 0, 1, -1)
_TAB_A = np.array([[_A[r[k]] for r in _SECTOR_BGR] for k in (2, 1, 0)], np.float32)
_TAB_B = np.array([[_B[r[k]] for r in _SECTOR_BGR] for k in (2, 1, 0)], np.float32)


# --- PNG -------------------------------------------------------------------
def _png_rows(path: str) -> Tuple[np.ndarray, int]:
    """(H, 1 + W*C) filtered rows of an 8-bit RGB/RGBA PNG, and C."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color = header[:4]
    if depth != 8 or color not in (2, 6) or header[6] != 0:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA, not interlaced")
    ch = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return raw[:h * (w * ch + 1)].reshape(h, w * ch + 1), ch


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """RGB uint8 images of PNG files of one size: each pixel is its
    filtered byte plus the predictor of its row's filter type, computed
    for every image at once along the anti-diagonals x + y = d, whose
    pixels depend only on earlier diagonals."""
    rows = [_png_rows(p) for p in paths]
    ch = rows[0][1]
    filt = np.stack([r[0] for r in rows])              # (N, H, 1 + W*C)
    n, h = filt.shape[:2]
    w = (filt.shape[2] - 1) // ch
    kind = filt[:, :, 0].astype(np.int16)              # (N, H)
    if kind.max() > 4:
        raise ValueError("unknown PNG filter type")
    x = filt[:, :, 1:].reshape(n, h, w, ch).astype(np.int16)
    out = np.zeros((n, h + 1, w + 1, ch), np.int16)     # a zero row and column
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = out[:, ys + 1, xs]                          # left
        b = out[:, ys, xs + 1]                          # up
        c = out[:, ys, xs]                              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kind[:, ys][..., None]
        pred = np.select([k == 0, k == 1, k == 2, k == 3],
                         [0, a, b, (a + b) >> 1], paeth)
        out[:, ys + 1, xs + 1] = (x[:, ys, xs] + pred) & 0xFF
    return [np.ascontiguousarray(out[i, 1:, 1:, :3].astype(np.uint8))
            for i in range(n)]


# --- calibration, labels, projections ----------------------------------------
def read_calib(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        lines = f.readlines()
    row = [np.array(ln.strip().split(" ")[1:], np.float32) for ln in lines[:4]]
    return {"P0": row[0].reshape(3, 4), "P2": row[2].reshape(3, 4)}


def read_labels(path: str) -> Dict[str, np.ndarray]:
    """The non-DontCare objects of a KITTI label file, first 30 kept."""
    with open(path) as f:
        parts = [ln.strip().split(" ") for ln in f if ln.strip()]
    parts = [p for p in parts if CLASSES.get(p[0], -1) >= 0][:MAX_OBJS]
    fields = np.zeros((len(parts), 15), np.float32)
    for i, p in enumerate(parts):
        vals = [float(v) for v in p[1:16]]
        fields[i, :len(vals)] = vals
    return {"cls": np.array([CLASSES[p[0]] for p in parts], np.int8),
            "trunc": fields[:, 0], "occl": fields[:, 1],
            "bbox": fields[:, 3:7].copy(), "dim": fields[:, [9, 7, 8]].copy(),
            "loc": fields[:, 10:13].copy(), "ry": fields[:, 13]}


def _project(points: np.ndarray, p2: np.ndarray, depth: bool = False):
    pts = np.asarray(points, np.float64)
    proj = np.eye(4)
    proj[:3, :4] = p2
    homo = np.concatenate([pts, np.ones_like(pts[..., :1])], -1) @ proj.T
    uv = homo[..., :2] / homo[..., 2:3]
    return np.concatenate([uv, homo[..., 2:3]], -1) if depth else uv


def _corners(centers, dims, rys):
    t = np.stack(np.unravel_index(np.arange(8), [2, 2, 2]), 1)[CORNER_ORDER]
    t = t.astype(np.float64) - 0.5
    corners = np.asarray(dims, np.float64)[:, None, :] * t[None]
    c, s = np.cos(np.asarray(rys, np.float64)), np.sin(np.asarray(rys, np.float64))
    z, o = np.zeros_like(c), np.ones_like(c)
    rot = np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                    np.stack([-s, z, c], -1)], -2)
    return np.einsum("nij,nkj->nik", corners, rot) + np.asarray(
        centers, np.float64)[:, None, :]


def empty_labels() -> Dict[str, np.ndarray]:
    o = MAX_OBJS
    return {"gt_bboxes": np.zeros((o, 4), np.float32),
            "gt_labels": np.zeros(o, np.float32),
            "gt_bboxes_3d": np.zeros((o, 7), np.float32),
            "gt_labels_3d": np.zeros(o, np.float32),
            "centers2d": np.zeros((o, 2), np.float32),
            "depths": np.zeros(o, np.float32),
            "gt_kpts_2d": np.zeros((o, NUM_KPTS * 2), np.float32),
            "gt_kpts_valid_mask": np.zeros((o, NUM_KPTS), np.float32),
            "mask": np.zeros(o, bool)}


def sample_labels(raw: Dict[str, np.ndarray], calib: Dict[str, np.ndarray],
                  ori_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """The fixed-slot labels of one image: objects through the filters,
    moved to camera 2 with a local yaw, projected centres and keypoints."""
    labels = empty_labels()
    if len(raw["cls"]) == 0:
        return labels
    p2 = calib["P2"]
    loc2 = raw["loc"].copy()
    loc2[:, 0] += float((p2[0, 3] - calib["P0"][0, 3]) / p2[0, 0])
    alpha = raw["ry"] - np.arctan2(loc2[:, 0], loc2[:, 2])
    gravity = raw["loc"].copy()
    gravity[:, 1] -= 0.5 * raw["dim"][:, 1]
    centers = _project(gravity, p2, depth=True)
    corners = _corners(gravity, raw["dim"], raw["ry"])
    kpts = np.concatenate([
        np.concatenate([_project(corners, p2),
                        (corners[:, :, 2] > 0).astype(np.float64)[..., None]], -1),
        np.concatenate([centers[:, :2], np.ones_like(centers[:, :1])],
                       -1)[:, None]], 1)
    h, w = ori_hw
    keep = ((raw["occl"] <= FILTER["max_occlusion"])
            & (raw["trunc"] <= FILTER["max_truncation"])
            & (raw["bbox"][:, 3] - raw["bbox"][:, 1] >= FILTER["min_height"])
            & (centers[:, 2] >= FILTER["min_depth"])
            & (centers[:, 2] <= FILTER["max_depth"]) & (centers[:, 2] > 0))
    inside = ((kpts[..., 0] >= 0) & (kpts[..., 0] <= w)
              & (kpts[..., 1] >= 0) & (kpts[..., 1] <= h))
    vis = np.where(inside, 2.0, kpts[..., 2])
    sel = np.where(keep)[0]
    m = len(sel)
    if m == 0:
        return labels
    labels["gt_bboxes"][:m] = raw["bbox"][sel]
    labels["gt_labels"][:m] = raw["cls"][sel]
    labels["gt_bboxes_3d"][:m] = np.concatenate(
        [loc2[sel], raw["dim"][sel], alpha[sel, None]], 1)
    labels["gt_labels_3d"][:m] = raw["cls"][sel]
    labels["centers2d"][:m] = centers[sel, :2]
    labels["depths"][:m] = centers[sel, 2]
    labels["gt_kpts_2d"][:m] = kpts[sel, :, :2].reshape(m, -1)
    labels["gt_kpts_valid_mask"][:m] = vis[sel]
    labels["mask"][:m] = True
    return labels


# --- augmentations ------------------------------------------------------------
def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """OpenCV's float32 COLOR_RGB2HSV, H in degrees."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    out = np.empty_like(img)
    np.divide(diff, np.abs(v) + FLT_EPSILON, out=out[..., 1])
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
    """OpenCV's float32 COLOR_HSV2RGB, H in degrees."""
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
        wt = _TAB_A[c][sector]
        wt += _TAB_B[c][sector] * h
        wt *= s
        np.subtract(np.float32(1), wt, out=wt)
        np.multiply(v, wt, out=out[..., c])
    return out


def photometric(img: np.ndarray, rng) -> np.ndarray:
    img = img.astype(np.float32)
    if rng.integers(2):
        img += np.float32(rng.uniform(-32, 32))
    contrast_last = rng.integers(2) == 0
    if not contrast_last and rng.integers(2):
        img *= np.float32(rng.uniform(0.5, 1.5))
    img = rgb_to_hsv(img)
    if rng.integers(2):
        img[..., 1] *= np.float32(rng.uniform(0.5, 1.5))
    if rng.integers(2):
        img[..., 0] += np.float32(rng.uniform(-18, 18))
        np.mod(img[..., 0], 360.0, out=img[..., 0])
    img = hsv_to_rgb(img)
    if contrast_last and rng.integers(2):
        img *= np.float32(rng.uniform(0.5, 1.5))
    if rng.integers(2):
        img = np.ascontiguousarray(img[..., rng.permutation(3)])
    return img


def _mask_all(label, keep):
    m1 = keep.astype(np.float32)
    m2 = m1[..., None]
    for k in ("gt_bboxes", "gt_bboxes_3d", "centers2d", "gt_kpts_2d",
              "gt_kpts_valid_mask"):
        label[k] = label[k] * m2
    for k in ("gt_labels", "gt_labels_3d", "depths"):
        label[k] = label[k] * m1
    label["mask"] = keep


def shift(s: Dict, rng) -> None:
    if rng.random() >= 0.5:
        return
    sx, sy = int(rng.uniform(-32, 32)), int(rng.uniform(-32, 32))
    h, w = s["ori_hw"]
    label = s["label"]
    box = label["gt_bboxes"].copy()
    box[..., 0::2] = np.clip(box[..., 0::2] + sx, 0, w)
    box[..., 1::2] = np.clip(box[..., 1::2] + sy, 0, h)
    valid = ((box[..., 2] - box[..., 0]) > 1) & ((box[..., 3] - box[..., 1]) > 1)
    if not valid.any():
        return
    label["gt_bboxes"] = box
    c = label["centers2d"].copy()
    c[..., 0] += sx
    c[..., 1] += sy
    label["centers2d"] = c
    k = label["gt_kpts_2d"].copy()
    k[..., 0::2] += sx
    k[..., 1::2] += sy
    label["gt_kpts_2d"] = k
    _mask_all(label, valid & label["mask"].astype(bool))
    s["p2"][0, 2] += sx
    s["p2"][1, 2] += sy
    img = s["img"]
    canvas = np.zeros_like(img)
    nx, ox, ny, oy = max(0, sx), max(0, -sx), max(0, sy), max(0, -sy)
    nh, nw = h - abs(sy), w - abs(sx)
    canvas[ny:ny + nh, nx:nx + nw] = img[oy:oy + nh, ox:ox + nw]
    s["img"] = canvas


def flip(s: Dict, rng) -> None:
    if rng.random() >= 0.5:
        return
    img = s["img"]
    w = img.shape[1]
    s["img"] = np.ascontiguousarray(img[:, ::-1])
    s["p2"][0, 2] = w - s["p2"][0, 2] - 1
    s["p2"][0, 3] = -s["p2"][0, 3]
    label = s["label"]
    m1 = label["mask"].astype(np.float32)
    m2 = m1[..., None]
    c = label["centers2d"]
    c[..., 0] = (w - c[..., 0] - 1) * m1
    box = label["gt_bboxes"].copy()
    fl = box.copy()
    fl[..., 0] = w - box[..., 2]
    fl[..., 2] = w - box[..., 0]
    label["gt_bboxes"] = fl * m2
    b3 = label["gt_bboxes_3d"].copy()
    b3[..., 0] *= -1
    b3[..., 6] = -b3[..., 6] + np.pi
    label["gt_bboxes_3d"] = b3 * m2
    k = label["gt_kpts_2d"].copy()
    k[..., 0::2] = (w - k[..., 0::2] - 1) * m2
    k = k.reshape(k.shape[0], 9, 2)[:, FLIP_KPT_ORDER]
    label["gt_kpts_2d"] = k.reshape(k.shape[0], -1)
    label["gt_kpts_valid_mask"] = label["gt_kpts_valid_mask"][:, FLIP_KPT_ORDER]


def crop(s: Dict, rng, size: Tuple[int, int]) -> None:
    h, w = s["ori_hw"]
    if rng.random() >= 0.5:
        return
    y0 = int(rng.integers(0, h - size[0] + 1))
    x0 = int(rng.integers(0, w - size[1] + 1))
    fx0, fy0, fx1, fy1 = x0, y0, x0 + size[1], y0 + size[0]
    label = s["label"]
    mask = label["mask"].astype(bool)
    box = label["gt_bboxes"]
    ix0, iy0 = np.maximum(box[:, 0], fx0), np.maximum(box[:, 1], fy0)
    ix1, iy1 = np.minimum(box[:, 2], fx1), np.minimum(box[:, 3], fy1)
    inter = np.stack([ix0, iy0, ix1, iy1], -1)
    within = np.all(np.isclose(inter, box), -1)
    out = (ix1 <= ix0) | (iy1 <= iy0)
    cut = ~within & ~out
    ratio = np.where(cut, ((ix1 - ix0) * (iy1 - iy0)) / np.maximum(
        (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1]), 1e-12), 0.0)
    keep = within | (cut & (ratio >= 0.2))
    if not (keep[mask].any() if mask.any() else False):
        return
    new_mask = keep & mask
    label["gt_bboxes"] = np.where((cut & keep)[:, None], inter, box)
    _mask_all(label, new_mask)
    k = label["gt_kpts_2d"].reshape(-1, 9, 2)
    inside = ((k[..., 0] >= fx0) & (k[..., 0] <= fx1)
              & (k[..., 1] >= fy0) & (k[..., 1] <= fy1))
    vis = label["gt_kpts_valid_mask"]
    label["gt_kpts_valid_mask"] = np.where(new_mask[:, None] & ~inside, 1.0,
                                           vis).astype(vis.dtype)
    img = s["img"]
    canvas = np.zeros_like(img)
    canvas[fy0:fy1, fx0:fx1] = img[fy0:fy1, fx0:fx1]
    s["img"] = canvas


# --- samples and batches --------------------------------------------------------
def epoch_order(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    order = np.arange(n)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    return order


def split_ids(root: str, split: str) -> List[str]:
    with open(os.path.join(root, "ImageSets", f"{split}.txt")) as f:
        return [ln.strip() for ln in f if ln.strip()]


def make_batch(root: str, ids: Sequence[str], seed: int, epoch: int,
               positions: Sequence[int], augment: bool,
               crop_hw: Tuple[int, int], pad_hw: Tuple[int, int]
               ) -> Dict[str, np.ndarray]:
    """The batch of the samples ``ids`` at epoch positions ``positions``:
    uint8 canvas (B, H, W, 3), ``img_hw`` (B, 2) int32, ``p2`` (B, 3, 4)
    float32 and the ``label`` arrays (B, 30, ...) float32."""
    sub = os.path.join(root, "training")
    images = read_pngs([os.path.join(sub, "image_2", f"{i}.png") for i in ids])
    samples = []
    for sid, img, pos in zip(ids, images, positions):
        calib = read_calib(os.path.join(sub, "calib", f"{sid}.txt"))
        s = {"img": img, "ori_hw": img.shape[:2], "p2": calib["P2"].copy(),
             "label": sample_labels(read_labels(os.path.join(
                 sub, "label_2", f"{sid}.txt")), calib, img.shape[:2])}
        if augment:
            rng = np.random.default_rng((seed, epoch, pos))
            s["img"] = photometric(s["img"], rng)
            shift(s, rng)
            flip(s, rng)
            crop(s, rng, crop_hw)
            s["img"] = np.clip(np.rint(s["img"]), 0, 255).astype(np.uint8)
        samples.append(s)
    canvas = np.zeros((len(samples), *pad_hw, 3), np.uint8)
    for i, s in enumerate(samples):
        h, w = s["img"].shape[:2]
        canvas[i, :min(h, pad_hw[0]), :min(w, pad_hw[1])] = (
            s["img"][:pad_hw[0], :pad_hw[1]])
    keys = samples[0]["label"].keys()
    return {"img": canvas,
            "img_hw": np.array([s["img"].shape[:2] for s in samples], np.int32),
            "p2": np.stack([s["p2"] for s in samples]).astype(np.float32),
            "label": {k: np.stack([s["label"][k] for s in samples])
                      .astype(np.float32) for k in keys}}
