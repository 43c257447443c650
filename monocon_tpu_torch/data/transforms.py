"""Host-side transform pipeline (pure numpy, vectorized over objects).

A copy of ``monocon_tpu/data/transforms.py`` (reference
``transforms/default_transforms.py``, ``geo_aware_transforms.py``) without
OpenCV, which the card's machine does not have:

  * ``PhotometricDistortion`` converts RGB <-> HSV with OpenCV's float32
    ``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB`` formulas, in C (``color.py``);
  * ``RandomHorizontalFlip`` mirrors with a reversed view made contiguous;
  * ``Resize3D`` resizes with :func:`resize_linear`, OpenCV's
    ``INTER_LINEAR`` in numpy.

Randomness: every random transform draws from an explicit
``numpy.random.Generator`` passed to ``Compose``, in the JAX package's
order, so that one generator gives both packages the same draws.

Sample dict: {'img': (H,W,3) uint8 or float32, 'img_metas': {...},
'calib': Calibration, 'label': {fixed-shape arrays, incl. 'mask'}}.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .color import hsv_to_rgb_, rgb_to_hsv_


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng if rng is not None else np.random.default_rng()
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


# OpenCV's fixed-point bilinear weights for 8-bit images: 11 fractional bits.
_RESIZE_COEF_BITS = 11


def _resize_taps(n_out: int, n_in: int):
    """Source index pairs and float32 weights of the second of each pair,
    as ``cv2.resize`` INTER_LINEAR computes them: half-pixel centres, the
    offset in double, clamped at both edges."""
    f = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    edge = (s < 0) | (s >= n_in - 1)
    frac[edge] = 0
    s = np.clip(s, 0, n_in - 1)
    return s, np.minimum(s + 1, n_in - 1), frac


def resize_linear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, out_hw[::-1])`` (INTER_LINEAR) of an (H, W, C)
    uint8 or float32 image. uint8 goes through OpenCV's 11-bit weights and
    its vectorised rounding, ``(((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >>
    4)) >> 16) + 2) >> 2``: within one level of OpenCV's. float32 weighs in
    float32."""
    (h, w), (oh, ow) = img.shape[:2], tuple(out_hw)
    if (h, w) == (oh, ow):
        return img.copy()
    y0, y1, fy = _resize_taps(oh, h)
    x0, x1, fx = _resize_taps(ow, w)
    if img.dtype == np.uint8:
        one = 1 << _RESIZE_COEF_BITS
        ax = [np.rint(a * one).astype(np.int32) for a in (1 - fx, fx)]
        by = [np.rint(b * one).astype(np.int32) for b in (1 - fy, fy)]
        src = img.astype(np.int32)
        rows = (src[:, x0] * ax[0][None, :, None]
                + src[:, x1] * ax[1][None, :, None]) >> 4
        out = (((by[0][:, None, None] * rows[y0]) >> 16)
               + ((by[1][:, None, None] * rows[y1]) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    rows = src[:, x0] * (1 - fx)[None, :, None] + src[:, x1] * fx[None, :, None]
    return rows[y0] * (1 - fy)[:, None, None] + rows[y1] * fy[:, None, None]


class Resize3D:
    """Resize image + rescale calib, 2D labels, keypoints; records
    ``scale_hw`` (reference default_transforms.py:15-49)."""

    def __init__(self, target_hw: Optional[Tuple[int, int]] = None):
        if isinstance(target_hw, int):
            target_hw = (target_hw, target_hw)
        self.target_hw = target_hw

    def __call__(self, sample: Dict, rng) -> Dict:
        if self.target_hw is None:
            return sample
        img = sample["img"]
        ori_hw = img.shape[:2]
        sample["img"] = resize_linear(img, self.target_hw)
        scale_hw = np.array(self.target_hw) / np.array(ori_hw)
        sample["img_metas"]["scale_hw"] = scale_hw
        sample["img_metas"]["ori_shape"] = self.target_hw
        sample["calib"].rescale(scale_hw[1], scale_hw[0])
        label = sample["label"]
        if label is not None:   # a raw frame has none
            label["gt_bboxes"] *= np.array([scale_hw[1], scale_hw[0]] * 2,
                                           np.float32)
            label["centers2d"] *= scale_hw[::-1].astype(np.float32)
            label["gt_kpts_2d"] *= np.tile(scale_hw[::-1], 9).astype(
                np.float32)
        return sample


class PhotometricDistortion:
    """mmdet-style photometric jitter: brightness, contrast (pre or post),
    HSV saturation/hue, random channel swap
    (reference default_transforms.py:52-120)."""

    def __init__(self, brightness_delta: float = 32,
                 contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                 hue_delta: float = 18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, sample: Dict, rng) -> Dict:
        # HSV is computed from RGB directly (the reference round-trips
        # through BGR purely as an mmcv artifact; hue/saturation jitter is
        # random, so the channel-order difference has no distributional
        # effect).
        img = sample["img"].astype(np.float32)

        if rng.integers(2):
            img += np.float32(
                rng.uniform(-self.brightness_delta, self.brightness_delta)
            )

        contrast_last = rng.integers(2) == 0
        if not contrast_last and rng.integers(2):
            img *= np.float32(rng.uniform(*self.contrast_range))

        rgb_to_hsv_(img)
        if rng.integers(2):
            img[..., 1] *= np.float32(rng.uniform(*self.saturation_range))
        if rng.integers(2):
            img[..., 0] += np.float32(
                rng.uniform(-self.hue_delta, self.hue_delta)
            )
            np.mod(img[..., 0], 360.0, out=img[..., 0])
        hsv_to_rgb_(img)

        if contrast_last and rng.integers(2):
            img *= np.float32(rng.uniform(*self.contrast_range))

        if rng.integers(2):
            img = np.ascontiguousarray(img[..., rng.permutation(3)])

        sample["img"] = img
        return sample


class RandomShift:
    """Shift image on a black canvas; shifts labels and the principal point
    of P2 (reference default_transforms.py:123-292). The reference's
    ``hide_kpts_in_shift_area`` flag is accepted but inert there (its
    filter is never invoked, default_transforms.py:253) — kept inert here
    for parity."""

    def __init__(self, prob: float = 0.5, shift_range=(-32, 32),
                 hide_kpts_in_shift_area: bool = True):
        self.prob = prob
        self.shift_range = shift_range
        self.hide_kpts_in_shift_area = hide_kpts_in_shift_area

    def __call__(self, sample: Dict, rng) -> Dict:
        metas = sample["img_metas"]
        if rng.random() >= self.prob:
            metas["is_shifted"] = False
            metas["shift_params"] = (0, 0)
            return sample
        sft_x = int(rng.uniform(*self.shift_range))
        sft_y = int(rng.uniform(*self.shift_range))
        return apply_shift(sample, sft_x, sft_y)


def apply_shift(sample: Dict, sft_x: int, sft_y: int) -> Dict:
    """Shared shift application, vectorized over objects."""
    metas = sample["img_metas"]
    img_shape = metas["ori_shape"]
    label = sample["label"]
    mask = label["mask"].copy().astype(bool)

    bboxes = label["gt_bboxes"].copy()
    bboxes[..., 0::2] = np.clip(bboxes[..., 0::2] + sft_x, 0, img_shape[1])
    bboxes[..., 1::2] = np.clip(bboxes[..., 1::2] + sft_y, 0, img_shape[0])
    validity = ((bboxes[..., 2] - bboxes[..., 0]) > 1) & (
        (bboxes[..., 3] - bboxes[..., 1]) > 1
    )
    if not validity.any():
        metas["is_shifted"] = False
        metas["shift_params"] = (0, 0)
        return sample

    metas["is_shifted"] = True
    metas["shift_params"] = (sft_x, sft_y)

    new_mask = validity & mask
    m1 = new_mask.astype(np.float32)
    m2 = m1[..., None]
    label["gt_bboxes"] = bboxes * m2
    label["gt_labels"] = label["gt_labels"] * m1
    label["gt_bboxes_3d"] = label["gt_bboxes_3d"] * m2
    label["gt_labels_3d"] = label["gt_labels_3d"] * m1
    centers = label["centers2d"].copy()
    centers[..., 0] += sft_x
    centers[..., 1] += sft_y
    label["centers2d"] = centers * m2
    label["depths"] = label["depths"] * m1
    kpts = label["gt_kpts_2d"].copy()
    kpts[..., 0::2] += sft_x
    kpts[..., 1::2] += sft_y
    label["gt_kpts_2d"] = kpts * m2
    label["gt_kpts_valid_mask"] = label["gt_kpts_valid_mask"] * m2
    label["mask"] = new_mask

    # Shift the principal point (default_transforms.py:242-252).
    calib = sample["calib"]
    calib.P2[0, 2] += sft_x
    calib.P2[1, 2] += sft_y

    # Shift image on a zeroed canvas.
    img = sample["img"]
    canvas = np.zeros_like(img)
    nx, ox = max(0, sft_x), max(0, -sft_x)
    ny, oy = max(0, sft_y), max(0, -sft_y)
    nh = img_shape[0] - abs(sft_y)
    nw = img_shape[1] - abs(sft_x)
    canvas[ny:ny + nh, nx:nx + nw] = img[oy:oy + nh, ox:ox + nw]
    sample["img"] = canvas
    return sample


# Left/right keypoint index swap under horizontal flip: the first 8 kpts are
# box corners whose x-mirrored counterparts are pairwise swaps
# (default_transforms.py:345-350); the 9th (center) stays.
FLIP_KPT_ORDER = np.array([1, 0, 3, 2, 5, 4, 7, 6, 8])


class RandomHorizontalFlip:
    """Mirror image, P2, labels, yaw, and keypoint ordering
    (reference default_transforms.py:295-373)."""

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, sample: Dict, rng) -> Dict:
        metas = sample["img_metas"]
        if rng.random() >= self.prob:
            metas["is_flipped"] = False
            return sample
        metas["is_flipped"] = True

        img = sample["img"]
        w = img.shape[1]
        sample["img"] = np.ascontiguousarray(img[:, ::-1])

        calib = sample["calib"]
        calib.P2[0, 2] = w - calib.P2[0, 2] - 1
        calib.P2[0, 3] = -calib.P2[0, 3]

        label = sample["label"]
        mask = label["mask"].astype(np.float32)
        m2 = mask[..., None]

        centers = label["centers2d"]
        centers[..., 0] = (w - centers[..., 0] - 1) * mask
        label["centers2d"] = centers

        bboxes = label["gt_bboxes"].copy()
        flipped = bboxes.copy()
        flipped[..., 0] = w - bboxes[..., 2]
        flipped[..., 2] = w - bboxes[..., 0]
        label["gt_bboxes"] = flipped * m2

        b3d = label["gt_bboxes_3d"].copy()
        b3d[..., 0] *= -1
        b3d[..., 6] = -b3d[..., 6] + np.pi
        label["gt_bboxes_3d"] = b3d * m2

        kpts = label["gt_kpts_2d"].copy()
        kpts[..., 0::2] = (w - kpts[..., 0::2] - 1) * m2
        kpts = kpts.reshape(kpts.shape[0], 9, 2)[:, FLIP_KPT_ORDER]
        label["gt_kpts_2d"] = kpts.reshape(kpts.shape[0], -1)
        label["gt_kpts_valid_mask"] = label["gt_kpts_valid_mask"][:, FLIP_KPT_ORDER]
        return sample


class RandomCrop3D:
    """Fixed-size crop kept IN PLACE on a zeroed canvas — geometry and
    calibration unchanged. Objects kept/clipped/dropped by
    intersection-area ratio >= ``area_filter_thres``
    (reference geo_aware_transforms.py:14-212)."""

    def __init__(self, prob: float = 0.5, crop_size=(320, 960),
                 hide_kpts_in_crop_area: bool = False,
                 area_filter_thres: float = 0.2):
        if isinstance(crop_size, int):
            crop_size = (crop_size, crop_size)
        self.prob = prob
        self.crop_size = crop_size
        self.hide_kpts_in_crop_area = hide_kpts_in_crop_area
        self.area_filter_thres = area_filter_thres

    def _sample_coord(self, metas: Dict, rng) -> Tuple[int, int, int, int]:
        ori_h, ori_w = metas["ori_shape"]
        crop_h, crop_w = self.crop_size
        y0 = int(rng.integers(0, ori_h - crop_h + 1))
        x0 = int(rng.integers(0, ori_w - crop_w + 1))
        return (x0, y0, x0 + crop_w, y0 + crop_h)

    def __call__(self, sample: Dict, rng) -> Dict:
        metas = sample["img_metas"]
        img_shape = metas["ori_shape"]
        if not (self.crop_size[0] <= img_shape[0]
                and self.crop_size[1] <= img_shape[1]):
            raise ValueError(
                f"crop {self.crop_size} larger than image {img_shape}")
        if rng.random() >= self.prob:
            metas["is_cropped"] = False
            metas["crop_coord"] = (0, 0, 0, 0)
            return sample

        coord = self._sample_coord(metas, rng)
        metas["is_cropped"] = True
        metas["crop_coord"] = coord
        return apply_crop(sample, coord, self.area_filter_thres,
                          self.hide_kpts_in_crop_area)


class RandomRangeCrop3D(RandomCrop3D):
    """RandomCrop3D with sampled crop height (256-320) x aspect 3.0.
    Not in the default pipeline, parity with
    geo_aware_transforms.py:215-418."""

    def __init__(self, prob: float = 0.5, height_range=(256, 320),
                 aspect_ratio: float = 3.0,
                 hide_kpts_in_crop_area: bool = True,
                 area_filter_thres: float = 0.2):
        super().__init__(prob=prob, crop_size=height_range,
                         hide_kpts_in_crop_area=hide_kpts_in_crop_area,
                         area_filter_thres=area_filter_thres)
        self.height_range = height_range
        self.width_range = (int(height_range[0] * aspect_ratio),
                            int(height_range[1] * aspect_ratio))

    def _sample_coord(self, metas: Dict, rng) -> Tuple[int, int, int, int]:
        ori_h, ori_w = metas["ori_shape"]
        crop_h = int(rng.integers(self.height_range[0], self.height_range[1] + 1))
        crop_w = int(rng.integers(self.width_range[0], self.width_range[1] + 1))
        y0 = int(rng.integers(0, ori_h - crop_h + 1))
        x0 = int(rng.integers(0, ori_w - crop_w + 1))
        return (x0, y0, x0 + crop_w, y0 + crop_h)

    def __call__(self, sample: Dict, rng) -> Dict:
        metas = sample["img_metas"]
        if rng.random() >= self.prob:
            metas["is_cropped"] = False
            metas["crop_coord"] = (0, 0, 0, 0)
            return sample
        coord = self._sample_coord(metas, rng)
        metas["is_cropped"] = True
        metas["crop_coord"] = coord
        return apply_crop(sample, coord, self.area_filter_thres,
                          self.hide_kpts_in_crop_area)


def apply_crop(sample: Dict, coord, area_thres: float, hide_kpts: bool) -> Dict:
    """Shared crop application, vectorized over objects."""
    label = sample["label"]
    mask = label["mask"].astype(bool)
    bboxes = label["gt_bboxes"]
    fx0, fy0, fx1, fy1 = coord

    ix0 = np.maximum(bboxes[:, 0], fx0)
    iy0 = np.maximum(bboxes[:, 1], fy0)
    ix1 = np.minimum(bboxes[:, 2], fx1)
    iy1 = np.minimum(bboxes[:, 3], fy1)
    inter = np.stack([ix0, iy0, ix1, iy1], axis=-1)

    within = np.all(np.isclose(inter, bboxes), axis=-1)
    out = (ix1 <= ix0) | (iy1 <= iy0)
    inters = ~within & ~out
    area_ratio = np.where(
        inters,
        ((ix1 - ix0) * (iy1 - iy0))
        / np.maximum((bboxes[:, 2] - bboxes[:, 0]) * (bboxes[:, 3] - bboxes[:, 1]), 1e-12),
        0.0,
    )
    keep = within | (inters & (area_ratio >= area_thres))
    new_mask = keep & mask

    # Reference quirk kept: if no object survives, return the sample
    # untouched (geo_aware_transforms.py:98-100).
    if not (keep[mask].any() if mask.any() else False):
        return sample

    clipped = np.where((inters & keep)[:, None], inter, bboxes)

    m1 = new_mask.astype(np.float32)
    m2 = m1[..., None]
    label["gt_bboxes"] = clipped * m2
    label["gt_labels"] = label["gt_labels"] * m1
    label["gt_bboxes_3d"] = label["gt_bboxes_3d"] * m2
    label["gt_labels_3d"] = label["gt_labels_3d"] * m1
    label["centers2d"] = label["centers2d"] * m2
    label["depths"] = label["depths"] * m1
    label["gt_kpts_2d"] = label["gt_kpts_2d"] * m2
    label["gt_kpts_valid_mask"] = label["gt_kpts_valid_mask"] * m2
    label["mask"] = new_mask

    if hide_kpts:
        kpts = label["gt_kpts_2d"].reshape(-1, 9, 2)
        inside = (
            (kpts[..., 0] >= fx0) & (kpts[..., 0] <= fx1)
            & (kpts[..., 1] >= fy0) & (kpts[..., 1] <= fy1)
        )
        vis = label["gt_kpts_valid_mask"]
        # Reference marks out-of-crop kpts with level 1 for valid objects
        # (geo_aware_transforms.py:157-190).
        vis = np.where(new_mask[:, None] & ~inside, 1.0, vis)
        label["gt_kpts_valid_mask"] = vis.astype(vis.dtype)

    img = sample["img"]
    canvas = np.zeros_like(img)
    canvas[fy0:fy1, fx0:fx1] = img[fy0:fy1, fx0:fx1]
    sample["img"] = canvas
    return sample


class Normalize:
    """(img - mean) / std in 0-255 space; optional original copy for viz
    (reference default_transforms.py:376-407)."""

    IMAGENET_MEAN = (123.675, 116.28, 103.53)
    IMAGENET_STD = (58.395, 57.12, 57.375)

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 keep_origin: bool = False):
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, 3)
        self.std = np.asarray(std, np.float32).reshape(1, 1, 3)
        self.inv_std = (1.0 / self.std).astype(np.float32)
        self.keep_origin = keep_origin

    def __call__(self, sample: Dict, rng) -> Dict:
        img = sample["img"].astype(np.float32)
        if self.keep_origin:
            sample["ori_img"] = img.copy()
        # In-place (img - mean) * (1/std): two passes, no temporaries.
        img -= self.mean
        img *= self.inv_std
        sample["img"] = img
        return sample


class Pad:
    """Zero-pad bottom/right to a multiple of ``size_divisor``; records
    ``pad_shape`` (reference default_transforms.py:410-433)."""

    def __init__(self, size_divisor: int = 32):
        self.size_divisor = size_divisor

    def __call__(self, sample: Dict, rng) -> Dict:
        img = sample["img"]
        h, w = img.shape[:2]
        ph = -(-h // self.size_divisor) * self.size_divisor
        pw = -(-w // self.size_divisor) * self.size_divisor
        canvas = np.zeros((ph, pw, img.shape[2]), dtype=img.dtype)
        canvas[:h, :w] = img
        sample["img"] = canvas
        sample["img_metas"]["pad_shape"] = (ph, pw)
        # True pixel extent before zero-fill: the uint8 transport zeroes
        # the border on the device after normalizing (ops.image_norm),
        # making it bit-identical to the float32 transport's 0.0.
        sample["img_metas"]["unpadded_shape"] = (h, w)
        return sample


class QuantizeU8:
    """Round to integral pixel values and store as uint8 for cheap
    host->device transport; normalization then happens on the device
    (``ops.image_norm.normalize_if_raw``).

    Divergence from the reference (documented, as in the JAX package):
    the reference normalizes the *float* output of PhotometricDistortion
    on the host WITHOUT clipping (brightness ±32 then contrast ×1.5 push
    pixels to roughly [-110, 430]); quantizing clamps them to [0, 255].
    ``TPU.IMAGE_TRANSPORT: float32`` keeps the float numerics. For the
    un-augmented eval pipeline pixels are already integral uint8, so the
    uint8 path is exact there."""

    def __call__(self, sample: Dict, rng) -> Dict:
        img = sample["img"]
        if img.dtype != np.uint8:
            sample["img"] = (
                np.clip(np.rint(img), 0, 255).astype(np.uint8)
            )
        return sample


def default_train_transforms(crop_hw: Tuple[int, int] = (320, 960),
                             device_normalize: bool = False) -> List:
    """Reference pipeline (dataset/monocon_dataset.py:23-35), minus
    ToTensor. ``crop_hw`` parameterizes the fixed crop for non-KITTI image
    sizes. ``device_normalize`` replaces the host Normalize with uint8
    quantization; the train step normalizes on the device (4x fewer bytes
    to copy)."""
    last = [QuantizeU8()] if device_normalize else [Normalize()]
    return [
        PhotometricDistortion(),
        RandomShift(prob=0.5, shift_range=(-32, 32)),
        RandomHorizontalFlip(prob=0.5),
        RandomCrop3D(prob=0.5, crop_size=tuple(crop_hw),
                     hide_kpts_in_crop_area=True),
        *last,
        Pad(32),
    ]


def default_test_transforms(device_normalize: bool = False) -> List:
    if device_normalize:
        # Eval images are untouched uint8; ship them raw and normalize
        # on the device: the same numerics, 4x fewer bytes.
        return [Pad(32)]
    return [Normalize(), Pad(32)]


class KeepOrigin:
    """Stash the current (unnormalized) image as ``ori_img`` for video
    export, like Normalize(keep_origin=True) does, without normalizing."""

    def __call__(self, sample: Dict, rng) -> Dict:
        sample["ori_img"] = sample["img"].copy()
        return sample


def default_raw_transforms(device_normalize: bool = False) -> List:
    """Raw-sequence inference keeps the unnormalized image for video export
    (reference dataset/kitti_raw_dataset.py:15-20). ``device_normalize``
    ships raw uint8 frames and normalizes on the device."""
    if device_normalize:
        return [KeepOrigin(), Pad(32)]
    return [Normalize(keep_origin=True), Pad(32)]
