"""The port's training augmentations against the JAX package's: the
RGB <-> HSV pair against OpenCV (and its C version against its numpy
version), each transform on the same sample and generator, and the
train-split dataset and loader as a whole."""

import copy

import cv2
import numpy as np
import pytest
import torch

from monocon_tpu.data import transforms as jax_tf
from monocon_tpu.data.loader import DataLoader as JaxDataLoader
from monocon_tpu.data.monocon_dataset import MonoConDataset as JaxDataset
from monocon_tpu.data.synthetic import generate_kitti_dataset as jax_generate
from monocon_tpu_torch.data import color
from monocon_tpu_torch.data import transforms as tf
from monocon_tpu_torch.data.loader import DataLoader
from monocon_tpu_torch.data.monocon_dataset import MonoConDataset
from torch_port_helpers import assert_same

# numpy HSV against OpenCV's float32 cvtColor: the pair follows OpenCV's
# formulas, but OpenCV's SIMD path may fuse a multiply-add or round a
# quotient once where the scalar formula rounds twice: ulp-level
# differences, at most 1 ulp of 430 (3.1e-5) in this test.
HSV_TOL = dict(rtol=1e-5, atol=1e-4)
IMAGE_HW, CROP_HW = (96, 320), (64, 256)
SEEDS = range(16)
# uint8 images of the loader: a pixel may differ by 1 where the float
# value sits on a rounding tie after ulp-level HSV differences.
MAX_OFF_BY_ONE_SHARE = 1e-3


def _test_image(rng):
    """375x1242 float32 in [-110, 430] (brightness +-32 and contrast x1.5
    make such values), with gray rows (s = 0), zero rows, pure and mixed
    hues, hues just below 360 and integral rows."""
    img = rng.uniform(-110, 430, (375, 1242, 3)).astype(np.float32)
    img[:5] = rng.uniform(-110, 430, (5, 1242, 1)).astype(np.float32)
    img[5:7] = 0
    img[7, :8] = [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0],
                  [0, 255, 255], [255, 0, 255], [-50, -80, -20], [430, 0, 0]]
    img[8, :200] = [200, 10, 10]
    img[8, :200, 2] += np.arange(200, dtype=np.float32) * 1e-5  # h -> 360
    img[9] = np.round(img[9])
    return img


def test_hsv_pair_matches_opencv():
    img = _test_image(np.random.default_rng(0))
    hsv = color.rgb_to_hsv(img)
    np.testing.assert_allclose(hsv, cv2.cvtColor(img, cv2.COLOR_RGB2HSV),
                               **HSV_TOL)
    assert (hsv[..., 0] >= 0).all() and (hsv[..., 0] <= 360).all()
    assert (hsv[:5, :, 1] == 0).all() and (hsv[5:7] == 0).all()
    np.testing.assert_array_equal(hsv[7, :6, 0], [0, 120, 240, 60, 180, 300])
    # HSV -> RGB on OpenCV's own HSV, as read, and after the jitter of
    # PhotometricDistortion (hue shifted and wrapped, saturation scaled).
    want_hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    jittered = want_hsv.copy()
    jittered[..., 0] = np.mod(jittered[..., 0] + np.float32(17.3), 360.0)
    jittered[..., 1] *= np.float32(1.4)
    for h in (want_hsv, jittered):
        np.testing.assert_allclose(color.hsv_to_rgb(h),
                                   cv2.cvtColor(h, cv2.COLOR_HSV2RGB),
                                   **HSV_TOL)
    gray = color.hsv_to_rgb(want_hsv[:5])
    np.testing.assert_array_equal(gray, np.repeat(gray[..., :1], 3, -1))


def test_native_hsv_equals_numpy():
    """The C pair the loader runs gives the numpy pair's bits."""
    img = _test_image(np.random.default_rng(1))
    hsv = color.rgb_to_hsv(img)
    assert color.rgb_to_hsv_(img.copy()).tobytes() == hsv.tobytes()
    hsv[..., 0] = np.mod(hsv[..., 0] - np.float32(11.5), 360.0)
    hsv[..., 1] *= np.float32(0.6)
    want = color.hsv_to_rgb(hsv)
    assert color.hsv_to_rgb_(hsv.copy()).tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="C-contiguous float32"):
        color.rgb_to_hsv_(img[:, ::2])


# ------------------------------------------------------------- transforms
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_train")
    jax_generate(str(root), num_train=5, num_val=2, image_hw=IMAGE_HW,
                 max_objects=6, seed=9)
    return root


@pytest.fixture(scope="module")
def raw_samples(tree):
    """Every train image of the tree with its labels, before any
    transform (read by the JAX dataset)."""
    ds = JaxDataset(str(tree), "train", transforms=[])
    samples = [ds.get_sample(i) for i in range(len(ds))]
    assert sum(int(s["label"]["mask"].sum()) for s in samples) >= 5
    return samples


TRANSFORMS = {
    "shift": (lambda m: m.RandomShift(prob=0.5), "is_shifted"),
    "flip": (lambda m: m.RandomHorizontalFlip(prob=0.5), "is_flipped"),
    "crop": (lambda m: m.RandomCrop3D(prob=0.5, crop_size=CROP_HW,
                                      hide_kpts_in_crop_area=True),
             "is_cropped"),
    "range_crop": (lambda m: m.RandomRangeCrop3D(prob=0.5,
                                                 height_range=(48, 64),
                                                 aspect_ratio=3.0),
                   "is_cropped"),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_geometric_transform_matches_jax(name, raw_samples):
    """Image, labels, calibration and metas exactly equal, over 16
    generators per sample: each branch is taken, and the generators stay
    in step."""
    make, flag = TRANSFORMS[name]
    ours, theirs = make(tf), make(jax_tf)
    taken = set()
    for i, sample in enumerate(raw_samples):
        for seed in SEEDS:
            got = ours(copy.deepcopy(sample), rng := np.random.default_rng(seed))
            want = theirs(copy.deepcopy(sample),
                          jax_rng := np.random.default_rng(seed))
            assert_same(got, want, f"{name} sample {i} seed {seed}")
            assert rng.random() == jax_rng.random()
            taken.add(got["img_metas"][flag])
    assert taken == {True, False}


def test_flip_kpt_order_matches_jax():
    assert_same(tf.FLIP_KPT_ORDER, jax_tf.FLIP_KPT_ORDER)


def test_photometric_distortion_matches_jax(raw_samples):
    """The float image within the HSV tolerance, the generator in step,
    the rest of the sample untouched; then QuantizeU8 of both."""
    worst = 0.0
    for i, sample in enumerate(raw_samples):
        for seed in SEEDS[:6]:
            got = tf.PhotometricDistortion()(
                copy.deepcopy(sample), rng := np.random.default_rng(seed))
            want = jax_tf.PhotometricDistortion()(
                copy.deepcopy(sample), jax_rng := np.random.default_rng(seed))
            assert rng.random() == jax_rng.random()
            assert got["img"].dtype == np.float32
            np.testing.assert_allclose(got["img"], want["img"], **HSV_TOL,
                                       err_msg=f"sample {i} seed {seed}")
            worst = max(worst, float(np.abs(got["img"] - want["img"]).max()))
            assert_same({k: v for k, v in got.items() if k != "img"},
                        {k: v for k, v in want.items() if k != "img"})
            q = tf.QuantizeU8()(got, None)["img"]
            q_jax = jax_tf.QuantizeU8()(want, None)["img"]
            assert q.dtype == np.uint8
            assert np.abs(q.astype(int) - q_jax).max() <= 1
    print(f"PhotometricDistortion: max |port - JAX| = {worst:.3g}")


@pytest.mark.parametrize("device_normalize", [False, True])
def test_default_train_transforms_match_jax(device_normalize):
    ours = tf.default_train_transforms(CROP_HW, device_normalize)
    theirs = jax_tf.default_train_transforms(CROP_HW, device_normalize)
    assert [type(t).__name__ for t in ours] == [
        type(t).__name__ for t in theirs]
    for a, b in zip(ours, theirs):
        assert_same(vars(a), vars(b))


# ------------------------------------------------------- dataset, loader
def test_train_loader_matches_jax(tree):
    """The train split through the default augmentations (uint8
    transport) and the loader, shuffled, batch 2 over 5 images, epochs 1
    and 2: the same order, labels (as tensors), metas and calibrations;
    images equal but for a share of pixels off by 1."""
    crop = tuple(CROP_HW)
    port = DataLoader(
        MonoConDataset(str(tree), "train", transforms=tf.default_train_transforms(
            crop, device_normalize=True)),
        "cpu", batch_size=2, shuffle=True, num_workers=2, pad_hw=IMAGE_HW,
        seed=3, labels=True)
    jax = JaxDataLoader(
        JaxDataset(str(tree), "train", transforms=jax_tf.default_train_transforms(
            crop, device_normalize=True)),
        batch_size=2, shuffle=True, num_workers=2, pad_hw=IMAGE_HW, seed=3)
    off, total = 0, 0
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax.set_epoch(epoch)
        port_batches, jax_batches = list(port), list(jax)
        assert [len(b["p2"]) for b in port_batches] == [2, 2, 1]
        for got, want in zip(port_batches, jax_batches, strict=True):
            img, want_img = got.pop("img").numpy(), want.pop("img")
            assert img.dtype == want_img.dtype == np.uint8
            diff = np.abs(img.astype(int) - want_img)
            assert diff.max() <= 1
            off += int((diff > 0).sum())
            total += diff.size
            assert all(isinstance(v, torch.Tensor)
                       for v in got["label"].values())
            assert_same(got, want)
    share = off / total
    print(f"train loader: {off} of {total} uint8 values off by 1 "
          f"({share:.2e})")
    assert share <= MAX_OFF_BY_ONE_SHARE


def test_train_split_defaults_to_train_transforms(tree):
    ds = MonoConDataset(str(tree), "train")
    assert [type(t).__name__ for t in ds.transforms.transforms] == [
        type(t).__name__ for t in JaxDataset(str(tree), "train")
        .transforms.transforms]


def test_image_cache_matches_jax(tree, tmp_path):
    """The decoded-image cache: the first read writes ``<id>.npy``, the
    second reads it back; the same files and pixels as the JAX cache."""
    for package, cls in (("port", MonoConDataset), ("jax", JaxDataset)):
        ds = cls(str(tree), "val", image_cache=str(tmp_path / package))
        first = ds.get_sample(0)["img"]
        ds.image_cache.put = None   # a second read must not write
        assert_same(ds.get_sample(0)["img"], first)
    files = sorted(p.name for p in (tmp_path / "port" / "val").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax" / "val").iterdir())
    assert len(files) == 1
    assert_same(np.load(tmp_path / "port" / "val" / files[0]),
                np.load(tmp_path / "jax" / "val" / files[0]))
