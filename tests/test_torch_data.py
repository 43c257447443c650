"""The port's data path against the JAX package's and OpenCV's: PNG reading,
the dataset, collate and the loader on the CPU, and the synthetic
generator. All comparisons are exact."""

import zlib

import cv2
import numpy as np
import pytest
import torch

from monocon_tpu.data.loader import DataLoader as JaxDataLoader
from monocon_tpu.data.loader import collate as jax_collate
from monocon_tpu.data.monocon_dataset import MonoConDataset as JaxDataset
from monocon_tpu.data.synthetic import generate_kitti_dataset as jax_generate
from monocon_tpu.data.transforms import (
    default_test_transforms as jax_test_transforms,
)
from monocon_tpu_torch.data import png
from monocon_tpu_torch.data.loader import DataLoader, collate
from monocon_tpu_torch.data.monocon_dataset import MonoConDataset
from monocon_tpu_torch.data.synthetic import generate_kitti_dataset
from monocon_tpu_torch.data.transforms import default_test_transforms
from torch_port_helpers import assert_same

PAD_HW = (160, 512)


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """A tree written by the JAX generator, its PNGs by OpenCV."""
    root = tmp_path_factory.mktemp("kitti_jax")
    jax_generate(str(root), num_train=2, num_val=5, image_hw=PAD_HW, seed=7)
    return root


def opencv_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def test_png_reads_every_opencv_file_of_a_tree(jax_tree):
    paths = sorted(jax_tree.rglob("*.png"))
    assert len(paths) == 12   # 7 in training/, 5 in testing/
    for path in paths:
        assert_same(png.read_png(path), opencv_rgb(path), str(path))


def _filter_bytes(path, height, stride):
    """The filter type byte of every row of a written PNG."""
    data = path.read_bytes()
    start = data.index(b"IDAT") + 4
    length = int.from_bytes(data[start - 8:start - 4], "big")
    raw = np.frombuffer(zlib.decompress(data[start:start + length]), np.uint8)
    return raw.reshape(height, stride + 1)[:, 0]


@pytest.mark.parametrize("filter_type", range(5),
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_filter_types_match_opencv(filter_type, tmp_path, rng):
    """Every row filtered with one type; noise beside a smooth ramp, so
    that each filter's predictor sees both."""
    img = rng.integers(0, 256, (23, 41, 3), dtype=np.uint8)
    img[:, :20] = np.arange(20, dtype=np.uint8)[None, :, None] * 7
    path = tmp_path / f"filter{filter_type}.png"
    png.write_png(path, img, filter_type)
    assert (_filter_bytes(path, 23, 41 * 3) == filter_type).all()
    assert_same(opencv_rgb(path), img)
    assert_same(png.read_png(path), img)


def test_png_rgba_drops_alpha(tmp_path, rng):
    rgba = rng.integers(0, 256, (9, 14, 4), dtype=np.uint8)
    path = tmp_path / "rgba.png"
    png.write_png(path, rgba, filter_type=4)
    assert_same(png.read_png(path), opencv_rgb(path))
    assert_same(png.read_png(path), np.ascontiguousarray(rgba[..., :3]))


@pytest.mark.parametrize("kind", ["16-bit", "gray", "cut short"])
def test_png_refuses_other_kinds(kind, tmp_path, rng):
    path = tmp_path / f"{kind}.png"
    if kind == "cut short":
        png.write_png(path, rng.integers(0, 256, (40, 50, 3), np.uint8))
        path.write_bytes(path.read_bytes()[:-100])
    else:
        cv2.imwrite(str(path), np.zeros((4, 5, 3), np.uint16)
                    if kind == "16-bit" else np.zeros((4, 5), np.uint8))
    with pytest.raises(ValueError, match=str(path)):
        png.read_png(path)


@pytest.mark.parametrize("device_normalize", [True, False],
                         ids=["uint8", "float32"])
def test_dataset_and_collate_match_jax(jax_tree, device_normalize):
    jax_ds = JaxDataset(str(jax_tree), "val", transforms=jax_test_transforms(
        device_normalize=device_normalize))
    port_ds = MonoConDataset(str(jax_tree), "val",
                             transforms=default_test_transforms(
                                 device_normalize=device_normalize))
    assert len(port_ds) == len(jax_ds) == 5
    jax_samples, port_samples = [], []
    for i in range(len(jax_ds)):
        jax_samples.append(jax_ds.get_sample(i, np.random.default_rng(i)))
        port_samples.append(port_ds.get_sample(i, np.random.default_rng(i)))
        assert_same(port_samples[-1], jax_samples[-1], f"sample {i}")
    assert_same(collate(port_samples, PAD_HW),
                jax_collate(jax_samples, PAD_HW))
    assert_same(port_ds.collect_gt_annos(), jax_ds.collect_gt_annos())


def test_loader_matches_jax_on_the_cpu(jax_tree):
    """Batch 2 over 5 images: the same order and contents, the last batch
    short (the JAX loader pads it only when asked to); the device keys
    arrive as CPU tensors."""
    transforms = default_test_transforms(device_normalize=True)
    port = DataLoader(MonoConDataset(str(jax_tree), "val",
                                     transforms=transforms), "cpu",
                      batch_size=2, shuffle=False, num_workers=2,
                      pad_hw=PAD_HW)
    jax = JaxDataLoader(JaxDataset(str(jax_tree), "val",
                                   transforms=jax_test_transforms(True)),
                        batch_size=2, shuffle=False, num_workers=2,
                        pad_hw=PAD_HW)
    port_batches, jax_batches = list(port), list(jax)
    assert [len(b["p2"]) for b in port_batches] == [2, 2, 1]
    for got, want in zip(port_batches, jax_batches, strict=True):
        for key in ("img", "img_hw", "p2"):
            assert isinstance(got[key], torch.Tensor)
            assert got[key].device == torch.device("cpu")
        assert_same(got, want)


def test_synthetic_generator_writes_the_jax_labels(tmp_path):
    """Labels, calibrations and split lists byte-equal to the JAX
    generator's; the images differ (another raster) but have the size."""
    args = dict(num_train=3, num_val=4, image_hw=(200, 640), seed=11)
    jax_generate(str(tmp_path / "jax"), **args)
    generate_kitti_dataset(str(tmp_path / "port"), **args)
    jax_files = sorted(p.relative_to(tmp_path / "jax")
                       for p in (tmp_path / "jax").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert port_files == jax_files
    texts = [f for f in jax_files if f.suffix == ".txt"]
    assert len(texts) == 4 + 7 * 2 + 4   # ImageSets, calib+label, testing calib
    for f in texts:
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f
    for f in jax_files:
        if f.suffix == ".png":
            img = png.read_png(tmp_path / "port" / f)
            assert img.shape == (200, 640, 3)
            assert_same(opencv_rgb(tmp_path / "port" / f), img)
