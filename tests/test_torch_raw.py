"""The port's raw-drive path against the JAX package's on the CPU:
``KITTIRawDataset`` samples, ``Resize3D`` against ``cv2.resize``,
``BatchedFrames`` and ``pipelined_frames``, the streamed forward as a whole
(the JAX ``test_raw.py`` forward against ``test_raw.make_stream``), and the
``monocon_tpu_torch.test_raw`` CLI."""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monocon_tpu.data import KITTIRawDataset as JaxRaw
from monocon_tpu.data import kitti_raw as jax_kitti_raw
from monocon_tpu.data.calib import Calibration as JaxCalibration
from monocon_tpu.data.transforms import Resize3D as JaxResize3D
from monocon_tpu.data.transforms import \
    default_raw_transforms as jax_raw_transforms
from monocon_tpu.ops.decode import decode_predictions as jax_decode
from monocon_tpu.ops.image_norm import normalize_if_raw as jax_normalize
from monocon_tpu.utils import split_batch_detections as jax_split
from monocon_tpu.utils import to_vis_format as jax_vis_format
from monocon_tpu.utils import streaming as jax_streaming
from monocon_tpu_torch.data import kitti_raw
from monocon_tpu_torch.data.calib import Calibration
from monocon_tpu_torch.data.kitti_raw import KITTIRawDataset
from monocon_tpu_torch.data.png import read_png
from monocon_tpu_torch.data.transforms import (Resize3D,
                                               default_raw_transforms)
from monocon_tpu_torch.test_raw import make_stream
from monocon_tpu_torch.utils import streaming
from torch_port_helpers import (F32_TOL, assert_same, perturb_variables,
                                port_detector)

ROOT = Path(__file__).resolve().parent.parent
FRAME_HW = (96, 320)
FRAMES = 7
P_RECT_02 = ("P_rect_02: 7.2e+02 0.0 6.0e+02 4.4e+01 0.0 7.2e+02 1.7e+02 "
             "2.1e-01 0.0 0.0 1.0 2.7e-03\n")


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """7 random frames written with ``cv2.imwrite``, as the JAX package's
    raw test writes them, and a ``calib_cam_to_cam.txt``."""
    root = tmp_path_factory.mktemp("drive")
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(FRAMES):
        cv2.imwrite(str(frames / f"{i:010d}.png"),
                    rng.integers(0, 255, (*FRAME_HW, 3), np.uint8))
    calib = root / "calib_cam_to_cam.txt"
    calib.write_text("S_rect_02: 1.2e+03 3.7e+02\n" + P_RECT_02)
    return frames, calib


# ----------------------------------------------------------------- dataset
@pytest.mark.parametrize("device_normalize", [False, True],
                         ids=["host_normalize", "uint8"])
def test_raw_samples_equal_jax(drive, device_normalize):
    """Every sample: image, original copy, metas (each a one-element
    list), calibration and the fake batch dim, exactly the JAX dataset's."""
    frames, calib = drive
    ours = KITTIRawDataset(str(frames), str(calib),
                           default_raw_transforms(device_normalize))
    theirs = JaxRaw(str(frames), str(calib),
                    jax_raw_transforms(device_normalize))
    assert len(ours) == len(theirs) == FRAMES
    for i in range(FRAMES):
        got, want = ours[i], theirs[i]
        assert got["img"].shape[0] == 1 and got["ori_img"].shape[0] == 1
        assert got["img"].dtype == (np.uint8 if device_normalize
                                    else np.float32)
        assert_same(got, want, f"frame {i}")


def test_default_transforms_normalize_as_jax(drive):
    """Without ``transforms`` the dataset normalises on the host and keeps
    the float32 original, as the JAX package's does."""
    frames, calib = drive
    got, want = (KITTIRawDataset(str(frames), str(calib))[3],
                 JaxRaw(str(frames), str(calib))[3])
    assert got["ori_img"].dtype == np.float32
    assert_same(got, want)


def test_frame_shape_reads_the_header_only(drive, monkeypatch):
    frames, calib = drive
    ds = KITTIRawDataset(str(frames), str(calib))

    def no_decode(*_):
        raise AssertionError("decoded")

    monkeypatch.setattr(kitti_raw, "read_png", no_decode)
    assert [ds.frame_shape(i) for i in range(FRAMES)] == [FRAME_HW] * FRAMES
    assert ds.frame_shape(0) == JaxRaw(str(frames), str(calib)).frame_shape(0)


def test_other_extensions_are_refused(drive, tmp_path):
    frames, calib = drive
    cv2.imwrite(str(tmp_path / "0000000000.jpg"),
                np.zeros((*FRAME_HW, 3), np.uint8))
    with pytest.raises(ValueError, match="no JPEG decoder"):
        KITTIRawDataset(str(tmp_path), str(calib), img_extension="jpg")
    # The JAX package reads it (with OpenCV).
    assert len(JaxRaw(str(tmp_path), str(calib), img_extension="jpg")) == 1


def test_parse_cam_to_cam_equals_jax(drive):
    _, calib = drive
    np.testing.assert_array_equal(kitti_raw.parse_cam_to_cam(str(calib)),
                                  jax_kitti_raw.parse_cam_to_cam(str(calib)))


# ----------------------------------------------------------------- Resize3D
def _resize_samples(img, rng):
    """The same sample for both packages: image, calibration and labels."""
    p2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
                   [0, 0, 1, 0.003]], np.float32)
    label = {"gt_bboxes": rng.uniform(0, 300, (5, 4)).astype(np.float32),
             "centers2d": rng.uniform(0, 300, (5, 2)).astype(np.float32),
             "gt_kpts_2d": rng.uniform(0, 300, (5, 18)).astype(np.float32)}
    return [{"img": img.copy(), "img_metas": {"ori_shape": img.shape[:2]},
             "calib": cls.from_p2(p2.copy()),
             "label": {k: v.copy() for k, v in label.items()}}
            for cls in (Calibration, JaxCalibration)]


@pytest.mark.parametrize("target_hw", [(120, 400), (64, 200), (375, 1242)],
                         ids=["up", "down", "kitti"])
def test_resize3d_uint8_within_one_level_of_cv2(target_hw, rng):
    """OpenCV rounds uint8 through 11-bit weights; the port reproduces its
    vectorised rounding: within one level, on few pixels (measured:
    0.34% of the values up 5:4, none down 2:3, 0.07% to 375x1242 from
    96x320)."""
    img = rng.integers(0, 256, (*FRAME_HW, 3), np.uint8)
    ours, theirs = _resize_samples(img, rng)
    got = Resize3D(target_hw)(ours, rng)
    want = JaxResize3D(target_hw)(theirs, rng)
    diff = np.abs(got["img"].astype(int) - want["img"])
    print(f"{target_hw}: {np.mean(diff > 0):.4%} of the values differ, "
          f"max {diff.max()}")
    assert got["img"].dtype == np.uint8 and got["img"].shape == (*target_hw, 3)
    assert diff.max() <= 1
    assert np.mean(diff > 0) < 0.01
    np.testing.assert_allclose(got["calib"].P2, want["calib"].P2, **F32_TOL)
    for key, value in want["label"].items():
        np.testing.assert_allclose(got["label"][key], value, **F32_TOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["img_metas"]["scale_hw"],
                               want["img_metas"]["scale_hw"], **F32_TOL)
    assert got["img_metas"]["ori_shape"] == want["img_metas"]["ori_shape"]


@pytest.mark.parametrize("target_hw", [(120, 400), (64, 200)],
                         ids=["up", "down"])
def test_resize3d_float32_within_1e3_of_cv2(target_hw, rng):
    img = rng.uniform(0, 255, (*FRAME_HW, 3)).astype(np.float32)
    ours, theirs = _resize_samples(img, rng)
    got = Resize3D(target_hw)(ours, rng)["img"]
    want = JaxResize3D(target_hw)(theirs, rng)["img"]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_resize3d_keeps_a_raw_frame_without_labels(rng):
    sample = {"img": rng.integers(0, 256, (*FRAME_HW, 3), np.uint8),
              "img_metas": {}, "calib": Calibration.from_p2(
                  np.eye(3, 4, dtype=np.float32)), "label": None}
    out = Resize3D((48, 160))(sample, rng)
    assert out["img"].shape == (48, 160, 3) and out["label"] is None
    np.testing.assert_allclose(out["img_metas"]["scale_hw"], [0.5, 0.5])


# ---------------------------------------------------------------- streaming
class _Frames:
    """7 one-frame samples whose pixels hold their index."""

    def __len__(self):
        return FRAMES

    def __getitem__(self, i):
        if not 0 <= i < FRAMES:
            raise IndexError(i)
        return {"img": np.full((1, 2, 3, 3), i, np.uint8)}


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_frames_and_pipeline_equal_jax(batch):
    """Order, padding by repeating the last frame, ``count``, and the
    pipeline's results in frame order, as the JAX package's."""
    ours = streaming.BatchedFrames(_Frames(), batch)
    theirs = jax_streaming.BatchedFrames(_Frames(), batch)
    assert len(ours) == len(theirs) == -(-FRAMES // batch)
    for j in range(len(ours)):
        assert_same(ours[j], theirs[j], f"batch {j}")
    with pytest.raises(IndexError):
        ours[len(ours)]

    def infer(sample):
        return sample["img"][:, 0, 0, 0].astype(int) * 10

    def finalize(out, sample):
        return list(out[: sample["count"]])

    got = list(streaming.pipelined_frames(ours, infer, finalize,
                                          prefetch=2, workers=3))
    want = list(jax_streaming.pipelined_frames(theirs, infer, finalize,
                                               prefetch=2, workers=3))
    assert got == want
    assert sum(got, []) == [10 * i for i in range(FRAMES)]


def test_pinned_upload_on_the_cpu_shares_memory():
    upload = streaming.PinnedUpload("cpu")
    array = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    tensor = upload(array)
    assert tensor.device.type == "cpu"
    array[0, 0, 0] = 99
    assert int(tensor[0, 0, 0]) == 99


# ------------------------------------------------------ the stream as a whole
@pytest.fixture(scope="module")
def jax_model():
    from monocon_tpu.models import create_detector_state

    model, variables = create_detector_state(jax.random.PRNGKey(0),
                                             image_hw=(64, 96))
    variables = perturb_variables(variables, np.random.default_rng(3))
    # Most top-30 scores clear the 0.4 threshold.
    variables["params"]["heads"]["heatmap"]["conv2"]["bias"][:] = 0.5
    return model, variables


def _jax_stream(model, variables, dataset, batch, threshold):
    """The root test_raw.py's forward and finalize, unpipelined."""
    @jax.jit
    def forward(variables, image, p2, img_hw):
        image = jax_normalize(image, img_hw)
        pred = model.apply(variables, image, train=False)
        return jax_decode(pred, p2, (image.shape[1], image.shape[2]))

    sample0 = dataset[0]
    p2 = jnp.asarray(np.tile(sample0["calib"][0].P2[None].astype(np.float32),
                             (batch, 1, 1)))
    img_hw = jnp.asarray(np.tile(np.array(
        sample0["img_metas"]["unpadded_shape"], np.int32), (batch, 1)))
    frames = jax_streaming.BatchedFrames(dataset, batch)
    out = []
    for j in range(len(frames)):
        sample = frames[j]
        decoded = forward(variables, jnp.asarray(sample["img"]), p2, img_hw)
        per_image = jax_split({k: np.asarray(v) for k, v in decoded.items()},
                              threshold)
        out += jax_vis_format(per_image[: sample["count"]])
    return out


def _unmatched(got, want):
    """Rows of ``want`` ((N, k), the label first) and of ``got`` left over
    once each row of ``want`` is matched to its own row of ``got`` with the
    same label and the rest within F32_TOL (rows whose scores tie may come
    in any order)."""
    free = list(range(len(got)))
    missing = []
    for row in want:
        for j in free:
            if got[j, 0] == row[0] and np.allclose(got[j, 1:], row[1:],
                                                   **F32_TOL):
                free.remove(j)
                break
        else:
            missing.append(row)
    return missing, got[free]


def assert_vis_close(got, want, nms_ties: int = 0):
    """Vis formats frame by frame: the same detections, labels equal up to
    score ties, boxes and scores within ``F32_TOL``. ``nms_ties``: how many
    detections a frame may hold that the other package's frame lacks, where
    two neighbouring heatmap cells tie to the last bit and the 3x3 max-pool
    NMS keeps one in one package and the other (or both) in the other."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        rows = [np.concatenate([b["labels_3d"][:, None], b["scores_3d"][:, None],
                                b["boxes_3d"]], 1).astype(np.float64)
                for b in (g["img_bbox"], w["img_bbox"])]
        assert rows[0].shape == rows[1].shape, f"frame {i}"
        missing, extra = _unmatched(*rows)
        assert len(missing) == len(extra) <= nms_ties, (
            f"frame {i}: {missing} against {extra}")
        assert len(g["img_bbox2d"]) == len(w["img_bbox2d"]) == 3
        lost = 0
        for c, (a, b) in enumerate(zip(g["img_bbox2d"], w["img_bbox2d"])):
            missing, extra = _unmatched(np.pad(a, ((0, 0), (1, 0))),
                                        np.pad(b, ((0, 0), (1, 0))))
            lost += max(len(missing), len(extra))
        assert lost <= 2 * nms_ties, f"frame {i}: 2D boxes"


def test_stream_matches_jax_test_raw(drive, jax_model):
    """The port's pipelined stream (uint8 frames, batches of 3, the last
    padded) against the JAX package's raw forward on the same frames and
    weights: every frame's vis format within F32_TOL."""
    frames, calib = drive
    model, variables = jax_model
    dataset = KITTIRawDataset(str(frames), str(calib),
                              default_raw_transforms(True))
    want = _jax_stream(model, variables,
                       JaxRaw(str(frames), str(calib), jax_raw_transforms(True)),
                       3, 0.4)
    detector = port_detector(variables).eval()
    batches, infer, finalize = make_stream(detector, dataset, "cpu", 3, 0.4)
    got = sum(streaming.pipelined_frames(batches, infer, finalize), [])
    assert sum(len(v["img_bbox"]["labels_3d"]) for v in want) > 0
    assert_vis_close(got, want)


def test_test_raw_cli_on_the_cpu(drive, jax_model, tmp_path):
    """``python -m monocon_tpu_torch.test_raw --device cpu``: three PNG
    sequences, one file per frame, at the frame's size (BEV 600x1200)."""
    import torch

    from monocon_tpu_torch.utils.weights import state_dict_from_jax

    frames, calib = drive
    pth = tmp_path / "model.pth"
    torch.save({"state_dict": {"model": state_dict_from_jax(jax_model[1])}},
               pth)
    out = tmp_path / "raw"
    proc = subprocess.run(
        [sys.executable, "-m", "monocon_tpu_torch.test_raw", "--device",
         "cpu", "--data_dir", str(frames), "--calib_file", str(calib),
         "--checkpoint_file", str(pth), "--save_dir", str(out), "--batch",
         "3", "--score_threshold", "0"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"Streamed {FRAMES} frames" in proc.stdout
    names = [f"{i:06d}.png" for i in range(FRAMES)]
    for item, hw in (("2d", FRAME_HW), ("3d", FRAME_HW), ("bev", (600, 1200))):
        assert sorted(os.listdir(out / item)) == names
        assert read_png(out / item / names[-1]).shape == (*hw, 3)
