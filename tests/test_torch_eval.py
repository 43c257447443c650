"""The port's evaluation path against the JAX package's: the KITTI AP
evaluator (C++ matcher and rotated IoU), the conversion to KITTI
annotations, the ``.pth`` import, the engine as a whole on one checkpoint
and tree, and the ``monocon_tpu_torch.test`` CLI."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from monocon_tpu.config import get_default_cfg as jax_default_cfg
from monocon_tpu.config import load_cfg as jax_load_cfg
from monocon_tpu.data.base_dataset import KittiMono3D as JaxKitti
from monocon_tpu.data.synthetic import generate_kitti_dataset as jax_generate
from monocon_tpu.engine.engine import MonoConEngine as JaxEngine
from monocon_tpu.eval import kitti_eval as jax_kitti_eval
from monocon_tpu.eval import kitti_eval_coco_style as jax_coco_style
from monocon_tpu.eval.rotate_iou import rotate_iou_pairs as jax_rotate_pairs
from monocon_tpu.models import create_detector_state
from monocon_tpu.utils import convert as jax_convert
from monocon_tpu.utils.torch_convert import save_torch_checkpoint
from monocon_tpu_torch.config import get_default_cfg, load_cfg
from monocon_tpu_torch.data.loader import collate
from monocon_tpu_torch.data.monocon_dataset import MonoConDataset
from monocon_tpu_torch.data.transforms import default_test_transforms
from monocon_tpu_torch.engine.checkpoint import load_weights
from monocon_tpu_torch.engine.engine import MonoConEngine
from monocon_tpu_torch.eval import kitti_eval, kitti_eval_coco_style
from monocon_tpu_torch.eval.rotate_iou import rotate_iou_pairs
from monocon_tpu_torch.models.detector import create_detector
from monocon_tpu_torch.utils import convert
from monocon_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_helpers import assert_same, perturb_variables

ROOT = Path(__file__).resolve().parent.parent
CLASSES = ["Pedestrian", "Cyclist", "Car"]
# The engine's KITTI annotations, JAX against the port, both float32.
ANNO_TOL = dict(rtol=1e-3, atol=1e-3)
SLICE_HW = (160, 512)


# ---------------------------------------------------------------- evaluator
@pytest.fixture(scope="module")
def eval_annos(tmp_path_factory):
    """GT annotations of a 24-image KITTI-size synthetic val split, and
    detections made from them: location +-0.3 m, bbox +-3 px, dimensions
    +-5%, random scores, plus false positives."""
    root = tmp_path_factory.mktemp("kitti_eval")
    jax_generate(str(root), num_train=0, num_val=24, max_objects=8, seed=21)
    gts = JaxKitti(str(root), "val").collect_gt_annos()
    rng = np.random.default_rng(21)
    dts = []
    for gt in gts:
        keep = gt["name"] != "DontCare"
        n = int(keep.sum())
        m = int(rng.integers(0, 3))     # false positives
        x1 = rng.uniform(0, 1100, m)
        y1 = rng.uniform(100, 300, m)
        fp_box = np.stack([x1, y1, x1 + rng.uniform(20, 150, m),
                           y1 + rng.uniform(30, 80, m)], -1)
        dts.append({
            "name": np.concatenate([gt["name"][keep],
                                    rng.choice(CLASSES, m)]),
            "truncated": np.zeros(n + m),
            "occluded": np.zeros(n + m),
            "alpha": np.concatenate([gt["alpha"][keep] + rng.normal(0, 0.1, n),
                                     rng.uniform(-np.pi, np.pi, m)]),
            "bbox": np.concatenate([gt["bbox"][keep]
                                    + rng.uniform(-3, 3, (n, 4)), fp_box]),
            "dimensions": np.concatenate([
                gt["dimensions"][keep] * rng.uniform(0.95, 1.05, (n, 3)),
                rng.uniform(0.5, 4, (m, 3))]),
            "location": np.concatenate([
                gt["location"][keep] + rng.uniform(-0.3, 0.3, (n, 3)),
                np.stack([rng.uniform(-10, 10, m), rng.uniform(1, 2, m),
                          rng.uniform(5, 50, m)], -1).reshape(m, 3)]),
            "rotation_y": np.concatenate([
                gt["rotation_y"][keep] + rng.normal(0, 0.1, n),
                rng.uniform(-np.pi, np.pi, m)]),
            "score": rng.uniform(0.05, 1.0, n + m),
        })
    return gts, dts


def test_kitti_eval_matches_jax(eval_annos):
    gts, dts = eval_annos
    for types in (["bbox"], ["bbox", "bev", "3d"]):
        got_str, got = kitti_eval(gts, dts, CLASSES, eval_types=types)
        want_str, want = jax_kitti_eval(gts, dts, CLASSES, eval_types=types)
        assert got_str == want_str
        assert got == want
    for cls in CLASSES:
        assert max(v for k, v in got.items()
                   if k.startswith(f"KITTI/{cls}_3D")) > 0, cls
    assert kitti_eval_coco_style(gts, dts, CLASSES) == jax_coco_style(
        gts, dts, CLASSES)


def test_rotate_iou_pairs_bit_equal():
    rng = np.random.default_rng(5)
    p = 20_000
    b = np.stack([rng.uniform(-40, 40, p), rng.uniform(0, 70, p),
                  rng.uniform(0.2, 6, p), rng.uniform(0.2, 6, p),
                  rng.uniform(-np.pi, np.pi, p)], -1)
    q = b + np.concatenate([rng.uniform(-3, 3, (p, 2)),
                            rng.uniform(-0.5, 0.5, (p, 3))], -1)
    for crit in (-1, 0, 1, 2):
        want = jax_rotate_pairs(b, q, crit)
        assert_same(rotate_iou_pairs(b, q, crit), want)


# --------------------------------------------------------------- conversion
@pytest.fixture(scope="module")
def slice_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_slice")
    jax_generate(str(root), num_train=1, num_val=5, image_hw=SLICE_HW, seed=5)
    return root


def test_conversion_matches_jax(slice_tree):
    """``split_batch_detections`` and ``convert_to_kitti_3d/2d`` on one
    decoded dict, with the metas and calibrations of a collated batch."""
    ds = MonoConDataset(str(slice_tree), "val",
                        transforms=default_test_transforms(True))
    batch = collate([ds.get_sample(i) for i in range(4)], SLICE_HW)
    rng = np.random.default_rng(3)
    b, k = 4, 30
    x1 = rng.uniform(-50, 500, (b, k))
    y1 = rng.uniform(-20, 150, (b, k))
    decoded = {
        "bboxes_2d": np.stack([x1, y1, x1 + rng.uniform(5, 80, (b, k)),
                               y1 + rng.uniform(5, 60, (b, k)),
                               rng.uniform(0, 1, (b, k))], -1),
        "bboxes_3d": np.stack([rng.uniform(-15, 15, (b, k)),
                               rng.uniform(1, 2, (b, k)),
                               rng.uniform(-2, 50, (b, k)),
                               *rng.uniform(0.5, 4, (3, b, k)),
                               rng.uniform(-np.pi, np.pi, (b, k))], -1),
        "labels": rng.integers(0, 3, (b, k)).astype(np.int32),
    }
    decoded = {k: v.astype(np.float32) if v.dtype == np.float64 else v
               for k, v in decoded.items()}
    per_image = convert.split_batch_detections(decoded, 0.4)
    assert_same(per_image, jax_convert.split_batch_detections(decoded, 0.4))
    got = convert.convert_to_kitti_3d(per_image, batch["img_metas"],
                                      batch["calib"])
    assert sum(len(a["name"]) for a in got) > 0
    assert_same(got, jax_convert.convert_to_kitti_3d(
        per_image, batch["img_metas"], batch["calib"]))
    assert_same(convert.convert_to_kitti_2d(per_image, batch["img_metas"]),
                jax_convert.convert_to_kitti_2d(per_image,
                                                batch["img_metas"]))


# --------------------------------------------------------------- .pth import
@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """JAX DLA-34 variables with random BN state and the center-heatmap
    bias at 0.5 (most top-30 scores clear the 0.4 threshold), written as a
    reference-container ``.pth``."""
    _, variables = create_detector_state(jax.random.PRNGKey(0),
                                         num_layers=34, image_hw=(64, 96))
    variables = perturb_variables(variables, np.random.default_rng(0))
    variables["params"]["heads"]["heatmap"]["conv2"]["bias"][:] = 0.5
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    save_torch_checkpoint(variables, str(path))
    return variables, path


@pytest.mark.parametrize("container", ["engine", "model", "bare"])
def test_pth_import(checkpoint, container, tmp_path):
    variables, path = checkpoint
    if container != "engine":
        sd = torch.load(path, weights_only=True)["state_dict"]["model"]
        path = tmp_path / "model.pth"
        torch.save({"model": sd} if container == "model" else sd, path)
    model = create_detector(device="cpu")
    load_weights(str(path), model)
    want = state_dict_from_jax(variables)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_orbax_directory_is_refused(tmp_path):
    with pytest.raises(ValueError, match="export_torch_ckpt.py"):
        load_weights(str(tmp_path), create_detector(device="cpu"))


@pytest.mark.parametrize("fault, error", [
    ("missing_key", RuntimeError),
    ("suffix", ValueError),
])
def test_pth_import_refuses(checkpoint, tmp_path, fault, error):
    """Every key is required, and only ``.pth``/``.pt`` files are read."""
    _, path = checkpoint
    sd = torch.load(path, weights_only=True)["state_dict"]["model"]
    if fault == "missing_key":
        del sd["head.heatmap_head.3.bias"]
    target = tmp_path / ("model.pth" if fault == "missing_key" else "model.ckpt")
    torch.save(sd, target)
    with pytest.raises(error):
        load_weights(str(target), create_detector(device="cpu"))


# -------------------------------------------------------------- the slice
def _configs(root):
    out = []
    for cfg in (jax_default_cfg(), get_default_cfg()):
        cfg.DATA.ROOT = str(root)
        cfg.DATA.BATCH_SIZE = 2     # 5 images: the last batch is short
        cfg.DATA.NUM_WORKERS = 2
        cfg.TPU.PAD_HW = list(SLICE_HW)
        cfg.SEED = 0
        out.append(cfg)
    return out


def _close(got, want, what):
    assert got.keys() == want.keys(), what
    for key, value in want.items():
        if value.dtype.kind in "fc":
            np.testing.assert_allclose(got[key], value, **ANNO_TOL,
                                       err_msg=f"{what} {key}")
        else:
            np.testing.assert_array_equal(got[key], value,
                                          err_msg=f"{what} {key}")


def test_engine_matches_jax(checkpoint, slice_tree):
    """The same ``.pth`` and tree through the JAX engine and the port's on
    the CPU: per image the same KITTI annotations, and the same 84 AP
    values."""
    _, path = checkpoint
    jax_cfg, cfg = _configs(slice_tree)
    jax_engine = JaxEngine(jax_cfg, is_test=True)
    jax_engine.load_checkpoint(str(path))
    want = {"img_bbox": [], "img_bbox2d": []}
    for batch in jax_engine.test_loader:
        jax_engine._collect_eval(jax_engine._dispatch_eval(batch), batch,
                                 want)
    engine = MonoConEngine(cfg, is_test=True, device="cpu")
    engine.load_checkpoint(str(path))
    got = engine.collect_detections()
    for name in want:
        assert len(got[name]) == len(want[name]) == 5
        for i, (g, w) in enumerate(zip(got[name], want[name])):
            _close(g, w, f"{name} image {i}")
    assert sum(len(a["name"]) for a in got["img_bbox"]) > 0
    ap = engine.evaluate(verbose=False)
    jax_ap = jax_engine.evaluate(verbose=False)
    assert len(ap) == 84
    assert sum(k.startswith("img_bbox/KITTI/") for k in ap) == 63
    assert sum(k.startswith("img_bbox2d/KITTI/") for k in ap) == 21
    assert ap == jax_ap


def test_test_cli_evaluates_on_the_cpu(checkpoint, slice_tree):
    _, path = checkpoint
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "monocon_tpu_torch.test", "--checkpoint_file",
         str(path), "--data_root", str(slice_tree), "--evaluate",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Eval Results" in proc.stdout and "3d   AP40" in proc.stdout


def test_test_cli_visualizes_on_the_cpu(checkpoint, slice_tree, tmp_path):
    """``--visualize`` writes one PNG per test image and item, named as
    the image, at the image's size (the BEV canvas: 600x1200)."""
    from monocon_tpu_torch.data.png import read_png

    _, path = checkpoint
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "monocon_tpu_torch.test", "--checkpoint_file",
         str(path), "--data_root", str(slice_tree), "--visualize",
         "--save_dir", str(tmp_path), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = sorted(os.listdir(slice_tree / "training" / "image_2"))[-5:]
    for item, hw in (("2d", SLICE_HW), ("3d", SLICE_HW), ("bev", (600, 1200))):
        assert sorted(os.listdir(tmp_path / item)) == names
        assert read_png(tmp_path / item / names[0]).shape == (*hw, 3)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("name", ["kitti_v5e.yaml", "kitti_v5e_pod.yaml"])
def test_config_files_load_as_in_jax(name):
    """The same key tree: the defaults and each config file give the JAX
    package's values."""
    assert get_default_cfg().to_plain_dict() == (
        jax_default_cfg().to_plain_dict())
    path = str(ROOT / "configs" / name)
    assert load_cfg(path).to_plain_dict() == jax_load_cfg(path).to_plain_dict()


@pytest.mark.parametrize("setting, match", [
    ({"TPU": {"SPATIAL_SHARDS": 8}}, "numerically safe"),
    ({"TPU": {"SPATIAL_SHARDS": 2, "PAD_HW": None}}, "static TPU.PAD_HW"),
    ({"TPU": {"SPATIAL_SHARDS": 5}}, "does not divide"),
    ({"TPU": {"SPATIAL_SHARDS": 2}}, "multiple of 2 ranks"),
], ids=["envelope", "no-canvas", "not-dividing", "one-process"])
def test_engine_rejects_unsafe_spatial_config(setting, match, tmp_path):
    """The port's counterpart of the JAX package's
    ``test_engine_rejects_unsafe_spatial_config``: a shard count above the
    envelope (6 at 384 rows), a canvas that is not static, a count that
    does not divide the canvas, and (the port's own) a process that holds
    no group of bands; each raises before the data is read."""
    cfg = get_default_cfg()
    cfg.DATA.ROOT = str(tmp_path / "absent")   # never reached
    cfg.merge_from_dict(setting)
    for is_test in (True, False):
        with pytest.raises(ValueError, match=match):
            MonoConEngine(cfg, is_test=is_test, device="cpu")


def test_pod_config_trains_over_two_by_two_ranks(tmp_path):
    """``configs/kitti_v5e_pod.yaml`` (bfloat16, two bands, accumulation
    2) with MULTIHOST off and a 128x160 canvas, through the train CLI over
    2 x 2 gloo ranks: two loader steps of a global batch of 4 make one
    optimizer step, every logged loss is finite, the evaluation over the
    ranks gives 84 finite AP keys, and the exported config keeps the
    file's settings."""
    from monocon_tpu_torch.config import load_cfg as port_load_cfg
    from monocon_tpu_torch.data.synthetic import generate_kitti_dataset

    tree, out, stubs = tmp_path / "kitti", tmp_path / "run", tmp_path / "stubs"
    generate_kitti_dataset(str(tree), num_train=8, num_val=1,
                           image_hw=(128, 160), seed=9)
    stubs.mkdir()
    # torch.utils.tensorboard imports TensorFlow where it is installed.
    (stubs / "tensorflow.py").write_text("raise ImportError\n")
    settings = {"TPU.MULTIHOST": False, "TPU.NUM_DEVICES": 4,
                "TPU.PAD_HW": [128, 160], "DATA.CROP_HW": [96, 128],
                "DATA.BATCH_SIZE": 4, "DATA.NUM_WORKERS": 1,
                "PERIOD.LOG_PERIOD": 1, "PERIOD.EVAL_PERIOD": 1,
                "SOLVER.OPTIM.NUM_EPOCHS": 1}
    cmd = [sys.executable, "-m", "monocon_tpu_torch.train", "--device",
           "cpu", "--config_file", str(ROOT / "configs" /
                                       "kitti_v5e_pod.yaml"),
           "--data_root", str(tree), "--output_dir", str(out)]
    for key, value in settings.items():
        cmd += ["--set", key, str(value)]
    env = dict(os.environ, PYTHONPATH=f"{stubs}{os.pathsep}{ROOT}",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "(2 data x 2 space)" in proc.stdout
    state = torch.load(out / "checkpoints" / "epoch_001_final" / "state.pth",
                       weights_only=False)
    assert state["state_dict"]["scheduler"]["count"] == 1
    rows = [json.loads(line) for line in
            (out / "tf_logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in rows if r["tag"] == "loss"]
    assert len(losses) == 2 and all(
        np.isfinite(v) for r in losses for k, v in r.items()
        if k not in ("tag", "step"))
    (ap,) = [r for r in rows if r["tag"] == "eval"]
    assert len(ap) == 86 and all(np.isfinite(v) for v in ap.values()
                                 if not isinstance(v, str))
    saved = port_load_cfg(str(out / "config.yaml"))
    assert (saved.TPU.SPATIAL_SHARDS, saved.TPU.GRAD_ACCUM_STEPS,
            saved.TPU.COMPUTE_DTYPE) == (2, 2, "bfloat16")


@pytest.mark.parametrize("setting", [
    {"TPU": {"GRAD_ACCUM_STEPS": 2}},
    {"TPU": {"COMPUTE_DTYPE": "bfloat16"}},
], ids=["grad_accum", "bf16"])
def test_engine_trains_what_the_port_once_refused(setting, slice_tree,
                                                  tmp_path):
    """Settings that earlier slices refused: a training engine builds and
    takes one step in each."""
    from monocon_tpu_torch.engine.train_step import train_step

    cfg = get_default_cfg()
    cfg.merge_from_dict(setting)
    cfg.DATA.ROOT, cfg.OUTPUT_DIR, cfg.SEED = str(slice_tree), str(tmp_path), 0
    cfg.DATA.BATCH_SIZE, cfg.DATA.NUM_WORKERS = 2, 1
    cfg.DATA.TRAIN_SPLIT, cfg.DATA.AUGMENT = "val", False
    cfg.TPU.PAD_HW = list(SLICE_HW)
    engine = MonoConEngine(cfg, device="cpu")
    batch = next(iter(engine.train_loader))
    losses = train_step(engine.model, engine.optimizer, engine.solver,
                        {"img": batch["img"], "img_hw": batch["img_hw"],
                         "label": batch["label"]})
    assert len(losses) == 11
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    accumulating = setting["TPU"].get("GRAD_ACCUM_STEPS", 1) > 1
    assert engine.solver.count == (0 if accumulating else 1)
    assert engine.solver.mini_step == (1 if accumulating else 0)
