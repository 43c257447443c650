"""Rules of the port that hold whatever the numbers: it imports nothing of
JAX, of the JAX package or of its ``scripts/``, nor OpenCV, PIL or
PyYAML; its entry points never choose the CPU on their own; and
``chip_smoke.py`` refuses to run without a CUDA device."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_port_helpers  # noqa: F401 -- caps torch's threads

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "monocon_tpu",
             "scripts", "cv2", "PIL", "yaml")


def _port_sources():
    return sorted((ROOT / "monocon_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "splat_breakdown.py",
        ROOT / "loop_breakdown.py", ROOT / "spatial_breakdown.py",
        ROOT / "overfit_breakdown.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for module in _imported_modules(path):
        top = module.split(".")[0]
        assert top not in FORBIDDEN, (path, module)


def test_entry_points_refuse_to_pick_the_cpu(monkeypatch):
    from monocon_tpu_torch import create_detector, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_detector()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """No CUDA device, or no package beside the script: a non-zero exit and
    no result line."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("cli, args", [
    ("test", ["--checkpoint_file", "model.pth", "--evaluate",
              "--data_root", "."]),
    ("train", ["--output_dir", "out", "--data_root", "."]),
    ("test", ["--checkpoint_file", "model.pth", "--visualize", "--save_dir",
              "out", "--data_root", "."]),
    ("test_raw", ["--data_dir", ".", "--calib_file", "calib.txt",
                  "--checkpoint_file", "model.pth", "--save_dir", "out"]),
    ("checks.overfit", ["--steps", "1"]),
    ("checks.generalization", ["--epochs", "1", "--out", "out"]),
], ids=["test", "train", "test_visualize", "test_raw", "overfit",
        "generalization"])
def test_cli_needs_a_card_unless_told(cli, args, tmp_path):
    """With no ``--device`` and no CUDA device the CLI fails before it
    reads or writes anything."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", f"monocon_tpu_torch.{cli}",
         *(str(tmp_path / a) if a in ("model.pth", "out", ".", "calib.txt")
           else a for a in args)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert os.listdir(tmp_path) == []


# The card's machine has no OpenCV, no PIL and no PyYAML: with each import
# refused, the evaluation, raw-drive and visualization paths import; a
# synthetic tree is written and read back through the dataset, a frame
# through the raw dataset, and one image of each plot is drawn.
WITHOUT_IMAGE_LIBRARIES = """
import os, sys
sys.modules["cv2"] = sys.modules["yaml"] = sys.modules["PIL"] = None
import numpy as np
import monocon_tpu_torch.engine.engine
import monocon_tpu_torch.test
import monocon_tpu_torch.test_raw
import monocon_tpu_torch.utils.streaming
from monocon_tpu_torch.data.kitti_raw import KITTIRawDataset
from monocon_tpu_torch.data.png import write_png
from monocon_tpu_torch.utils import draw
from monocon_tpu_torch.utils.visualizer import Visualizer
from monocon_tpu_torch.config import get_default_cfg
from monocon_tpu_torch.data.monocon_dataset import MonoConDataset
from monocon_tpu_torch.data.synthetic import generate_kitti_dataset
get_default_cfg()
generate_kitti_dataset(sys.argv[1], num_train=0, num_val=2,
                       image_hw=(48, 96), seed=0)
ds = MonoConDataset(sys.argv[1], "val")
sample = ds.get_sample(1)
assert sample["img"].shape == (64, 96, 3), sample["img"].shape
assert len(ds.collect_gt_annos()) == 2
print("read", len(ds), "images")
frames = os.path.join(sys.argv[1], "frames")
os.makedirs(frames)
write_png(os.path.join(frames, "0000000000.png"),
          np.zeros((48, 96, 3), np.uint8))
calib = os.path.join(sys.argv[1], "calib_cam_to_cam.txt")
with open(calib, "w") as f:
    f.write("P_rect_02: 7.2e+02 0 48 0 0 7.2e+02 24 0 0 0 1 0\\n")
raw = KITTIRawDataset(frames, calib)
vis = [{"img_bbox": {"boxes_3d": np.array([[0, 1, 10, 2, 1.5, 4, 0.3]]),
                     "scores_3d": np.ones(1), "labels_3d": np.array([2])},
        "img_bbox2d": [np.zeros((0, 5)), np.zeros((0, 5)),
                       np.array([[10, 10, 40, 30, 0.9]])]}]
plots = Visualizer(raw, vis)
shapes = [plots.plot_bboxes_2d(0).shape, plots.plot_bboxes_3d(0).shape,
          plots.plot_bev(0).shape]
assert shapes == [(48, 96, 3), (48, 96, 3), (600, 1200, 3)], shapes
print("drew", len(shapes), "plots")
"""


def test_eval_path_needs_no_image_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", WITHOUT_IMAGE_LIBRARIES, str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "read 2 images" in proc.stdout and "drew 3 plots" in proc.stdout


# The training path with the same three imports refused: a synthetic train
# tree read through the train transforms, then one CPU step through
# MonoConEngine.train(), which writes config.yaml and a checkpoint.
TRAIN_WITHOUT_IMAGE_LIBRARIES = """
import os, sys
sys.modules["cv2"] = sys.modules["yaml"] = sys.modules["PIL"] = None
import numpy as np
import monocon_tpu_torch.train
from monocon_tpu_torch import MonoConEngine
from monocon_tpu_torch.config import get_default_cfg
from monocon_tpu_torch.data.monocon_dataset import MonoConDataset
from monocon_tpu_torch.data.synthetic import generate_kitti_dataset
from monocon_tpu_torch.data.transforms import default_train_transforms
root, out = sys.argv[1], sys.argv[2]
generate_kitti_dataset(root, num_train=2, num_val=1, image_hw=(64, 160),
                       seed=0)
for seed in range(4):
    sample = MonoConDataset(root, "train", transforms=default_train_transforms(
        (48, 128), device_normalize=True)).get_sample(
            0, np.random.default_rng(seed))
    assert sample["img"].shape == (64, 160, 3), sample["img"].shape
cfg = get_default_cfg()
cfg.DATA.ROOT, cfg.OUTPUT_DIR, cfg.SEED = root, out, 0
cfg.DATA.BATCH_SIZE, cfg.DATA.NUM_WORKERS = 2, 1
cfg.DATA.CROP_HW, cfg.TPU.PAD_HW = [48, 128], [64, 160]
cfg.SOLVER.OPTIM.NUM_EPOCHS, cfg.PERIOD.EVAL_PERIOD = 1, -1
engine = MonoConEngine(cfg, device="cpu")
engine.train()
assert os.path.isfile(os.path.join(out, "config.yaml"))
assert os.path.isfile(os.path.join(
    out, "checkpoints", "epoch_001_final", "state.pth"))
print("trained", engine.global_iters - 1, "step")
"""


def test_train_path_needs_no_image_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_WITHOUT_IMAGE_LIBRARIES,
         str(tmp_path / "kitti"), str(tmp_path / "out")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "trained 1 step" in proc.stdout


# The shipped config file through the train CLI on the CPU, with the same
# three imports refused: bfloat16 from the file, two micro-steps per
# optimizer step, on a tiny synthetic tree.
CONFIG_FILE_RUN = """
import runpy, sys
sys.modules["cv2"] = sys.modules["yaml"] = sys.modules["PIL"] = None
from monocon_tpu_torch.data.synthetic import generate_kitti_dataset
generate_kitti_dataset(sys.argv[1], num_train=5, num_val=1,
                       image_hw=(64, 160), seed=0)
sys.argv = ["train", *sys.argv[2:]]
try:
    runpy.run_module("monocon_tpu_torch.train", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
"""


def test_train_cli_reads_the_shipped_config_without_pyyaml(tmp_path):
    root, out = tmp_path / "kitti", tmp_path / "out"
    overrides = {"DATA.ROOT": root, "OUTPUT_DIR": out, "DATA.BATCH_SIZE": 2,
                 "DATA.NUM_WORKERS": 1, "DATA.CROP_HW": "[48, 128]",
                 "TPU.PAD_HW": "[64, 160]", "SOLVER.OPTIM.NUM_EPOCHS": 1,
                 "PERIOD.EVAL_PERIOD": -1, "PERIOD.LOG_PERIOD": 1,
                 "TPU.GRAD_ACCUM_STEPS": 2}
    args = ["--device", "cpu", "--config_file",
            str(ROOT / "configs" / "kitti_v5e.yaml")]
    for key, value in overrides.items():
        args += ["--set", key, str(value)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", CONFIG_FILE_RUN, str(root), *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    saved = (out / "config.yaml").read_text()
    assert "COMPUTE_DTYPE: \"bfloat16\"" in saved
    assert "GRAD_ACCUM_STEPS: 2" in saved and "SEED: 1" in saved
    final = out / "checkpoints" / "epoch_001_final"
    container = torch.load(final / "state.pth", weights_only=True)
    # 5 images at batch 2: 3 micro-steps, one optimizer step, and the
    # third micro-step's gradient waiting in the accumulation.
    solver = container["state_dict"]["scheduler"]
    assert (solver["count"], solver["mini_step"]) == (1, 1)
    assert proc.stdout.count("| Progress") == 3


@pytest.fixture()
def refused_path(tmp_path):
    """A directory whose ``cv2``, ``yaml`` and ``PIL`` raise ImportError,
    for the front of ``PYTHONPATH``: it refuses the three imports in a
    command's own process and in the processes it spawns. TensorFlow, which
    the card's machine lacks too and ``torch.utils.tensorboard`` takes
    about 20 s to import here, is refused as well."""
    stubs = tmp_path / "refused"
    (stubs / "PIL").mkdir(parents=True)
    refuse = "raise ImportError('refused for this test')\n"
    for path in (stubs / "cv2.py", stubs / "yaml.py", stubs / "tensorflow.py",
                 stubs / "PIL" / "__init__.py"):
        path.write_text(refuse)
    return f"{stubs}{os.pathsep}{ROOT}"


def test_bench_needs_no_image_library(refused_path):
    env = dict(os.environ, PYTHONPATH=refused_path, BENCH_BATCH="1",
               BENCH_ITERS="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "monocon_tpu_torch.bench", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    (line,) = proc.stdout.strip().splitlines()
    assert json.loads(line)["device"] == "cpu"


def test_multi_rank_train_cli_needs_no_image_library(refused_path, tmp_path):
    """Two gloo ranks spawned by the train CLI, the three imports refused
    in every process: one step of a global batch of 2, a checkpoint."""
    root, out = tmp_path / "kitti", tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=refused_path, OMP_NUM_THREADS="1")
    make_tree = ("from monocon_tpu_torch.data.synthetic import "
                 "generate_kitti_dataset as g; "
                 f"g({str(root)!r}, num_train=2, num_val=1, "
                 "image_hw=(64, 160), seed=0)")
    subprocess.run([sys.executable, "-c", make_tree], cwd=ROOT, env=env,
                   check=True, timeout=120)
    args = ["--device", "cpu", "--data_root", str(root), "--output_dir",
            str(out), "--num_epochs", "1", "--batch_size", "2"]
    for key, value in {"TPU.NUM_DEVICES": 2, "SEED": 0,
                       "DATA.NUM_WORKERS": 1, "DATA.CROP_HW": "[48, 128]",
                       "TPU.PAD_HW": "[64, 160]",
                       "PERIOD.EVAL_PERIOD": -1}.items():
        args += ["--set", key, str(value)]
    proc = subprocess.run(
        [sys.executable, "-m", "monocon_tpu_torch.train", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "rank 0 of 2" in proc.stdout
    assert (out / "checkpoints" / "epoch_001_final" / "state.pth").is_file()
    shutil.rmtree(out)  # 235 MB of checkpoint
