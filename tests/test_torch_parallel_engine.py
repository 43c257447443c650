"""The port's engine over two gloo ranks on the CPU, through its CLIs:
``python -m monocon_tpu_torch.train --device cpu --set TPU.NUM_DEVICES 2``
spawns the two processes itself. On a synthetic tree of 6 train and 3 val
images at a global batch of 4, both splits end in a padded remainder:

  * rank 0 alone prints and writes (``config.yaml``, checkpoints,
    ``tf_logs/metrics.jsonl``);
  * the first logged step's losses equal a one-process run's;
  * the AP dict of the two ranks' evaluation equals a one-process
    evaluation of the same checkpoint, and ``test --visualize`` over two
    ranks draws what one process draws, detection for detection (the
    checkpoint's centre heatmap biased so that boxes clear the score
    threshold);
  * ``--resume_from`` continues the run on both ranks: the next epoch's
    first losses equal those of one process resumed from the checkpoint.

The CLIs run as subprocesses, several at a time, with one thread a
rank, and without TensorFlow: ``torch.utils.tensorboard`` imports it
where it is installed, which costs each rank 0 about 20 s of CPU here,
and the metrics file these tests read does not need it.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from monocon_tpu_torch.config import get_default_cfg
from monocon_tpu_torch.data.png import read_png
from monocon_tpu_torch.data.synthetic import generate_kitti_dataset
from monocon_tpu_torch.engine.engine import MonoConEngine
from torch_port_helpers import F32_TOL

ROOT = Path(__file__).resolve().parent.parent
IMAGE_HW, CROP_HW = (64, 160), (48, 128)
BATCH, STEPS = 4, 2
CLI_TIMEOUT_S = 600
# Heatmap logit of the drawn checkpoint: most cells score above the
# engine's 0.4 threshold.
HEATMAP_BIAS = 0.5
SETTINGS = {"SEED": 0, "DATA.BATCH_SIZE": BATCH, "DATA.NUM_WORKERS": 1,
            "TPU.PAD_HW": list(IMAGE_HW), "DATA.CROP_HW": list(CROP_HW),
            "PERIOD.LOG_PERIOD": 1, "PERIOD.EVAL_PERIOD": 1}


def cli(module, tree, ranks, *args, **settings):
    """``python -m monocon_tpu_torch.<module>`` on the CPU with ``ranks``
    processes, started (not waited for)."""
    cmd = [sys.executable, "-m", f"monocon_tpu_torch.{module}", "--device",
           "cpu", "--data_root", str(tree), *args]
    for key, value in {**SETTINGS, "TPU.NUM_DEVICES": ranks,
                       **settings}.items():
        cmd += ["--set", key, str(value)]
    stubs = tree.parent / "stubs"
    stubs.mkdir(exist_ok=True)
    (stubs / "tensorflow.py").write_text("raise ImportError\n")
    env = dict(os.environ, PYTHONPATH=f"{stubs}{os.pathsep}{ROOT}",
               OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(proc) -> str:
    out = proc.communicate(timeout=CLI_TIMEOUT_S)[0]
    assert proc.returncode == 0, out[-4000:]
    return out


def metrics(out: Path, tag: str):
    lines = (out / "tf_logs" / "metrics.jsonl").read_text().splitlines()
    rows = [json.loads(line) for line in lines]
    return [{k: v for k, v in r.items() if k != "tag"} for r in rows
            if r["tag"] == tag]


def port_cfg(tree, out, **settings):
    cfg = get_default_cfg()
    cfg.DATA.ROOT, cfg.OUTPUT_DIR = str(tree), str(out)
    for key, value in {**SETTINGS, "TPU.NUM_DEVICES": 1,
                       **settings}.items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        node[leaf] = value
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The CLI runs, started together where they can: one epoch over two
    ranks (A) beside one process (B); then A resumed for a second epoch
    over two ranks (C) and in one process (G), beside ``test
    --visualize`` over two ranks on A's checkpoint with its heatmap biased
    (D)."""
    base = tmp_path_factory.mktemp("parallel_engine")
    tree = base / "kitti"
    generate_kitti_dataset(str(tree), num_train=6, num_val=3,
                           image_hw=IMAGE_HW, seed=5)
    out = {name: base / name for name in "ABCDG"}
    a = cli("train", tree, 2, "--output_dir", str(out["A"]),
            "--num_epochs", "1")
    b = cli("train", tree, 1, "--output_dir", str(out["B"]),
            "--num_epochs", "1", **{"PERIOD.EVAL_PERIOD": -1})
    logs = {"A": finish(a), "B": finish(b)}

    final = out["A"] / "checkpoints" / "epoch_001_final" / "state.pth"
    state = torch.load(final, weights_only=True)["state_dict"]["model"]
    state["head.heatmap_head.3.bias"].fill_(HEATMAP_BIAS)
    biased = base / "biased.pth"
    torch.save(state, biased)
    resumed = {name: cli("train", tree, ranks, "--output_dir",
                         str(out[name]), "--num_epochs", "2",
                         "--resume_from", str(final.parent),
                         **{"PERIOD.EVAL_PERIOD": -1})
               for name, ranks in (("C", 2), ("G", 1))}
    d = cli("test", tree, 2, "--checkpoint_file", str(biased),
            "--visualize", "--save_dir", str(out["D"]))
    logs.update({name: finish(proc) for name, proc in resumed.items()},
                D=finish(d))
    # The checkpoints no test reads (235 MB each, with AdamW's state).
    saved = {name: sorted(os.listdir(out[name] / "checkpoints"))
             for name in "BCG"}
    for name in "BCG":
        shutil.rmtree(out[name] / "checkpoints")
    yield {"tree": tree, "out": out, "logs": logs, "biased": biased,
           "final": final.parent, "base": base, "saved": saved}
    shutil.rmtree(base)


def test_rank_zero_alone_writes(runs):
    a, log = runs["out"]["A"], runs["logs"]["A"]
    assert log.count("MonoCon Engine (PyTorch port)") == 1
    assert "rank 0 of 2" in log
    assert log.count("| Progress") == STEPS
    assert log.count("Checkpoint saved") == 2
    assert sorted(os.listdir(a)) == ["checkpoints", "config.yaml", "tf_logs"]
    assert sorted(os.listdir(a / "checkpoints")) == [
        "epoch_001", "epoch_001_final"]
    assert [m["step"] for m in metrics(a, "loss")] == [1, 2]
    assert len(metrics(a, "eval")) == 1
    assert "NUM_DEVICES: 2" in (a / "config.yaml").read_text()


def test_first_step_matches_one_process(runs):
    """The global batch's first step: the two ranks' global losses are one
    process's (float32: the rank layouts round their sums differently)."""
    (two,), (one,) = (metrics(runs["out"][k], "loss")[:1] for k in "AB")
    assert set(two) == set(one) and len(one) == 11
    for key, want in one.items():
        np.testing.assert_allclose(two[key], want, err_msg=key, **F32_TOL)


def test_ap_matches_one_process_evaluation(runs):
    """The AP dict that rank 0 computed from both ranks' detections after
    epoch 1 equals one process's evaluation of that epoch's checkpoint."""
    (ap,) = metrics(runs["out"]["A"], "eval")
    ap.pop("step")
    engine = MonoConEngine(port_cfg(runs["tree"], runs["base"] / "E"),
                           is_test=True, device="cpu")
    engine.load_checkpoint(
        str(runs["out"]["A"] / "checkpoints" / "epoch_001" / "state.pth"))
    want = engine.evaluate(verbose=False)
    assert len(want) == 84 and ap.keys() == want.keys()
    for key, value in want.items():
        assert ap[key] == pytest.approx(value, abs=1e-9), key


def test_visualize_over_two_ranks_draws_what_one_process_draws(runs):
    cfg = port_cfg(runs["tree"], runs["base"] / "F")
    engine = MonoConEngine(cfg, is_test=True, device="cpu")
    engine.load_checkpoint(str(runs["biased"]))
    want = runs["base"] / "vis_one"
    engine.visualize(str(want))
    got = runs["out"]["D"]
    assert runs["logs"]["D"].count("Visualizations saved") == 1
    for item in ("2d", "3d", "bev"):
        names = sorted(os.listdir(want / item))
        assert len(names) == 3 and sorted(os.listdir(got / item)) == names
        for name in names:
            assert np.array_equal(read_png(got / item / name),
                                  read_png(want / item / name)), (item, name)
    # Boxes were drawn: a 2D plot differs from its bare image.
    images = [engine.test_dataset.image_path(i) for i in range(3)]
    assert any(not np.array_equal(read_png(path), read_png(
        want / "2d" / os.path.basename(path))) for path in images)


def test_resume_from_continues_on_both_ranks(runs):
    """C continues A's run for epoch 2; its first losses equal those of
    one process resumed from the same checkpoint, which they would not
    if a rank had trained on other weights."""
    c, log = runs["out"]["C"], runs["logs"]["C"]
    assert log.count("Training resumes from") == 1
    assert runs["saved"]["C"] == ["epoch_002_final"]
    steps = metrics(c, "loss")
    assert [m["step"] for m in steps] == [STEPS + 1, 2 * STEPS]
    want = metrics(runs["out"]["G"], "loss")[0]
    assert want["step"] == STEPS + 1
    for key, value in want.items():
        np.testing.assert_allclose(steps[0][key], value, err_msg=key,
                                   **F32_TOL)
