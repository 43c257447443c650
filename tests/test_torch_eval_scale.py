"""``monocon_tpu_torch.checks.eval_scale`` against the JAX package's
``scripts/eval_scale_bench.py``: the same synthetic annotations, the same
AP dict, a committed JAX AP dict that is current, and the CLI without
OpenCV, PIL or PyYAML.

``python tests/test_torch_eval_scale.py`` rewrites the committed record
(``monocon_tpu_torch/checks/resources/eval_scale_jax_ap.json``) with the
JAX package's ``kitti_eval`` on ``synth_annos(3769, seed=0)``."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from monocon_tpu.eval import kitti_eval as jax_kitti_eval
from monocon_tpu_torch.checks import eval_scale
from monocon_tpu_torch.eval import kitti_eval

ROOT = Path(__file__).resolve().parent.parent
RECORD_IMAGES, RECORD_SEED = 3769, 0
KEYS = {"images", "seed", "device", "end_to_end_cpp_s", "ap_keys",
        "ap_equals_jax", "stages_3d", "stage_repeats", "eval_period"}
STAGES = {"overlap_matrices_3d", "clean_data_flat_vectorized", "flat_pack",
          "threshold_matching", "fused_pr", "right_envelope"}


def jax_script():
    """``scripts/eval_scale_bench.py``, loaded by path (the port never
    imports it)."""
    spec = importlib.util.spec_from_file_location(
        "eval_scale_bench", ROOT / "scripts" / "eval_scale_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_record(images=RECORD_IMAGES, seed=RECORD_SEED):
    """The committed record's content: the JAX package's AP dict on the
    JAX script's annotations."""
    gt, dt = jax_script().synth_annos(images, seed)
    _, ap = jax_kitti_eval(gt, dt, eval_scale.CLASSES)
    return {"images": images, "seed": seed, "ap": ap}


@pytest.mark.parametrize("seed", [0, 1])
def test_synth_annos_equal_the_jax_scripts(seed):
    ours, theirs = eval_scale.synth_annos(50, seed), jax_script().synth_annos(
        50, seed)
    for got, want in zip(ours, theirs):
        assert len(got) == len(want) == 50
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_ap_dict_equals_the_jax_packages():
    gt, dt = eval_scale.synth_annos(300, seed=2)
    _, ours = kitti_eval(gt, dt, eval_scale.CLASSES)
    _, theirs = jax_kitti_eval(gt, dt, eval_scale.CLASSES)
    assert len(ours) == 63 and ours == theirs
    assert sum(v > 0 for v in ours.values()) > 40


def test_committed_jax_ap_is_current():
    """The committed JAX AP dict is what the JAX package gives now, and the
    port's evaluator gives the same, float for float."""
    committed = json.loads(eval_scale.JAX_AP.read_text())
    assert committed == jax_record()
    assert eval_scale.jax_ap(RECORD_IMAGES, RECORD_SEED) == committed["ap"]
    assert eval_scale.jax_ap(200, RECORD_SEED) is None


def test_stage_attribution_times_every_stage():
    gt, dt = eval_scale.synth_annos(40, seed=3)
    stages = eval_scale.stage_attribution(gt, dt)
    assert set(stages) == STAGES
    assert all(v >= 0 for v in stages.values())
    period = eval_scale.eval_period(2.0, 150.0)
    assert period["steps"] == 2320
    assert period["eval_share"] == pytest.approx(2.0 / (348.0 + 2.0))


def test_cli_needs_no_image_library(tmp_path):
    """``python -m monocon_tpu_torch.checks.eval_scale`` with cv2, yaml and
    PIL refused writes the documented keys."""
    stubs = tmp_path / "refused"
    (stubs / "PIL").mkdir(parents=True)
    for path in (stubs / "cv2.py", stubs / "yaml.py",
                 stubs / "PIL" / "__init__.py"):
        path.write_text("raise ImportError('refused for this test')\n")
    out = tmp_path / "record.json"
    env = dict(os.environ, PYTHONPATH=f"{stubs}{os.pathsep}{ROOT}")
    proc = subprocess.run(
        [sys.executable, "-m", "monocon_tpu_torch.checks.eval_scale",
         "--images", "200", "--json", str(out), "--profile",
         "--train-ms-per-step", "150"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    record = json.loads(out.read_text())
    assert set(record) == KEYS | {"profile_top"}
    assert set(record["stages_3d"]) == STAGES
    assert record["images"] == 200 and record["ap_keys"] == 63
    assert record["ap_equals_jax"] is None
    assert record["stage_repeats"] == eval_scale.STAGE_REPEATS
    assert len(record["profile_top"]) == eval_scale.PROFILE_TOP
    assert record["device"]["host"]
    assert record["eval_period"]["train_ms_per_step"] == 150.0


if __name__ == "__main__":
    eval_scale.JAX_AP.parent.mkdir(exist_ok=True)
    eval_scale.JAX_AP.write_text(json.dumps(jax_record(), indent=1) + "\n")
    print(f"-> {eval_scale.JAX_AP}")
