"""The import guard: each traffic mix's set-up, at a small size on the
CPU in a fresh interpreter, loads no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``monocon_tpu``; each configuration's
reference, loaded, built, run and counted as the check and the FLOP
count do, loads nothing of the program either, and the check refuses a
reference file that imports the program, JAX or the harness."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import check

ROOT = Path(__file__).resolve().parents[2]
SETUP = """
import json, sys
from pathlib import Path
import torch
from perfbench.drivers import KINDS
from perfbench.tests.tiny import tiny_spec
if __name__ == "__main__":
    spec = tiny_spec({workload!r})
    cell = KINDS[spec["traffic"]["kind"]]("guard", spec["config"],
                                          spec["traffic"], 3,
                                          torch.device("cpu"),
                                          cache=Path({cache!r}))
    cell.setup()
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
REFERENCE = """
import json, sys
import torch
import perfbench.check, perfbench.reference.data, perfbench.reference.step
from perfbench.counts.flops import train_flops
config = json.load(open({config!r}))
ref = perfbench.check.reference_module(config)
with ref.backends("float32"):
    model = ref.build(config["model"]).train()
    out = model(torch.zeros(2, 64, 96, 3))
    sum(v.mean() for v in out.values()).backward()
train_flops(config, 2, (64, 96))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
CONFIGS = {c["name"]: c["file"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]}


def top_level_modules(code, tmp_path):
    script = tmp_path / "guard.py"
    script.write_text(code)
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("workload", ["dla34-f32.train-step",
                                      "dla102-f32.train-step"])
def test_setup_loads_no_jax(workload, tmp_path):
    loaded = top_level_modules(
        SETUP.format(workload=workload, cache=str(tmp_path / "cache")),
        tmp_path)
    assert "monocon_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "monocon_tpu"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_loads_nothing_of_the_program(name, tmp_path):
    loaded = top_level_modules(
        REFERENCE.format(config=str(ROOT / CONFIGS[name])), tmp_path)
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "monocon_tpu",
                         "monocon_tpu_torch"}


@pytest.mark.parametrize("line,refused", [
    ("import torch\nfrom .model import DLA, Heads\n", False),
    ("from perfbench.reference import model\n", False),
    ("from . import data\nimport numpy as np\n", False),
    ("import monocon_tpu_torch.models.dla\n", True),
    ("from monocon_tpu_torch.models import dla\n", True),
    ("import jax.numpy as jnp\n", True),
    ("from monocon_tpu.models import dla\n", True),
    ("from ..drivers import port_cfg\n", True),
    ("import perfbench.weights\n", True),
    ("from .bad import x\n", True),
])
def test_a_reference_that_imports_the_program_is_refused(line, refused,
                                                         tmp_path):
    """What a reference file imports, and what the reference files it
    imports import (``bad.py`` below imports JAX)."""
    (tmp_path / "model.py").write_text("import torch\n")
    (tmp_path / "data.py").write_text("import numpy\n")
    (tmp_path / "bad.py").write_text("import math\nimport flax\n")
    (tmp_path / "new.py").write_text(line)
    assert bool(check.refused_imports(tmp_path / "new.py")) == refused


def test_a_reference_outside_the_reference_files_is_refused():
    for path in ("perfbench/drivers.py", "perfbench/reference/../run.py",
                 "perfbench/reference/absent.py"):
        with pytest.raises(ValueError):
            check.reference_module({"name": "x", "reference": path})
