"""The import guard: each traffic mix's set-up, at a small size on the
CPU in a fresh interpreter, loads no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``monocon_tpu``; the reference alone
loads nothing of the program either."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

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
import perfbench.check, perfbench.reference.data, perfbench.reference.model
import perfbench.reference.step
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


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


def test_reference_loads_nothing_of_the_program(tmp_path):
    loaded = top_level_modules(REFERENCE, tmp_path)
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "monocon_tpu",
                         "monocon_tpu_torch"}
