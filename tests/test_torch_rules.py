"""Rules of the port that hold whatever the numbers: it imports nothing of
JAX or of the JAX package, its entry points never choose the CPU on their
own, and ``chip_smoke.py`` refuses to run without a CUDA device."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "monocon_tpu")


def _port_sources():
    return sorted((ROOT / "monocon_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "splat_breakdown.py"]


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
        assert module.split(".")[0] not in FORBIDDEN, (path, module)


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
