"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it is found by name; a new cell, traffic mix, configuration or per-layer
metric takes only new files and entries."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run
from perfbench.drivers import KINDS

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_and_command(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in bench["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    assert len({c["file"] for c in bench["configs"]}) == len(names)


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])


def test_metrics(bench):
    e2e, layers = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25
    layer_names = {}
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
        moved = next(e for e in e2e if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert run.applies(moved, cell)
        layer_names.setdefault(m["layer"], set()).add(m["layer"])
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        spec = run.cell_spec(w["name"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]


def test_every_name_is_found(bench):
    for w in bench["workloads"]:
        spec = run.cell_spec(w["name"])
        assert spec["traffic"]["kind"] in KINDS
        for m in spec["per_layer"]:
            assert callable(run.reader(m["name"]))


# A reference of a model new to the harness, in a file of its own: the
# detector put together from the blocks of ``model.py``. ``{plant}`` is
# left empty, or plants one head's 3x3 kernel mirrored.
NEW_REFERENCE = """
import torch.nn.functional as F
from torch import nn

from .model import ARCH, DLA, START_LEVEL, DLAUp, Heads, backends  # noqa


class Assembled(nn.Module):
    def __init__(self, depth):
        super().__init__()
        ch = ARCH[depth][2]
        self.backbone = DLA(depth)
        self.neck = DLAUp(ch[START_LEVEL:])
        self.head = Heads(ch[START_LEVEL])

    def forward(self, image):
        x = image.permute(0, 3, 1, 2).contiguous()
        return self.head(self.neck(self.backbone(x)))


def build(model, precision="float32"):
    net = Assembled(int(model["num_layers"]))
{plant}
    return net
"""
PLANT = """
    conv = net.head.heatmap_head[0]
    conv.forward = lambda x: F.conv2d(x, conv.weight.flip(-2, -1), conv.bias,
                                      1, 1)
"""
# A reader of the configuration and of the program's spans: the traced
# steps' monocon.step spans a step, times the configuration's depth.
NEW_READER = """
def read(ctx):
    t = ctx["trace"]
    if t is None or not t.steps:
        return None
    steps = sum(name == "monocon.step" for _, _, name in t.program_spans)
    return steps / t.steps * ctx["config"]["model"]["num_layers"]
"""
# One tiny run of the new cell on the CPU, traced, in the copy.
NEW_RUN = """
import json
from pathlib import Path
import torch
from perfbench import run
from perfbench.tests.tiny import tiny_spec
if __name__ == "__main__":
    spec = tiny_spec("dla34-assembled.train-step-traced-first")
    result, numbers = run.run_cell(spec, 2 ** 31 + 11, 1.0, True,
                                   torch.device("cpu"), cache=Path({cache!r}))
    print(json.dumps({{k: result[k] for k in ("correct", "metrics",
                                              "checks")}}))
"""


def files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def add_cell(root, bench, config, traffic, metric, cell_name):
    """Files and entries of one more configuration, traffic mix, metric
    and cell in the checkout at ``root``."""
    name = config["name"]
    (root / f"perfbench/configs/{name}.json").write_text(json.dumps(config))
    (root / f"perfbench/traffic/{cell_name}.json").write_text(
        json.dumps(traffic))
    (root / f"perfbench/metrics/{metric}.py").write_text(
        "def read(ctx):\n    t = ctx['trace']\n"
        "    return None if t is None else float(t.steps)\n")
    bench["configs"].append({"name": name, "source": "x",
                             "file": f"perfbench/configs/{name}.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": f"{name}.{cell_name}", "config": name,
                               "traffic": cell_name, "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": metric, "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "model step",
                               "moves": "train_images_per_s",
                               "workloads": [f"{name}.{cell_name}"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("case", ["a cell of a known model",
                                  "a new reference model",
                                  "a new reference model, planted"])
def test_a_new_cell_needs_only_new_files_and_entries(case, tmp_path):
    """A throwaway configuration, traffic mix and per-layer metric, added
    as files and entries in a copy of the checkout, are found by name; one
    whose ``reference`` names a new reference file is built, checked and
    read from that file: correct, and not correct with a planted change
    in it."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = files(root)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "perfbench/configs/dla34-f32.json").read_text())
    if case == "a cell of a known model":
        config.update(name="dla34-f32-b4")
        config["cfg"]["DATA.BATCH_SIZE"] = 4
        add_cell(root, bench, config, {
            "kind": "train_step", "ring_batches": 4, "warmup_steps": 1,
            "augment": True, "trace_start": 0.5, "trace_steps": 2},
            "steps_traced", "train-step-ring4")
        spec = run.cell_spec("dla34-f32-b4.train-step-ring4", root)
        assert spec["config"]["cfg"]["DATA.BATCH_SIZE"] == 4
        assert spec["traffic"]["ring_batches"] == 4
        assert "steps_traced" in [m["name"] for m in spec["per_layer"]]

        class T:
            steps = 3
        assert run.reader("steps_traced", root)({"trace": T()}) == 3.0
        assert run.per_layer({"per_layer": [{"name": "steps_traced",
                                             "unit": "steps"}]},
                             {"trace": None}, root) == {}
        return
    planted = case.endswith("planted")
    (root / "perfbench/reference/assembled.py").write_text(
        NEW_REFERENCE.format(plant=PLANT if planted else ""))
    config.update(name="dla34-assembled",
                  reference="perfbench/reference/assembled.py")
    add_cell(root, bench, config, {
        "kind": "train_step", "ring_batches": 3, "warmup_steps": 1,
        "augment": True, "trace_start": 0.0, "trace_steps": 1},
        "step_spans_by_depth", "train-step-traced-first")
    (root / "perfbench/metrics/step_spans_by_depth.py").write_text(NEW_READER)
    # Nothing already there changed: BENCHMARK.json only gained entries.
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    now = json.loads((root / "BENCHMARK.json").read_text())
    for key, value in old.items():
        assert (now[key][:len(value)] if isinstance(value, list)
                else now[key]) == value
    after = files(root)
    assert all(after[p] == v for p, v in before.items()
               if p.name != "BENCHMARK.json")
    script = tmp_path / "new_run.py"
    script.write_text(NEW_RUN.format(cache=str(tmp_path / "cache")))
    out = subprocess.run([sys.executable, str(script)], cwd=root,
                         capture_output=True, text=True, timeout=900,
                         env={"PYTHONPATH": f"{root}:{ROOT}",
                              "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
                              "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metrics"]["step_spans_by_depth"]["value"] == 34.0
    assert result["correct"] is not planted, result["checks"]
    if planted:
        assert result["checks"]["loss_gap1"]["value"] > \
            result["checks"]["loss_gap1"]["limit"], result["checks"]
