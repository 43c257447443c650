"""The training step's spans (``engine/train_step.py``,
``utils/profiling.py::span``): none entered without a profiler; under
one, each step is one ``monocon.step`` range with its five phases in
order, in the profiler's events and in ``device_trace``'s chrome trace."""

import glob
import gzip
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_port_helpers  # noqa: F401 -- caps torch's threads
from monocon_tpu_torch.engine.train_step import train_step
from monocon_tpu_torch.models.detector import MonoConDetector
from monocon_tpu_torch.solver.schedule import build_optimizer
from monocon_tpu_torch.utils import profiling
from monocon_tpu_torch.utils.profiling import TRACE_SUFFIX, device_trace

STEP = "monocon.step"
PHASES = [f"{STEP}.{p}"
          for p in ("targets", "forward", "losses", "backward", "solver")]
HW = (64, 160)


def _label(rng, b=2, o=8):
    """A fixed-shape label batch with three objects an image."""
    label = {"gt_bboxes": np.zeros((b, o, 4)), "gt_labels": np.zeros((b, o)),
             "gt_bboxes_3d": np.zeros((b, o, 7)), "depths": np.zeros((b, o)),
             "gt_kpts_2d": np.zeros((b, o, 18)),
             "gt_kpts_valid_mask": np.zeros((b, o, 9)),
             "mask": np.zeros((b, o))}
    for i in range(b):
        for j in range(3):
            x, y = rng.uniform(0, HW[1] - 40), rng.uniform(0, HW[0] - 30)
            label["gt_bboxes"][i, j] = [x, y, x + 36, y + 24]
            label["gt_labels"][i, j] = j
            label["gt_bboxes_3d"][i, j] = [0, 1, 20, 1.5, 1.6, 3.9, 0.3]
            label["depths"][i, j] = rng.uniform(5, 50)
            label["gt_kpts_2d"][i, j] = rng.uniform(0, HW[1], 18)
            label["gt_kpts_valid_mask"][i, j] = 2
            label["mask"][i, j] = 1
    return {k: torch.from_numpy(v.astype(np.float32))
            for k, v in label.items()}


@pytest.fixture(scope="module")
def stepper():
    """``step()`` runs one training step of a DLA-34 detector on the CPU
    at 64x160, batch 2."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    model = MonoConDetector(34)
    optimizer, solver = build_optimizer(model.parameters(), total_steps=10)
    batch = {"img": torch.from_numpy(
        rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8)),
        "img_hw": torch.tensor([HW, HW]), "label": _label(rng)}

    def step():
        losses = train_step(model, optimizer, solver, batch)
        assert len(losses) == 11 and torch.isfinite(losses["total_loss"])
        return losses
    return step


def _assert_steps(ranges, steps):
    """``ranges``: (name, start, end, parent name) of every ``monocon.*``
    range, in start order. ``steps`` step ranges, each the parent of the
    five phases in order, with nothing else named so."""
    tops = [r for r in ranges if r[0] == STEP]
    assert len(tops) == steps
    assert all(r[3] is None for r in tops)
    for top in tops:
        children = [r for r in ranges if top[1] <= r[1] and r[2] <= top[2]
                    and r is not top]
        assert [c[0] for c in children] == PHASES
        assert all(c[3] == STEP for c in children)
        ends = [top[1]] + [x for c in children for x in (c[1], c[2])]
        assert ends == sorted(ends)
    assert len(ranges) == steps * (1 + len(PHASES))


def test_no_profiler_enters_no_record_function(stepper, monkeypatch):
    """``record_function`` raises for the program's names (torch's own
    optimizer opens ranges of its own, which pass)."""
    inner = torch.autograd.profiler.record_function

    def refuse(name, *args, **kwargs):
        if name.startswith("monocon."):
            raise AssertionError(f"{name} entered without a profiler")
        return inner(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    stepper()
    with profiling.span("monocon.step") as entered:
        assert entered is None


def test_two_steps_give_two_step_ranges_with_five_phases_in_order(stepper):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stepper()
        stepper()
    ranges = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith("monocon."):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith(
                    "monocon."):
                parent = parent.cpu_parent
            ranges.append((e.name, e.time_range.start, e.time_range.end,
                           parent.name if parent is not None else None))
    _assert_steps(ranges, 2)


def test_the_phases_show_in_device_traces_chrome_trace(stepper, tmp_path):
    with device_trace(str(tmp_path)):
        stepper()
        stepper()
    (path,) = glob.glob(os.path.join(tmp_path, f"*{TRACE_SUFFIX}"))
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith("monocon.")]
    assert all(e["cat"] == "user_annotation" for e in events)
    events.sort(key=lambda e: e["ts"])
    ranges = []
    for e in events:
        start, end = e["ts"], e["ts"] + e["dur"]
        parent = [p for p in ranges if p[1] <= start and end <= p[2]]
        ranges.append((e["name"], start, end,
                       parent[-1][0] if parent else None))
    _assert_steps(ranges, 2)
