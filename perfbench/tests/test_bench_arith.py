"""The arithmetic the benchmark copied: the union of device intervals,
the idle share, the gaps and their names, MFU, the splat bound, and the
rate over the window."""

import numpy as np
import pytest
import torch

from perfbench import run, trace
from perfbench.counts import splat
from perfbench.counts.flops import count_flops


def make_trace():
    t = trace.Trace(wall=1.0, steps=2)
    t.ops = [trace.DeviceOp("a", 0.0, 0.2, True),
             trace.DeviceOp("b", 0.1, 0.3, True),     # overlaps a
             trace.DeviceOp("Memcpy HtoD", 0.5, 0.6, False),
             trace.DeviceOp("a", 0.9, 1.0, True)]
    t.spans = [(0.0, 1.0, "perfbench.train_step"),
               (0.3, 0.5, "perfbench.loader_next")]
    return t


def test_union_idle_and_gaps():
    t = make_trace()
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.busy_seconds(t) == pytest.approx(0.5)
    assert trace.idle_pct(t) == pytest.approx(50.0)
    assert trace.gaps(t) == [(0.3, 0.5), (0.6, 0.9)]
    assert trace.idle_pct(trace.Trace(wall=1.0)) is None


def test_breakdown_names_gaps_by_host_span():
    b = trace.breakdown(make_trace())
    assert b["device_ops"][0] == ["a", pytest.approx(0.3)]
    assert len(b["device_ops"]) == 3
    # The longest gap (0.6 -> 0.9) opens inside the step span alone; the
    # other (0.3 -> 0.5) inside the loader's.
    assert b["idle_gaps"] == [["perfbench.train_step", pytest.approx(0.3)],
                              ["perfbench.loader_next", pytest.approx(0.2)]]


def test_kernel_readers():
    t = make_trace()
    ctx = {"kind": "train_step", "trace": t, "counters": {},
           "device_name": "NVIDIA H100 80GB HBM3", "dtype": "bfloat16",
           "window": {"untraced_steps": 10, "untraced_wall": 2.0}}
    assert run.reader("launches_per_step.train")(ctx) == 1.5
    assert run.reader("device_idle_pct.train")(ctx) == pytest.approx(50.0)
    ctx["counters"]["flops_per_step"] = 989.4e12
    # 5 steps a second of 989.4 TFLOP each on a 989.4 TFLOP/s card: 500%.
    assert run.reader("train_mfu_pct")(ctx) == pytest.approx(500.0)
    ctx["device_name"] = "another card"
    assert run.reader("train_mfu_pct")(ctx) is None


def test_splat_bound_by_hand():
    label = {"gt_bboxes": np.zeros((1, 2, 4), np.float32),
             "mask": np.array([[1.0, 0.0]], np.float32),
             "gt_kpts_2d": np.zeros((1, 2, 18), np.float32),
             "gt_kpts_valid_mask": np.zeros((1, 2, 9), np.float32)}
    # One object whose box is 40x40 pixels at (100, 100) on a 64x160
    # canvas: 10x10 cells on the 16x40 map, centre (7, 7).
    label["gt_bboxes"][0, 0] = [80, 8, 120, 48]
    nbytes, ops = splat.step_work(label, (64, 160))
    r = splat._radius(np.float32(10.0), np.float32(10.0))
    side = 2 * r + 1
    assert ops == side * side * splat.OPS_PER_PIXEL
    assert nbytes == 1 * 2 * 10 * splat.INPUT_BYTES + 1 * 12 * 16 * 40 * 4
    t, what = splat.bound_seconds(nbytes, ops, 3.35e12)
    assert what == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    # Keypoints at the edge count only their pixels on the map.
    label["gt_kpts_valid_mask"][0, 0, 0] = 2
    nbytes2, ops2 = splat.step_work(label, (64, 160))
    assert ops2 == ops + (r + 1) * (r + 1) * splat.OPS_PER_PIXEL


def test_splat_roofline_reader():
    t = trace.Trace(wall=1.0, steps=1)
    t.ops = [trace.DeviceOp("splat_kernel(int)", 0.0, 2e-5, True),
             trace.DeviceOp("other", 0.0, 1.0, True)]
    label = {"gt_bboxes": torch.zeros(1, 1, 4), "mask": torch.zeros(1, 1),
             "gt_kpts_2d": torch.zeros(1, 1, 18),
             "gt_kpts_valid_mask": torch.zeros(1, 1, 9)}
    ctx = {"trace": t, "counters": {"traced_labels": [label]},
           "device_name": "NVIDIA H100 80GB HBM3", "pad_hw": (64, 160)}
    nbytes = 10 * splat.INPUT_BYTES + 12 * 16 * 40 * 4
    assert run.reader("splat_roofline_pct")(ctx) == pytest.approx(
        100 * nbytes / 3.35e12 / 2e-5)
    t.ops = t.ops[1:]
    assert run.reader("splat_roofline_pct")(ctx) is None


def test_flop_count_is_two_per_multiply_add():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    x = torch.zeros(2, 3, 16, 16)
    assert count_flops(lambda: conv(x)) == 2 * 2 * 8 * 16 * 16 * 3 * 9


def test_rates_over_the_window():
    spec = {"end_to_end": [{"name": "train_images_per_s", "unit": "images/s"},
                           {"name": "train_peak_mem_gib", "unit": "GiB"},
                           {"name": "setup_s", "unit": "s"}]}
    window = {"images": 480, "wall": 4.0, "memory_peak_bytes": 3 * 2 ** 30}
    out = run.end_to_end(spec, window, 12.5)
    assert out == {"train_images_per_s": {"value": 120.0, "unit": "images/s"},
                   "train_peak_mem_gib": {"value": 3.0, "unit": "GiB"},
                   "setup_s": {"value": 12.5, "unit": "s"}}
