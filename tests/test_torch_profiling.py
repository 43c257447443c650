"""``monocon_tpu_torch/utils/profiling.py``, as
``tests/test_misc_components.py::test_profiling_utils`` holds the JAX
package's: the timer decorator, the synchronising timer, and the kernel
time that :func:`device_op_seconds` reads from a chrome trace (a small
hand-written one here; a real trace of the card in the ``cuda``-marked
test)."""

import gzip
import json
import os
import time

import pytest
import torch

import torch_port_helpers  # noqa: F401 -- caps torch's threads
from monocon_tpu_torch.utils.profiling import (TRACE_SUFFIX, block_on,
                                               device_op_seconds,
                                               device_trace, sync_timer,
                                               timed)


def test_timed_and_sync_timer():
    @timed
    def f(x):
        return x + 1

    result, elapsed = f(1)
    assert result == 2 and elapsed >= 0
    x = torch.ones(8, 8)
    assert sync_timer(lambda a: a * 2, x, iters=3, warmup=1) > 0
    tree = {"a": [x, (x, 3)], "b": "text"}
    assert block_on(tree) is tree


def _write_trace(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_device_op_seconds_sums_the_kernels_of_the_newest_trace(tmp_path):
    """Complete events of category ``kernel`` count; copies, fills, host
    ops, runtime calls and instant events do not; an older trace is
    ignored."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "conv", "dur": 1500.0},
        {"ph": "X", "cat": "kernel", "name": "bn", "dur": 250.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 900},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 40},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 7000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 12},
        {"ph": "i", "cat": "kernel", "name": "marker", "dur": 99},
        {"ph": "M", "name": "process_name", "args": {"name": "python"}},
    ]
    old = tmp_path / f"1{TRACE_SUFFIX}"
    _write_trace(old, [{"ph": "X", "cat": "kernel", "dur": 1e9}])
    os.utime(old, (time.time() - 60, time.time() - 60))
    _write_trace(tmp_path / f"2{TRACE_SUFFIX}", events)
    assert device_op_seconds(str(tmp_path)) == pytest.approx(1750.5e-6)
    with pytest.raises(FileNotFoundError):
        device_op_seconds(str(tmp_path / "empty"))


def test_device_trace_writes_a_trace_without_kernels_on_the_cpu(tmp_path):
    with device_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert len(list(tmp_path.glob(f"*{TRACE_SUFFIX}"))) == 1
    assert device_op_seconds(str(tmp_path)) == 0.0


@pytest.mark.cuda
def test_device_op_seconds_of_a_card_trace(tmp_path):
    """A traced loop of matrix products: positive kernel time, no more than
    the CUDA-event time of the same loop (5% for the events' own edges)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(2048, 2048, device="cuda")
    a @ a
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with device_trace(str(tmp_path)):
        start.record()
        for _ in range(10):
            a = (a @ a).tanh()
        end.record()
        torch.cuda.synchronize()
    kernel_s = device_op_seconds(str(tmp_path))
    assert 0 < kernel_s <= 1.05 * start.elapsed_time(end) / 1e3
