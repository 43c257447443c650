"""Timing and device profiling.

Port of ``monocon_tpu/utils/profiling.py``: the reference's timer
decorator (``utils/decorators.py``), a timer that waits for the devices
before it reads the clock, and trace capture with ``torch.profiler`` in
the place of ``jax.profiler``. :func:`device_op_seconds` reads a trace
back: the summed duration of its GPU kernels. :func:`span` names a stretch
of the program in whatever trace is being recorded.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import gzip
import json
import os
import time
from typing import Any, Callable, Tuple

import torch
from torch.autograd import profiler as autograd_profiler

# The chrome-trace category of a GPU kernel as CUPTI records it. Copies
# ("gpu_memcpy"), fills ("gpu_memset") and the host's "cuda_runtime" calls
# have categories of their own and are not counted.
KERNEL_CATEGORY = "kernel"
TRACE_SUFFIX = ".pt.trace.json.gz"
# What :func:`span` returns while no profiler records: one shared context
# that does nothing.
_NO_SPAN = contextlib.nullcontext()


def timed(fn: Callable) -> Callable:
    """Wrap ``fn`` to return ``(result, elapsed_seconds)``.

    Parity: reference ``decorator_timer`` (utils/decorators.py:4-11)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs) -> Tuple[Any, float]:
        t0 = time.time()
        result = fn(*args, **kwargs)
        return result, time.time() - t0

    return wrapper


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_on(tree: Any) -> Any:
    """Wait until the work that produces every tensor in a nest of dicts,
    lists and tuples is done: synchronise each CUDA device they lie on
    (CPU tensors are ready when they are returned). Returns ``tree``."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)
    return tree


def sync_timer(fn: Callable, *args, iters: int = 10, warmup: int = 2,
               **kwargs) -> float:
    """Steady-state seconds per call of ``fn(*args, **kwargs)``: ``warmup``
    calls, then ``iters`` calls between two waits for the devices."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    block_on(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    block_on(out)
    return (time.perf_counter() - t0) / iters


def span(name: str):
    """A context that marks a stretch of the program as ``name`` in the
    trace of a recording ``torch.profiler``, on the profiler's own clock
    (a ``record_function`` range; :func:`device_trace`'s trace shows it
    over the kernels). While no profiler records it reads the profiler's
    flag once and enters nothing."""
    if autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the host and, where CUDA is available, the card with
    ``torch.profiler``; on exit the trace is written as a gzipped chrome
    trace ``<time>.pt.trace.json.gz`` under ``log_dir`` (open it in
    Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{time.time_ns()}{TRACE_SUFFIX}"))


def device_op_seconds(log_dir: str) -> float:
    """Summed seconds of the GPU kernels in the newest trace under
    ``log_dir``: the duration of every complete event (``"ph": "X"``) of
    category ``"kernel"``. It is the counterpart of the JAX package's sum
    over the device lane's "XLA Ops"; kernels that overlap on two streams
    count twice. A trace without CUDA activity gives 0."""
    paths = glob.glob(os.path.join(log_dir, f"*{TRACE_SUFFIX}"))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with gzip.open(max(paths, key=os.path.getmtime), "rt") as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("dur", 0) for e in events
               if e.get("ph") == "X"
               and e.get("cat") == KERNEL_CATEGORY) / 1e6
