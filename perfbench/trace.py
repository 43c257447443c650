"""Reading a ``torch.profiler`` window: device intervals, host spans, the
union of the device's busy time, the idle gaps and the top operations.

One pass over the profiler's events keeps the device operations, the
benchmark's ``perfbench.*`` spans, the program's ``monocon.*`` spans and,
for each device operation, the host time of the runtime or driver call
that launched it (the call that shares its correlation id).

The arithmetic is that of ``chip_smoke.py``'s ``traced_busy_share`` and
``kernel_breakdown``: the device's busy time is the union of its
operations' intervals (kernels, copies and fills), so operations that
overlap on two streams count once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

SPAN_PREFIX = "perfbench."
PROGRAM_SPAN_PREFIX = "monocon."
# Words in the name of a runtime or driver call that puts work on the
# device (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync,
# cudaMemsetAsync, ...); it shares its correlation id with that work.
LAUNCH_WORDS = ("launch", "memcpy", "memset")
Interval = Tuple[float, float]


@dataclass
class DeviceOp:
    name: str
    start: float        # seconds, on the profiler's clock
    end: float
    kernel: bool        # a kernel, not a copy or a fill
    # Host time of the call that launched it; None where the profiler
    # links none.
    launched: Optional[float] = None


@dataclass
class Trace:
    """What one profiled stretch holds; ``wall`` is its host seconds and
    ``steps`` the steps (or batches) it covered. ``spans`` are the
    benchmark's host spans, ``program_spans`` the program's."""

    ops: List[DeviceOp] = field(default_factory=list)
    spans: List[Tuple[float, float, str]] = field(default_factory=list)
    program_spans: List[Tuple[float, float, str]] = field(
        default_factory=list)
    wall: float = 0.0
    steps: int = 0

    def kernels(self, name_part: str = "") -> List[DeviceOp]:
        return [o for o in self.ops if o.kernel and name_part in o.name]


def is_launch(name: str) -> bool:
    """Whether a host event is a runtime or driver call that puts work on
    the device."""
    low = name.lower()
    return low.startswith("cu") and any(w in low for w in LAUNCH_WORDS)


def from_profiler(prof, wall: float, steps: int) -> Trace:
    """The device operations with their launch times, and the
    ``perfbench.*`` and ``monocon.*`` host spans, of a finished
    ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    trace = Trace(wall=wall, steps=steps)
    op_ids, launches = [], {}
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False):
                continue    # a host span drawn on the device's lane
            low = e.name.lower()
            copy = low.startswith(("memcpy", "memset")) or "memcpy" in low
            trace.ops.append(DeviceOp(e.name, start, end, not copy))
            op_ids.append(e.id)
        elif e.name.startswith(SPAN_PREFIX):
            trace.spans.append((start, end, e.name))
        elif e.name.startswith(PROGRAM_SPAN_PREFIX):
            trace.program_spans.append((start, end, e.name))
        elif is_launch(e.name):
            launches[e.id] = start
    for op, i in zip(trace.ops, op_ids):
        op.launched = launches.get(i)
    return trace


def union_seconds(intervals: List[Interval]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, covered = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > covered:
            busy += end - max(start, covered)
            covered = end
    return busy


def busy_seconds(trace: Trace) -> float:
    return union_seconds([(o.start, o.end) for o in trace.ops])


def idle_pct(trace: Trace) -> Optional[float]:
    """100 minus the device's busy share of the stretch's wall time;
    None for a trace with no device operation."""
    if not trace.ops or trace.wall <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(trace) / trace.wall)


def gaps(trace: Trace) -> List[Interval]:
    """The device's idle intervals between its first and last operation."""
    out, covered = [], None
    for start, end in sorted((o.start, o.end) for o in trace.ops):
        if covered is not None and start > covered:
            out.append((covered, start))
        covered = end if covered is None else max(covered, end)
    return out


def span_at(trace: Trace, t: float) -> str:
    """The innermost ``perfbench.*`` span open at host time ``t``."""
    best = None
    for start, end, name in trace.spans:
        if start <= t <= end and (best is None or end - start < best[0]):
            best = (end - start, name)
    return best[1] if best else "outside perfbench spans"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The ``top`` device operations by summed seconds, and the ``top``
    longest idle gaps, each named by the span the host was in when the
    gap began."""
    by_name = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[span_at(trace, a), b - a] for a, b in longest]}
