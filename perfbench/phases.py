"""The training step's device work and idle time, put down to the phase of
the program that caused them: the five children of the program's
``monocon.step`` span (``engine/train_step.py``).

- A device operation belongs to the innermost phase span, on any host
  thread, open at its launch time: the start of the runtime or driver
  call that shares its correlation id. Backward's kernels, launched from
  autograd's thread while the main thread sits in
  ``monocon.step.backward``, belong to ``backward``.
- An idle gap of the device (``trace.gaps``) belongs to the innermost
  phase span open at the gap's start: what the host was doing when the
  device ran dry, the rule ``trace.span_at`` applies to the benchmark's
  own spans.
- Operations and gaps in no phase (the step's own time, the host outside
  any step, an operation with no launch time) go to ``REMAINDER``.

All in seconds on the trace's clock. The device operations, their launch
times, the busy time, gaps and the program's spans are those
``trace.from_profiler`` reads.

    python3 -m perfbench.phases --workload <cell> --seed <n> [--steps 20]

sets a cell up, times ``--steps`` steps untraced, profiles as many more
and prints one JSON line: each phase's and the remainder's launches,
device ms and idle ms a step, beside the totals they add up to.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import trace as tr

STEP = "monocon.step"
PHASES = ("targets", "forward", "losses", "backward", "solver")
REMAINDER = "remainder"
# The least share of the stretch's device time that must have a launch
# time, and that must fall in the five phases, for a reading.
COVERED = 0.99


@dataclass
class Attribution:
    """Per phase (and ``REMAINDER``): kernels launched, device seconds of
    kernels, copies and fills, idle seconds."""

    launches: Dict[str, int] = field(default_factory=dict)
    device_s: Dict[str, float] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)
    linked_s: float = 0.0       # device seconds with a launch time

    def total(self, quantity: str) -> float:
        return sum(getattr(self, quantity).values())

    def covered(self) -> bool:
        """Whether enough of the device time is linked and in phases."""
        device = self.total("device_s")
        phased = device - self.device_s[REMAINDER]
        return (device > 0 and self.linked_s >= COVERED * device
                and phased >= COVERED * device)


def phase_at(spans: List, t: Optional[float]) -> str:
    """The phase of the innermost phase span open at host time ``t``."""
    best = None
    if t is not None:
        for start, end, phase in spans:
            if start <= t <= end and (best is None or end - start < best[0]):
                best = (end - start, phase)
    return best[1] if best else REMAINDER


def attribute(trace: tr.Trace) -> Optional[Attribution]:
    """The stretch's launches, device and idle time by phase; None for a
    stretch with no ``monocon.step`` span."""
    if not any(name == STEP for _, _, name in trace.program_spans):
        return None
    prefix = STEP + "."
    spans = [(start, end, name[len(prefix):])
             for start, end, name in trace.program_spans
             if name.startswith(prefix) and name[len(prefix):] in PHASES]
    keys = PHASES + (REMAINDER,)
    out = Attribution({p: 0 for p in keys}, {p: 0.0 for p in keys},
                      {p: 0.0 for p in keys})
    for op in trace.ops:
        phase, dur = phase_at(spans, op.launched), op.end - op.start
        out.launches[phase] += int(op.kernel)
        out.device_s[phase] += dur
        if op.launched is not None:
            out.linked_s += dur
    for start, end in tr.gaps(trace):
        out.idle_s[phase_at(spans, start)] += end - start
    return out


def report(trace: tr.Trace) -> Dict:
    """Each phase's and the remainder's numbers per step (ms, launches),
    beside the totals they add up to: kernels, busy time (the union) and
    summed gaps over the steps. ``covered`` is False where under 99% of
    the device time has a launch time or falls in the five phases: the
    table is then no reading of the phases."""
    out, steps = attribute(trace), max(trace.steps, 1)
    if out is None:
        return {"phases": None}
    table = {p: {"launches": out.launches[p] / steps,
                 "device_ms": 1e3 * out.device_s[p] / steps,
                 "idle_ms": 1e3 * out.idle_s[p] / steps}
             for p in PHASES + (REMAINDER,)}
    device = out.total("device_s")
    return {"phases": table, "covered": out.covered(),
            "linked_share": out.linked_s / device if device else None,
            "launches": len(trace.kernels()) / steps,
            "busy_ms": 1e3 * tr.busy_seconds(trace) / steps,
            "device_ms": 1e3 * device / steps,
            "gaps_ms": 1e3 * sum(b - a for a, b in tr.gaps(trace)) / steps,
            "steps": trace.steps, "traced_ms_per_step":
            1e3 * trace.wall / steps}


def main(argv=None) -> int:
    import argparse
    import json
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import run
    from .drivers import KINDS

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)
    spec = run.cell_spec(args.workload)
    run.set_caches()
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run.program_backends(spec["config"])
    cell = KINDS[spec["traffic"]["kind"]](
        args.workload, spec["config"], spec["traffic"], args.seed, device)
    cell.setup()

    def steps() -> float:
        """Seconds for ``args.steps`` steps, between synchronisations."""
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            cell._step(cell.next)
            cell.next += 1
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    untraced = steps()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    wall = steps()
    prof.stop()
    out = report(tr.from_profiler(prof, wall, args.steps))
    out.update(workload=args.workload, seed=args.seed, card=run.card_label(),
               untraced_ms_per_step=1e3 * untraced / args.steps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
