"""The step's phases (``perfbench/phases.py``): attribution by launch time
and by a gap's start, sums that add up, the 99% guard, silence on a
stretch without program spans or launch links, and a profiler stub read
by the benchmark's ``trace.from_profiler`` (launch times and program
spans kept), with and without ``monocon.*`` events, to the same
numbers; a real profiler's ``monocon.*`` span kept, on the CPU, and its
launch links, on the card."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import phases, run, trace
from perfbench.trace import DeviceOp

OLD = ["launches_per_step.train", "train_mfu_pct", "splat_roofline_pct",
       "device_idle_pct.train"]


def step_spans(t0):
    """One step's six ranges from ``t0`` on: the step and its five
    phases."""
    return [(t0, t0 + 10, "monocon.step"),
            (t0 + 1, t0 + 2, "monocon.step.targets"),
            (t0 + 2, t0 + 4, "monocon.step.forward"),
            (t0 + 4, t0 + 5, "monocon.step.losses"),
            (t0 + 5, t0 + 8, "monocon.step.backward"),
            (t0 + 8, t0 + 9, "monocon.step.solver")]


def make_phased(fills=True):
    """Two steps of 10 s, with the program's spans and each operation's
    launch time. The main thread launches in targets, forward,
    losses and solver; autograd's thread launches backward's kernels
    while the main thread sits in backward; with ``fills``, one fill a
    step is launched in the step's own time. Gaps open in forward (3.6 ->
    4.2), solver (8.9 -> 9.3), the step's own time (9.5 -> 10.6) and
    between the steps' work."""
    t = trace.Trace(wall=20.0, steps=2)
    t.spans = [(0.0, 10.0, "perfbench.train_step"),
               (10.0, 20.0, "perfbench.train_step")]
    t.program_spans = step_spans(0.0) + step_spans(10.0)
    for t0 in (0.0, 10.0):
        for op, at in [
                (DeviceOp("splat", t0 + 1.5, t0 + 2.0, True), t0 + 1.1),
                (DeviceOp("Memcpy HtoD", t0 + 2.0, t0 + 2.1, False),
                 t0 + 1.2),
                (DeviceOp("conv", t0 + 2.1, t0 + 3.6, True), t0 + 2.1),
                (DeviceOp("loss", t0 + 4.2, t0 + 4.4, True), t0 + 4.1),
                # autograd's thread, inside the main thread's backward
                (DeviceOp("dgrad", t0 + 4.4, t0 + 7.0, True), t0 + 5.5),
                (DeviceOp("wgrad", t0 + 7.0, t0 + 8.9, True), t0 + 6.5),
                (DeviceOp("adam", t0 + 9.3, t0 + 9.5, True), t0 + 8.5)]:
            op.launched = at
            t.ops.append(op)
    if fills:
        t.ops += [DeviceOp("fill", 10.6, 10.7, True, 9.6),
                  DeviceOp("fill", 19.7, 19.8, True, 19.6)]
    return t


def test_attribution_by_launch_and_by_gap_start():
    out = phases.attribute(make_phased())
    assert out.launches == {"targets": 2, "forward": 2, "losses": 2,
                            "backward": 4, "solver": 2, "remainder": 2}
    want = {"targets": 1.2, "forward": 3.0, "losses": 0.4, "backward": 9.0,
            "solver": 0.4, "remainder": 0.2}
    for phase, seconds in want.items():
        assert out.device_s[phase] == pytest.approx(seconds), phase
    # Forward's gap opens at 3.6 and solver's at 8.9 in each step; the
    # gap at 9.5 opens in the step's own time, and the first step's last
    # gap (10.7 -> 11.5) in the second step's, before its targets.
    idle = {"forward": 1.2, "solver": 0.8, "remainder": 1.1 + 0.8 + 0.2}
    for phase in phases.PHASES + (phases.REMAINDER,):
        assert out.idle_s[phase] == pytest.approx(idle.get(phase, 0.0))


def test_the_innermost_open_phase_wins():
    spans = [(0.0, 10.0, "backward"), (2.0, 3.0, "solver")]
    assert phases.phase_at(spans, 2.5) == "solver"
    assert phases.phase_at(spans, 5.0) == "backward"
    assert phases.phase_at(spans, 11.0) == phases.REMAINDER
    assert phases.phase_at(spans, None) == phases.REMAINDER


def test_the_phases_and_the_remainder_add_up():
    t = make_phased()
    out = phases.attribute(t)
    assert out.total("launches") == len(t.kernels())
    assert out.total("device_s") == pytest.approx(
        sum(o.end - o.start for o in t.ops))
    assert out.total("device_s") == pytest.approx(trace.busy_seconds(t))
    assert out.total("idle_s") == pytest.approx(
        sum(b - a for a, b in trace.gaps(t)))
    report = phases.report(t)
    assert report["covered"] is False       # the fills: 1.4% remainder
    for key, total in [("launches", "launches"), ("device_ms", "busy_ms"),
                       ("idle_ms", "gaps_ms")]:
        assert report[total] == pytest.approx(
            sum(r[key] for r in report["phases"].values())), key


def test_the_report_reads_the_attribution_per_step():
    p = make_phased(fills=False)
    report = phases.report(p)
    assert report["covered"] is True and report["linked_share"] == 1.0
    got = report["phases"]
    assert got["backward"]["launches"] == 2
    assert got["targets"]["launches"] == 1
    assert got["backward"]["device_ms"] == pytest.approx(4500)
    assert got["forward"]["device_ms"] == pytest.approx(1500)
    assert got["forward"]["idle_ms"] == pytest.approx(600)
    assert got["solver"]["idle_ms"] == pytest.approx(400)
    assert got["backward"]["idle_ms"] == 0
    ctx = {"kind": "train_step", "trace": p}
    assert sum(r["launches"] for r in got.values()) \
        == run.reader("launches_per_step.train")(ctx)


def test_the_99_percent_guard():
    p = make_phased(fills=False)
    assert phases.attribute(p).covered()
    device = sum(o.end - o.start for o in p.ops)
    # An operation with no launch link, 1.1% of the device time.
    orphan = DeviceOp("orphan", 30.0, 30.0 + 0.011 * device / 0.989, True)
    p.ops.append(orphan)
    assert not phases.attribute(p).covered()
    # Linked, but launched in the step's own time: outside the phases.
    orphan.launched = 9.7
    out = phases.attribute(p)
    assert out.linked_s == pytest.approx(out.total("device_s"))
    assert not out.covered()
    # Under 1%: covered.
    orphan.end = 30.0 + 0.009 * device
    assert phases.attribute(p).covered()


@pytest.mark.parametrize("missing", ["step span", "launch links",
                                     "everything"])
def test_no_reading_without_spans_or_links(missing):
    p = make_phased(fills=False)
    assert phases.report(p)["covered"] is True
    if missing == "step span":
        p.program_spans = [s for s in p.program_spans
                           if s[2] != "monocon.step"]
        assert phases.report(p) == {"phases": None}
    elif missing == "launch links":
        for op in p.ops:
            op.launched = None
        report = phases.report(p)
        assert report["covered"] is False and report["linked_share"] == 0
    else:
        p = trace.Trace(wall=1.0, steps=2)
        assert phases.report(p) == {"phases": None}


# -- from_profiler on a stub profiler -------------------------------------

def event(name, start, end, device="cpu", eid=0, annotation=False):
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    return SimpleNamespace(
        name=name, id=eid, is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start * 1e6, end=end * 1e6),
        device_type=cuda if device == "cuda" else cpu)


def stub_events():
    """Two steps as the profiler lists them: the benchmark's span, the
    program's spans (host, and as user annotations on the device lane),
    aten ops, launch calls on the main thread and on autograd's thread
    (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync), a sync, and the
    device's kernels and copy with their correlation ids; one kernel's
    launch is missing."""
    out = []
    for i, t0 in enumerate((0.0, 10.0)):
        c = 100 * i
        out += [event("perfbench.train_step", t0, t0 + 10)]
        out += [event(n, a, b) for a, b, n in step_spans(t0)]
        out += [event("monocon.step.forward", t0 + 2.05, t0 + 3.7, "cuda",
                      annotation=True)]
        out += [event("aten::conv2d", t0 + 2.05, t0 + 2.2, eid=7 + c),
                event("cudaLaunchKernel", t0 + 1.1, t0 + 1.15, eid=1 + c),
                event("cudaMemcpyAsync", t0 + 1.2, t0 + 1.25, eid=2 + c),
                event("cuLaunchKernel", t0 + 2.1, t0 + 2.15, eid=3 + c),
                event("cudaLaunchKernel", t0 + 5.5, t0 + 5.55, eid=4 + c),
                event("cudaStreamSynchronize", t0 + 9.6, t0 + 9.9, eid=6 + c),
                event("splat_kernel", t0 + 1.5, t0 + 2.0, "cuda", eid=1 + c),
                event("Memcpy HtoD", t0 + 2.0, t0 + 2.1, "cuda", eid=2 + c),
                event("conv", t0 + 2.1, t0 + 3.6, "cuda", eid=3 + c),
                event("dgrad", t0 + 4.4, t0 + 7.0, "cuda", eid=4 + c),
                event("adam", t0 + 9.3, t0 + 9.5, "cuda", eid=5 + c)]
    return sorted(out, key=lambda e: e.time_range.start)


def test_read_profiler_links_launch_times_and_program_spans():
    p = trace.from_profiler(SimpleNamespace(events=stub_events), 20.0, 2)
    launched = {(o.name, o.start): o.launched for o in p.ops}
    assert launched[("splat_kernel", 1.5)] == pytest.approx(1.1)
    assert launched[("Memcpy HtoD", 12.0)] == pytest.approx(11.2)
    assert launched[("conv", 2.1)] == pytest.approx(2.1)
    assert launched[("dgrad", 14.4)] == pytest.approx(15.5)
    assert launched[("adam", 9.3)] is None
    assert len(p.ops) == 10 and len(p.spans) == 2
    assert sorted(p.program_spans) == sorted(step_spans(0.0)
                                             + step_spans(10.0))
    out = phases.attribute(p)
    assert out.launches["backward"] == 2 and out.launches["targets"] == 2
    assert out.launches[phases.REMAINDER] == 2       # adam: no link


def test_the_benchmarks_trace_reads_the_same_without_program_spans():
    """The benchmark's reading of a profiler, and the four readers that
    read it, are the same with and without the program's events."""
    events = stub_events()
    without = [e for e in events if not e.name.startswith("monocon.")]
    a = trace.from_profiler(SimpleNamespace(events=lambda: events), 20.0, 2)
    b = trace.from_profiler(SimpleNamespace(events=lambda: without), 20.0, 2)
    assert a.ops == b.ops and a.spans == b.spans
    assert (a.wall, a.steps) == (b.wall, b.steps)
    assert trace.busy_seconds(a) == trace.busy_seconds(b)
    assert trace.idle_pct(a) == trace.idle_pct(b)
    assert trace.gaps(a) == trace.gaps(b)
    assert trace.breakdown(a) == trace.breakdown(b)
    assert b.program_spans == [] and phases.report(b) == {"phases": None}
    label = {"gt_bboxes": torch.zeros(1, 1, 4), "mask": torch.zeros(1, 1),
             "gt_kpts_2d": torch.zeros(1, 1, 18),
             "gt_kpts_valid_mask": torch.zeros(1, 1, 9)}
    ctxs = []
    for x in (a, b):
        ctxs.append({"kind": "train_step", "trace": x, "pad_hw": (64, 160),
                     "device_name": "NVIDIA H100 80GB HBM3",
                     "dtype": "float32",
                     "window": {"untraced_steps": 10, "untraced_wall": 2.0},
                     "counters": {"flops_per_step": 1e12,
                                  "traced_labels": [label]}})
    for name in OLD:
        assert run.reader(name)(ctxs[0]) == run.reader(name)(ctxs[1]), name
        assert run.reader(name)(ctxs[0]) is not None, name


# -- from_profiler on a real profiler --------------------------------------

def program_step(x):
    """One of the program's spans with a phase inside, in the benchmark's
    span, around some work on ``x``'s device."""
    from monocon_tpu_torch.utils.profiling import span

    with torch.profiler.record_function("perfbench.train_step"):
        with span("monocon.step"), span("monocon.step.forward"):
            return (x @ x + 1).sum().item()


def profiled(activities, x):
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        program_step(x)
    return trace.from_profiler(prof, 1.0, 1)


def test_a_real_profiler_keeps_the_programs_spans():
    from torch.profiler import ProfilerActivity

    t = profiled([ProfilerActivity.CPU], torch.ones(64, 64))
    assert [n for _, _, n in t.spans] == ["perfbench.train_step"]
    assert sorted(n for _, _, n in t.program_spans) == [
        "monocon.step", "monocon.step.forward"]
    (outer,) = t.spans
    for start, end, _ in t.program_spans:
        assert outer[0] <= start <= end <= outer[1]
    assert t.ops == []


@pytest.mark.cuda
def test_a_real_profiler_links_each_launch_on_the_card(card):
    from torch.profiler import ProfilerActivity

    x = torch.ones(256, 256, device=card)
    program_step(x)
    t = profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA], x)
    (forward,) = [s for s in t.program_spans
                  if s[2] == "monocon.step.forward"]
    assert t.kernels()
    for op in t.ops:
        assert op.launched is not None, op
        assert forward[0] <= op.launched <= forward[1], op
    out = phases.attribute(t)
    assert out.launches["forward"] == len(t.kernels())
