"""The splat kernel's share of its roofline in the profiled stretch: the
least time of the stretch's splat calls (each input read once and each
heatmap written once, or the operations their labels need, whichever
bounds it; ``counts/splat.py``) over the summed device time of the
``splat_kernel`` launches in the trace."""

from perfbench.counts.peaks import hbm_bytes_per_s
from perfbench.counts.splat import bound_seconds, step_work


def read(ctx):
    trace, labels = ctx["trace"], ctx["counters"].get("traced_labels")
    rate = hbm_bytes_per_s(ctx["device_name"])
    if trace is None or not labels or rate is None:
        return None
    kernels = trace.kernels("splat_kernel")
    if not kernels:
        return None
    bound = 0.0
    for label in labels:
        nbytes, ops = step_work({k: v.numpy() for k, v in label.items()},
                                ctx["pad_hw"])
        bound += bound_seconds(nbytes, ops, rate)[0]
    return 100.0 * bound / sum(k.end - k.start for k in kernels)
