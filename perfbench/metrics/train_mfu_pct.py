"""The training step's share of the card's dense peak in the configured
dtype: ``torch.utils.flop_counter`` FLOPs of one forward + backward of
the configuration's plain reference at the cell's shapes (counted at
set-up on the meta device, ``counts/flops.py::train_flops``) times the
steps a second of the window outside the profiled stretch, over the
peak."""

from perfbench.counts.peaks import peak_flops


def read(ctx):
    flops = ctx["counters"].get("flops_per_step")
    w = ctx["window"]
    peak = peak_flops(ctx["device_name"], ctx["dtype"])
    if (not ctx["kind"].startswith("train") or not flops or peak is None
            or w["untraced_wall"] <= 0 or w["untraced_steps"] <= 0):
        return None
    return 100.0 * flops * w["untraced_steps"] / w["untraced_wall"] / peak
