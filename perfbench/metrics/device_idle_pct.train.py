"""100 minus the card's busy share of the profiled stretch of a training
cell: the union of its kernels', copies' and fills' intervals over the
stretch's host wall time."""

from perfbench.trace import idle_pct


def read(ctx):
    if not ctx["kind"].startswith("train") or ctx["trace"] is None:
        return None
    return idle_pct(ctx["trace"])
