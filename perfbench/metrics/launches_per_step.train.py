"""CUDA kernels a training step launches, counted in the profiled
stretch's device trace (copies and fills left out)."""


def read(ctx):
    trace = ctx["trace"]
    if not ctx["kind"].startswith("train") or trace is None or not trace.steps:
        return None
    kernels = trace.kernels()
    return len(kernels) / trace.steps if kernels else None
