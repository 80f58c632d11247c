"""Host milliseconds per train step inside the runner's dispatch regions (``fused_dispatch_K{n}`` around a fused
dispatch's replays, ``train_step_dispatch`` around a per-step call)."""


def read(trace):
    regions = trace.regions(r"fused_dispatch_K\d+|train_step_dispatch")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
