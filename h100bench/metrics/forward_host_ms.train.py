"""Host milliseconds per train step inside the program's ``runner.forward`` regions: the pipeline's TRAINING
call (a per-step path; a fused step's forward replays inside its CUDA graph, with no host region)."""


def read(trace):
    regions = trace.regions(r"runner\.forward")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
