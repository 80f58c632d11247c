"""Host milliseconds per frame inside the program's ``pipeline.chunk`` regions: every chunk of the
EVALUATION chunk loop, its models and renderer included."""


def read(trace):
    regions = trace.regions(r"pipeline\.chunk")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
