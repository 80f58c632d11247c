"""Host milliseconds per frame inside the program's ``renderer.*`` regions: the refinements, the
compositing with its casts and the losses, in the frame's chunks."""


def read(trace):
    regions = trace.regions(r"renderer\..+")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
