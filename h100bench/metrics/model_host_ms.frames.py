"""Host milliseconds per frame inside the program's ``model.<class name>`` regions: every call of an
implicit function (a NeRF MLP on K1, a proposal MLP) in the frame's chunks."""


def read(trace):
    regions = trace.regions(r"model\..+")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
