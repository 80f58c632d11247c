"""Host milliseconds per frame inside the program's ``service.fetch`` region: the copies of the frame's
rgb and depth to the host, which wait for the frame's queued device work."""


def read(trace):
    regions = trace.regions(r"service\.fetch")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
