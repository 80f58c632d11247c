"""Host milliseconds per train step inside the program's ``runner.backward`` regions: ``zero_grad`` and
``backward()``, the main thread waiting while autograd's thread launches the backward (a per-step path)."""


def read(trace):
    regions = trace.regions(r"runner\.backward")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
