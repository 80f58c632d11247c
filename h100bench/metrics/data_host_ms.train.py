"""Host milliseconds per train step inside the program's ``data.batch`` regions: the loader's next batch,
``prepare_batch`` and the data hooks per step; a fused dispatch's uploads of its rows and rates."""


def read(trace):
    regions = trace.regions(r"data\.batch")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
