"""Host milliseconds per train step inside the program's ``runner.draws`` regions: a step's random draws
(``make_step_draws``), or a fused dispatch's draws of its K steps."""


def read(trace):
    regions = trace.regions(r"runner\.draws")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
