"""Host milliseconds per train step inside the program's ``model.hash_encode`` regions: the hash grid's encoding
call in each model's forward (the backward's K5 is launched from autograd's thread, outside them)."""


def read(trace):
    regions = trace.regions(r"model\.hash_encode")
    if not regions or not trace.units:
        return None
    return sum(e - s for _, s, e in regions) * 1e-3 / trace.units
