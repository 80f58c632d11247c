"""Device kernels per frame in the traced stretch."""


def read(trace):
    kernels = trace.kernels()
    return len(kernels) / trace.units if kernels and trace.units else None
