"""Device kernels per train step in the traced stretch, the kernels of CUDA graph replays included."""


def read(trace):
    kernels = trace.kernels()
    return len(kernels) / trace.units if kernels and trace.units else None
