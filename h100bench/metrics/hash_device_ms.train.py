"""Device milliseconds per train step in the hash encoding's kernels: K4 (forward) and every kernel of K5 (the
tables' gradient)."""

NAMES = ("hash_encode_fwd_kernel", "hash_encode_bwd_zero_kernel", "hash_encode_bwd_max_kernel",
         "hash_encode_bwd_scatter_kernel", "hash_encode_bwd_convert_kernel")


def read(trace):
    kernels = trace.kernels(NAMES)
    if not kernels or not trace.units:
        return None
    return sum(e - s for _, s, e in kernels) * 1e-3 / trace.units
