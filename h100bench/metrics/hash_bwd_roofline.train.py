"""Percent of its roofline the hash encoding's backward (K5) reaches: the least time of the bytes the stretch's steps
must move through it (points and cotangents in, every table's gradient written once; counts/hash_grid.py) over the
device time of all of K5's kernels."""

from h100bench.trace import roofline_share

K5_NAMES = ("hash_encode_bwd_zero_kernel", "hash_encode_bwd_max_kernel", "hash_encode_bwd_scatter_kernel",
            "hash_encode_bwd_convert_kernel")


def read(trace):
    return roofline_share(trace, K5_NAMES, "hash_bwd")
