"""Percent of its roofline the hash encoding's forward kernel (K4) reaches: the least time of the bytes the stretch's
steps must move through it (points in, features out, every table read once; counts/hash_grid.py) over K4's device
time."""

from h100bench.trace import roofline_share

K4_NAMES = ("hash_encode_fwd_kernel",)


def read(trace):
    return roofline_share(trace, K4_NAMES, "hash_fwd")
