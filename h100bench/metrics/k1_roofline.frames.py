"""Percent of its roofline the NeRF MLP's forward kernel reaches: the least time of the forward launches the
stretch needs (frozen counts at the points the inputs need) over the forward kernel's device time."""

from h100bench.trace import K1_NAMES, roofline_share


def read(trace):
    return roofline_share(trace, K1_NAMES, "k1")
