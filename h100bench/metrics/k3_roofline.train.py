"""Percent of its roofline the NeRF MLP's backward kernel reaches: the least time of the weight and input
gradients the stretch's steps need (no recomputed forward) over the backward launch's device time."""

from h100bench.trace import K3_NAMES, roofline_share


def read(trace):
    return roofline_share(trace, K3_NAMES, "k3")
