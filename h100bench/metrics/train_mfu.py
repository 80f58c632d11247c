"""Percent of the card's bfloat16 peak in the traced epoch: every model's forward, weight and input gradients at
the configuration's widths and points per ray, times the steps, over the stretch's seconds."""

from h100bench.trace import mfu


def read(trace):
    return mfu(trace)
