"""Percent of the card's bfloat16 peak in the traced frames: every model's forward at the configuration's widths
and evaluation points per ray, times the frame's rays and the frames, over the stretch's seconds."""

from h100bench.trace import mfu


def read(trace):
    return mfu(trace)
