"""Percent of the traced stretch in which no device operation runs: one minus the union of the kernels', copies'
and fills' intervals over the stretch."""

from h100bench.trace import idle_percent


def read(trace):
    return idle_percent(trace)
