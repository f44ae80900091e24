"""Rank 0's wait for the input queue (``data.wait``), ms a step over the
window's untraced steps."""

from benchmark.metrics import _spans


def read(run):
    return _spans.ms_per_step(run, "data.wait")
