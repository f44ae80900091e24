"""Rank 0's host time in the step function (``train.step``: forward,
backward, the all-reduce and Adam as the host issues them), ms a step over
the window's untraced steps."""

from benchmark.metrics import _spans


def read(run):
    return _spans.ms_per_step(run, "train.step")
