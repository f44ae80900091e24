"""The share of the traced window in which the device was idle while the
host's innermost event was the span ``serving.fetch`` (the outputs' copies
out and their concatenation)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.idle_share(run, "serving.fetch")
