"""The share of the traced window in which the device was idle while the
host's innermost event was the span ``serving.normalize`` (uint8 frames to
mean-subtracted float32 in numpy)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.idle_share(run, "serving.normalize")
