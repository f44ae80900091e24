"""The share of the traced part of the webcam window in which no operation
ran on the card."""

from benchmark.metrics import _shared


def read(run):
    return None if run.trace is None else _shared.idle_percent(run)
