"""The share of the traced window in which no operation ran on a card, the
mean over the four ranks."""

from benchmark.metrics import _shared


def read(run):
    return None if run.trace is None else _shared.idle_percent(run)
