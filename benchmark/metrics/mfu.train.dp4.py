"""The data-parallel training step's share of the f32 peak, as
``mfu.train``: the samples of all four ranks over 67 TFLOP/s times four."""

from benchmark.metrics import _shared


def read(run):
    return _shared.train_mfu(run)
