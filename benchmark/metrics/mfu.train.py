"""The whole training step's share of the f32 peak: PoseNet's forward and
backward FLOPs a sample (180.7 GFLOP at 256x256) times the traced window's
samples per second over all ranks, over 67 TFLOP/s times the cards."""

from benchmark.metrics import _shared


def read(run):
    return _shared.train_mfu(run)
