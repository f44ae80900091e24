"""PoseNet's f32 convolutions forward and backward on the data-parallel
path, as ``conv.roofline.train``: rank 0's traced steps over its conv
kernels' time."""

from benchmark.metrics import _shared


def read(run):
    return _shared.train_conv_share(run)
