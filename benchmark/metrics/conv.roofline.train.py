"""PoseNet's f32 convolutions forward and backward against the f32 peak:
the forward, input-gradient and weight-gradient FLOPs of the traced steps
(less the first layer's input gradient), over the conv kernels' traced time
at 67 TFLOP/s. None where the trace names no conv kernel, as a replayed
CUDA graph's may not."""

from benchmark.metrics import _shared


def read(run):
    return _shared.train_conv_share(run)
