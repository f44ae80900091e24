"""The cascade's f32 convolutions against the f32 peak: their direct-conv
FLOPs over the frames of the traced window, over the conv kernels' traced
time at 67 TFLOP/s. cuDNN's FFT and Winograd kernels do fewer multiplies, so
the share is taken over the whole network only."""

from benchmark.metrics import _shared


def read(run):
    if run.trace is None:
        return None
    frames = run.counters["traced_frames"]
    _shared.print_unmatched(run)
    return _shared.conv_share(run, frames * _shared.frame_flops(run))
