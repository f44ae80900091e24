"""The whole webcam step's share of the f32 peak: 121.8 GFLOP a frame
times the frames the traced part served per second, over 67 TFLOP/s. It
bounds a claimed gain where a kernel leaves the path."""

from benchmark.flops import peaks
from benchmark.metrics import _shared


def read(run):
    if run.trace is None:
        return None
    rate = len(_shared.traced_requests(run)) / run.trace.window_s
    return 100.0 * _shared.frame_flops(run) * rate / peaks.PEAK_F32
