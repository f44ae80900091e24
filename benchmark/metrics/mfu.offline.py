"""The whole offline step's share of the f32 peak: the cascade's conv
FLOPs a frame (121.8 GFLOP at 240x320) times the traced window's frames per
second, over 67 TFLOP/s."""

from benchmark.flops import peaks
from benchmark.metrics import _shared


def read(run):
    if run.trace is None:
        return None
    rate = run.counters["traced_frames"] / run.trace.window_s
    return 100.0 * _shared.frame_flops(run) * rate / peaks.PEAK_F32
