"""The hand-written keypoint decode (csrc/decode.cu) against its bound: for
each frame of the traced part, the larger of its f32 operations (6 a source
value and upsampled offset) at 67 TFLOP/s and its bytes (the 32x32x21
scoremap read once, the (row, col) pairs written once) at 3.35 TB/s, over
the kernel's traced time."""

from benchmark.flops import layers, peaks
from benchmark.metrics import _shared


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_time(peaks.DECODE)
    frames = len(_shared.traced_requests(run))
    if t <= 0 or not frames:
        return None
    ops, nbytes = layers.decode_cost(run.params["batch_size"])
    bound = max(ops / peaks.PEAK_F32, nbytes / peaks.PEAK_HBM)
    return 100.0 * bound * frames / t
