"""The hand-written flood fill (csrc/floodfill.cu) against its bound: for
each frame of the traced part, the larger of its int32 operations (43.125 a
32-pixel word and pass, over the passes that frame's mask needs, plus 2 a
pixel) at the int32 peak and its bytes (the map read once, the mask written
once) at 3.35 TB/s, summed, over the kernel's traced time."""

from benchmark.flops import layers, peaks


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_time(peaks.FLOOD_FILL)
    passes = run.counters.get("traced_flood_passes")
    if t <= 0 or passes is None or not len(passes):
        return None
    h, w = run.params["input_hw"]
    bound = 0.0
    for p in passes:
        ops, nbytes = layers.flood_cost(h, w, int(p))
        bound += max(ops / peaks.PEAK_INT32, nbytes / peaks.PEAK_HBM)
    return 100.0 * bound / t
