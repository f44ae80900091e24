"""What several per-layer readers share: the traced window's frames and
steps, and shares of a peak. A reader returns None where its cell's trace
holds nothing for it to read."""

import numpy as np

from benchmark.flops import layers, peaks


def idle_percent(run):
    """The device's idle share of the traced window, the mean over ranks."""
    traces = run.rank_traces or [(run.trace.busy_s, run.trace.window_s)]
    busy = sum(b for b, _ in traces)
    window = sum(w for _, w in traces)
    return 100.0 * (1.0 - busy / window)


def traced_requests(run):
    """The predict spans of the webcam window that lie in its traced part."""
    a, b = run.counters["traced_window"]
    return [s for s in run.spans["predict"] if a <= 0.5 * (s[0] + s[1]) <= b]


def untraced_pairs(run):
    """(client latency ms, predict span ms) of each answered request before
    the traced part (the profiler slows the process after it too): the
    server runs one request at a time and there is one client, so the k-th
    answered request is the k-th predict span."""
    ok = [r for r in run.counters["requests"] if r["status"] == 200]
    spans = run.spans["predict"]
    if len(spans) != len(ok):
        return []
    a = run.counters.get("traced_window", (np.inf,))[0]
    return [((r["done"] - r["sent"]) * 1e3, (s[1] - s[0]) * 1e3)
            for r, s in zip(ok, spans) if s[1] < a]


def conv_share(run, flops):
    """``flops`` of direct convolution over the traced conv kernel time at
    the f32 peak, in percent; None where the trace names no conv kernel."""
    t = run.trace.kernel_time(peaks.CONV)
    if t <= 0:
        return None
    return 100.0 * flops / (t * peaks.PEAK_F32)


def frame_flops(run):
    return layers.frame_flops(tuple(run.params["input_hw"]))


def train_flops(run):
    return layers.posenet_train_flops(run.params["crop_size"])


def print_unmatched(run):
    """Report the kernel time the conv patterns leave out (standard error)."""
    from benchmark import trace

    trace.print_unmatched(run.trace, peaks.CONV, "conv classification")


def train_mfu(run):
    """The training step's share of the f32 peak over the traced window:
    PoseNet's forward and backward FLOPs a sample times the samples a second
    over all ranks, over 67 TFLOP/s times the cards."""
    if run.trace is None:
        return None
    samples = run.counters["traced_steps"] * run.params["batch_size"] * run.chips
    rate = samples / run.trace.window_s
    return 100.0 * train_flops(run) * rate / (peaks.PEAK_F32 * run.chips)


def train_conv_share(run):
    """PoseNet's convolutions forward and backward against the f32 peak, rank
    0's traced steps over its conv kernels' time."""
    if run.trace is None:
        return None
    steps = run.counters["traced_steps"]
    print_unmatched(run)
    return conv_share(run, steps * run.params["batch_size"] * train_flops(run))
