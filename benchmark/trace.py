"""The device trace of a ``--trace 1`` run: torch.profiler over CPU and CUDA
for a steady part of the window, read back from its Chrome trace.

What it gives the per-layer readers (``Trace``): every device operation
(kernels, copies, memsets) with its interval, the busy time as the union of
those intervals, the traced window's length, the kernels by name, and each
idle gap of the device named by the host operation that was running at its
middle (the innermost profiled CPU op, runtime call or benchmark span).
"""

import contextlib
import heapq
import json
import os
import sys

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "benchmark.traced_window"
NAME_CHARS = 160  # a kernel's name is cut to this many characters


class Trace:
    """One rank's traced window, in seconds."""

    def __init__(self, events):
        window = [e for e in events if e.get("name") == WINDOW_SPAN]
        if not window:
            raise RuntimeError("the trace holds no traced-window span")
        t0 = float(window[0]["ts"])
        t1 = t0 + float(window[0]["dur"])
        self.window_s = (t1 - t0) * 1e-6
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b <= t0 or a >= t1:
                continue
            item = (max(a, t0), min(b, t1), e.get("name", ""), e.get("cat"))
            if e.get("cat") in DEVICE_CATS:
                dev.append(item)
            elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN:
                host.append(item)
        dev.sort()
        self.ops = [(a * 1e-6, b * 1e-6, name, cat) for a, b, name, cat in dev]
        self.kernels = [(name, (b - a)) for a, b, name, cat in self.ops
                        if cat == "kernel"]
        busy, gaps, cursor = 0.0, [], t0
        for a, b, _, _ in dev:
            if a > cursor:
                gaps.append((cursor, a))
            if b > cursor:
                busy += b - max(a, cursor)
                cursor = b
        if cursor < t1:
            gaps.append((cursor, t1))
        self.busy_s = busy * 1e-6
        names = _innermost(host, [(a + b) / 2 for a, b in gaps])
        self.gaps = [(name, (b - a) * 1e-6)
                     for name, (a, b) in zip(names, gaps)]

    def kernel_time(self, pattern=None):
        """Seconds of kernels whose name matches ``pattern`` (a compiled
        regex; all kernels without one)."""
        return sum(d for name, d in self.kernels
                   if pattern is None or pattern.search(name))

    def kernel_count(self):
        return len(self.kernels)

    def breakdown(self, top=10):
        by_op, by_gap = {}, {}
        for a, b, name, _ in self.ops:
            key = name[:NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + (b - a)
        for name, d in self.gaps:
            key = name[:NAME_CHARS]
            by_gap[key] = by_gap.get(key, 0.0) + d
        order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _innermost(host, times):
    """The name of the latest-started host event that holds each of the
    sorted ``times`` (the innermost, as a thread's events nest)."""
    host = sorted(host)
    heap, j, out = [], 0, []
    for t in times:
        while j < len(host) and host[j][0] <= t:
            a, b, name, _ = host[j]
            heapq.heappush(heap, (-a, b, name))
            j += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "host outside any profiled op (Python, numpy)")
    return out


@contextlib.contextmanager
def traced(path, on):
    """Profile the block when ``on``; yields a holder whose ``trace`` is the
    block's ``Trace`` afterwards (None when off). The Chrome trace goes to
    ``path`` and is deleted once read."""
    holder = type("Holder", (), {"trace": None})()
    if not on:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield holder
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    holder.trace = Trace(events)


def print_unmatched(trace, pattern, what, top=8):
    """Report on standard error the kernel time that ``pattern`` leaves out,
    so nothing is hidden by the classification."""
    rest = {}
    for name, d in trace.kernels:
        if not pattern.search(name):
            rest[name[:NAME_CHARS]] = rest.get(name[:NAME_CHARS], 0.0) + d
    total = sum(rest.values())
    print(f"{what}: {total:.6f} s of kernels match no pattern; the largest:",
          file=sys.stderr)
    for name, d in sorted(rest.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {d:.6f} s  {name}", file=sys.stderr)
