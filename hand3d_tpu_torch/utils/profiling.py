"""Profiling and timing helpers (counterpart of
hand3d_tpu/utils/profiling.py).

The reference had no profiling support (SURVEY.md section 5). Here:
  * ``trace(logdir)`` runs ``torch.profiler`` over a block and writes a
    Chrome trace (viewable in Perfetto or chrome://tracing; TensorBoard's
    profiler plugin reads the same file from ``logdir``);
  * ``StageTimer`` times callables with the device synchronized around each
    call: CUDA launches are asynchronous, so host timing without a
    synchronize measures the launch, not the work.
"""

import contextlib
import os
import socket
import time

import torch


@contextlib.contextmanager
def trace(logdir, activities=None):
    """Capture a trace of the block: ``with trace('/tmp/trace'): step()``.

    Records the CPU and, where CUDA is available, the CUDA activity, and
    writes ``<host>.<pid>.<ns>.pt.trace.json`` into ``logdir``. Yields the
    profiler, whose ``key_averages()`` summarize the block.
    """
    from torch.profiler import ProfilerActivity, profile

    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
        prof.export_chrome_trace(
            os.path.join(logdir, f"{name}.pt.trace.json"))


def _synchronize(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Times callables with the device synchronized around each call
    (``torch.cuda.synchronize`` of ``device``; a CPU device needs none).

    ``measure`` returns the median seconds per call and records it;
    ``report`` prints the stages, slowest first, with their shares.
    """

    def __init__(self, warmup=2, iters=5, device=None):
        self.warmup = warmup
        self.iters = iters
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.results = {}

    def measure(self, name, fn, *args, **kwargs):
        """Median seconds per call of ``fn(*args, **kwargs)``; recorded."""
        for _ in range(self.warmup):
            fn(*args, **kwargs)
        _synchronize(self.device)
        times = []
        for _ in range(self.iters):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            _synchronize(self.device)
            times.append(time.perf_counter() - t0)
        times.sort()
        median = times[len(times) // 2]
        self.results[name] = median
        return median

    def report(self, log=print):
        total = sum(self.results.values())
        for name, t in sorted(self.results.items(), key=lambda kv: -kv[1]):
            log(f"{name:32s} {t * 1e3:8.2f} ms  {t / total * 100:5.1f}%")
        log(f"{'total':32s} {total * 1e3:8.2f} ms")
