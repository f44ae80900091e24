"""Profiling and timing helpers (counterpart of
hand3d_tpu/utils/profiling.py).

The reference had no profiling support (SURVEY.md section 5). Here:
  * ``trace(logdir)`` runs ``torch.profiler`` over a block, on every thread
    of the process, and writes a Chrome trace (viewable in Perfetto or
    chrome://tracing; TensorBoard's profiler plugin reads the same file from
    ``logdir``);
  * ``StageTimer`` times callables with the device synchronized around each
    call: CUDA launches are asynchronous, so host timing without a
    synchronize measures the launch, not the work;
  * the span recorder, always on: ``span(name)`` times a block where the
    work happens, ``record(name, start_ns, end_ns)`` a span whose ends were
    taken apart (a queue wait), ``count(name, n)`` counts; ``spans()``,
    ``span_totals()`` and ``counters()`` read them back. ``cli.serve``'s
    ``GET /metrics`` exports the totals and counters; the benchmark's
    per-layer readers read the spans.

A span records its name, its start and end on ``time.perf_counter_ns``
(CLOCK_MONOTONIC on Linux, so spans of two processes of one host share a
clock), its own id, the id of the span open around it and a request id.
Both come from the context (``contextvars``): the span open around it on
this thread, or in the context handed over with the work, as
``cli.serve`` hands a request to its device thread. The request id is the
id of the outermost span of that context, its own where none is open.
While this thread is being profiled (or every thread is, under ``trace``),
a span also opens ``torch.profiler.record_function(name)``, so that it
lands in the trace on the trace's own clock; otherwise it costs a few
microseconds and no profiler call.
"""

import collections
import contextlib
import contextvars
import itertools
import os
import socket
import threading
import time
from typing import NamedTuple, Optional

import torch

# spans the ring keeps: a 51 s run of the webcam benchmark cell serves about
# 3,600 requests of 9 spans each, about half of it
SPAN_RING = 1 << 16


@contextlib.contextmanager
def trace(logdir, activities=None):
    """Capture a trace of the block: ``with trace('/tmp/trace'): step()``.

    Records the CPU and, where CUDA is available, the CUDA activity, of
    every thread of the process (a server's handler and device threads and
    their spans too), and writes ``<host>.<pid>.<ns>.pt.trace.json`` into
    ``logdir``. Yields the profiler, whose ``key_averages()`` summarize the
    block.
    """
    from torch.profiler import ProfilerActivity, profile

    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    from torch._C._profiler import _ExperimentalConfig

    prof = profile(activities=activities, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))
    global _tracing
    prof.start()
    with RECORDER._lock:
        _tracing += 1
    try:
        yield prof
    finally:
        with RECORDER._lock:
            _tracing -= 1
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


class SpanRecord(NamedTuple):
    """One recorded span; times in ``time.perf_counter_ns`` nanoseconds."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the span open around it in its context
    request: int  # the outermost span's id in its context


class Recorder:
    """The latest ``SPAN_RING`` spans in a ring, and for every span name the
    exact count and sum of all its spans since the recorder was made, and
    the counters. Thread-safe."""

    def __init__(self):
        self._ring = collections.deque(maxlen=SPAN_RING)
        self._totals = {}  # name -> [count, sum of ns]
        self._counters = {}
        self._lock = threading.Lock()

    def add(self, rec):
        """Keep ``rec``, a tuple in ``SpanRecord``'s order."""
        with self._lock:
            self._ring.append(rec)
            t = self._totals.get(rec[0])
            if t is None:
                t = self._totals[rec[0]] = [0, 0]
            t[0] += 1
            t[1] += rec[2] - rec[1]

    def count(self, name, n=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self):
        with self._lock:
            ring = list(self._ring)
        return [SpanRecord._make(r) for r in ring]

    def span_totals(self):
        with self._lock:
            return {k: (c, ns) for k, (c, ns) in self._totals.items()}

    def counters(self):
        with self._lock:
            return dict(self._counters)


# the process's recorder, which span / record / count write and the readers
# read
RECORDER = Recorder()
_tracing = 0  # how many ``trace`` blocks are open; changed under RECORDER._lock
_ids = itertools.count(1)  # next() of a count is atomic under the GIL
_open = contextvars.ContextVar("hand3d_open_span", default=None)


def _context(own_id):
    """(parent, request) of a span with id ``own_id`` opened now."""
    cur = _open.get()
    return (None, own_id) if cur is None else cur


def _profiled():
    return (torch._C._autograd._profiler_enabled()
            or _tracing > 0)


class span:
    """``with span("serving.h2d"): ...`` records the block as a span (see
    the module docstring); ``start_ns`` and ``end_ns`` are set on the object
    the block gets."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request",
                 "_token", "_annotation")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.id = next(_ids)
        self.parent, self.request = _context(self.id)
        self._token = _open.set((self.id, self.request))
        self._annotation = None
        if _profiled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _open.reset(self._token)
        RECORDER.add((self.name, self.start_ns, self.end_ns, self.id,
                      self.parent, self.request))
        return False


def record(name, start_ns, end_ns):
    """Record a span whose ends were taken apart (``time.perf_counter_ns``),
    as a child of the span open in this context."""
    own = next(_ids)
    parent, request = _context(own)
    RECORDER.add((name, start_ns, end_ns, own, parent, request))


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    RECORDER.count(name, n)


def spans():
    """The process's latest spans (at most ``SPAN_RING``), oldest first."""
    return RECORDER.spans()


def span_totals():
    """{name: (count, nanoseconds)} of every span the process recorded."""
    return RECORDER.span_totals()


def counters():
    """{name: count} of the process's counters."""
    return RECORDER.counters()
