"""What the readers of the program's own spans share: the process's span
recorder (``hand3d_tpu_torch.utils.profiling``), the webcam requests joined
to their spans, an idle share named by a span, and a span's time a step.
Each returns None where the program records no such span, as a program
without the recorder does not."""

import bisect

import numpy as np

from hand3d_tpu_torch.utils import profiling


def spans():
    """The process's recorded spans, or None where the program has no span
    recorder."""
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def recorded(name):
    """Whether the process has recorded a span named ``name``."""
    totals = getattr(profiling, "span_totals", None)
    return totals is not None and name in totals()


def _ms(s):
    return (s.end_ns - s.start_ns) * 1e-6


def webcam_requests(run):
    """(client latency ms, {span name: ms}) of each answered request that
    ended before the traced part, joined by time, not by order: the one
    ``serve.request`` span that lies inside the client's [sent, done]
    (both clocks are CLOCK_MONOTONIC), then that request's spans by request
    id, each name's summed. A record with no such span, or more than one,
    is left out."""
    got = spans()
    if not got:
        return []
    cut = run.counters.get("traced_window", (np.inf,))[0]
    records = [r for r in run.counters["requests"]
               if r["status"] == 200 and r["done"] < cut]
    requests = sorted((s for s in got if s.name == "serve.request"),
                      key=lambda s: s.start_ns)
    starts = [s.start_ns / 1e9 for s in requests]  # as perf_counter
    parts = {}
    for s in got:
        if s.name != "serve.request":
            mine = parts.setdefault(s.request, {})
            mine[s.name] = mine.get(s.name, 0.0) + _ms(s)
    out = []
    for r in records:
        inside = []
        i = bisect.bisect_left(starts, r["sent"])
        while i < len(requests) and starts[i] <= r["done"]:
            if requests[i].end_ns / 1e9 <= r["done"]:
                inside.append(requests[i])
            i += 1
        if len(inside) == 1:
            req = inside[0]
            out.append(((r["done"] - r["sent"]) * 1e3,
                        dict(parts.get(req.id, {}),
                             **{"serve.request": _ms(req)})))
    return out


def webcam_median(run, needs, value):
    """The median over the joined requests that hold every span in
    ``needs`` of ``value(latency_ms, parts)``; None where none does."""
    vals = [value(lat, p) for lat, p in webcam_requests(run)
            if all(n in p for n in needs)]
    return float(np.median(vals)) if vals else None


def idle_share(run, name):
    """The % of the traced window in which the device was idle while the
    host's innermost event was the span ``name``."""
    if run.trace is None or not recorded(name):
        return None
    idle = sum(d for n, d in run.trace.gaps if n == name)
    return 100.0 * idle / run.trace.window_s


def ms_per_step(run, name):
    """The span ``name``'s mean ms over the window's untraced steps: the
    last ``steps - traced_steps`` spans of that name (set-up's steps come
    before the window, the traced steps first in it)."""
    got = spans()
    n = run.counters.get("steps", 0) - run.counters.get("traced_steps", 0)
    if not got or n <= 0:
        return None
    mine = [s for s in got if s.name == name][-n:]
    if len(mine) < n:
        return None
    return sum(_ms(s) for s in mine) / n
