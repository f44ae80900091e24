"""The webcam client's tail: the 95th percentile of the client latency, send
to full JSON reply, over every request of the window that ended before the
traced part (the profiler slows the process from there on). A request that
was never answered counts as infinite, as in ``latency_p50_ms``."""

import numpy as np


def read(run):
    a = run.counters.get("traced_window", (np.inf,))[0]
    lat = [(r["done"] - r["sent"]) * 1e3 if r["status"] == 200 else np.inf
           for r in run.counters["requests"] if r["done"] < a]
    if not lat:
        return None
    return float(np.percentile(lat, 95, method="higher"))
