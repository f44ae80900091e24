"""What the HTTP server adds to a request (body read and .npy decode, the
hand-off to its device thread, JSON encode and send): each answered
request's client latency less the benchmark's span around the estimator's
predict, the median over the requests before the traced part."""

import numpy as np

from benchmark.metrics import _shared


def read(run):
    pairs = _shared.untraced_pairs(run)
    if not pairs:
        return None
    return float(np.median([lat - span for lat, span in pairs]))
