"""The estimator's predict (host normalize, the copy in, the cascade, the
copies out), timed by the benchmark's span around the predict it hands to
make_server: the median over the requests before the traced part."""

import numpy as np

from benchmark.metrics import _shared


def read(run):
    pairs = _shared.untraced_pairs(run)
    if not pairs:
        return None
    return float(np.median([span for _, span in pairs]))
