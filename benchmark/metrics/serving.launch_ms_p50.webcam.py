"""The host issuing the cascade's kernels (``serving.launch``: the cascade,
the served outputs' selection), the median over the requests before the
traced part."""

from benchmark.metrics import _spans


def read(run):
    return _spans.webcam_median(run, ["serving.launch"],
                                lambda lat, p: p["serving.launch"])
