"""The host waiting on the device's remaining work, then the copies out
(``serving.fetch``), the median over the requests before the traced
part."""

from benchmark.metrics import _spans


def read(run):
    return _spans.webcam_median(run, ["serving.fetch"],
                                lambda lat, p: p["serving.fetch"])
