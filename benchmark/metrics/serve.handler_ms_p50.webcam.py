"""The server's handler less the predict: ``serve.request`` less
``serve.predict`` (body read and .npy decode, the hand-off to the device
thread, JSON encode and write), the median over the requests before the
traced part."""

from benchmark.metrics import _spans


def read(run):
    return _spans.webcam_median(
        run, ["serve.request", "serve.predict"],
        lambda lat, p: p["serve.request"] - p["serve.predict"])
