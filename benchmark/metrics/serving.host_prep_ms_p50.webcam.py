"""The host's preparation of a frame inside the predict: ``serving.normalize``
plus ``serving.h2d`` (the copy in), the median over the requests before the
traced part."""

from benchmark.metrics import _spans


def read(run):
    return _spans.webcam_median(
        run, ["serving.normalize", "serving.h2d"],
        lambda lat, p: p["serving.normalize"] + p["serving.h2d"])
