"""What a request costs outside the server's handler: the client latency
less the ``serve.request`` span (TCP connect and accept, the thread spawned
a connection, the header parse and the close), the median over the requests
before the traced part."""

from benchmark.metrics import _spans


def read(run):
    return _spans.webcam_median(run, ["serve.request"],
                                lambda lat, p: lat - p["serve.request"])
