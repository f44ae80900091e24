"""Kernels the card ran in the traced part of the webcam window, per frame
served there: the launches the host pays for each frame."""

from benchmark.metrics import _shared


def read(run):
    if run.trace is None:
        return None
    frames = len(_shared.traced_requests(run))
    if not frames:
        return None
    return run.trace.kernel_count() / frames
