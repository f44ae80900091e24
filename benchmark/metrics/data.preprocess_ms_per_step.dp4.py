"""Rank 0's ``data.preprocess`` span, ms a step over the window's untraced
steps: the batch's copy to the device and ``InputPipeline._emit``.
``train_posenet`` fuses the crop preprocess into the loss (the pipeline
yields raw records), so on this path the span is the raw batch's copy in
alone; the crop preprocess's ops run inside ``train.step``."""

from benchmark.metrics import _spans


def read(run):
    return _spans.ms_per_step(run, "data.preprocess")
