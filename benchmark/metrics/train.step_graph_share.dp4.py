"""The % of rank 0's data-parallel steps that replayed the captured CUDA
graph: 100 x the counter ``train.step_graph.replays`` over the count of
``train.step`` spans, both since the process began (set-up's steps
included)."""

from hand3d_tpu_torch.utils import profiling


def read(run):
    counters = getattr(profiling, "counters", None)
    totals = getattr(profiling, "span_totals", None)
    if counters is None or totals is None:
        return None
    replays = counters().get("train.step_graph.replays")
    steps = totals().get("train.step", (0, 0))[0]
    if replays is None or not steps:
        return None
    return 100.0 * replays / steps
