"""The % of rank 0's replays of the data-parallel step's CUDA graph that
were launched while the previous replay was still running on the card:
100 x the counter ``train.step_graph.in_flight`` over
``train.step_graph.replays``, both since the process began (set-up's steps
included). A program without the counter reads nothing."""

from hand3d_tpu_torch.utils import profiling


def read(run):
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    got = counters()
    in_flight = got.get("train.step_graph.in_flight")
    replays = got.get("train.step_graph.replays")
    if in_flight is None or not replays:
        return None
    return 100.0 * in_flight / replays
