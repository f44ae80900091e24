"""The reader of ``train.step_in_flight_share.dp4`` on synthetic recorders
whose graph counters are known."""

import pytest

from benchmark import harness
from hand3d_tpu_torch.utils import profiling

NAME = "train.step_in_flight_share.dp4"


class FakeRun:
    counters = {}
    trace = None


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def read(run=None):
    return harness.load_reader(NAME).read(run or FakeRun())


def test_in_flight_share_reads_in_flight_over_replays(recorder):
    profiling.count("train.step_graph.replays", 40)
    assert read() is None  # a program without the counter
    profiling.count("train.step_graph.in_flight", 0)
    assert read() == pytest.approx(0.0)  # counted, none in flight
    profiling.count("train.step_graph.in_flight", 36)
    profiling.count("train.step_graph.eager", 5)  # not in the share
    assert read() == pytest.approx(90.0)


def test_in_flight_share_finds_nothing_without_replays_or_counters(
        recorder, monkeypatch):
    profiling.count("train.step_graph.in_flight", 0)
    assert read() is None  # no replay
    profiling.count("train.step_graph.replays", 1)
    assert read() == pytest.approx(0.0)
    monkeypatch.delattr(profiling, "counters")
    assert read() is None
