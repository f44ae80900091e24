"""The reader of ``train.step_graph_share.dp4`` on synthetic recorders whose
``train.step`` spans and graph counters are known."""

import pytest

from benchmark import harness
from hand3d_tpu_torch.utils import profiling

T = 1000 * 10**9  # ns: the clock's reading at the synthetic runs' start
STEP = 10**6  # ns: each synthetic step's length
NAME = "train.step_graph_share.dp4"


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


def test_step_graph_share_reads_replays_over_steps(recorder):
    # 8 steps since the process began, 6 of them replays of the graph
    for _ in range(8):
        profiling.record("train.step", T, T + STEP)
    assert read() is None  # no such counter
    profiling.count("train.step_graph.replays", 6)
    profiling.count("train.step_graph.eager", 2)
    assert read() == pytest.approx(75.0)


def test_step_graph_share_finds_nothing_without_steps_or_counters(
        recorder, monkeypatch):
    profiling.count("train.step_graph.replays", 1)
    assert read() is None  # no train.step span
    profiling.record("train.step", T, T + STEP)
    assert read() == pytest.approx(100.0)
    monkeypatch.delattr(profiling, "counters")
    assert read() is None
