"""The readers of the program's spans (``metrics/_spans.py`` and the ten
metrics on it) on synthetic runs whose spans, client records and idle gaps
are known."""

import pytest

from benchmark import harness
from hand3d_tpu_torch.utils import profiling

S = 10**9  # ns a second
T = 1000 * S  # the clock's reading at the synthetic runs' start


class FakeTrace:
    def __init__(self, gaps, window_s):
        self.gaps = gaps
        self.window_s = window_s


class FakeRun:
    def __init__(self, counters=None, trace=None):
        self.counters = counters or {}
        self.trace = trace


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def read(name, run):
    return harness.load_reader(name).read(run)


def ms(x):
    return int(round(x * 1e6))


def add_request(rec, rid, start_ms, parts):
    """A ``serve.request`` span starting at ``start_ms`` (ms after T) with
    children laid end to end: ``parts`` is [(name, ms)]; returns its end."""
    t = T + ms(start_ms)
    kids = []
    for i, (name, d) in enumerate(parts):
        kids.append((name, t, t + ms(d), rid * 100 + i + 1, rid, rid))
        t += ms(d)
    rec.add(("serve.request", T + ms(start_ms), t, rid, None, rid))
    for k in kids:
        rec.add(k)
    return (t - T) / 1e6


PARTS_A = [("serve.read", 1.0), ("serve.handoff", 0.5),
           ("serving.normalize", 0.25), ("serving.h2d", 0.5),
           ("serving.launch", 7.0), ("serving.fetch", 2.0),
           ("serve.predict", 0.0), ("serve.reply", 1.0)]
PARTS_B = [("serve.read", 2.0), ("serve.handoff", 0.5),
           ("serving.normalize", 0.75), ("serving.h2d", 0.5),
           ("serving.launch", 9.0), ("serving.fetch", 4.0),
           ("serve.predict", 0.0), ("serve.reply", 1.0)]


def webcam_run(rec):
    """Requests A and B answered before the traced part; a warm-up request
    whose span overlaps A's client record; a failed record; a record in the
    traced part. serve.predict's length is set to the serving spans' sum
    plus 0.5 ms."""
    def with_predict(parts):
        inner = sum(d for n, d in parts if n.startswith("serving."))
        return [(n, inner + 0.5 if n == "serve.predict" else d)
                for n, d in parts]

    warm_end = add_request(rec, 1, 0.0, with_predict(PARTS_A))
    a_start = warm_end + 1.0
    a_end = add_request(rec, 2, a_start, with_predict(PARTS_A))
    b_end = add_request(rec, 3, 100.0, with_predict(PARTS_B))
    late_end = add_request(rec, 4, 300.0, with_predict(PARTS_B))
    records = [
        # sent while the warm-up request was still open: its span starts
        # before `sent`, so it is not this record's
        {"sent": (T + ms(warm_end - 3.0)) / S,
         "done": (T + ms(a_end + 2.0)) / S, "status": 200},
        {"sent": (T + ms(99.0)) / S, "done": (T + ms(b_end + 3.0)) / S,
         "status": 200},
        {"sent": (T + ms(200.0)) / S, "done": (T + ms(210.0)) / S,
         "status": 0},
        {"sent": (T + ms(299.0)) / S, "done": (T + ms(late_end + 1.0)) / S,
         "status": 200},
    ]
    run = FakeRun({"requests": records,
                   "traced_window": ((T + ms(250.0)) / S, (T + ms(400)) / S)})
    a_lat = (records[0]["done"] - records[0]["sent"]) * 1e3
    b_lat = (records[1]["done"] - records[1]["sent"]) * 1e3
    a_req = a_end - a_start
    b_req = b_end - 100.0
    return run, (a_lat, a_req), (b_lat, b_req)


def test_webcam_readers_join_requests_by_time(recorder):
    run, (a_lat, a_req), (b_lat, b_req) = webcam_run(recorder)
    from benchmark.metrics import _spans

    joined = _spans.webcam_requests(run)
    assert [round(p["serve.request"], 6) for _, p in joined] == [
        round(a_req, 6), round(b_req, 6)]

    def mid(a, b):
        return 0.5 * (a + b)

    def pred(parts):
        return sum(d for n, d in parts if n.startswith("serving.")) + 0.5

    want = {
        "serve.connection_ms_p50.webcam": mid(a_lat - a_req, b_lat - b_req),
        "serve.handler_ms_p50.webcam": mid(a_req - pred(PARTS_A),
                                           b_req - pred(PARTS_B)),
        "serving.host_prep_ms_p50.webcam": mid(0.75, 1.25),
        "serving.launch_ms_p50.webcam": mid(7.0, 9.0),
        "serving.fetch_ms_p50.webcam": mid(2.0, 4.0),
    }
    for name, value in want.items():
        assert read(name, run) == pytest.approx(value, abs=1e-6), name
    # the five add up to the client latency (predict's 0.5 ms outside the
    # serving spans aside)
    total = sum(want.values()) + 0.5
    assert total == pytest.approx(mid(a_lat, b_lat), abs=1e-6)


def test_webcam_join_leaves_out_a_record_holding_two_requests(recorder):
    add_request(recorder, 1, 0.0, PARTS_A)
    end = add_request(recorder, 2, 20.0, PARTS_A)
    run = FakeRun({"requests": [{"sent": T / S, "done": (T + ms(end)) / S,
                                 "status": 200}]})
    assert read("serving.launch_ms_p50.webcam", run) is None


OFFLINE = ["device.idle_normalize.offline", "device.idle_fetch.offline"]


def test_offline_idle_shares_read_the_named_gaps(recorder):
    for name in ("serving.normalize", "serving.fetch"):
        profiling.record(name, 0, 1)
    trace = FakeTrace([("serving.normalize", 0.4), ("serving.fetch", 0.1),
                       ("aten::copy_", 0.3), ("serving.normalize", 0.2)],
                      4.0)
    run = FakeRun(trace=trace)
    assert read(OFFLINE[0], run) == pytest.approx(15.0)
    assert read(OFFLINE[1], run) == pytest.approx(2.5)
    assert all(read(n, FakeRun()) is None for n in OFFLINE)


DP4 = {"data.wait_ms_per_step.dp4": "data.wait",
       "data.preprocess_ms_per_step.dp4": "data.preprocess",
       "train.step_host_ms_per_step.dp4": "train.step"}


def test_dp4_readers_take_the_untraced_steps(recorder):
    # 3 set-up steps, then a window of 10 whose first 4 are traced; each
    # name's span of step i lasts (i + 1) ms times its factor
    factor = {"data.wait": 1, "data.preprocess": 2, "train.step": 10}
    for i in range(3 + 10):
        for span, f in factor.items():
            profiling.record(span, T, T + ms((i + 1) * f))
    run = FakeRun({"steps": 10, "traced_steps": 4})
    untraced = range(3 + 4, 3 + 10)
    for metric, span in DP4.items():
        want = sum((i + 1) * factor[span] for i in untraced) / len(untraced)
        assert read(metric, run) == pytest.approx(want), metric
    run = FakeRun({"steps": 4, "traced_steps": 4})
    assert all(read(m, run) is None for m in DP4)


def test_readers_find_nothing_in_a_program_without_the_recorder(
        recorder, monkeypatch):
    run, _, _ = webcam_run(recorder)
    profiling.record("serving.normalize", 0, 1)
    for attr in ("spans", "span_totals"):
        monkeypatch.delattr(profiling, attr)
    run.trace = FakeTrace([("serving.normalize", 1.0)], 4.0)
    run.counters.update(steps=10, traced_steps=4)
    names = [m for m in (
        "serve.connection_ms_p50.webcam", "serve.handler_ms_p50.webcam",
        "serving.host_prep_ms_p50.webcam", "serving.launch_ms_p50.webcam",
        "serving.fetch_ms_p50.webcam", *OFFLINE, *DP4)]
    assert len(names) == 10
    assert all(read(n, run) is None for n in names)
