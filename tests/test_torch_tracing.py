"""The port's span recorder (hand3d_tpu_torch.utils.profiling) on the CPU:
nesting, request ids across the server's device-thread hand-off, the ring's
bound, counters under threads, the profiler annotations, and the spans that
serving and the dynamic batcher record.

This file imports no jax.
"""

import http.client
import io
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hand3d_tpu_torch import serving, weights
from hand3d_tpu_torch.cli import serve, train_posenet
from hand3d_tpu_torch.data import synthetic
from hand3d_tpu_torch.train import trainer
from hand3d_tpu_torch.utils import profiling

from torch_tmp import tmp_path  # noqa: F401

HW = (48, 64)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh process recorder for the test."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


@pytest.fixture(scope="module")
def params():
    return weights.random_params(3)


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parent_and_request_ids(recorder):
    with profiling.span("outer") as outer:
        with profiling.span("middle") as middle:
            with profiling.span("inner"):
                pass
            profiling.record("waited", 5, 9)
        with profiling.span("sibling"):
            pass
    with profiling.span("next"):
        pass
    s = by_name(profiling.spans())
    assert [x.name for x in profiling.spans()] == [
        "inner", "waited", "middle", "sibling", "outer", "next"]
    o, m = s["outer"][0], s["middle"][0]
    assert (o.id, o.parent, o.request) == (outer.id, None, outer.id)
    assert (m.id, m.parent, m.request) == (middle.id, o.id, o.id)
    assert s["inner"][0].parent == m.id
    assert (s["waited"][0].start_ns, s["waited"][0].end_ns) == (5, 9)
    assert s["waited"][0].parent == m.id
    assert s["sibling"][0].parent == o.id
    assert {x.request for n in ("inner", "waited", "sibling")
            for x in s[n]} == {o.id}
    nxt = s["next"][0]
    assert nxt.parent is None and nxt.request == nxt.id != o.id
    assert o.start_ns <= m.start_ns <= m.end_ns <= o.end_ns
    assert (outer.start_ns, outer.end_ns) == (o.start_ns, o.end_ns)


def test_a_span_records_when_its_block_raises(recorder):
    with pytest.raises(KeyError):
        with profiling.span("failing"):
            raise KeyError("x")
    with profiling.span("after"):
        pass
    failing, after = profiling.spans()
    assert failing.name == "failing" and after.parent is None


def test_ring_keeps_the_latest_and_exact_totals_after_it_wraps(recorder):
    n = profiling.SPAN_RING + 7
    for i in range(n):
        profiling.record("even" if i % 2 == 0 else "odd", 0, i)
    kept = profiling.spans()
    assert [s.end_ns for s in kept] == list(range(7, n))
    evens = range(0, n, 2)
    odds = range(1, n, 2)
    assert profiling.span_totals() == {"even": (len(evens), sum(evens)),
                                       "odd": (len(odds), sum(odds))}
    assert profiling.SPAN_RING >= 3_600 * 9


def test_counters_and_totals_exact_under_eight_threads(recorder):
    per_thread, workers = 2000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(per_thread):
                profiling.count("hits")
                profiling.count("weighted", i)
                profiling.record("tick", 0, 1)
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counters() == {
        "hits": per_thread * workers,
        "weighted": per_thread * sum(range(workers))}
    assert profiling.span_totals() == {"tick": (per_thread * workers,
                                                per_thread * workers)}
    ids = [s.id for s in profiling.spans()]
    assert len(set(ids)) == len(ids) == per_thread * workers


def test_spans_are_annotations_under_the_profiler_only(recorder,
                                                       monkeypatch, tmp_path):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.span("quiet.outer"):
        with profiling.span("quiet.inner"):
            torch.ones(4).sum()
    assert entered == []
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("loud.outer"):
            with profiling.span("loud.inner"):
                torch.ones(4).sum()
    assert entered == ["loud.outer", "loud.inner"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert {"loud.outer", "loud.inner"} <= set(notes)
    outer, inner = notes["loud.outer"], notes["loud.inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert len(profiling.spans()) == 4


def test_trace_holds_spans_of_other_threads(recorder, tmp_path):
    """``utils.profiling.trace`` profiles every thread, and a span on a
    thread the profiler did not start is in its trace."""
    def work():
        with profiling.span("worker.span"):
            torch.ones(4).sum()

    with profiling.trace(str(tmp_path / "t")):
        t = threading.Thread(target=work)
        t.start()
        t.join(30)
    assert not t.is_alive()
    (path,) = (tmp_path / "t").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "worker.span" for e in events)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/predict", body=body,
                     headers={"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _value(text, prefix):
    """The number on the line of ``text`` that starts with ``prefix``."""
    (line,) = [x for x in text.splitlines() if x.startswith(prefix)]
    return float(line[len(prefix):])


def _wait_for(name, n, timeout=30.0):
    """The recorder's spans once ``n`` of ``name`` are in it (the handler
    thread closes its request span after the reply is sent)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        spans = profiling.spans()
        if sum(s.name == name for s in spans) >= n:
            return spans
        time.sleep(0.01)
    raise AssertionError(f"fewer than {n} {name} spans after {timeout} s")


@pytest.mark.parametrize("serialize", [True, False])
def test_request_id_crosses_the_device_thread_handoff(recorder, serialize):
    threads = {}

    def predict(images):
        threads["predict"] = threading.current_thread().name
        with profiling.span("test.device_work"):
            n = len(images)
            return {"keypoint_uv21": np.zeros((n, 21, 2)),
                    "keypoint_coord3d": np.zeros((n, 21, 3)),
                    "center": np.zeros((n, 2)),
                    "scale_crop": np.ones((n, 1))}

    srv = serve.make_server(predict, {}, port=0, serialize=serialize)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.save(buf, np.zeros((2, 4, 4, 3), np.uint8))
        for _ in range(2):
            status, _ = _post(port, buf.getvalue())
            assert status == 200
        spans = _wait_for("serve.request", 2)
        total = sum(r.end_ns - r.start_ns for r in spans
                    if r.name == "serve.request") * 1e-9
        # the handler adds its request's seconds once its span has closed
        deadline = time.monotonic() + 30
        while True:
            status, text = _get(port, "/metrics")
            got = _value(text, "hand3d_request_seconds_sum ")
            if abs(got - total) < 2e-6 or time.monotonic() > deadline:
                break
            time.sleep(0.01)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)
    assert status == 200
    assert (threads["predict"].startswith("device")) == serialize
    s = by_name(spans)
    requests = s["serve.request"]
    assert len({r.request for r in requests}) == 2
    for req in requests:
        assert req.parent is None and req.request == req.id
        mine = [x for x in spans if x.request == req.id and x is not req]
        names = sorted(x.name for x in mine)
        want = ["serve.predict", "serve.read", "serve.reply",
                "test.device_work"]
        assert names == sorted(want + (["serve.handoff"] if serialize
                                       else []))
        got = {x.name: x for x in mine}
        for name in ("serve.read", "serve.predict", "serve.reply",
                     "serve.handoff"):
            if name in got:
                assert got[name].parent == req.id, name
                assert req.start_ns <= got[name].start_ns
                assert got[name].end_ns <= req.end_ns
        assert got["test.device_work"].parent == got["serve.predict"].id
        if serialize:
            assert (got["serve.handoff"].end_ns
                    <= got["serve.predict"].start_ns)
    assert "hand3d_requests_total 2\n" in text
    assert "hand3d_images_total 4\n" in text
    assert 'hand3d_span_seconds_count{span="serve.request"} 2\n' in text
    assert _value(text, "hand3d_request_seconds_sum ") == pytest.approx(
        total, abs=2e-6)
    assert _value(text, 'hand3d_span_seconds_sum{span="serve.request"} ') \
        == pytest.approx(total, abs=2e-6)


def test_predict_is_covered_by_its_serving_spans(recorder, params):
    est = serving.HandPoseEstimator(params, batch_size=2, input_hw=HW,
                                    device="cpu").warmup()
    images = np.random.default_rng(0).integers(0, 256, (3, *HW, 3),
                                               dtype=np.uint8)
    with profiling.span("test.call") as call:
        est.predict(images)
    spans = [s for s in profiling.spans() if s.request == call.id]
    s = by_name(spans)
    assert sorted(s) == ["serving.fetch", "serving.h2d", "serving.launch",
                         "serving.normalize", "test.call"]
    assert (len(s["serving.h2d"]), len(s["serving.launch"])) == (2, 2)
    children = [x for x in spans if x.parent == call.id]
    assert all(c.name.startswith("serving.") for c in children)
    covered = sum(c.end_ns - c.start_ns for c in children)
    assert covered >= 0.9 * (call.end_ns - call.start_ns)


def test_batcher_records_each_requests_queue_wait(recorder, params):
    est = serving.HandPoseEstimator(params, batch_size=4, input_hw=HW,
                                    device="cpu").warmup()
    batcher = serving.DynamicBatcher(est, max_batch=4, max_wait_ms=200)
    images = np.random.default_rng(1).integers(0, 256, (4, *HW, 3),
                                               dtype=np.uint8)
    calls = {}

    def client(i):
        with profiling.span("test.client") as c:
            batcher.predict(images[i:i + 1])
        calls[i] = c.id

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    waits = [s for s in profiling.spans() if s.name == "batcher.queue_wait"]
    assert sorted(w.request for w in waits) == sorted(calls.values())
    assert all(w.parent == w.request and w.end_ns >= w.start_ns
               for w in waits)
    c = profiling.counters()
    assert c["batcher.images"] == 4
    assert 1 <= c["batcher.batches"] <= 4


def test_pipeline_and_train_step_spans_a_step(recorder, tmp_path):
    """Each step of the per-step path: one ``data.wait`` and one
    ``data.preprocess`` in the pipeline's iterator, one ``train.step`` in
    the step function."""
    data = tmp_path / "rhd.bin"
    synthetic.make_rhd_bin(str(data), num_records=6)
    job = train_posenet.setup(["--data", str(data), "--device", "cpu",
                               "--batch-size", "2", "--crop-size", "32",
                               "--snapshot-dir", str(tmp_path / "snap")])
    state = trainer.init_state(job.params, job.optimizer)
    step = trainer.make_train_step(job.loss, job.optimizer)
    it = job.pipeline.iterate(epochs=None)
    try:
        for i in range(3):
            state, _ = step(state, next(it), (0, i))
    finally:
        it.close()
    names = [s.name for s in profiling.spans()]
    assert names == ["data.wait", "data.preprocess", "train.step"] * 3
    assert all(s.parent is None for s in profiling.spans())
