"""A single-card ``HandPoseEstimator``'s cascade as CUDA graphs
(``serving._CascadeGraph``).

On the card (marked ``gpu``; they skip without one): a graphed ``predict``
equals the cascade called eagerly on the same params and frames, bit for
bit, in every mode; a call of several chunks keeps each chunk's answers;
uint8 and float frames get a graph each; two threads calling one estimator
get their own answers; the buckets of an ``AutoBucketEstimator`` share one
pool and answer as their cascades; the counters ``serving.graph.captures``
and ``serving.graph.replays``, the kernels' launch counts (a replay enters
no binding) and their runs in the card's trace; and what ``cli.serve``'s
``GET /metrics`` reports of them. On the CPU: an estimator
takes the eager path and records no ``serving.graph.*`` count.

This file imports no jax. On a machine with a card run the ``gpu`` cases
with ``python -m pytest -p no:cacheprovider --noconftest -m gpu
tests/test_torch_serving_graph.py``.
"""

import argparse
import http.client
import io
import threading

import numpy as np
import pytest
import torch

from hand3d_tpu_torch import serving, weights
from hand3d_tpu_torch.batching import (predict_input, select_serving_outputs,
                                       to_device_normalized)
from hand3d_tpu_torch.cli import serve
from hand3d_tpu_torch.ops.kernels import kernel_counts, kernel_runs
from hand3d_tpu_torch.utils import profiling

HW = (240, 320)
CPU_HW = (48, 64)
GRAPH_COUNTERS = ("serving.graph.captures", "serving.graph.replays")
MODES = {
    "b1-f32": dict(batch_size=1),
    "b4-f32": dict(batch_size=4),
    "b4-bf16": dict(batch_size=4, compute_dtype="bfloat16"),
    "b4-seg_scale0.5": dict(batch_size=4, seg_scale=0.5),
    "b4-int8": dict(batch_size=4, quantize="int8"),
    "b4-phase_pack": dict(batch_size=4, phase_pack=True),
}


@pytest.fixture
def recorder(monkeypatch):
    """A fresh process recorder for the test."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


@pytest.fixture(scope="module")
def params():
    return weights.random_params(3)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def frames(n, seed, hw=HW):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def eager(est, images):
    """``est``'s cascade called eagerly, launch by launch, on ``images``
    padded into chunks as ``predict`` pads them: numpy out."""
    images = predict_input(images)
    b = est.batch_size
    outs = []
    for start in range(0, len(images), b):
        chunk = images[start:start + b]
        valid = len(chunk)
        chunk = np.concatenate(
            [chunk, np.zeros((b - valid, *chunk.shape[1:]), chunk.dtype)])
        with torch.inference_mode():
            out = select_serving_outputs(est.net.inference(
                est.params, to_device_normalized(chunk, est.levels),
                est.hand_side, keypoints_scoremap=False))
        outs.append({k: v[:valid].cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def graph_counts():
    counts = profiling.counters()
    return {k: counts.get(k, 0) for k in GRAPH_COUNTERS}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_a_cpu_estimator_runs_the_cascade_eagerly(recorder, params, dtype):
    est = serving.HandPoseEstimator(params, batch_size=2, input_hw=CPU_HW,
                                    device="cpu")
    images = frames(3, 1, CPU_HW)
    if dtype == "float32":
        images = images / np.float32(255.0)
    assert_equal(est.predict(images), eager(est, images))
    assert est._graphs is None
    assert not any(k.startswith("serving.graph.")
                   for k in profiling.counters())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
def test_graphed_predict_equals_the_eager_cascade_bitwise(recorder, params,
                                                          cuda, mode):
    kw = MODES[mode]
    est = serving.HandPoseEstimator(params, input_hw=HW, device=cuda, **kw)
    b = kw["batch_size"]
    images = frames(b + (b + 1) // 2, 2)  # two chunks, the last padded
    got = est.predict(images)
    assert graph_counts() == {"serving.graph.captures": 1,
                              "serving.graph.replays": 2}
    assert_equal(got, eager(est, images))


@pytest.mark.gpu
def test_each_chunk_of_a_call_keeps_its_answers(recorder, params, cuda):
    est = serving.HandPoseEstimator(params, batch_size=2, input_hw=HW,
                                    device=cuda)
    images = frames(6, 3)
    got = est.predict(images)
    assert graph_counts()["serving.graph.replays"] == 3
    assert_equal(got, eager(est, images))
    # the chunks' answers differ, so one replay's outputs served thrice
    # would show
    assert not np.array_equal(got["hand_scoremap"][:2],
                              got["hand_scoremap"][4:])


@pytest.mark.gpu
def test_uint8_and_float_frames_get_a_graph_each(recorder, params, cuda):
    est = serving.HandPoseEstimator(params, batch_size=2, input_hw=HW,
                                    device=cuda)
    calls = [frames(2, 4), frames(2, 5) / np.float32(255.0), frames(2, 6),
             frames(1, 7) / np.float32(255.0)]
    for images in calls:
        assert_equal(est.predict(images), eager(est, images))
    assert sorted(map(str, est._graphs)) == ["float32", "uint8"]
    assert graph_counts() == {"serving.graph.captures": 2,
                              "serving.graph.replays": 4}


@pytest.mark.gpu
def test_two_threads_on_one_estimator_get_their_own_answers(recorder, params,
                                                            cuda):
    est = serving.HandPoseEstimator(params, batch_size=2, input_hw=HW,
                                    device=cuda).warmup()
    mine = {t: frames(3, 10 + t) for t in range(2)}
    want = {t: eager(est, mine[t]) for t in mine}
    got = {t: [] for t in mine}
    errors = []

    def client(t):
        try:
            for _ in range(10):
                got[t].append(est.predict(mine[t]))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in mine]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not errors and not any(th.is_alive() for th in threads)
    for t in mine:
        assert len(got[t]) == 10
        for out in got[t]:
            assert_equal(out, want[t])


@pytest.mark.gpu
def test_each_replayed_chunk_counts_a_replay_and_runs_each_kernel_once(
        recorder, params, cuda):
    est = serving.HandPoseEstimator(params, batch_size=2, input_hw=HW,
                                    device=cuda).warmup()
    # the warm-up's eager chunks launched the kernels, and the capture
    # recorded a launch of each
    warm = serving.GRAPH_WARMUP_CALLS + 1
    assert kernel_counts() == {"flood_fill": warm, "decode_upsampled": warm}
    assert graph_counts() == {"serving.graph.captures": 1,
                              "serving.graph.replays": 1}
    _, runs = kernel_runs(lambda: est.predict(frames(5, 8)))  # three chunks
    assert runs == {"flood_fill": 3, "decode_upsampled": 3}
    assert kernel_counts() == {"flood_fill": warm, "decode_upsampled": warm}
    assert graph_counts() == {"serving.graph.captures": 1,
                              "serving.graph.replays": 4}


@pytest.mark.gpu
def test_the_buckets_of_one_auto_estimator_share_one_pool(recorder, params,
                                                          cuda):
    auto = serving.AutoBucketEstimator(params, batch_size=2, device=cuda)
    # the first bucket again after the second's capture
    calls = [(hw, frames(3, 20 + i, hw))
             for i, hw in enumerate([HW, (192, 256), HW])]
    for hw, images in calls:
        got = auto.predict(images)
        assert tuple(got.pop("snap_hw")) == hw
        assert_equal(got, eager(auto._buckets[hw], images))
    assert {id(est._pool) for est in auto._buckets.values()} == {
        id(auto._pool)}
    assert graph_counts()["serving.graph.captures"] == 2


def _post(port, images):
    buf = io.BytesIO()
    np.save(buf, images)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/predict", buf.getvalue(),
                     {"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def _counters(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    prefix = 'hand3d_counter_total{counter="'
    return {line[len(prefix):].split('"')[0]: int(line.split()[-1])
            for line in text.splitlines() if line.startswith(prefix)}


@pytest.mark.gpu
def test_served_metrics_count_one_capture_and_a_replay_a_request(
        recorder, params, cuda, tmp_path):
    npz = tmp_path / "weights.npz"
    np.savez(npz, **{f"{scope}/{layer}/{key}": arr
                     for scope, sub in params.items()
                     for layer, leaf in sub.items()
                     for key, arr in leaf.items()})
    args = argparse.Namespace(
        weights=str(npz), artifact=None, batch_size=1, input_hw=list(HW),
        quantize=None, seg_scale=1.0, compute_dtype=None, device=str(cuda))
    est, meta = serve.build_estimator(args)
    srv = serve.make_server(est.predict, meta, "127.0.0.1", 0,
                            serialize=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]
        pool = frames(8, 9)
        for i in range(3):
            assert _post(port, pool[i:i + 1]) == 200
        warm = _counters(port)
        for i in range(3, 8):
            assert _post(port, pool[i:i + 1]) == 200
        after = _counters(port)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)
    assert warm["serving.graph.captures"] == after[
        "serving.graph.captures"] == 1
    assert after["serving.graph.replays"] - warm["serving.graph.replays"] \
        == 5
