"""The port's serving CLIs on the CPU: the HTTP server
(hand3d_tpu_torch.cli.serve, the counterpart of tests/test_cli.py's server
cases), its graceful SIGTERM, and the demo.

This file imports no jax.
"""

import http.client
import importlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from hand3d_tpu_torch import export, serving, weights
from hand3d_tpu_torch.cli import serve

from torch_tmp import module_dir, tmp_path  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
HW = (48, 64)


@pytest.fixture(scope="module")
def params():
    return weights.random_params(2)


@pytest.fixture(scope="module")
def npz(params, tmp_path_factory):
    """``params`` as an .npz weights file."""
    with module_dir(tmp_path_factory, "weights") as d:
        weights.save_npz(str(d / "w.npz"), params)
        yield d / "w.npz"


def frames(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def npy(images):
    buf = io.BytesIO()
    np.save(buf, images)
    return buf.getvalue()


def request(port, method, path, body=None, content_type=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=(
            {"Content-Type": content_type} if content_type else {}))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class Serving:
    """cli.serve's server on a free port, in a thread."""

    def __init__(self, predict, meta, serialize=True):
        self.srv = serve.make_server(predict, meta, port=0,
                                     serialize=serialize)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()


def test_http_predict_healthz_metrics(params):
    """.npy bodies (and PNG where PIL exists) at any resolution come back as
    JSON keypoints in the caller's frame, equal to the estimator's answer;
    /healthz reports the configuration; a bad body is a 400; /metrics
    counts requests, images and errors."""
    est = serving.AutoBucketEstimator(params, batch_size=2, snap_hws=[HW],
                                      device="cpu")
    images = frames(2, 60, 80, seed=0)
    want = est.predict(images)
    with Serving(est.predict, {"source": "test", "device": "cpu"}) as s:
        status, body = request(s.port, "GET", "/healthz")
        assert status == 200
        assert json.loads(body) == {"status": "ok", "source": "test",
                                    "device": "cpu"}
        status, body = request(s.port, "POST", "/predict", npy(images),
                               "application/x-npy")
        assert status == 200
        out = json.loads(body)
        for k in ("keypoint_uv21", "keypoint_coord3d", "center"):
            np.testing.assert_allclose(out[k], want[k], rtol=1e-6, atol=0,
                                       err_msg=k)
        np.testing.assert_allclose(out["scale_crop"], want["scale_crop"][:, 0],
                                   rtol=1e-6)
        uv = np.asarray(out["keypoint_uv21"])
        assert uv.shape == (2, 21, 2)
        # one [H, W, 3] image is a batch of one
        status, body = request(s.port, "POST", "/predict", npy(images[0]),
                               "application/x-npy")
        assert status == 200
        np.testing.assert_allclose(json.loads(body)["keypoint_uv21"],
                                   uv[:1], rtol=1e-6)
        posts = 2
        try:
            from PIL import Image
        except ImportError:
            Image = None
        if Image is not None:
            png = io.BytesIO()
            Image.fromarray(images[1]).save(png, format="PNG")
            status, body = request(s.port, "POST", "/predict",
                                   png.getvalue(), "image/png")
            assert status == 200
            np.testing.assert_allclose(json.loads(body)["keypoint_uv21"],
                                       uv[1:], rtol=1e-6)
            posts += 1
        status, body = request(s.port, "POST", "/predict", b"not-an-image",
                               "application/x-npy")
        assert status == 400 and b"error" in body
        assert request(s.port, "GET", "/nowhere")[0] == 404
        status, body = request(s.port, "GET", "/metrics")
        text = body.decode()
        assert status == 200
        assert f"hand3d_requests_total {posts}" in text
        assert f"hand3d_images_total {posts + 1}" in text
        assert "hand3d_errors_total 1" in text
        assert "hand3d_request_seconds_sum" in text


def test_http_predict_failure_is_500():
    def broken_predict(images, normalized=False):
        raise RuntimeError("device fell over")

    with Serving(broken_predict, {"source": "test"}) as s:
        status, body = request(s.port, "POST", "/predict",
                               npy(np.zeros((1, 8, 8, 3), np.uint8)),
                               "application/x-npy")
    assert status == 500 and b"device fell over" in body


def test_http_dynamic_batch_coalesces(params):
    """Behind serialize=False the handler threads reach the batcher at once:
    four one-image POSTs run as one device batch."""
    est = serving.HandPoseEstimator(params, batch_size=4, input_hw=HW,
                                    device="cpu").warmup()
    sizes = []
    inner = est.predict

    def counting(images, normalized=False):
        sizes.append(len(images))
        return inner(images, normalized=normalized)

    est.predict = counting
    batcher = serving.DynamicBatcher(est, max_batch=4, max_wait_ms=1000.0)
    images = frames(4, *HW, seed=1)
    try:
        with Serving(batcher.predict, {"source": "test"},
                     serialize=False) as s:
            results = [None] * 4

            def post(i):
                results[i] = request(s.port, "POST", "/predict",
                                     npy(images[i:i + 1]),
                                     "application/x-npy")
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        batcher.close()
    assert sizes == [4]
    want = inner(images)["keypoint_uv21"]
    for i, (status, body) in enumerate(results):
        assert status == 200
        np.testing.assert_allclose(json.loads(body)["keypoint_uv21"],
                                   want[i:i + 1], rtol=1e-6)


def test_build_estimator_from_weights_and_from_an_artifact(params, npz,
                                                           tmp_path):
    art = tmp_path / "c.h3dx"
    export.export_estimator(params, str(art), batch_size=1, input_hw=HW,
                            device="cpu")
    base = ["--input-hw", "48", "64", "--device", "cpu"]
    est, meta = serve.build_estimator(serve_args(
        ["--weights", str(npz), "--batch-size", "2",
         "--compute-dtype", "bfloat16", *base]))
    assert isinstance(est, serving.AutoBucketEstimator)
    assert meta["source"] == "weights" and meta["compute_dtype"] == "bfloat16"
    assert est.snap_hws == [HW]
    images = frames(1, 50, 70, seed=2)
    live = est.predict(images)
    est, meta = serve.build_estimator(serve_args(["--artifact", str(art)]))
    assert isinstance(est, serving.SnapEstimator)
    assert meta["source"] == "artifact" and meta["format"] == "torch.export"
    out = est.predict(images)
    np.testing.assert_array_equal(out["snap_hw"], HW)
    assert out["keypoint_uv21"].shape == live["keypoint_uv21"].shape
    est, meta = serve.build_estimator(serve_args(
        ["--weights", str(npz), "--quantize", "int8", *base]))
    assert meta["quantize"] == "int8" and est.params.quantize == "int8"
    want = serving.AutoBucketEstimator(params, batch_size=1, snap_hws=[HW],
                                       quantize="int8",
                                       device="cpu").predict(images)
    for k, v in est.predict(images).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def serve_args(argv):
    """serve.main's parsed flags for ``argv``, without serving."""
    captured = {}

    def stop(args):
        captured["args"] = args
        raise SystemExit(0)

    real = serve.build_estimator
    serve.build_estimator = stop
    try:
        with pytest.raises(SystemExit):
            serve.main(argv)
    finally:
        serve.build_estimator = real
    return captured["args"]


def test_serve_main_answers_then_stops_on_sigterm(npz):
    """The CLI in its own process: --dynamic-batch, a POST, then SIGTERM
    finishes cleanly with exit code 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "hand3d_tpu_torch.cli.serve", "--weights",
         str(npz), "--device", "cpu", "--port", "0", "--input-hw", "48",
         "64", "--batch-size", "2", "--dynamic-batch", "5"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (
            line + proc.stderr.read())
        port = int(line.split(":")[2].split()[0])
        status, body = request(port, "POST", "/predict",
                               npy(frames(1, *HW, seed=3)),
                               "application/x-npy")
        assert status == 200, body
        status, body = request(port, "GET", "/healthz")
        assert json.loads(body)["dynamic_batch_ms"] == 5.0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        assert "shut down cleanly" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("cli, argv", [
    ("serve", ["--weights", "w.npz"]),
    ("export_model", ["--weights", "w.npz", "--out", "c.h3dx"]),
    ("demo", ["hand.png"])])
def test_serving_clis_default_to_cuda_and_refuse_a_missing_card(
        npz, tmp_path, monkeypatch, cli, argv):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    os.symlink(npz, "w.npz")
    module = importlib.import_module(f"hand3d_tpu_torch.cli.{cli}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


@pytest.mark.parametrize("entry", ["auto_bucket", "bf16_estimator",
                                   "export"])
def test_serving_entry_points_turn_tf32_off_first(params, monkeypatch,
                                                  entry):
    """As tests/test_torch_precision.py: on a stubbed card each entry point
    turns both TF32 flags off before it moves a parameter to the device
    (which then fails without a CUDA build)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    make = {
        "auto_bucket": lambda: serving.AutoBucketEstimator(params,
                                                           device="cuda"),
        "bf16_estimator": lambda: serving.HandPoseEstimator(
            params, batch_size=1, compute_dtype="bfloat16", device="cuda"),
        "export": lambda: export.export_estimator(params, device="cuda")}
    with pytest.raises((AssertionError, RuntimeError)):
        make[entry]()
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (False, False)


def test_demo_writes_the_pose_figure(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    from hand3d_tpu_torch.cli import demo

    src = tmp_path / "hand.png"
    plt.imsave(src, frames(1, 90, 120, seed=4)[0])
    demo.main([str(src), "--out-dir", str(tmp_path), "--device", "cpu",
               "--right"])
    out = tmp_path / "hand_pose.png"
    assert out.exists() and out.stat().st_size > 10_000
    assert f"Wrote {out}" in capsys.readouterr().out
    # --quantize int8: the same figure from the int8 tree, whose int8 convs
    # and FCs run (46 of its 67 layers)
    from hand3d_tpu_torch.ops import quant

    calls = []
    (tmp_path / "q").mkdir()
    conv = quant.conv2d_int8
    quant.conv2d_int8 = lambda *a: calls.append(1) or conv(*a)
    try:
        demo.main([str(src), "--out-dir", str(tmp_path / "q"), "--device",
                   "cpu", "--quantize", "int8"])
    finally:
        quant.conv2d_int8 = conv
    assert (tmp_path / "q" / "hand_pose.png").stat().st_size > 10_000
    assert len(calls) == 41  # the int8 convs; 5 int8 FCs take dense_int8


def test_serialized_predicts_run_on_one_device_thread():
    """Without a batcher every predict runs on the server's one long-lived
    device thread, one at a time, whatever handler thread took the request:
    a new thread's first CUDA work sets up its own library handles."""
    seen, busy = [], []
    lock = threading.Lock()

    def predict(images, normalized=False):
        with lock:
            busy.append(1)
            assert len(busy) == 1  # one at a time
        seen.append(threading.get_ident())
        with lock:
            busy.pop()
        return {"keypoint_uv21": np.zeros((len(images), 21, 2)),
                "keypoint_coord3d": np.zeros((len(images), 21, 3)),
                "center": np.zeros((len(images), 2)),
                "scale_crop": np.ones((len(images), 1))}

    with Serving(predict, {"source": "test"}) as s:
        threads = [threading.Thread(target=request, args=(
            s.port, "POST", "/predict", npy(np.zeros((1, 8, 8, 3), np.uint8)),
            "application/x-npy")) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        device_thread = s.srv.device_thread
    assert len(seen) == 6 and len(set(seen)) == 1
    assert seen[0] != threading.get_ident()
    assert device_thread._shutdown  # server_close stops it
