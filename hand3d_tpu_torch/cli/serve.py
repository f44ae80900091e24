"""Minimal HTTP inference server for the hand-pose cascade (stdlib only;
counterpart of hand3d_tpu/cli/serve.py).

The same predictions served three ways — in-process (`HandPoseEstimator`),
AOT artifact (`ExportedEstimator`), and over HTTP (this CLI, fronting either
of the two).

    # from converted weights, on the card
    python -m hand3d_tpu_torch.cli.serve --weights weights.npz --port 8000
    # or from an AOT export artifact (no weight file needed)
    python -m hand3d_tpu_torch.cli.serve --artifact cascade.h3dx --port 8000

    curl -X POST -H 'Content-Type: application/x-npy' \
        --data-binary @frame.npy localhost:8000/predict
    curl localhost:8000/healthz

`POST /predict` takes an .npy body (Content-Type application/x-npy, one
[H, W, 3] image or an [N, H, W, 3] stack) or a PNG/JPEG body (needs PIL),
any resolution — resized to the serving bucket on the device — and returns
JSON: keypoint_uv21 (input-frame pixels), keypoint_coord3d (root-relative,
bone-normalized), center, scale_crop. `GET /healthz` reports readiness and
configuration, `GET /metrics` request, error and image counters. Requests
run one at a time on one device thread, or are coalesced into device
batches with --dynamic-batch.
"""

import argparse
import io
import json
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _decode_body(body, content_type):
    if content_type == "application/x-npy":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.ndim == 3:
            arr = arr[None]
        return arr
    from PIL import Image

    img = Image.open(io.BytesIO(body)).convert("RGB")
    return np.asarray(img, np.uint8)[None]


class _Handler(BaseHTTPRequestHandler):
    server_version = "hand3d-tpu-torch"

    def _json(self, code, payload):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            return self._json(200, {"status": "ok", **self.server.meta})
        if self.path == "/metrics":
            s = self.server.stats
            with self.server.stats_lock:
                lines = "".join(
                    f"hand3d_{k} {v}\n" for k, v in sorted(s.items()))
            body = lines.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return None
        return self._json(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path != "/predict":
            return self._json(404, {"error": "unknown path"})
        t0 = time.perf_counter()
        try:  # malformed request body -> the client's fault: 400
            length = int(self.headers.get("Content-Length", 0))
            images = _decode_body(self.rfile.read(length),
                                  self.headers.get("Content-Type", ""))
        except Exception as e:
            with self.server.stats_lock:
                self.server.stats["errors_total"] += 1
            return self._json(400, {"error": f"{type(e).__name__}: {e}"})
        try:  # predict-side failure -> a server fault: 500
            out = self.server.run_predict(images)
            with self.server.stats_lock:
                self.server.stats["requests_total"] += 1
                self.server.stats["images_total"] += len(images)
                self.server.stats["request_seconds_sum"] = round(
                    self.server.stats["request_seconds_sum"]
                    + (time.perf_counter() - t0), 6)
            return self._json(200, {
                "keypoint_uv21": np.asarray(out["keypoint_uv21"]).tolist(),
                "keypoint_coord3d":
                    np.asarray(out["keypoint_coord3d"]).tolist(),
                "center": np.asarray(out["center"]).tolist(),
                "scale_crop": np.asarray(out["scale_crop"]).reshape(
                    len(images)).tolist(),
            })
        except Exception as e:  # surface the cause to the client
            with self.server.stats_lock:
                self.server.stats["errors_total"] += 1
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args):  # route through one logger
        print(f"[serve] {self.address_string()} {fmt % args}", flush=True)


class _Server(ThreadingHTTPServer):
    # ThreadingHTTPServer defaults to daemon handler threads, which the
    # interpreter kills at exit; non-daemon threads are tracked and joined
    # by server_close(), which is what makes SIGTERM actually finish
    # in-flight requests before main() returns.
    daemon_threads = False

    def server_close(self):
        super().server_close()
        if self.device_thread is not None:
            self.device_thread.shutdown()


def make_server(predict, meta, host="127.0.0.1", port=8000, serialize=True):
    """``serialize=True`` runs every ``predict`` on one long-lived thread,
    one at a time: a thread's first CUDA work sets up its own library
    handles, which a handler thread a request would pay each time.
    ``serialize=False`` lets handler threads call ``predict`` concurrently —
    required for DynamicBatcher to see concurrent requests (its own queue
    provides the thread safety, and only its thread touches the card)."""
    srv = _Server((host, port), _Handler)
    srv.predict = predict
    srv.meta = meta
    srv.device_thread = (ThreadPoolExecutor(1, "device") if serialize
                         else None)
    if serialize:
        srv.run_predict = lambda images: srv.device_thread.submit(
            predict, images).result()
    else:
        srv.run_predict = predict
    srv.stats = {"requests_total": 0, "errors_total": 0, "images_total": 0,
                 "request_seconds_sum": 0.0}
    srv.stats_lock = threading.Lock()
    return srv


def build_estimator(args):
    """Returns (estimator, meta) from --weights or --artifact. Either way
    the estimator accepts any input resolution (snap resize on the device,
    uv mapped back) and exposes the .predict(images, normalized=) contract
    DynamicBatcher can wrap."""
    if args.artifact:
        from hand3d_tpu_torch.export import ExportedEstimator
        from hand3d_tpu_torch.serving import SnapEstimator

        est = SnapEstimator(ExportedEstimator.load(args.artifact).warmup())
        return est, {"source": "artifact", **est.est.meta}
    from hand3d_tpu_torch.serving import AutoBucketEstimator
    from hand3d_tpu_torch.weights import load_npz

    est = AutoBucketEstimator(
        load_npz(args.weights), batch_size=args.batch_size,
        snap_hws=[tuple(args.input_hw)], seg_scale=args.seg_scale,
        compute_dtype=args.compute_dtype, quantize=args.quantize,
        device=args.device)
    meta = {"source": "weights", "batch_size": args.batch_size,
            "input_hw": list(args.input_hw), "quantize": args.quantize,
            "seg_scale": args.seg_scale, "compute_dtype": args.compute_dtype,
            "device": args.device}
    return est, meta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="npz param tree")
    src.add_argument("--artifact", help="AOT export artifact (.h3dx)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--input-hw", type=int, nargs=2, default=[240, 320],
                   help="serving bucket; inputs snap to it on the device")
    p.add_argument("--quantize", default=None, choices=[None, "int8"],
                   help="int8 post-training quantization of --weights "
                        "(dynamic activation scales, ops.quant; an artifact "
                        "carries its own)")
    p.add_argument("--seg-scale", type=float, default=1.0)
    p.add_argument("--compute-dtype", default=None,
                   choices=[None, "bfloat16"],
                   help="conv compute dtype of --weights (an artifact "
                        "carries its own)")
    p.add_argument("--device", default="cuda",
                   help="torch device of --weights (default cuda: the CUDA "
                        "kernels; cpu: their plain twins)")
    p.add_argument("--dynamic-batch", type=float, default=None,
                   metavar="WAIT_MS",
                   help="coalesce concurrent requests into one device "
                        "batch of up to --batch-size images, waiting at "
                        "most WAIT_MS for stragglers (serving.DynamicBatcher)")
    args = p.parse_args(argv)

    est, meta = build_estimator(args)
    predict = est.predict
    batcher = None
    if args.dynamic_batch is not None:
        from hand3d_tpu_torch.serving import DynamicBatcher

        batcher = DynamicBatcher(est, max_batch=args.batch_size,
                                 max_wait_ms=args.dynamic_batch)
        predict = batcher.predict
        meta = {**meta, "dynamic_batch_ms": args.dynamic_batch}
    srv = make_server(predict, meta, args.host, args.port,
                      serialize=args.dynamic_batch is None)
    print(f"serving on http://{args.host}:{srv.server_address[1]} "
          f"({meta})", flush=True)

    # graceful SIGTERM (container stop / supervisor): finish in-flight
    # requests, stop accepting, exit 0
    def _term(signum, frame):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if batcher is not None:
            batcher.close()
        print("shut down cleanly", flush=True)


if __name__ == "__main__":
    main()
