"""Interactive serving over HTTP: the server ``cli.serve`` builds, driven by
one closed-loop client in a child process (``http_client.py``), as a webcam
app behind the server drives it.

The server is the CLI's own: ``build_estimator`` on an ``.npz`` of the
seed's weights and ``make_server(serialize=True)`` on a free port, built in
this process. The benchmark's one addition is a span around the ``predict``
it hands to ``make_server``.

Parameters: ``input_hw``, ``batch_size`` (the CLI's ``--batch-size``),
``pool_frames`` (the seed's frames, sent round the pool from a seeded
start), ``warmup_requests``, ``check_requests`` (replies the reference
recomputes, drawn from the seed) and ``trace_seconds`` (the traced part of
a ``--trace 1`` run's window, which ends a second before the window does:
the profiler slows the process after it stops too, so the spans are read
from the requests before it).
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from benchmark import inputs, trace
from benchmark.reference import cascade as ref
from benchmark.reference import check_cascade
from benchmark.traffic import http_client

CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "http_client.py")


def setup(run):
    from hand3d_tpu_torch.cli import serve

    prm = run.params
    hw = tuple(prm["input_hw"])
    weights = inputs.make_weights(run.seed, run.device)
    npz = run.tmp / "weights.npz"
    np.savez(npz, **{f"{scope}/{layer}/{key}": arr
                     for scope, sub in weights.items()
                     for layer, leaf in sub.items()
                     for key, arr in leaf.items()})
    frames = inputs.make_frames(run.seed, prm["pool_frames"], hw, run.device)
    pool = run.tmp / "frames.npy"
    np.save(pool, frames)
    # the CLI's defaults, as `serve --weights W --batch-size B` parses them
    args = argparse.Namespace(
        weights=str(npz), artifact=None, host="127.0.0.1", port=0,
        batch_size=prm["batch_size"], input_hw=list(hw), quantize=None,
        seg_scale=1.0, compute_dtype=None, device=str(run.device),
        dynamic_batch=None)
    est, meta = serve.build_estimator(args)
    os.remove(npz)

    def predict(images):
        a = time.perf_counter()
        out = est.predict(images)
        run.span("predict", a, time.perf_counter())
        return out

    srv = serve.make_server(predict, meta, args.host, args.port,
                            serialize=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    quiet = open(os.devnull, "w")
    with contextlib.redirect_stdout(quiet):  # the server logs each request
        thread.start()
        port = srv.server_address[1]
        for i in range(prm["warmup_requests"]):
            status, _ = http_client.post(
                port, http_client.encode(frames[i % len(frames)]))
            if status != 200:
                raise RuntimeError(f"warm-up request answered {status}")
    return {"weights": weights, "frames": frames, "pool": pool, "srv": srv,
            "thread": thread, "port": port, "quiet": quiet}


def window(run, st):
    prm = run.params
    out = run.tmp / "replies.json"
    run.spans["predict"] = []
    first = int(run.seed % len(st["frames"]))
    with contextlib.redirect_stdout(st["quiet"]):
        client = subprocess.Popen(
            [sys.executable, CLIENT, "--port", str(st["port"]), "--frames",
             str(st["pool"]), "--first", str(first), "--seconds",
             str(run.seconds), "--out", str(out)],
            stdout=subprocess.DEVNULL)
        try:
            if run.trace_on:
                time.sleep(max(0.0, run.seconds - prm["trace_seconds"] - 1))
                with trace.traced(run.tmp / "trace.json", True) as held:
                    a = time.perf_counter()
                    time.sleep(prm["trace_seconds"])
                    b = time.perf_counter()
                run.trace = held.trace
                run.counters["traced_window"] = (a, b)
            code = client.wait(run.seconds + http_client.TIMEOUT_S + 60)
        finally:
            if client.poll() is None:
                client.kill()
                client.wait()
    if code != 0:
        raise RuntimeError(f"the client exited with {code}")
    with open(out) as f:
        records = json.load(f)["records"]
    os.remove(out)
    ok = [r for r in records if r["status"] == 200]
    run.attempted = len(records)
    run.failed = len(records) - len(ok)
    lat = np.array([(r["done"] - r["sent"]) * 1e3 if r["status"] == 200
                    else np.inf for r in records])
    run.counters["requests"] = records
    run.e2e["latency_p50_ms"] = float(np.percentile(lat, 50, method="higher"))
    return ok


def check(run, st, ok):
    prm = run.params
    st["srv"].shutdown()
    st["srv"].server_close()
    st["thread"].join(30)
    del st["srv"]
    torch.cuda.empty_cache()
    rows = inputs.sample_rows(run.seed, len(ok), prm["check_requests"])
    sample = [ok[i] for i in rows]
    got = {k: np.asarray([r["reply"][k][0] if k != "scale_crop"
                          else r["reply"][k] for r in sample], np.float32)
           for k in ("keypoint_uv21", "keypoint_coord3d", "center",
                     "scale_crop")}
    frames = st["frames"][[r["frame"] for r in sample]]
    params = ref.to_torch(st["weights"], run.device)
    readings, per_frame = check_cascade.judge(params, frames, got, run.device)
    run.counters.update(per_frame)
    check_cascade.report(per_frame, sys.stderr)
    if run.trace_on:
        # the passes the frames of the traced window need, for the flood
        # fill's roofline
        a, b = run.counters["traced_window"]
        traced = [r["frame"] for r in run.counters["requests"]
                  if r["status"] == 200 and a <= 0.5 * (r["sent"] + r["done"])
                  <= b]
        run.counters["traced_flood_passes"] = flood_passes(
            params, st["frames"], traced, run.device)
    st["quiet"].close()
    os.remove(st["pool"])
    run.judge(readings)


def flood_passes(params, frames, which, device, block=32):
    """The flood-fill passes each listed frame needs, by the reference."""
    uniq, counts = np.unique(np.asarray(which, np.int64), return_counts=True)
    passes = []
    with torch.no_grad():
        for a in range(0, len(uniq), block):
            image = ref.normalize(frames[uniq[a:a + block]], device)
            _, det, seed = ref.foreground(
                ref.handsegnet(params["HandSegNet"], image))
            h, w = image.shape[1:3]
            _, p = ref.flood(det, seed, max(h, w) // 10)
            passes.append(p.cpu().numpy())
    per = np.concatenate(passes) if passes else np.zeros(0)
    return np.repeat(per, counts)
