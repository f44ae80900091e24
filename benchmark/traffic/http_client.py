"""The closed-loop HTTP client of ``closed_http``: one client, one request in
flight, the next frame sent when the reply has arrived.

It runs in a process of its own and imports neither torch nor the program:

    python benchmark/traffic/http_client.py --port P --frames pool.npy \
        --first I --seconds S --out replies.json

Each request POSTs one [H, W, 3] uint8 frame of the pool as an ``.npy``
body to ``/predict`` on a connection of its own (the server speaks
HTTP/1.0); the frames go round the pool from ``--first``. A reply that
comes late counts with its latency; one that has not come after
``TIMEOUT_S`` counts as failed. The
client encodes every frame before its window, then sends for ``--seconds``
and writes, for every request, the frame, the send and reply times on its
clock (``time.perf_counter``), the HTTP status and the parsed reply.
"""

import argparse
import http.client
import io
import json
import sys
import time

import numpy as np


def encode(frame):
    buf = io.BytesIO()
    np.save(buf, frame, allow_pickle=False)
    return buf.getvalue()


# a reply that comes late is late, not wrong: the client waits this long for
# each before it counts the request as never answered
TIMEOUT_S = 150.0


def post(port, body, phases=None):
    """(status, body) of one POST; ``phases`` (a list) gets the seconds the
    connect and the whole exchange took."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    t0 = time.perf_counter()
    try:
        conn.connect()
        t1 = time.perf_counter()
        conn.request("POST", "/predict", body=body,
                     headers={"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        out = resp.status, resp.read()
        if phases is not None:
            phases += [t1 - t0, time.perf_counter() - t0]
        return out
    finally:
        conn.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--frames", required=True)
    p.add_argument("--first", type=int, default=0)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    pool = np.load(args.frames, mmap_mode="r")
    bodies = [encode(np.asarray(f)) for f in pool]
    records = []
    i = args.first
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < args.seconds:
        k = i % len(bodies)
        sent = time.perf_counter()
        phases = []
        try:
            status, raw = post(args.port, bodies[k], phases=phases)
            reply = json.loads(raw) if status == 200 else None
        except (OSError, http.client.HTTPException, ValueError) as e:
            status, reply = 0, None
            print(f"request {i}: {type(e).__name__}: {e} after "
                  f"{time.perf_counter() - sent:.3f} s", file=sys.stderr)
        if phases and phases[1] > 1.0:
            print(f"request {i}: connect {phases[0]:.3f} s, whole "
                  f"{phases[1]:.3f} s", file=sys.stderr)
        records.append({"frame": k, "sent": sent,
                        "done": time.perf_counter(), "status": status,
                        "reply": reply})
        i += 1
    with open(args.out, "w") as f:
        json.dump({"start": t_start, "records": records}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
