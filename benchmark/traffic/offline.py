"""Offline serving: one caller runs ``HandPoseEstimator.predict`` on calls of
uint8 frames back to back, in a closed loop, as a video or dataset job does.

Parameters (the workload's ``params``): ``input_hw``, ``batch_size`` (the
estimator's device batch), ``call_frames`` (frames a call), ``pool_frames``
(the seed's frame pool; consecutive calls take consecutive slices of it, so
no two consecutive calls repeat a frame), ``warmup_calls``,
``keep_calls_from`` and ``keep_calls`` (which calls' answers are kept for the
check, drawn from the seed), ``check_frames`` (how many of those frames the
reference recomputes) and ``trace_seconds`` (the traced part of the window
in a ``--trace 1`` run).
"""

import sys
import time

import numpy as np
import torch

from benchmark import inputs, trace
from benchmark.reference import cascade as ref
from benchmark.reference import check_cascade


def setup(run):
    from hand3d_tpu_torch.serving import HandPoseEstimator

    prm = run.params
    hw = tuple(prm["input_hw"])
    weights = inputs.make_weights(run.seed, run.device)
    frames = inputs.make_frames(run.seed, prm["pool_frames"], hw, run.device)
    est = HandPoseEstimator(weights, batch_size=prm["batch_size"],
                            input_hw=hw, device=run.device)
    st = {"weights": weights, "frames": frames, "est": est,
          "next": int(run.seed % (len(frames) // prm["call_frames"]))}
    for _ in range(prm["warmup_calls"]):
        est.predict(_take(st, prm["call_frames"])[1])
    return st


def _take(st, n):
    """The next call's frame indices and frames."""
    frames = st["frames"]
    calls = len(frames) // n
    a = (st["next"] % calls) * n
    st["next"] += 1
    return np.arange(a, a + n), frames[a:a + n]


def window(run, st):
    prm = run.params
    n = prm["call_frames"]
    keep = set(inputs.sample_rows(run.seed, prm["keep_calls_from"],
                                  prm["keep_calls"]).tolist())
    kept, done, calls = [], 0, 0
    est = st["est"]
    t_start = time.perf_counter()
    t_end = t_start

    def one_call():
        nonlocal done, calls, t_end
        idx, frames = _take(st, n)
        a = time.perf_counter()
        run.attempted += 1
        try:
            out = est.predict(frames)
        except RuntimeError:
            run.failed += 1
            raise
        t_end = time.perf_counter()
        run.span("predict", a, t_end)
        if calls in keep:
            kept.append((idx, out))
        done += n
        calls += 1

    traced_for = prm["trace_seconds"] if run.trace_on else run.seconds
    with trace.traced(run.tmp / "trace.json", run.trace_on) as held:
        while time.perf_counter() - t_start < traced_for:
            one_call()
        run.counters["traced_frames"] = done
    run.trace = held.trace
    while time.perf_counter() - t_start < run.seconds:
        one_call()
    run.counters["frames"] = done
    run.counters["window_s"] = t_end - t_start
    run.e2e["frames_per_s"] = done / (t_end - t_start)
    return kept


def check(run, st, kept):
    prm = run.params
    del st["est"]
    torch.cuda.empty_cache()
    if not kept:
        print("no call that the check keeps completed in the window",
              file=sys.stderr)
        return
    idx = np.concatenate([i for i, _ in kept])
    got = {k: np.concatenate([o[k] for _, o in kept]) for k in kept[0][1]}
    rows = inputs.sample_rows(run.seed, len(idx), prm["check_frames"])
    got = {k: v[rows] for k, v in got.items()}
    params = ref.to_torch(st["weights"], run.device)
    readings, per_frame = check_cascade.judge(params, st["frames"][idx[rows]],
                                           got, run.device)
    run.counters.update(per_frame)
    check_cascade.report(per_frame, sys.stderr)
    run.judge(readings)
