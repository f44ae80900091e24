"""Readings that set a cell's correctness limits, read on the card at the
cell's own size over many seeds in one process:

    python benchmark/control.py --workload <cell> --seeds 1 2 3 ... [--program]

For each seed it prints one JSON line of the cell's numbers for

* ``control``: the plain reference computed in TF32 (the nearest precision
  below the configuration's f32 with TF32 off), put in the program's place
  and judged by the f32 reference as a run judges the program;
* ``program`` (with ``--program``): served cells, the program's estimator
  at the cell's batch size on the same frames as the control; one-card
  training cells, the cell's own set-up and check (``traffic/train.py``)
  with no window;
* ``half``, ``unchanged`` (the state left as it was in the window's steps)
  and, on more than one chip, ``no_exchange`` (training cells): the
  reference with the fault planted (``posenet_train.run(fault=)``); a state
  left unchanged in every step reads 1 by construction and needs no run.

The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness, inputs  # noqa: E402
from benchmark.reference import cascade as ref  # noqa: E402
from benchmark.reference import check_cascade, posenet_train  # noqa: E402
from benchmark.traffic import train  # noqa: E402


def served(run, seed, device, program):
    prm = run.params
    hw = tuple(prm["input_hw"])
    weights = inputs.make_weights(seed, device)
    pool = inputs.make_frames(seed, prm["pool_frames"], hw, device)
    k = prm.get("check_frames", prm.get("check_requests"))
    frames = pool[inputs.sample_rows(seed, len(pool), k)]
    params = ref.to_torch(weights, device)
    keep = ("hand_scoremap" if "check_frames" in prm else None,
            "center", "scale_crop", "keypoint_uv21", "keypoint_coord3d")
    b = prm["batch_size"]
    out = {}
    ref.set_tf32(True)
    with torch.no_grad():
        parts = [ref.infer(params, frames[a:a + b], device)
                 for a in range(0, len(frames), b)]
    got = {key: np.concatenate([p[key] for p in parts]) for key in keep
           if key}
    out["control"] = check_cascade.judge(params, frames, got, device)[0]
    if program:
        from hand3d_tpu_torch.serving import HandPoseEstimator

        est = HandPoseEstimator(weights, batch_size=b, input_hw=hw,
                                device=device)
        got = {key: v for key, v in est.predict(frames).items()
               if key in keep}
        del est
        out["program"] = check_cascade.judge(params, frames, got, device)[0]
    return out


def trained(run, seed, device, program=False):
    prm = run.params
    window = prm.get("steps_per_call", 0) if prm["path"] == "resident" else 0
    out = {}
    if program:
        prog = harness.Run(run.name, seed, 0, 0, device=device,
                           overrides=run.params)
        st = train.setup(prog)
        train.check(prog, st, None)
        out["program"] = {k: v for k, (v, _) in prog.numbers.items()}
    records = inputs.make_records(seed, prm["records"], device)
    weights = inputs.make_weights(seed, device, scopes=("PoseNet2D",))

    def go(**kw):
        return posenet_train.run(weights, records, seed, prm["batch_size"],
                                 run.chips, train.CHECK_STEPS + window,
                                 device, crop_size=prm["crop_size"],
                                 delta_at=train.CHECK_STEPS, **kw)

    def judged(v):
        got = {"losses": v["loss"][:train.CHECK_STEPS],
               "grad0": v["grad0"], "delta": v["delta"]}
        if window:
            got["window_losses"] = v["loss"][train.CHECK_STEPS:]
        return train.compare(got, base)

    base = go()
    faults = (["half"] + (["unchanged"] if window else [])
              + (["no_exchange"] if run.chips > 1 else []))
    out["control"] = judged(go(tf32=True))
    out.update({f: judged(go(fault=f)) for f in faults})
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    run = harness.Run(args.workload, 0, 0, 0, device=device)
    for seed in args.seeds:
        t = time.perf_counter()
        if run.workload["generator"] == "train":
            out = trained(run, seed, device, args.program)
        else:
            out = served(run, seed, device, args.program)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
