"""Synthetic-overfit gate: the port's four trainers OPTIMIZE, not just step
(counterpart of tools/overfit_check.py).

Each training CLI runs end to end in its own process (argument parsing,
InputPipeline, fused preprocess + train step, snapshots, metrics log) on 16
fixed synthetic RHD records at batch 8, and its loss must fall by a stated
factor: the first reported loss over the median of the last three. The
step budgets, drop ratios and eval bounds are the JAX tool's:

  * handsegnet: ``--steps`` steps, drop >= 5x;
  * posenet: 5x the steps, drop >= 0.9x (a divergence backstop: with the
    reference's augmentation noise on, the loss floor is the noise floor)
    and the GT-cropped 2D eval on the same records <= 15 px mean EPE;
  * lifting (proposed): 2x the steps, drop >= 4x;
  * joint (proposed): 2x the steps, warm-started from THIS run's posenet and
    lifting snapshots, drop >= 0.9x and the end-to-end 3D eval <= 40 mm.

``--only joint`` therefore runs posenet and lifting first. Training runs
``--steps-per-call`` steps a device call (default 50, as the JAX tool:
replays of one captured CUDA graph over the records held on the device;
1 is the per-step path). Everything is written into a temporary directory
that is deleted at the end, or into ``--keep DIR``, which keeps the records
and the final snapshots (``snap_<stage>/snapshot-<step>.pt``), e.g. for
``tools/preset_accuracy.py --overfit-dir DIR``. ``--warm-from DIR`` starts
handsegnet, posenet and lifting from the newest snapshots of an earlier
``--keep DIR`` (a fine-tune, so each drop bar becomes the 0.9 divergence
backstop and the eval bounds judge); ``--qat`` trains every stage under the
int8 fake-quant view (the trainers' ``--qat``). The last line of standard
output is one JSON summary; the exit code is 0 when every trainer passed.

    python -m hand3d_tpu_torch.tools.overfit_check            # on the card
    python -m hand3d_tpu_torch.tools.overfit_check --keep /tmp/of
    python -m hand3d_tpu_torch.tools.overfit_check --qat --warm-from /tmp/of
    python -m hand3d_tpu_torch.tools.overfit_check --only lifting --steps 2 \
        --device cpu                                         # plumbing
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAGES = ("handsegnet", "posenet", "lifting", "joint")


def _latest_snapshot(snap_dir):
    """The newest snapshot-<step>.pt of an earlier run's snapshot dir."""
    from hand3d_tpu_torch.train.checkpoints import latest_snapshot

    path = latest_snapshot(snap_dir)
    if path is None:
        raise SystemExit(f"--warm-from: no snapshot under {snap_dir}")
    return path


def _trainers(steps, data_dir, work, device, steps_per_call=50, qat=False,
              warm_from=None, run=STAGES):
    """{name: (argv, min drop ratio, (eval key, bound) or None)} in run
    order; joint reads posenet's and lifting's final snapshots of this run.
    ``warm_from``: an earlier ``--keep`` dir whose newest snapshots start
    the other three stages that ``run`` holds."""
    train_bin = os.path.join(data_dir, "rhd_training.bin")
    eval_bin = os.path.join(data_dir, "rhd_evaluation.bin")

    def common(name, n_steps):
        return [
            "-m", f"hand3d_tpu_torch.cli.train_{name}", "--data", train_bin,
            "--batch-size", "8", "--max-iter", str(n_steps),
            "--show-loss-freq", str(max(1, n_steps // 12)),
            "--snapshot-freq", str(10 * n_steps),  # the final snapshot only
            "--steps-per-call", str(steps_per_call), "--lr", "1e-4", "1e-4",
            "--lr-iter", "1000000", "--device", device,
            "--snapshot-dir", os.path.join(work, f"snap_{name}"),
            "--metrics-log", os.path.join(work, f"{name}.jsonl"),
            *(["--qat"] if qat else []), *warm(name)]

    def warm(name):
        if warm_from is None or name == "joint" or name not in run:
            return []
        return ["--weights",
                _latest_snapshot(os.path.join(warm_from, f"snap_{name}"))]

    def snapshot(name, n_steps):
        return os.path.join(work, f"snap_{name}", f"snapshot-{n_steps}.pt")

    return {
        "handsegnet": (common("handsegnet", steps), 5.0, None),
        "posenet": ([*common("posenet", 5 * steps), "--eval-data", eval_bin,
                     "--eval-freq", str(5 * steps)],
                    0.9, ("eval_epe_mean_px", 15.0)),
        "lifting": ([*common("lifting", 2 * steps), "--variant", "proposed"],
                    4.0, None),
        "joint": ([*common("joint", 2 * steps), "--variant", "proposed",
                   "--weights", snapshot("posenet", 5 * steps),
                   snapshot("lifting", 2 * steps),
                   "--eval-data", eval_bin, "--eval-freq", str(2 * steps)],
                  0.9, ("eval_epe_mean_mm", 40.0)),
    }


def read_curve(path):
    """(loss rows [(step, loss, ts)], {eval key: last value})."""
    losses, evals = [], {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "loss" in rec:
                losses.append((int(rec["step"]), float(rec["loss"]),
                               float(rec["ts"])))
            evals.update((k, v) for k, v in rec.items()
                         if k.startswith("eval_"))
    return losses, evals


def ms_per_step(losses):
    """Milliseconds a step between the first and the last loss report (the
    first step's set-up before the first report is left out)."""
    (s0, _, t0), (s1, _, t1) = losses[0], losses[-1]
    return 1000.0 * (t1 - t0) / (s1 - s0) if s1 > s0 else None


def judge(losses, evals, min_ratio, eval_bound):
    # the median of the last three reports: one batch-8 loss is noisy
    first = losses[0][1]
    tail = sorted(v for _, v, _ in losses[-3:])
    last = tail[len(tail) // 2]
    ratio = first / max(last, 1e-12)
    entry = {"loss_first": first, "loss_last": last, "drop_ratio": ratio,
             "min_ratio": min_ratio, "ms_per_step": ms_per_step(losses),
             "curve": [(s, v) for s, v, _ in losses], **evals}
    ok = ratio >= min_ratio
    if eval_bound is not None:
        key, bound = eval_bound
        entry.update(bound_key=key, bound_value=bound)
        ok = ok and evals.get(key) is not None and evals[key] <= bound
    entry["ok"] = ok
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600,
                    help="Base step budget: handsegnet runs it, lifting and "
                         "joint 2x, posenet 5x")
    ap.add_argument("--records", type=int, default=16)
    ap.add_argument("--only", default=None, choices=STAGES,
                    help="One trainer (joint also runs its two stages)")
    ap.add_argument("--device", default="cuda",
                    help="The trainers' --device (default cuda)")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="Per-trainer wall timeout, seconds")
    ap.add_argument("--steps-per-call", type=int, default=50,
                    help="The trainers' --steps-per-call (1: the per-step "
                         "path)")
    ap.add_argument("--keep", default=None,
                    help="Keep the work dir (records and final snapshots) "
                         "here, e.g. for tools/preset_accuracy.py")
    ap.add_argument("--warm-from", default=None,
                    help="An earlier --keep dir: handsegnet, posenet and "
                         "lifting start from its newest snapshots (e.g. a "
                         "QAT fine-tune of the float overfit weights); joint "
                         "always starts from this run's stage snapshots")
    ap.add_argument("--qat", action="store_true",
                    help="Train every stage under the int8 fake-quant view "
                         "(the trainers' --qat)")
    args = ap.parse_args(argv)

    from hand3d_tpu_torch.data.synthetic import make_rhd_bin

    run = set(STAGES) if args.only is None else {args.only}
    if "joint" in run:
        run |= {"posenet", "lifting"}
    results = {}
    t_start = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        work = args.keep or tmp
        data_dir = os.path.join(work, "data")
        os.makedirs(data_dir, exist_ok=True)
        make_rhd_bin(os.path.join(data_dir, "rhd_training.bin"),
                     num_records=args.records)
        # the same records under the eval name: a memorization EPE
        make_rhd_bin(os.path.join(data_dir, "rhd_evaluation.bin"),
                     num_records=args.records)
        trainers = _trainers(args.steps, data_dir, work, args.device,
                             args.steps_per_call, args.qat, args.warm_from,
                             run)
        for name, (cmd, min_ratio, eval_bound) in trainers.items():
            if name not in run:
                continue
            if args.warm_from is not None:
                # a fine-tune starts converged: the ratio is the divergence
                # backstop and the eval bounds judge (posenet, joint)
                min_ratio = min(min_ratio, 0.9)
            n_steps = int(cmd[cmd.index("--max-iter") + 1])
            t0 = time.time()
            try:
                proc = subprocess.run([sys.executable, *cmd], cwd=REPO,
                                      capture_output=True, text=True,
                                      timeout=args.timeout)
                err = None if proc.returncode == 0 else (
                    f"rc={proc.returncode}: {proc.stderr[-600:]}")
            except subprocess.TimeoutExpired:
                err = f"TIMEOUT after {args.timeout} s"
            entry = {"seconds": time.time() - t0, "steps": n_steps}
            if err is None:
                entry.update(judge(*read_curve(
                    os.path.join(work, f"{name}.jsonl")), min_ratio,
                    eval_bound))
            else:
                entry.update(ok=False, error=err)
            results[name] = entry
            detail = err or (
                f"loss {entry['loss_first']:.4g} -> {entry['loss_last']:.4g} "
                f"({entry['drop_ratio']:.3g}x, need {min_ratio}x)"
                + (f"  {eval_bound[0]} {entry.get(eval_bound[0])} "
                   f"(need <= {eval_bound[1]})" if eval_bound else ""))
            print(f"{name:<11} {'PASS' if entry['ok'] else 'FAIL'}  "
                  f"{entry['seconds']:7.1f} s  {detail}", flush=True)

    ok = all(r["ok"] for r in results.values())
    print(json.dumps({"gate": "overfit_check", "ok": ok, "steps": args.steps,
                      "records": args.records, "device": args.device,
                      "steps_per_call": args.steps_per_call,
                      "qat": args.qat, "warm_from": args.warm_from,
                      "wall_s": time.time() - t_start,
                      "trainers": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
