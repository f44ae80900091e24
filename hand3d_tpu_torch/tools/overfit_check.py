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

``--only joint`` therefore runs posenet and lifting first. Training is one
step a device call (``--steps-per-call 1``). Everything is written into a
temporary directory that is deleted at the end. The last line of standard
output is one JSON summary; the exit code is 0 when every trainer passed.

    python -m hand3d_tpu_torch.tools.overfit_check            # on the card
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


def _trainers(steps, data_dir, work, device):
    """{name: (argv, min drop ratio, (eval key, bound) or None)} in run
    order; joint reads posenet's and lifting's final snapshots."""
    train_bin = os.path.join(data_dir, "rhd_training.bin")
    eval_bin = os.path.join(data_dir, "rhd_evaluation.bin")

    def common(name, n_steps):
        return [
            "-m", f"hand3d_tpu_torch.cli.train_{name}", "--data", train_bin,
            "--batch-size", "8", "--max-iter", str(n_steps),
            "--show-loss-freq", str(max(1, n_steps // 12)),
            "--snapshot-freq", str(10 * n_steps),  # the final snapshot only
            "--steps-per-call", "1", "--lr", "1e-4", "1e-4",
            "--lr-iter", "1000000", "--device", device,
            "--snapshot-dir", os.path.join(work, f"snap_{name}"),
            "--metrics-log", os.path.join(work, f"{name}.jsonl")]

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
    args = ap.parse_args(argv)

    from hand3d_tpu_torch.data.synthetic import make_rhd_bin

    run = set(STAGES) if args.only is None else {args.only}
    if "joint" in run:
        run |= {"posenet", "lifting"}
    results = {}
    t_start = time.time()
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "data")
        os.makedirs(data_dir)
        make_rhd_bin(os.path.join(data_dir, "rhd_training.bin"),
                     num_records=args.records)
        # the same records under the eval name: a memorization EPE
        make_rhd_bin(os.path.join(data_dir, "rhd_evaluation.bin"),
                     num_records=args.records)
        trainers = _trainers(args.steps, data_dir, work, args.device)
        for name, (cmd, min_ratio, eval_bound) in trainers.items():
            if name not in run:
                continue
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
                      "wall_s": time.time() - t_start,
                      "trainers": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
