"""Generalization gate: the port's PoseNet training improves HELD-OUT data,
not just memorizes (counterpart of tools/generalization_check.py).

  * 2048 train and 256 val synthetic RHD records, rendered so that the
    pixels encode the pose (data/synthetic.make_rhd_bin_rendered, seeds 0
    and 10000: disjoint poses);
  * train_posenet warm-started the reference's way, from a CPM-MPII-shaped
    TF checkpoint (random weights under the CPM names, written by
    weights/tf_ckpt.write_checkpoint, with the heads and optimizer state
    that the discard rules of training_posenet.py:74-76 drop), read through
    ``--weights`` and its CPM rules;
  * 3000 steps, LR 1e-4 -> 1e-5 at step 2000: the crossing is read from the
    lr column of the metrics log;
  * the val GT-cropped EPE (eval2d_gt_cropped) at the end must be <= 0.6 x
    the warm start's;
  * run B is SIGTERM-killed mid-run and resumed with --resume; its final
    params must equal run A's bit for bit. Both runs use --deterministic
    (deterministic cuDNN, cuBLAS and torch algorithms);
  * ``--steps-per-call`` steps a device call (default 50, as the JAX tool;
    3 in ``--smoke``): evals and the SIGTERM's stop land on window
    boundaries.

``--smoke`` is a tiny plumbing run for the CPU: it keeps the warm start, the
LR crossing and the resume check (run B stopped at half by its step count
rather than a signal), and does not judge the learning. Everything is
written into a temporary directory that is deleted at the end. The last
line of standard output is one JSON summary; the exit code is 0 when every
judged check passed.

    python -m hand3d_tpu_torch.tools.generalization_check          # the card
    python -m hand3d_tpu_torch.tools.generalization_check --smoke --device cpu
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _log(msg):
    print(f"[generalization_check] {msg}", flush=True)


def make_synthetic_cpm_checkpoint(prefix, seed=123):
    """A CPM-MPII-shaped TF checkpoint of random PoseNet weights.

    The trunk and conv5_1 go under CPM/PoseNet/<layer>_CPM, as the real
    cpm-model-mpii names them; conv5_2 too, which the warm start drops; the
    refiners (conv6_*, conv7_*) are left out, as the real model has Mconv
    layers in their place. Decoys the discard rules must drop: a PersonNet
    layer, an Mconv refiner, Adam slots, global_step. Returns the prefix
    and the PoseNet tree written.
    """
    from hand3d_tpu_torch.models import posenet
    from hand3d_tpu_torch.weights.convert import tree_to_flat
    from hand3d_tpu_torch.weights.tf_ckpt import write_checkpoint

    rng = np.random.default_rng(seed)
    params = posenet.init(rng)
    ckpt = {}
    for name, value in tree_to_flat(params).items():
        layer, leaf = name.split("/")
        if layer.startswith(("conv6", "conv7")):
            continue
        ckpt[f"CPM/PoseNet/{layer}_CPM/{leaf}"] = value
    ckpt["CPM/PersonNet/conv1_1/weights"] = rng.standard_normal(
        (3, 3, 3, 8)).astype(np.float32)
    ckpt["CPM/PoseNet/Mconv1_stage2/weights"] = rng.standard_normal(
        (7, 7, 32, 32)).astype(np.float32)
    ckpt["CPM/PoseNet/conv1_1_CPM/weights/Adam"] = np.zeros(
        (3, 3, 3, 64), np.float32)
    ckpt["global_step"] = np.asarray(300000, np.int64)
    return write_checkpoint(prefix, ckpt), params


def val_epe(posenet_params, val_bin, batch_size, max_batches, device):
    """GT-cropped 2D mean EPE (px) of a PoseNet tree on the val file."""
    from hand3d_tpu_torch.data.rhd import RHDDataset
    from hand3d_tpu_torch.eval.harnesses import eval2d_gt_cropped

    m = eval2d_gt_cropped(posenet_params, RHDDataset("evaluation", val_bin),
                          batch_size=batch_size, max_batches=max_batches,
                          device=device)
    return float(m["epe_mean_px"])


def _trainer_argv(args, work, run, max_iter, resume=False):
    return [
        sys.executable, "-m", "hand3d_tpu_torch.cli.train_posenet",
        "--data", os.path.join(work, "rhd_training.bin"),
        "--batch-size", str(args.batch_size), "--max-iter", str(max_iter),
        "--lr", str(args.lr0), str(args.lr1),
        "--lr-iter", str(args.lr_boundary),
        "--show-loss-freq", str(max(1, args.steps // 20)),
        "--snapshot-dir", os.path.join(work, f"snap_{run}"),
        "--snapshot-freq", str(10 * max_iter),  # final (+ preemption) only
        "--steps-per-call", str(args.steps_per_call),
        "--crop-size", str(args.crop_size),
        "--eval-data", os.path.join(work, "rhd_evaluation.bin"),
        "--eval-freq", str(max(1, args.steps // args.evals)),
        *(["--eval-batches", str(args.eval_batches)]
          if args.eval_batches else []),
        "--metrics-log", os.path.join(work, f"{run}.jsonl"),
        "--weights", os.path.join(work, "cpm-model-mpii"),
        "--device", args.device, "--deterministic",
        *(["--resume"] if resume else []),
    ]


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def bitwise_diffs(tree_a, tree_b):
    """The leaves in which two TF-layout numpy trees differ."""
    from hand3d_tpu_torch.weights.convert import tree_to_flat

    a, b = tree_to_flat(tree_a), tree_to_flat(tree_b)
    if a.keys() != b.keys():
        return [f"key sets differ: {sorted(a.keys() ^ b.keys())}"]
    return [f"{k}: max|d|={np.max(np.abs(a[k] - b[k])):.3e}"
            for k in a if not np.array_equal(a[k], b[k])]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--lr-boundary", type=int, default=2000,
                    help="LR steps from lr0 to lr1 here (must be < --steps "
                         "so the run crosses it)")
    ap.add_argument("--lr0", type=float, default=1e-4)
    ap.add_argument("--lr1", type=float, default=1e-5)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--crop-size", type=int, default=256)
    ap.add_argument("--train-records", type=int, default=2048)
    ap.add_argument("--val-records", type=int, default=256)
    ap.add_argument("--evals", type=int, default=4,
                    help="In-training val evals across the run")
    ap.add_argument("--eval-batches", type=int, default=None)
    ap.add_argument("--steps-per-call", type=int, default=50,
                    help="train_posenet's --steps-per-call (1: the per-step "
                         "path)")
    ap.add_argument("--timeout", type=int, default=2400,
                    help="Per-run wall timeout, seconds")
    ap.add_argument("--improve-ratio", type=float, default=0.6,
                    help="Final val EPE must be <= ratio * warm-start EPE")
    ap.add_argument("--device", default="cuda",
                    help="The trainer's --device (default cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="Tiny CPU plumbing run: skips the learning check, "
                         "keeps the warm-start, LR-crossing and resume "
                         "checks")
    args = ap.parse_args(argv)

    if args.smoke:
        args.steps = min(args.steps, 6)
        args.lr_boundary = min(args.lr_boundary, 3)
        args.train_records = min(args.train_records, 24)
        args.val_records = min(args.val_records, 8)
        args.crop_size = min(args.crop_size, 64)
        args.steps_per_call = min(args.steps_per_call, 3)
        args.eval_batches = 1
        args.evals = 2
    if args.lr_boundary >= args.steps:
        raise SystemExit("the run must cross the LR boundary: "
                         "--lr-boundary must be < --steps")

    from hand3d_tpu_torch.cli._common import load_weight_trees
    from hand3d_tpu_torch.data.synthetic import make_rhd_bin_rendered
    from hand3d_tpu_torch.models import posenet
    from hand3d_tpu_torch.train.checkpoints import load_snapshot_params

    t_start = time.time()
    checks, timing = {}, {}
    with tempfile.TemporaryDirectory() as work:
        _log(f"rendering {args.train_records} train / {args.val_records} "
             "val records ...")
        t0 = time.time()
        make_rhd_bin_rendered(os.path.join(work, "rhd_training.bin"),
                              num_records=args.train_records, seed=0)
        make_rhd_bin_rendered(os.path.join(work, "rhd_evaluation.bin"),
                              num_records=args.val_records, seed=10_000)
        timing["render_s"] = time.time() - t0

        _log("writing the synthetic CPM-MPII checkpoint ...")
        cpm = os.path.join(work, "cpm-model-mpii")
        _, written = make_synthetic_cpm_checkpoint(cpm)
        warm = load_weight_trees([cpm])[posenet.SCOPE]
        # what the warm start must take: the trunk and conv5_1, not conv5_2
        want = [k for k in written
                if not k.startswith(("conv5_2", "conv6", "conv7"))]
        checks["warm_start_layers"] = len(warm)
        checks["warm_start_equals_checkpoint"] = sorted(warm) == sorted(
            want) and all(np.array_equal(warm[k][leaf], written[k][leaf])
                          for k in want for leaf in ("weights", "biases"))
        # train_posenet's step-0 PoseNet: the checkpoint's layers over its
        # own seeded ones (--seed 0)
        warm_params = posenet.init(np.random.default_rng(0))
        warm_params.update(warm)
        epe_initial = val_epe(warm_params,
                              os.path.join(work, "rhd_evaluation.bin"),
                              args.batch_size, args.eval_batches, args.device)
        checks["epe_initial_px"] = epe_initial
        _log(f"warm-start val EPE {epe_initial:.3f} px")

        def run(name, max_iter, resume=False, kill_at_frac=None):
            argv = _trainer_argv(args, work, name, max_iter, resume=resume)
            log_path = os.path.join(work, f"{name}.jsonl")
            t0 = time.time()
            proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE, text=True)
            killed = False
            deadline = time.time() + args.timeout
            if kill_at_frac is not None:
                target = int(max_iter * kill_at_frac)
                while time.time() < deadline and proc.poll() is None:
                    try:
                        rows = read_jsonl(log_path)
                    except (OSError, ValueError):
                        rows = []
                    if any(r.get("step", -1) >= target and "loss" in r
                           for r in rows):
                        _log(f"{name}: step {target} reached -> SIGTERM")
                        proc.send_signal(signal.SIGTERM)
                        killed = True
                        break
                    time.sleep(0.1)
            try:
                _, err = proc.communicate(
                    timeout=max(10.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise SystemExit(f"{name}: TIMEOUT after {args.timeout} s")
            if proc.returncode != 0:
                raise SystemExit(
                    f"{name}: rc={proc.returncode}: {(err or '')[-800:]}")
            timing[f"{name}{'_resume' if resume else ''}_s"] = \
                time.time() - t0
            return killed

        _log(f"run A: {args.steps} steps straight ...")
        run("a", args.steps)
        rows_a = read_jsonl(os.path.join(work, "a.jsonl"))
        losses = [r for r in rows_a if "loss" in r]
        if len(losses) > 1:
            timing["a_ms_per_step"] = 1000.0 * (
                losses[-1]["ts"] - losses[0]["ts"]) / (
                losses[-1]["step"] - losses[0]["step"])
        evals = [(r["step"], r["eval_epe_mean_px"]) for r in rows_a
                 if "eval_epe_mean_px" in r]
        checks["val_epe_curve"] = evals
        epe_final = evals[-1][1] if evals else float("inf")
        checks["epe_final_px"] = epe_final
        checks["improve_ratio_measured"] = epe_final / max(epe_initial, 1e-9)
        checks["learned"] = (None if args.smoke else
                             bool(epe_final <= args.improve_ratio
                                  * epe_initial))

        # the LR boundary, read from the log's lr column
        steps_hi = [r["step"] for r in losses if r.get("lr") == args.lr0]
        steps_lo = [r["step"] for r in losses if r.get("lr") == args.lr1]
        checks["lr_values_seen"] = sorted({r["lr"] for r in rows_a
                                           if "lr" in r})
        checks["lr_crossed"] = bool(
            steps_hi and steps_lo
            and max(steps_hi) < args.lr_boundary <= min(steps_lo))

        # run B: interrupted mid-run, then --resume. At smoke scale a run
        # takes seconds and a polled SIGTERM would race its end, so B stops
        # at half by its step count instead
        if args.smoke:
            _log("run B: half the steps, then --resume (smoke) ...")
            run("b", args.steps // 2)
            checks["b_killed_midrun"] = None
        else:
            _log("run B: SIGTERM mid-run, then --resume ...")
            checks["b_killed_midrun"] = run("b", args.steps, kill_at_frac=0.5)
        rows_b = read_jsonl(os.path.join(work, "b.jsonl"))
        checks["b_stopped_at"] = max(r["step"] for r in rows_b
                                     if "loss" in r)
        run("b", args.steps, resume=True)
        diffs = bitwise_diffs(
            *(load_snapshot_params(os.path.join(
                work, f"snap_{r}", f"snapshot-{args.steps}.pt"))
              for r in ("a", "b")))
        checks["resume_bitwise_equal"] = not diffs
        if diffs:
            checks["resume_diffs"] = diffs[:8]

    judged = [checks[k] for k in ("warm_start_equals_checkpoint", "learned",
                                  "lr_crossed", "b_killed_midrun",
                                  "resume_bitwise_equal")
              if checks[k] is not None]
    ok = all(judged)
    print(json.dumps({"gate": "generalization_check", "ok": ok,
                      "smoke": args.smoke, "device": args.device,
                      "steps_per_call": args.steps_per_call,
                      "steps": args.steps, "lr_boundary": args.lr_boundary,
                      "train_records": args.train_records,
                      "val_records": args.val_records,
                      "wall_s": time.time() - t_start, **timing, **checks}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
