"""Shared helpers of the port's CLIs (counterpart of hand3d_tpu/cli/_common.py).

Weights are ``.npz`` files with '/'-joined keys, as the JAX package's
``save_npz`` exports them, or the port's training snapshots
(``snapshot-<step>.pt``, params only). Scopes and layers that no file names
keep their seeded random values.
"""

import argparse
import re
from typing import Any, Callable, NamedTuple

from hand3d_tpu_torch.weights import load_npz

_SNAPSHOT_RE = re.compile(r"(^|/)snapshot-\d+\.pt$")


def base_parser(description):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there the two "
                        "CUDA kernels run). 'cpu' runs their plain twins.")
    p.add_argument("--weights", nargs="+", default=None,
                   help="Weight files: .npz (the JAX package's export) or "
                        "the port's snapshot-<step>.pt training snapshots.")
    return p


def load_weight_trees(paths):
    """Merge .npz files and training snapshots into one TF-layout tree."""
    from hand3d_tpu_torch.train.checkpoints import load_snapshot_params

    merged = {}
    for path in paths:
        if path.endswith(".npz"):
            tree = load_npz(path)
        elif _SNAPSHOT_RE.search(path):
            tree = load_snapshot_params(path)
        else:
            raise ValueError(
                f"{path}: only .npz weights and snapshot-<step>.pt training "
                "snapshots are read by the PyTorch port; reference .pickle "
                "files, TF checkpoints and .msgpack snapshots wait for "
                "ROADMAP.md 'Still to port', queue 2")
        for scope, sub in tree.items():
            merged.setdefault(scope, {}).update(sub)
    return merged


def init_or_load(params, weight_paths):
    """Overlay the layers of ``weight_paths`` on the seeded tree ``params``,
    for the scopes it has."""
    if weight_paths:
        loaded = load_weight_trees(weight_paths)
        for scope in params:
            if scope in loaded:
                params[scope].update(loaded[scope])
    return params


def progress_printer(total, batch_size):
    def progress(batch_idx, valid):
        done = batch_idx * batch_size + valid
        if batch_idx % 10 == 0:
            print(f"{done} / {total} images done: "
                  f"{done * 100.0 / total:.3f} percent")
    return progress


# --- training ------------------------------------------------------------------


def add_train_args(p, max_iter, lr, lr_iter, snapshot_dir):
    """The flags every trainer shares, with the stage's reference defaults."""
    p.set_defaults(batch_size=8)
    p.add_argument("--data", default=None, help="Path to rhd_training.bin")
    p.add_argument("--max-iter", type=int, default=max_iter)
    p.add_argument("--lr", type=float, nargs="+", default=lr)
    p.add_argument("--lr-iter", type=int, nargs="+", default=lr_iter)
    p.add_argument("--snapshot-dir", default=snapshot_dir)
    p.add_argument("--snapshot-freq", type=int, default=5000)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--qat", action="store_true",
                   help="Quantization-aware training: not ported, raises "
                        "(ROADMAP.md 'Still to port', queue 5).")
    add_show_loss_arg(p)
    add_steps_per_call_arg(p)
    p.add_argument("--metrics-log", default=None,
                   help="Append one JSON line per loss report here (JSONL).")
    p.add_argument("--step-timeout", type=float, default=None,
                   help="Watchdog: abort (exit 17) if no step completes "
                        "within this many seconds (hang detection); set "
                        "well above the first step's time.")
    p.add_argument("--no-fused", dest="fused", action="store_false",
                   default=True,
                   help="Preprocess in the input pipeline (its own draws per "
                        "epoch and step) instead of inside the train step")
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="Device mesh: not ported, raises (ROADMAP.md 'Still "
                        "to port', queue 1).")
    add_memory_args(p)
    return p


def add_show_loss_arg(p):
    p.add_argument("--show-loss-freq", type=int, default=1000,
                   help="Steps between loss reports (print + --metrics-log)")
    return p


def add_steps_per_call_arg(p):
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="Training steps per device call; only 1 is ported "
                        "(device-resident training waits for ROADMAP.md "
                        "'Still to port', queue 1).")


def add_memory_args(p):
    """Activation-memory levers shared by the training CLIs."""
    p.add_argument("--remat", nargs="?", const=True, default=False,
                   help="Recompute activations in the backward pass instead "
                        "of storing them (torch.utils.checkpoint). Named "
                        "recompute policies are not ported and raise.")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="Gradient accumulation: split the batch into this "
                        "many microbatches, average their grads, apply one "
                        "update (batch size must be divisible)")
    return p


def reject_unported(args):
    """Raise for the training flags the port does not have yet, naming the
    ROADMAP.md queue that ports them: nothing is silently ignored."""
    if args.qat:
        raise NotImplementedError(
            "--qat (quantization-aware training) is not ported: ROADMAP.md "
            "'Still to port', queue 5")
    if args.mesh is not None:
        raise NotImplementedError(
            "--mesh is not ported: the port trains on one device "
            "(ROADMAP.md 'Still to port', queue 1)")
    if args.steps_per_call > 1:
        raise NotImplementedError(
            "--steps-per-call > 1 (device-resident multi-step training) is "
            "not ported: ROADMAP.md 'Still to port', queue 1")
    if isinstance(args.remat, str):
        raise NotImplementedError(
            f"--remat {args.remat}: named recompute policies are not ported "
            "(ROADMAP.md 'Still to port', queue 1); --remat alone recomputes "
            "everything")


def _metrics_logger(args):
    """MetricsLogger for --metrics-log, or None.

    A fresh run truncates an existing log (a re-run's curve must not be
    judged against a stale first line); --resume appends, so the curve is
    contiguous across the restart. Every row with a step carries the
    scheduled LR (train.schedule.piecewise_constant), direct evidence of the
    LR boundaries crossed.
    """
    if not args.metrics_log:
        return None
    from hand3d_tpu_torch.train.schedule import piecewise_constant
    from hand3d_tpu_torch.utils.logging import MetricsLogger

    logger = MetricsLogger(args.metrics_log, echo=False,
                           fresh=not args.resume)
    schedule = piecewise_constant(args.lr_iter, args.lr)
    log = logger.log

    def log_with_lr(step=None, **kw):
        if step is not None and "lr" not in kw:
            kw["lr"] = schedule(step)
        return log(step=step, **kw)

    logger.log = log_with_lr
    return logger


def add_eval_args(p, what):
    """--eval-data / --eval-freq / --eval-batches of an in-training eval."""
    p.add_argument("--eval-data", default=None,
                   help=f"Path to rhd_evaluation.bin: {what}")
    p.add_argument("--eval-freq", type=int, default=5000,
                   help="Steps between in-training evals (with --eval-data)")
    p.add_argument("--eval-batches", type=int, default=None,
                   help="Bound each in-training eval to this many batches "
                        "(default: the full eval set)")
    return p


class TrainJob(NamedTuple):
    """What a trainer's ``setup`` builds and ``run`` hands to
    ``train.loop.fit``: the loss over the pipeline's batches, the seeded
    (or loaded) params on the device, the optimizer, the pipeline, the step
    count and fit's keyword options."""
    loss: Callable
    params: dict
    optimizer: Any
    pipeline: Any
    max_iter: int
    options: dict


def fit_options(args, snapshot_dir, eval_fn=None):
    """fit's keyword options from the shared training flags."""
    return dict(seed=args.seed, show_loss_freq=args.show_loss_freq,
                snapshot_dir=snapshot_dir, snapshot_freq=args.snapshot_freq,
                resume=args.resume, step_timeout=args.step_timeout,
                remat=args.remat, accum_steps=args.accum_steps,
                metrics_logger=_metrics_logger(args), eval_fn=eval_fn,
                eval_freq=getattr(args, "eval_freq", 0))


def run(job):
    """Train ``job``; returns the final TrainState. The metrics log is
    closed afterwards."""
    from hand3d_tpu_torch.train.loop import fit

    try:
        return fit(job.loss, job.params, job.optimizer, job.pipeline,
                   job.max_iter, **job.options)
    finally:
        if job.options["metrics_logger"] is not None:
            job.options["metrics_logger"].close()
