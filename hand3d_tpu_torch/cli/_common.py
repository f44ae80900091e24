"""Shared helpers of the port's CLIs (counterpart of hand3d_tpu/cli/_common.py).

``--weights`` takes, in any mix: ``.npz`` files with '/'-joined keys (the
JAX package's ``save_npz`` export), the port's training snapshots
(``snapshot-<step>.pt``) and the JAX package's (``.msgpack``), both params
only, TF V2 checkpoints (a prefix, or its ``.index``; the reference's
training snapshots and the CPM-MPII warm start) and the reference's
``.pickle`` weights. Scopes and layers that no file names keep their seeded
random values.
"""

import argparse
import os
import re
from typing import Any, Callable, NamedTuple

from hand3d_tpu_torch.weights import load_npz
from hand3d_tpu_torch.weights.convert import (
    CPM_HANDSEGNET_DISCARD, CPM_HANDSEGNET_RENAME, CPM_POSENET_DISCARD,
    CPM_POSENET_RENAME, SNAPSHOT_DISCARD, apply_discard_rename,
    convert_reference_pickles, flat_to_tree, load_tf_checkpoint_flat)

_SNAPSHOT_RE = re.compile(r"(^|/)snapshot-\d+\.pt$")


def base_parser(description):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there the two "
                        "CUDA kernels run). 'cpu' runs their plain twins.")
    p.add_argument("--weights", nargs="+", default=None,
                   help="Weight files: .npz (the JAX package's export), "
                        "snapshot-<step>.pt (the port's training snapshots), "
                        ".msgpack (the JAX package's), a TF checkpoint "
                        "(prefix or .index; a CPM-MPII one is split into "
                        "HandSegNet and PoseNet2D) or reference .pickle "
                        "files (converted on the fly).")
    return p


def _load_tf_ckpt_tree(path):
    """TF V2 checkpoint (prefix or .index path) -> param tree.

    Optimizer slots are dropped (SNAPSHOT_DISCARD, eval2d_gt_cropped.py:62).
    Variables under CPM-MPII scopes go through the reference's warm-start
    discard and rename rules (training_handsegnet.py:73-75,
    training_posenet.py:74-76), so ``--weights cpm-model-mpii`` reads the
    shipped checkpoint directly.
    """
    prefix = path[: -len(".index")] if path.endswith(".index") else path
    flat = load_tf_checkpoint_flat(prefix, discard_list=SNAPSHOT_DISCARD)
    if any(n.startswith("CPM/") for n in flat):
        seg = apply_discard_rename(flat, CPM_HANDSEGNET_DISCARD,
                                   CPM_HANDSEGNET_RENAME)
        pose = apply_discard_rename(flat, CPM_POSENET_DISCARD,
                                    CPM_POSENET_RENAME)
        flat = {
            **{k: v for k, v in seg.items() if k.startswith("HandSegNet")},
            **{k: v for k, v in pose.items() if k.startswith("PoseNet2D")},
        }
    return flat_to_tree(flat)


def load_weight_trees(paths, exclude_var_list=None):
    """Merge weight files of every format into one TF-layout tree; a later
    file overrides an earlier one layer by layer. ``exclude_var_list``
    drops the reference pickles' names that contain an entry."""
    from hand3d_tpu_torch.train.checkpoints import load_snapshot_params

    merged = {}
    for path in paths:
        if _SNAPSHOT_RE.search(path) or path.endswith(".msgpack"):
            tree = load_snapshot_params(path)
        elif path.endswith(".npz"):
            tree = load_npz(path)
        elif path.endswith(".index") or os.path.exists(path + ".index"):
            tree = _load_tf_ckpt_tree(path)
        else:
            tree = convert_reference_pickles([path], exclude_var_list)
        for scope, sub in tree.items():
            merged.setdefault(scope, {}).update(sub)
    return merged


def init_or_load(params, weight_paths, exclude_var_list=None):
    """Overlay the layers of ``weight_paths`` on the seeded tree ``params``,
    for the scopes it has."""
    if weight_paths:
        loaded = load_weight_trees(weight_paths, exclude_var_list)
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
    add_qat_arg(p)
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
    p.add_argument("--deterministic", action="store_true",
                   help="Deterministic cuDNN, cuBLAS and torch algorithms: "
                        "on the card a run stopped and --resume'd then "
                        "equals the uninterrupted run bit for bit (as on "
                        "the CPU always)")
    add_mesh_arg(p)
    add_memory_args(p)
    return p


def add_mesh_arg(p):
    """--mesh: a device mesh over torch.distributed ranks (launch one
    process per device with torchrun)."""
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="Device mesh, e.g. '8x1' (data-parallel over 8 "
                        "devices) or '4x2' (DP x tensor-parallel: wide "
                        "layers split over the 2 ranks of each row). "
                        "'auto' = all devices data-parallel. Default: "
                        "single device. A device is a torch.distributed "
                        "rank: torchrun --nproc-per-node N ... --mesh DxM "
                        "with D x M = N.")
    return p


def build_mesh(spec, device):
    """'auto' | 'NxM' -> ``parallel.make_mesh`` (None: no mesh).

    Under a launcher (torchrun's environment) torch.distributed is brought
    up first (``init_distributed(auto=True)``): gloo for a CPU ``device``,
    else its default (NCCL, or gloo where ranks share a card).
    """
    if spec is None:
        return None
    import torch
    import torch.distributed as dist

    from hand3d_tpu_torch.parallel import mesh as mesh_lib

    if mesh_lib.launched() and not dist.is_initialized():
        mesh_lib.init_distributed(
            auto=True,
            backend="gloo" if torch.device(device).type == "cpu" else None)
    if spec == "auto":
        return mesh_lib.make_mesh()
    n_data, n_model = (int(x) for x in spec.lower().split("x"))
    return mesh_lib.make_mesh(n_data, n_model)


def eval_mesh(args):
    """The mesh of an eval CLI's --mesh (None without it), with
    ``args.device`` set to this rank's device first."""
    args.device = mesh_device(args)
    return build_mesh(args.mesh, args.device)


def global_batch(args, mesh):
    """A trainer's batch over all ranks: --batch-size is per process in
    training (as in the JAX package) and global in eval."""
    if mesh is None:
        return args.batch_size
    from hand3d_tpu_torch.parallel.mesh import batch_shard_count

    return args.batch_size * batch_shard_count(mesh)


def mesh_device(args):
    """The CLI's device: under --mesh, this rank's (``parallel.rank_device``:
    "cuda" is the card of LOCAL_RANK)."""
    if args.mesh is None:
        return args.device
    from hand3d_tpu_torch.parallel.mesh import rank_device

    return rank_device(args.device)


def add_show_loss_arg(p):
    p.add_argument("--show-loss-freq", type=int, default=1000,
                   help="Steps between loss reports (print + --metrics-log)")
    return p


def add_steps_per_call_arg(p):
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="Run this many training steps per device call "
                        "(replays of one CUDA graph over a device-resident "
                        "dataset). Amortizes per-step dispatch latency when "
                        "the dataset fits device memory (fine-tuning, small "
                        "sets); trajectory-identical to --steps-per-call 1. "
                        "Requires the fused preprocess path and no --mesh.")


def add_memory_args(p):
    """Activation-memory levers shared by the training CLIs."""
    p.add_argument("--remat", nargs="?", const=True, default=False,
                   help="Checkpoint the loss: recompute activations in the "
                        "backward pass instead of storing them. Takes an "
                        "optional jax.checkpoint_policies name (e.g. "
                        "--remat dots_saveable keeps conv/matmul outputs "
                        "and only recomputes elementwise work)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="Gradient accumulation: split the batch into this "
                        "many microbatches, average their grads, apply one "
                        "update (batch size must be divisible)")
    return p


def add_qat_arg(p):
    p.add_argument("--qat", action="store_true",
                   help="Quantization-aware training: train under the int8 "
                        "fake-quant view (ops.quant.qat_view) so the weights "
                        "adapt to the deployed int8 numerics; a snapshot is "
                        "a float tree, quantize_params_int8 of it the "
                        "deployment tree.")


def maybe_qat(loss_fn, args):
    """``loss_fn`` under the QAT view when --qat is set."""
    if not getattr(args, "qat", False):
        return loss_fn
    from hand3d_tpu_torch.ops.quant import qat_view

    def wrapped(params, batch, generator):
        return loss_fn(qat_view(params), batch, generator)

    return wrapped


def add_quantize_arg(p):
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="Post-training int8 quantization of the conv/FC path "
                        "(ops.quant): measures the quantized EPE beside the "
                        "f32 numbers.")
    p.add_argument("--phase-pack", action="store_true",
                   help="Run conv1_2 of HandSegNet and PoseNet phase-packed: "
                        "its even and odd output columns as one stride-(1, 2) "
                        "conv of twice the channels, fused with the 2x2 pool "
                        "after it (ops.phasepack; 4/3 of the layer's "
                        "multiply-adds, equal to the plain layer to float "
                        "reassociation). Applied after --quantize.")


def maybe_quantize(params, args):
    """The inference param transforms of --quantize int8 and --phase-pack:
    with --quantize, the TF-layout tree ``params`` on the CLI's device,
    quantized there (``ops.quant.quantize_params_int8``), as a torch tree
    the eval harnesses take as it is; then --phase-pack packs conv1_2
    (``ops.phasepack.phase_pack_params``, either tree). Without either,
    ``params`` unchanged."""
    if getattr(args, "quantize", None) == "int8":
        from hand3d_tpu_torch import precision
        from hand3d_tpu_torch.ops.quant import quantize_params_int8
        from hand3d_tpu_torch.weights import params_from_jax

        params = quantize_params_int8(params_from_jax(
            params, precision.exact_f32(args.device)))
    if getattr(args, "phase_pack", False):
        from hand3d_tpu_torch.ops.phasepack import phase_pack_params

        params = phase_pack_params(params)
    return params


def reject_unported(args):
    """Raise early for training flags that cannot run together, before any
    device or mesh is set up: --steps-per-call K > 1 with --mesh (fit's
    error, as in the JAX package) and a --remat name that is no policy."""
    from hand3d_tpu_torch.train.trainer import remat_saves

    if args.mesh is not None and args.steps_per_call > 1:
        raise ValueError(
            "steps_per_call > 1 does not compose with a mesh yet: the "
            "resident dataset would need per-shard index streams; run "
            "multi-step training single-device")
    remat_saves(args.remat)


def train_device(args):
    """The trainer's torch device, TF32 off (``precision.exact_f32``).

    With --deterministic every cuDNN, cuBLAS and torch algorithm is the
    deterministic one. cuBLAS reads CUBLAS_WORKSPACE_CONFIG when it starts,
    so the setting is made before the process's first CUDA work, or the
    caller must have made it. Under --mesh the device is this rank's
    (``mesh_device``).
    """
    import torch

    from hand3d_tpu_torch import precision

    if args.deterministic:
        if "CUBLAS_WORKSPACE_CONFIG" not in os.environ:
            if torch.cuda.is_initialized():
                raise RuntimeError(
                    "--deterministic after CUDA started: set "
                    "CUBLAS_WORKSPACE_CONFIG=:4096:8 before the process's "
                    "first CUDA work")
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
    return precision.exact_f32(mesh_device(args))


def _metrics_logger(args):
    """MetricsLogger for --metrics-log, or None.

    A fresh run truncates an existing log (a re-run's curve must not be
    judged against a stale first line); --resume appends, so the curve is
    contiguous across the restart. Every row with a step carries the
    scheduled LR (train.schedule.piecewise_constant), direct evidence of the
    LR boundaries crossed.
    """
    from hand3d_tpu_torch.parallel.mesh import process_index

    if not args.metrics_log or process_index() != 0:  # rank 0 writes it
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


def fit_options(args, snapshot_dir, eval_fn=None, mesh=None):
    """fit's keyword options from the shared training flags."""
    return dict(seed=args.seed, show_loss_freq=args.show_loss_freq,
                mesh=mesh,
                snapshot_dir=snapshot_dir, snapshot_freq=args.snapshot_freq,
                resume=args.resume, step_timeout=args.step_timeout,
                remat=args.remat, accum_steps=args.accum_steps,
                steps_per_call=args.steps_per_call,
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
