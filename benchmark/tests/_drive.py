"""Drive a whole run of a cell on the CPU at a small size, without the
harness's look for a card: set-up, window and check, with a fault planted in
the program where asked. Used by the tests and, one process a rank, by the
data-parallel test."""

import importlib
import os
import time

import torch

from benchmark import harness

SMALL = {
    "chp3d-f32.offline-b32": dict(input_hw=[64, 96], batch_size=2,
                                  call_frames=4, pool_frames=16,
                                  warmup_calls=1, keep_calls_from=1,
                                  keep_calls=1, check_frames=4),
    "chp3d-f32.webcam-http": dict(input_hw=[64, 96], pool_frames=8,
                                  warmup_requests=2, check_requests=4),
    "posenet-train.resident-b8": dict(batch_size=2, steps_per_call=3,
                                      records=16, crop_size=64,
                                      warmup_steps=3),
    "posenet-train.dp4-b8": dict(batch_size=2, records=16, crop_size=64,
                                 warmup_steps=2, chips=2),
}


def plant(fault):
    """Break the timed path underneath: returns an undo function."""
    from hand3d_tpu_torch import serving
    from hand3d_tpu_torch.cli import train_posenet
    from hand3d_tpu_torch.parallel import mesh
    from hand3d_tpu_torch.train import trainer

    undo = []

    def patch(obj, name, fn):
        old = getattr(obj, name)
        setattr(obj, name, fn(old))
        undo.append(lambda: setattr(obj, name, old))

    if fault == "answer":  # one keypoint of each batch's first frame moved
        def run_chunk(old):
            def f(self, chunk):
                out = dict(old(self, chunk))
                uv = out["keypoint_uv21"].clone()
                uv[0, 0] += 3.0
                out["keypoint_uv21"] = uv
                return out
            return f
        patch(serving.HandPoseEstimator, "_run", run_chunk)
    elif fault == "box":  # the first frame's crop box moved by 5 px
        def run_chunk(old):
            def f(self, chunk):
                out = dict(old(self, chunk))
                center = out["center"].clone()
                center[0] += 5.0
                out["center"] = center
                return out
            return f
        patch(serving.HandPoseEstimator, "_run", run_chunk)
    elif fault == "half_outputs":  # the batch's second half never computed
        def run_chunk(old):
            def f(self, chunk):
                out = old(self, chunk)
                n = len(chunk) // 2
                return {k: torch.cat([v[:len(chunk) - n], v[:n]])
                        for k, v in out.items()}
            return f
        patch(serving.HandPoseEstimator, "_run", run_chunk)
    elif fault == "unchanged":  # the update leaves the state as it was
        patch(trainer.ScheduledAdam, "apply",
              lambda old: lambda self, opt, params, grads, step=None:
              self.lr(self.prepare(opt, trainer.tree_leaves(params))[0]
                      ["step"]))
    elif fault == "short_window":  # a window runs two of its steps at most
        def run(old):
            def f(self, state, k, step0):
                state, _ = old(self, state, min(k, 2), step0)
                return state, self.metrics[:, :k].clone()
            return f
        patch(trainer.ResidentStep, "run", run)
    elif fault == "half_batch":  # the loss over half the batch
        def half(old):
            def f(params, batch, generator):
                n = max(1, batch["image_crop"].shape[0] // 2)
                return old(params, {k: v[:n] for k, v in batch.items()},
                           generator)
            return f
        patch(train_posenet, "loss_fn", half)
    elif fault == "no_exchange":  # the gradient all-reduce left out
        patch(mesh, "sum_flat", lambda old: lambda tensors, m: list(tensors))
    elif fault is not None:
        raise ValueError(fault)

    def restore():
        for u in reversed(undo):
            u()
    return restore


def drive(name, fault=None, seconds=2.0, seed=2 ** 31 + 17, rank=0):
    torch.set_num_threads(2)
    run = harness.Run(name, seed, seconds, 0, rank=rank,
                      device=torch.device("cpu"), overrides=SMALL[name])
    run.t0 = time.perf_counter()
    run.start_ranks = lambda: []
    restore = plant(fault)
    try:
        harness.execute(run, importlib.import_module(
            f"benchmark.traffic.{run.workload['generator']}"))
    finally:
        restore()
    correct = bool(run.numbers) and run.failed == 0 and all(
        v <= lim for v, lim in run.numbers.values())
    return correct, {k: v for k, (v, _) in run.numbers.items()}


def rank_main(rank, world, port, name, fault, seed, out):
    """One rank of a data-parallel run over gloo on the CPU."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    result = drive(name, fault, seed=seed, rank=rank)
    if rank == 0:
        out.put(result)
