"""One rank of the port's data-parallel checks on the CPU (gloo).

Run by tests/test_torch_mesh.py, one process per rank:

    python tests/torch_mesh_worker.py RANK WORLD PORT INPUTS.pkl OUT_DIR

It imports torch and the port only (no jax), joins a gloo group at
127.0.0.1:PORT, builds the 2x1 mesh and runs every check of INPUTS.pkl (a
pickle of numpy trees written by the test), then writes what it saw to
OUT_DIR/rank<RANK>.pkl. The test holds those results to JAX and to a single
process.
"""

import hashlib
import os
import pickle
import signal
import sys

import numpy as np
import torch

from hand3d_tpu_torch import parity, weights
from hand3d_tpu_torch.cli import train_handsegnet, train_lifting, train_posenet
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.stb import STBDataset
from hand3d_tpu_torch.eval import harnesses
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.serving import HandPoseEstimator
from hand3d_tpu_torch.train import checkpoints, trainer
from hand3d_tpu_torch.train.loop import fit

TIMEOUT_S = 120


def loss_of(name):
    if name == "posenet":
        return train_posenet.loss_fn
    if name == "handsegnet":
        return train_handsegnet.loss_fn
    return train_lifting.make_loss(name.split(":")[1])[0]


def rows(batch, lo, per):
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + per]))
            for k, v in batch.items()}


def tf_grads(params, grads):
    """Gradients in the TF layout of their params, keyed by path."""
    return {path: weights.params_to_jax({"g": g})["g"]
            for path, g in zip(trainer.tree_paths(params), grads)}


def digest(tree):
    """sha256 of a flat dict of arrays, in key order: what the ranks
    compare to show they are bit-equal."""
    h = hashlib.sha256()
    for key in sorted(tree):
        h.update(key.encode())
        h.update(np.ascontiguousarray(tree[key]).tobytes())
    return h.hexdigest()


def train_stage(spec, mesh, rank):
    """DP steps of one stage from the spec's params over its global
    batches: per step the global loss, this rank's own loss (its rows
    alone), digests of the global gradients and of the params after the
    update, and on rank 0 those gradients and params."""
    loss_fn = loss_of(spec["loss"])
    opt = trainer.make_optimizer([spec["lr"]], [])
    state = trainer.init_state(weights.params_from_jax(spec["params"], "cpu"),
                               opt)
    grads_of = trainer.DataParallelGrads(loss_fn, mesh,
                                         accum_steps=spec["accum"])
    out = []
    for i, batch in enumerate(spec["batches"]):
        n = len(next(iter(batch.values())))
        lo, per = mesh_lib.shard_rows(mesh, n)
        local = rows(batch, lo, per)
        with torch.no_grad():
            own = loss_fn(state.params, local, None).item()
        loss, grads = grads_of(state.params, local, (0, i))
        opt.apply(state.opt_state, state.params, grads, state.step)
        state = state._replace(step=state.step + 1)
        grads = tf_grads(state.params, grads)
        params = weights.tree_to_flat(weights.params_to_jax(state.params))
        out.append({"loss": loss.item(), "own_loss": own,
                    "digest": (digest(grads), digest(params))})
        if rank == 0:
            out[-1].update(grads=grads, params=params)
    return out


def recorded_eval(run):
    """(metrics, dists fed to EvalUtil) of a harness call."""
    fed = []
    base = harnesses.EvalUtil

    class Recording(base):
        def feed_batch(self, dists, vis):
            fed.append(np.asarray(dists))
            super().feed_batch(dists, vis)

    harnesses.EvalUtil = Recording
    try:
        metrics = run()
    finally:
        harnesses.EvalUtil = base
    return metrics, np.concatenate(fed)


def evals(spec, mesh):
    out = {}
    out["gt_cropped"] = recorded_eval(lambda: harnesses.eval2d_gt_cropped(
        spec["posenet_params"], RHDDataset("evaluation", spec["rhd"]),
        spec["batch"], mesh=mesh, device="cpu"))
    out["full"] = recorded_eval(lambda: harnesses.eval_full_pipeline(
        spec["cascade_params"], STBDataset("evaluation", spec["stb"]),
        spec["batch"], mesh=mesh, device="cpu"))
    return out


def serve(spec, mesh):
    """The estimator's answers on every rank, and the cascade's fields of
    each padded batch from this rank's rows, gathered over the ranks."""
    images, b = spec["images"], spec["batch"]
    est = HandPoseEstimator(spec["params"], batch_size=b,
                            input_hw=images.shape[1:3], mesh=mesh,
                            device="cpu")
    served = est.predict(images)
    lo, per = mesh_lib.shard_rows(mesh, b)
    norm = np.pad(images.astype(np.float32) / 255.0 - 0.5,
                  ((0, -len(images) % b), (0, 0), (0, 0), (0, 0)))
    side = torch.tensor([[1.0, 0.0]] * per)
    chunks = []
    for start in range(0, len(norm), b):
        mine = torch.from_numpy(norm[start + lo:start + lo + per])
        fields = parity.port_fields(est.params, mine, side)
        chunks.append({k: v.numpy() for k, v in mesh_lib.gather_rows(
            {k: torch.from_numpy(v) for k, v in fields.items()},
            mesh).items()})
    return {"served": served, "fields": chunks}


def preempted_fit(spec, rank):
    """train_posenet through its CLI on the mesh, with a SIGTERM sent to
    rank 1 alone while it computes step 2: every rank must stop and
    snapshot at the same step."""
    job = train_posenet.setup([
        "--data", spec["rhd"], "--device", "cpu", "--crop-size", "32",
        "--batch-size", "1", "--max-iter", "8", "--mesh", "2x1",
        "--show-loss-freq", "1", "--snapshot-dir", spec["dir"],
        "--snapshot-freq", "100", "--metrics-log",
        os.path.join(spec["dir"], "m.jsonl")])
    calls = []
    loss = job.loss

    def signalled(params, batch, generator):
        calls.append(1)
        if rank == 1 and len(calls) == 3:  # step 2's forward
            os.kill(os.getpid(), signal.SIGTERM)
        return loss(params, batch, generator)

    lines = []
    try:
        state = fit(signalled, job.params, job.optimizer, job.pipeline,
                    job.max_iter, log=lines.append, **job.options)
    finally:
        if job.options["metrics_logger"] is not None:
            job.options["metrics_logger"].close()
    return {"step": state.step, "lines": lines,
            "snapshots": [s for s, _ in
                          checkpoints.sorted_snapshots(spec["dir"])]}


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    inputs, out_dir = sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)
    with open(inputs, "rb") as f:
        spec = pickle.load(f)
    mesh_lib.init_distributed(f"127.0.0.1:{port}", world, rank,
                              backend="gloo", timeout=TIMEOUT_S)
    mesh = mesh_lib.make_mesh(world, 1)
    out = {"stages": {name: train_stage(s, mesh, rank)
                      for name, s in spec["stages"].items()},
           "eval": evals(spec["eval"], mesh),
           "serve": serve(spec["serve"], mesh),
           "fit": preempted_fit(spec["fit"], rank)}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
