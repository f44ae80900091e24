"""One rank of the port's scale-out checks on the CPU (gloo, four ranks).

Run by tests/test_torch_parallel.py, one process per rank:

    python tests/torch_parallel_worker.py RANK WORLD PORT INPUTS.pkl OUT_DIR

It imports torch and the port only (no jax), joins a gloo group at
127.0.0.1:PORT and runs every check of INPUTS.pkl (numpy trees and batches
written by the test) on the meshes the test names: tensor parallelism on
1x4 and 2x2, the multislice meshes 2x1x2 and 2x2x1, spatial partitioning,
GPipe on a 2x2 ("data", "stage") mesh, the expert-parallel MoE layer on a
2x2 ("data", "expert") mesh, the estimator, eval2d_gt_cropped, fit with a
snapshot and its resume on another mesh, and the CLIs with --mesh 2x2. It
writes what it saw to OUT_DIR/rank<RANK>.pkl; the test holds that to JAX
and to one process.
"""

import contextlib
import hashlib
import io
import os
import pickle
import sys

import numpy as np
import torch

from hand3d_tpu_torch import parity, weights
from hand3d_tpu_torch.cli import (eval2d, eval2d_gt_cropped, eval3d,
                                  eval_full, train_handsegnet, train_joint,
                                  train_lifting, train_posenet)
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.eval import harnesses
from hand3d_tpu_torch.models import handsegnet
from hand3d_tpu_torch.ops import nn
from hand3d_tpu_torch.parallel import collectives, expert, pipeline
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.serving import HandPoseEstimator
from hand3d_tpu_torch.train import checkpoints, losses, trainer
from hand3d_tpu_torch.train.loop import fit

TIMEOUT_S = 120


def digest(tree):
    """sha256 of a flat dict of arrays, in key order."""
    h = hashlib.sha256()
    for key in sorted(tree):
        h.update(key.encode())
        h.update(np.ascontiguousarray(tree[key]).tobytes())
    return h.hexdigest()


def flat_tf(tree):
    """A whole torch tree as TF-layout arrays keyed by '/'-joined path."""
    return weights.tree_to_flat(weights.params_to_jax(tree))


def local_shapes(tree):
    return {p: tuple(t.shape) for p, t in zip(trainer.tree_paths(tree),
                                              trainer.tree_leaves(tree))}


def whole_grads(mesh, params, grads):
    """Gradients of a sharded tree, gathered whole, TF layout by path."""
    return flat_tf(mesh_lib.gather_params(
        mesh, trainer.tree_unflatten(params, grads)))


def rows(batch, lo, per):
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + per]))
            for k, v in batch.items()}


def report(rank, full, **small):
    """Digests on every rank, the arrays on rank 0."""
    out = dict(small, digest=digest(full))
    if rank == 0:
        out["full"] = full
    return out


def loss_of(name):
    if name.startswith("posenet"):
        return train_posenet.loss_fn
    if name == "handsegnet":
        return train_handsegnet.loss_fn
    return train_lifting.make_loss(name.split(":")[1])[0]


def train_stage(spec, mesh, rank):
    """Steps of one stage on the 2x2 mesh (TP over "model"): per step the
    loss and the whole gradients and params after it; the local shapes."""
    opt = trainer.make_optimizer([spec["lr"]], [])
    state = trainer.shard_state(mesh, trainer.init_state(
        weights.params_from_jax(spec["params"], "cpu"), opt))
    grads_of = trainer.DataParallelGrads(loss_of(spec["loss"]), mesh,
                                         accum_steps=spec["accum"])
    out = {"shapes": local_shapes(state.params), "steps": []}
    for i, batch in enumerate(spec["batches"]):
        lo, per = mesh_lib.shard_rows(mesh, len(next(iter(batch.values()))))
        loss, grads = grads_of(state.params, rows(batch, lo, per), (0, i))
        opt.apply(state.opt_state, state.params, grads, state.step)
        state = state._replace(step=state.step + 1)
        g = whole_grads(mesh, state.params, grads)
        p = flat_tf(mesh_lib.gather_params(mesh, state.params))
        step = {"loss": loss.item(), "digest": (digest(g), digest(p))}
        if rank == 0:
            step.update(grads=g, params=p)
        out["steps"].append(step)
    return out


def dense_grads(spec, mesh, rank, conv):
    """Gradients of the TP test layers (conv 8->256 + fc 256->128, or the fc
    alone) on ``mesh``, whole, and this rank's local shapes."""
    params = trainer.shard_state(mesh, trainer.init_state(
        weights.params_from_jax(spec["params"], "cpu"),
        trainer.make_optimizer([1.0], []))).params
    x = spec["x"]

    def loss(p, batch, generator):
        h = batch["x"]
        if conv:
            h = nn.conv2d_relu(h.permute(0, 3, 1, 2), p["conv"])
            h = h.mean(dim=(2, 3))
        return losses.batch_mean(torch.square(nn.dense_relu(h, p["fc"])))

    lo, per = mesh_lib.shard_rows(mesh, len(x))
    _, grads = trainer.DataParallelGrads(loss, mesh)(
        params, rows({"x": x}, lo, per), (0, 0))
    g = whole_grads(mesh, params, grads)
    return report(rank, g, shapes=local_shapes(params),
                  batch_shards=mesh_lib.batch_shard_count(mesh))


def layer_checks(spec, mesh, rank):
    """Each sharded layout through ``ops.nn`` on the 2x2 mesh: a float, an
    int8 and a QAT conv, an int8 dense and a transposed conv, this rank's
    output of the whole input (the layers' tree sharded, then run)."""
    from hand3d_tpu_torch.ops import quant

    whole = weights.params_from_jax(spec["params"], "cpu")
    q = quant.quantize_params_int8(
        {k: whole[k] for k in ("conv", "fc")}, min_in_chan=0)
    trees = {"float": whole, "int8": q, "qat": quant.qat_view(whole)}
    x = torch.from_numpy(spec["x"])
    h = torch.from_numpy(spec["h"])
    out = {}
    for name, tree in trees.items():
        sharded = (quant.qat_view(mesh_lib.shard_params(mesh, whole))
                   if name == "qat" else mesh_lib.shard_params(mesh, tree))
        out[f"{name}/conv"] = nn.conv2d(x, sharded["conv"]).numpy()
        out[f"{name}/fc"] = nn.dense(h, sharded["fc"]).numpy()
        out[f"{name}/shard"] = mesh_lib.SHARD_KEY in sharded["conv"]
    up = mesh_lib.shard_params(mesh, {"up": whole["up"]})["up"]
    out["float/up"] = nn.conv2d_transpose(x, up).numpy()
    out["up_dims"] = up[mesh_lib.SHARD_KEY].dims
    return report(rank, {k: v for k, v in out.items()
                         if isinstance(v, np.ndarray)},
                  **{k: v for k, v in out.items()
                     if not isinstance(v, np.ndarray)})


def sp_checks(spec, mesh, rank):
    """HandSegNet with its activations split by rows over "model": the
    output (gathered over the batch) and the gradients of a DP+SP step;
    the errors of heights that do not divide."""
    params = trainer.init_state(weights.params_from_jax(spec["params"], "cpu"),
                                trainer.make_optimizer([1.0], [])).params
    constrain = mesh_lib.spatial_constrainer(mesh)
    batch = spec["batch"]
    lo, per = mesh_lib.shard_rows(mesh, len(batch["image"]))
    mine = rows(batch, lo, per)
    with torch.no_grad():
        seg = handsegnet.apply(params, mine["image"], constrain=constrain)[0]
    seg = mesh_lib.gather_rows({"seg": seg}, mesh)["seg"].numpy()

    def loss(p, b, generator):
        return losses.handsegnet_loss(
            handsegnet.apply(p, b["image"], constrain=constrain),
            b["hand_mask"])

    _, grads = trainer.DataParallelGrads(loss, mesh)(params, mine, (0, 0))
    g = flat_tf(trainer.tree_unflatten(params, grads))
    errors = {}
    for h in spec["bad_heights"]:
        try:
            handsegnet.apply(params, torch.zeros(1, h, 64, 3),
                             constrain=constrain)
        except ValueError as e:
            errors[h] = str(e)
    return report(rank, {"seg": seg, **{f"grad/{k}": v for k, v in g.items()}},
                  errors=errors)


def pp_checks(spec, rank):
    """GPipe on a 2x2 ("data", "stage") mesh: the loss at each n_micro, the
    gradients at n_micro 2, whole; the local shapes of the stage."""
    mesh = pipeline.make_pipeline_mesh(2, 2)
    params = weights.params_from_jax(spec["params"], "cpu")
    trunk, stacked = pipeline.stack_refinement_params(params)
    local = pipeline.shard_refinement_params(mesh, stacked)
    trunk = trainer.tree_map(lambda t: t.requires_grad_(True), trunk)
    local = trainer.tree_map(lambda t: t.requires_grad_(True), local)
    n = len(spec["image"])
    per = n // mesh_lib.process_count()
    lo = mesh_lib.process_index() * per
    args = [torch.from_numpy(np.ascontiguousarray(spec[k][lo:lo + per]))
            for k in ("image", "gt", "vis")]
    out = {"losses": {}, "stage_shapes": local_shapes(local)}
    for n_micro in spec["n_micro"]:
        loss_fn = pipeline.posenet_pipeline_loss(mesh, n_micro)
        if n_micro != spec["grad_n_micro"]:
            with torch.no_grad():
                out["losses"][n_micro] = loss_fn(trunk, local, *args).item()
            continue
        loss = loss_fn(trunk, local, *args)
        out["losses"][n_micro] = loss.item()
        t_leaves, s_leaves = (trainer.tree_leaves(trunk),
                              trainer.tree_leaves(local))
        grads = torch.autograd.grad(loss, t_leaves + s_leaves)
        g_trunk, g_stage = pipeline.reduce_pipeline_grads(
            mesh, grads[:len(t_leaves)], grads[len(t_leaves):])
        stage_group = mesh.get_group(pipeline.STAGE_AXIS)
        g_stacked = trainer.tree_unflatten(local, [
            collectives.all_gather(g, stage_group, 0) for g in g_stage])
        whole = pipeline.unstack_refinement_params(
            trainer.tree_unflatten(trunk, g_trunk), g_stacked)
        grads_tf = flat_tf(whole)
    return report(rank, grads_tf, **out)


def ep_checks(spec, rank):
    """The MoE layer on a 2x2 ("data", "expert") mesh: each capacity
    factor's outputs (gathered) and aux loss, and the gradients of
    mean(out^2) + 0.01 aux at the first one."""
    mesh = expert.make_expert_mesh(2, 2)
    whole = trainer.tree_map(lambda t: t.requires_grad_(True),
                             weights.params_from_jax(spec["params"], "cpu"))
    params = expert.shard_expert_params(mesh, whole)
    params["experts"] = trainer.tree_map(lambda t: t.requires_grad_(True),
                                         params["experts"])
    x = spec["x"]
    per = len(x) // mesh_lib.process_count()
    lo = mesh_lib.process_index() * per
    mine = torch.from_numpy(x[lo:lo + per])
    out = {}
    world = torch.distributed.group.WORLD
    for i, cf in enumerate(spec["capacity_factors"]):
        y, aux = expert.moe_dense_apply(mesh, params, mine, cf)
        full = collectives.all_gather(y, world, 0)
        out[f"out/{cf}"] = full.detach().numpy()
        out[f"aux/{cf}"] = np.float32(aux.item())
        if i == 0:
            loss = y.square().sum() / full.numel() + 0.01 * aux
            gate = trainer.tree_leaves(params["gate"])
            exp = trainer.tree_leaves(params["experts"])
            grads = torch.autograd.grad(loss, gate + exp)
            g_gate, g_exp = expert.reduce_expert_grads(
                mesh, grads[:len(gate)], grads[len(gate):])
            group = mesh.get_group(expert.EXPERT_AXIS)
            g = {"gate": trainer.tree_unflatten(params["gate"], g_gate),
                 "experts": trainer.tree_unflatten(params["experts"], [
                     collectives.all_gather(t, group, 0) for t in g_exp])}
            out.update({f"grad/{k}": v for k, v in flat_tf(g).items()})
            out["expert_slab"] = tuple(params["experts"]["weights"].shape)
    slab = out.pop("expert_slab")
    return report(rank, out, expert_slab=slab)


def serve(spec, mesh):
    """The estimator's answers on every rank, and the cascade's fields of
    each padded batch from this rank's rows, gathered over the batch."""
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
    return {"served": served, "fields": chunks,
            "sharded": mesh_lib.is_sharded(est.params)}


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


def fit_and_resume(spec, rank):
    """train_posenet on the 2x2 mesh for 2 steps; rank 0's snapshot against
    the gathered state; then --resume on a 4x1 mesh for one more step."""
    d = spec["dir"]

    def run(mesh, max_iter, *extra):
        job = train_posenet.setup([
            "--data", spec["rhd"], "--device", "cpu", "--crop-size", "32",
            "--batch-size", "1", "--max-iter", str(max_iter), "--mesh",
            mesh, "--show-loss-freq", "1", "--snapshot-dir", d,
            "--snapshot-freq", "100", *extra])
        lines = []
        state = fit(job.loss, job.params, job.optimizer, job.pipeline,
                    job.max_iter, log=lines.append, **job.options)
        return job.options["mesh"], state, lines

    mesh, state, _ = run("2x2", 2)
    whole = trainer.gather_state(mesh, state)
    out = {"shapes": local_shapes(state.params)}
    if rank == 0:
        snap = torch.load(os.path.join(d, "snapshot-2.pt"), weights_only=True)
        saved = trainer.tree_leaves(snap["params"])
        out["snapshot_equal"] = (
            trainer.tree_paths(snap["params"])
            == trainer.tree_paths(whole.params)
            and all(torch.equal(a, b) for a, b in
                    zip(saved, trainer.tree_leaves(whole.params))))
        moments = whole.opt_state.state_dict()["state"]
        out["moments_equal"] = all(
            torch.equal(moments[i][k], snap["opt_state"]["state"][i][k])
            for i in moments for k in ("exp_avg", "exp_avg_sq"))
        out["moments_shapes_whole"] = all(
            moments[i]["exp_avg"].shape == saved[i].shape for i in moments)
    torch.distributed.barrier()
    mesh, state, lines = run("4x1", 3, "--resume")
    out["resumed"] = {"step": state.step, "lines": lines,
                      "snapshots": [s for s, _ in
                                    checkpoints.sorted_snapshots(d)]}
    return out


def clis(spec):
    """The four trainers and the four eval CLIs with --mesh 2x2: their
    printed lines."""
    data, tmp = spec["rhd"], spec["dir"]
    train_flags = {train_posenet: ["--crop-size", "32"],
                   train_handsegnet: [],
                   train_lifting: ["--variant", "local"],
                   train_joint: ["--crop-size", "32"]}
    out = {}
    for module, extra in train_flags.items():
        name = module.__name__.rsplit(".", 1)[1]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state = module.main([
                "--data", data, "--device", "cpu", "--batch-size", "1",
                "--max-iter", "1", "--show-loss-freq", "1", "--mesh", "2x2",
                "--snapshot-dir", os.path.join(tmp, name), *extra])
        out[name] = {"lines": buf.getvalue().splitlines(),
                     "sharded": mesh_lib.is_sharded(state.params)}
    for module, extra in ((eval2d, []), (eval2d_gt_cropped, []),
                          (eval3d, []), (eval_full, ["--dataset", "rhd"])):
        name = module.__name__.rsplit(".", 1)[1]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            module.main(["--data", data, "--device", "cpu", "--batch-size",
                         "2", "--mesh", "2x2", *extra])
        out[name] = {"lines": buf.getvalue().splitlines()}
    return out


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    inputs, out_dir = sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    with open(inputs, "rb") as f:
        spec = pickle.load(f)
    mesh_lib.init_distributed(f"127.0.0.1:{port}", world, rank,
                              backend="gloo", timeout=TIMEOUT_S)
    mesh = mesh_lib.make_mesh(2, 2)
    out = {
        "tp4": dense_grads(spec["tp4"], mesh_lib.make_mesh(1, 4), rank, True),
        "multislice": {
            "2x1x2": dense_grads(spec["ms"], mesh_lib.make_multislice_mesh(
                2, 1, 2), rank, False),
            "2x2x1": dense_grads(spec["ms"], mesh_lib.make_multislice_mesh(
                2, 2, 1), rank, False)},
        "layers": layer_checks(spec["layers"], mesh, rank),
        "stages": {name: train_stage(s, mesh, rank)
                   for name, s in spec["stages"].items()},
        "sp": sp_checks(spec["sp"], mesh, rank),
        "pp": pp_checks(spec["pp"], rank),
        "ep": ep_checks(spec["ep"], rank),
        "serve": serve(spec["serve"], mesh),
        "eval": recorded_eval(lambda: harnesses.eval2d_gt_cropped(
            spec["eval"]["posenet_params"],
            RHDDataset("evaluation", spec["eval"]["rhd"]),
            spec["eval"]["batch"], mesh=mesh, device="cpu")),
        "fit": fit_and_resume(spec["fit"], rank),
        "clis": clis(spec["clis"]),
    }
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
