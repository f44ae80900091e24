"""Training snapshots, Orbax checkpoints, resume and params export
(counterpart of hand3d_tpu/train/checkpoints.py).

  * Full-state snapshots ``snapshot-<step>.pt`` hold the params (torch
    layout, on the CPU), the Adam state (``state_dict``) and the step
    counter: tensors, dicts, lists and plain numbers only, so a snapshot
    loads under ``torch.load(weights_only=True)`` and training resumes
    exactly, Adam moments included (the reference's TF Saver snapshots lost
    them on load).
  * Orbax checkpoints ``<directory>/<step>`` hold the same state in the
    JAX package's TrainState layout (``save_orbax`` / ``restore_orbax``):
    the JAX package's checkpoints (OCDBT, zstd) restore here, and the
    port's restore in the JAX package, with no orbax, tensorstore or jax
    on this side (weights/orbax.py, weights/ocdbt.py, weights/zstd.py).
  * ``export_params`` writes a params-only .npz in the JAX package's layout,
    which ``hand3d_tpu.weights.load_npz`` and the port's ``--weights`` read.
"""

import io
import os
import re

import numpy as np
import torch

from hand3d_tpu_torch import weights
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.train.trainer import (ScheduledAdam, TrainState,
                                            tree_leaves, tree_paths,
                                            tree_unflatten)
from hand3d_tpu_torch.weights import orbax

_SNAP_RE = re.compile(r"snapshot-(\d+)\.pt$")


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_snapshot(directory, state, step=None, keep=1):
    """Write ``snapshot-<step>.pt`` into ``directory``; prune older ones.

    The write is atomic: the payload is serialized in memory first (copying
    device tensors, where a wedged device would hang), then written to a
    .tmp file that is fsynced and renamed. A run killed mid-save (step
    watchdog, OOM killer, preemption) leaves no truncated snapshot for
    ``latest_snapshot`` to hand to --resume.
    """
    if keep < 1:
        raise ValueError(f"keep={keep}: the snapshot being written must "
                         "survive its own prune")
    os.makedirs(directory, exist_ok=True)
    step = int(step if step is not None else state.step)
    path = os.path.join(directory, f"snapshot-{step}.pt")
    buf = io.BytesIO()
    torch.save({"params": _to_cpu(state.params),
                "opt_state": _to_cpu(state.opt_state.state_dict()),
                "step": int(state.step)}, buf)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getbuffer())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # prune by step, but never the snapshot just written: a higher-step file
    # of a longer earlier run must not outlive it (it would take the next
    # --resume)
    others = [p for _, p in sorted_snapshots(directory) if p != path]
    for old in others[: max(0, len(others) - (keep - 1))]:
        os.remove(old)
    # orphaned .tmp files of runs killed mid-save (the loop is the one
    # writer)
    for name in os.listdir(directory):
        if name.endswith(".pt.tmp"):
            try:
                os.remove(os.path.join(directory, name))
            except FileNotFoundError:
                pass
    return path


def sorted_snapshots(directory):
    """[(step, path)] of the snapshots in ``directory``, by step."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _SNAP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def latest_snapshot(directory):
    snaps = sorted_snapshots(directory)
    return snaps[-1][1] if snaps else None


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_snapshot(path, template_state):
    """Load ``path`` into ``template_state`` (a TrainState of the same tree,
    as ``trainer.init_state`` makes it): params copied in place, the Adam
    state loaded onto the params' device. Returns the restored TrainState."""
    payload = _load(path)
    saved = payload["params"]
    if tree_paths(saved) != tree_paths(template_state.params):
        raise ValueError(f"{path}: its param tree differs from the "
                         "template's")
    with torch.no_grad():
        for leaf, value in zip(tree_leaves(template_state.params),
                               tree_leaves(saved)):
            leaf.copy_(value)
    template_state.opt_state.load_state_dict(payload["opt_state"])
    return TrainState(template_state.params, template_state.opt_state,
                      int(payload["step"]))


def load_snapshot_params(path):
    """The params of a snapshot as a TF-layout numpy tree, Adam state left
    out: the reference's load_weights_from_snapshot (utils/general.py:
    614-651), so a training snapshot can seed fine-tuning or eval. Takes the
    port's ``snapshot-<step>.pt`` and the JAX package's
    ``snapshot-<step>.msgpack`` (read by weights/flax_msgpack.py)."""
    if str(path).endswith(".msgpack"):
        from hand3d_tpu_torch.weights import flax_msgpack

        return flax_msgpack.load_snapshot_params(path)
    return weights.params_to_jax(_load(path)["params"])


def export_params(path, params):
    """Params-only .npz in the JAX layout (hand3d_tpu.weights.load_npz)."""
    weights.save_npz(path, weights.params_to_jax(params))


def import_params(path):
    """The TF-layout numpy tree of an .npz export."""
    return weights.load_npz(path)


def _refuse_sharded(params):
    if mesh_lib.is_sharded(params):
        raise ValueError("a state sharded over the mesh's 'model' axis: "
                         "gather it whole first (trainer.gather_state)")


def _adam_moments(state):
    """(count, exp_avg leaves, exp_avg_sq leaves) of the port's Adam, in
    ``tree_leaves`` order; a leaf with no Adam state yet has zero moments
    at count 0. Leaves at different counts raise."""
    counts, mu, nu = set(), [], []
    for p in tree_leaves(state.params):
        slot = state.opt_state.state.get(p)
        counts.add(float(slot["step"]) if slot else 0.0)
        mu.append(slot["exp_avg"] if slot else torch.zeros_like(p))
        nu.append(slot["exp_avg_sq"] if slot else torch.zeros_like(p))
    if len(counts) != 1 or not next(iter(counts)).is_integer():
        raise ValueError(f"the Adam state's update counts differ across the "
                         f"params ({sorted(counts)}): Orbax's layout holds "
                         "one count")
    return int(counts.pop()), mu, nu


def _flat(prefix, tree):
    return {prefix + tuple(path.split("/")): value
            for path, value in weights.tree_to_flat(tree).items()}


def save_orbax(directory, state, step=None):
    """Write the TrainState as an Orbax checkpoint at ``directory/<step>``
    (which must not exist) in the JAX package's layout: params and Adam
    moments TF-layout (HWIO / [in, out], ``weights_p2`` for phase-packed
    layers), optax's ``(ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count))`` and an int32 step. The JAX package's
    ``restore_orbax`` reads it (its leaves come back as numpy arrays).
    Returns the path. A state sharded over "model" raises, before anything
    is written."""
    _refuse_sharded(state.params)
    step = int(step if step is not None else state.step)
    count, mu, nu = _adam_moments(state)
    count = np.asarray(count, np.int32)
    leaves = _flat(("params",), weights.params_to_jax(state.params))
    leaves.update(_flat(("opt_state", 0, "mu"), weights.params_to_jax(
        tree_unflatten(state.params, mu))))
    leaves.update(_flat(("opt_state", 0, "nu"), weights.params_to_jax(
        tree_unflatten(state.params, nu))))
    leaves[("opt_state", 0, "count")] = count
    leaves[("opt_state", 1, "count")] = count
    leaves[("step",)] = np.asarray(state.step, np.int32)
    path = os.path.abspath(os.path.join(directory, str(step)))
    return orbax.write_pytree(path, leaves)


def _subtree(leaves, prefix):
    n = len(prefix)
    return {"/".join(map(str, k[n:])): v for k, v in leaves.items()
            if k[:n] == prefix}


def _check_like(path, got, want, what):
    """Raise unless ``got`` ({'/' path: array}) has ``want``'s paths,
    shapes and dtypes."""
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{path}: its {what} tree differs from the "
                         f"template's (missing {missing[:4]}, extra "
                         f"{extra[:4]})")
    for key, value in want.items():
        have = got[key]
        if have.shape != value.shape or have.dtype != value.dtype:
            raise ValueError(
                f"{path}: {what}/{key} is {have.dtype}{list(have.shape)}, "
                f"the template's {value.dtype}{list(value.shape)}")


def _scalar(path, leaves, key):
    if key not in leaves:
        raise ValueError(f"{path}: no {'.'.join(map(str, key))} leaf")
    value = leaves[key]
    if value.shape != () or value.dtype.kind not in "iu":
        raise ValueError(f"{path}: {'.'.join(map(str, key))} is "
                         f"{value.dtype}{list(value.shape)}, not an integer "
                         "scalar")
    return int(value)


def restore_orbax(path, template_state):
    """Restore an Orbax checkpoint of one step (the port's ``save_orbax``
    or the JAX package's, OCDBT or not) into ``template_state``, a
    TrainState of the same tree (``trainer.init_state``): the tree, shapes
    and dtypes are checked against it, a mismatch raising with the path;
    params are copied into its leaves on their device and the Adam moments
    loaded through the optimizer's ``load_state_dict``, its counts on the
    params' device as the trainer keeps them. A fresh JAX state
    (count 0, zero moments) restores as a state at step 0. Returns the
    restored TrainState."""
    _refuse_sharded(template_state.params)
    path = os.fspath(path)
    leaves = orbax.read_pytree(path)
    roots = {k[:2] if k[0] == "opt_state" else k[:1] for k in leaves}
    expected = {("params",), ("step",), ("opt_state", 0), ("opt_state", 1)}
    if roots != expected:
        raise ValueError(f"{path}: not a TrainState of Adam on a schedule "
                         f"(its top-level leaves: {sorted(map(str, roots))})")
    want = weights.tree_to_flat(weights.params_to_jax(template_state.params))
    for prefix in (("params",), ("opt_state", 0, "mu"),
                   ("opt_state", 0, "nu")):
        _check_like(path, _subtree(leaves, prefix), want,
                    "/".join(map(str, prefix)))
    moments = {f"{m}/{k}" for m in ("mu", "nu") for k in want}
    if (set(_subtree(leaves, ("opt_state", 0))) - moments != {"count"}
            or set(_subtree(leaves, ("opt_state", 1))) != {"count"}):
        raise ValueError(f"{path}: its opt_state is not optax's "
                         "(ScaleByAdamState, ScaleByScheduleState)")
    count = _scalar(path, leaves, ("opt_state", 0, "count"))
    if _scalar(path, leaves, ("opt_state", 1, "count")) != count:
        raise ValueError(f"{path}: the Adam and schedule counts differ; the "
                         "port's Adam keeps one")
    step = _scalar(path, leaves, ("step",))

    def torch_leaves(prefix):
        tree = weights.flat_to_tree(_subtree(leaves, prefix))
        return tree_leaves(weights.params_from_jax(tree, "cpu"))

    params = tree_leaves(template_state.params)
    with torch.no_grad():
        for leaf, value in zip(params, torch_leaves(("params",))):
            leaf.copy_(value)
    opt = template_state.opt_state
    saved = opt.state_dict()
    saved["state"] = {
        i: {"step": torch.tensor(float(count)), "exp_avg": m,
            "exp_avg_sq": v}
        for i, (m, v) in enumerate(zip(torch_leaves(("opt_state", 0, "mu")),
                                       torch_leaves(("opt_state", 0, "nu"))))}
    opt.load_state_dict(saved)
    ScheduledAdam.prepare(opt, params)  # counts onto the device
    return TrainState(template_state.params, opt, step)
