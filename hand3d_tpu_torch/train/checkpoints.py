"""Training snapshots, resume and params export (counterpart of
hand3d_tpu/train/checkpoints.py).

  * Full-state snapshots ``snapshot-<step>.pt`` hold the params (torch
    layout, on the CPU), the Adam state (``state_dict``) and the step
    counter: tensors, dicts, lists and plain numbers only, so a snapshot
    loads under ``torch.load(weights_only=True)`` and training resumes
    exactly, Adam moments included (the reference's TF Saver snapshots lost
    them on load).
  * ``export_params`` writes a params-only .npz in the JAX package's layout,
    which ``hand3d_tpu.weights.load_npz`` and the port's ``--weights`` read.

The JAX package's Orbax checkpoints are a JAX-ecosystem format and are not
ported (ROADMAP.md, out of scope).
"""

import io
import os
import re

import torch

from hand3d_tpu_torch import weights
from hand3d_tpu_torch.train.trainer import TrainState, tree_leaves, tree_paths

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
