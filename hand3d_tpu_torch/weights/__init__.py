"""Parameter trees: npz reader, TF layout -> torch, seeded random init.

A param tree is the JAX package's: {scope: {layer: {"weights", "biases"}}}
with TF layouts (conv kernels HWIO, dense kernels [in, out]), as
``hand3d_tpu.weights.save_npz`` writes it and as ``ColorHandPose3D().init``
makes it. This module reads and makes such trees with numpy alone, so the
port runs where jax is not installed. The other formats' readers are
``convert`` (reference pickles, the warm-start rules), ``tf_ckpt`` (TF V2
checkpoints) and ``flax_msgpack`` (the JAX package's training snapshots).
"""

import numpy as np
import torch

from hand3d_tpu_torch.models import handsegnet, posenet, poseprior
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.weights.convert import (  # noqa: F401
    flat_to_tree, tree_to_flat)


def load_npz(path):
    """Param tree of an .npz with '/'-joined keys (hand3d_tpu save_npz)."""
    with np.load(path) as data:
        return flat_to_tree({k: data[k] for k in data.files})


def save_npz(path, tree):
    """Write a TF-layout numpy tree as an .npz with '/'-joined keys, the
    file ``hand3d_tpu.weights.load_npz`` and :func:`load_npz` read."""
    np.savez(path, **tree_to_flat(tree))


# float32 leaves of the float, int8, QAT and phase-packed layer layouts;
# "weights_q" keeps its int8 dtype. Kernels of 4 dims go HWIO <-> OIHW.
_FLOAT_KEYS = ("weights", "biases", "weights_fq", "weight_scale", "act_scale",
               "act_scale_fq", "weights_p2")
_KEYS = _FLOAT_KEYS + ("weights_q",)


def params_from_jax(tree, device):
    """TF-layout numpy tree -> torch tree on ``device``.

    Conv kernels ("weights", "weights_fq", "weights_q", the phase-packed
    "weights_p2" [3, 4, in, 2 out] -> [2 out, in, 3, 4]) go HWIO -> OIHW,
    and the stage-stacked kernels of ``parallel.pipeline`` ([S, kh, kw, in,
    out]) go so stage by stage; dense kernels stay [in, out], the stacked
    experts of ``parallel.expert`` ([E, in, out]) too. "weights_q" stays
    int8, every other leaf (biases, scales) is float32: the int8, QAT and
    phase-packed layouts of the JAX package carry across. Another leaf name
    raises.
    """
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = params_from_jax(value, device)
            continue
        if key not in _KEYS:
            raise ValueError(f"unsupported parameter {key!r}: the port "
                             "carries the float, int8, QAT and phase-packed "
                             "layouts")
        arr = np.asarray(value, np.int8 if key == "weights_q"
                         else np.float32)
        if arr.ndim >= 4:  # [..., kh, kw, in, out] -> [..., out, in, kh, kw]
            lead = tuple(range(arr.ndim - 4))
            arr = arr.transpose(*lead, *(d + len(lead) for d in (3, 2, 0, 1)))
        out[key] = torch.tensor(arr, device=device)
    return out


def params_to_jax(tree):
    """Torch tree -> TF-layout numpy tree, the inverse of
    :func:`params_from_jax`: kernels of 4 dims and more go OIHW -> HWIO
    (stage by stage), "weights_q" stays int8, everything else is float32.
    A tree sharded over a mesh's "model" axis is gathered first
    (``parallel.gather_params``)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = params_to_jax(value)
            continue
        if mesh_lib.is_shard(value):
            raise ValueError("a tree sharded over 'model': gather it first "
                             "(parallel.gather_params)")
        arr = value.detach().cpu().numpy()
        arr = arr.astype(np.int8 if key == "weights_q" else np.float32)
        if arr.ndim >= 4:
            lead = tuple(range(arr.ndim - 4))
            arr = arr.transpose(*lead, *(d + len(lead) for d in (2, 3, 1, 0)))
        out[key] = arr
    return out


def random_params(seed):
    """Seeded TF-layout numpy tree with exactly the names and shapes of
    ``hand3d_tpu.models.cascade.ColorHandPose3D().init(key)``: Xavier-uniform
    kernels, 1e-4 biases. The values differ from jax.random's."""
    rng = np.random.default_rng(seed)
    return {
        handsegnet.SCOPE: handsegnet.init(rng),
        posenet.SCOPE: posenet.init(rng),
        poseprior.POSEPRIOR_SCOPE: poseprior.init_poseprior(rng),
        poseprior.VIEWPOINT_SCOPE: poseprior.init_viewpoint(rng),
    }


def random_lifting_params(variant, seed):
    """Seeded TF-layout numpy tree with the names and shapes of
    ``hand3d_tpu.models.poseprior.PosePriorNetwork(variant).init(key)``."""
    return poseprior.PosePriorNetwork(variant).init(
        np.random.default_rng(seed))
