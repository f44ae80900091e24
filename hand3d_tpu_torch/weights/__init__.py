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


def params_from_jax(tree, device):
    """TF-layout numpy tree -> float32 torch tree on ``device``.

    Conv kernels go HWIO -> OIHW; dense kernels stay [in, out]. Layer dicts
    other than the float {"weights", "biases"} layout (int8, QAT or
    phase-packed) are not ported and raise.
    """
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = params_from_jax(value, device)
            continue
        if key not in ("weights", "biases"):
            raise ValueError(f"unsupported parameter {key!r}: only the float "
                             "weights/biases layout is ported")
        arr = np.asarray(value, np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[key] = torch.tensor(arr, device=device)
    return out


def params_to_jax(tree):
    """Torch tree -> TF-layout float32 numpy tree, the inverse of
    :func:`params_from_jax`: conv kernels go OIHW -> HWIO."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = params_to_jax(value)
            continue
        arr = value.detach().cpu().numpy().astype(np.float32)
        out[key] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
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
