"""Numerics checks and failure detection (counterpart of
hand3d_tpu/utils/debug.py).

The reference's only numeric guard was tf.check_numerics on FC weights
(utils/general.py:122-127). Here:
  * ``all_finite(tree)`` -- one bool tensor: every floating leaf is finite
    (no host read, so it can sit inside a step);
  * ``check_finite_pytree(tree, name)`` -- host-side hard check for
    snapshots and exports, raising FloatingPointError naming the first bad
    leaf, in the JAX package's words;
  * ``enable_nan_debugging()`` -- ``torch.autograd.set_detect_anomaly``.
"""

import numpy as np
import torch


def enable_nan_debugging(enabled=True):
    """Make autograd fail loudly where a NaN appears (slow; debugging only):
    ``torch.autograd.set_detect_anomaly(True)``.

    Unlike JAX's ``jax_debug_nans``, which checks the output of every jitted
    primitive, anomaly mode checks only the BACKWARD pass: it raises when a
    backward function returns NaN and names the forward op that made it. A
    NaN made in a forward pass that no gradient flows through (inference,
    eval, ``torch.no_grad``), an inf that never turns into a NaN, and a NaN
    in the optimizer's update are not caught; check those with
    ``all_finite`` / ``check_finite_pytree``.
    """
    torch.autograd.set_detect_anomaly(enabled)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict / list / tuple tree, dict keys
    sorted and sequence positions written "[i]" (jax.tree_util's order and
    key names)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, path + (f"[{i}]",))
    elif tree is not None:
        yield path, tree


def _floating(x):
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def all_finite(tree):
    """Scalar bool tensor: every floating leaf of ``tree`` (tensors or
    arrays) is finite; True when there is none. Computed where the tensors
    lie, with no host read."""
    flags = [torch.isfinite(torch.as_tensor(x)).all()
             for _, x in _leaves(tree) if _floating(x)]
    if not flags:
        return torch.tensor(True)
    device = flags[0].device
    return torch.stack([f.to(device) for f in flags]).all()


def check_finite_pytree(tree, name="pytree"):
    """Host side: raise FloatingPointError naming the first leaf (in sorted
    key order) that holds a non-finite value; return ``tree``."""
    for path, leaf in _leaves(tree):
        if not _floating(leaf):
            continue
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        if not np.isfinite(arr).all():
            keys = "/".join(str(p) for p in path)
            raise FloatingPointError(f"non-finite values in {name}:{keys}")
    return tree
