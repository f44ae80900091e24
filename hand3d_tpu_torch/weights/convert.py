"""Reference TF1 weights -> the port's param trees (counterpart of
hand3d_tpu/weights/convert.py, numpy and the standard library only).

The reference distributes weights two ways:
  * pickled {variable_name: ndarray} dicts (handsegnet-rhd.pickle,
    posenet3d-rhd-stb*.pickle, lifting-<variant>.pickle), which its net.init
    loads with substring exclusion (nets/ColorHandPose3DNetwork.py:34-59);
  * TF checkpoints (training snapshots and the CPM-MPII warm start), which
    utils/general.load_weights_from_snapshot (:614-651) loads with substring
    discard and rename.

Conversion is structural: 'HandSegNet/conv1_1/weights' becomes a nested dict
path, and the arrays keep their TF layouts (conv kernels HWIO, dense kernels
[in, out]), which ``weights.params_from_jax`` turns into torch's.
"""

import pickle

import numpy as np

_SUFFIXES = (":0",)


def _clean_name(name):
    for suf in _SUFFIXES:
        if name.endswith(suf):
            name = name[: -len(suf)]
    return name


def apply_discard_rename(flat, discard_list=None, rename_dict=None):
    """Substring discard and rename, as general.py:614-651 does them.

    ``discard_list``: drop every variable whose name contains an entry.
    ``rename_dict``: for each (old, new) in order, replace the substring old
    with new in the name as the earlier renames left it.
    """
    out = {}
    for name, value in flat.items():
        if discard_list and any(d in name for d in discard_list):
            continue
        new_name = name
        if rename_dict:
            for old, new in rename_dict.items():
                if old in new_name:
                    new_name = new_name.replace(old, new)
        out[new_name] = value
    return out


def flat_to_tree(flat):
    """{'A/b/weights': arr} -> {'A': {'b': {'weights': arr}}} (a ':0'
    suffix dropped)."""
    tree = {}
    for name, value in flat.items():
        *parents, leaf = _clean_name(name).split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return tree


def tree_to_flat(tree, prefix=""):
    """Inverse of :func:`flat_to_tree`."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(tree_to_flat(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def load_pickle_flat(path, exclude_var_list=None):
    """One reference pickle as a flat {name: ndarray} dict.

    ``exclude_var_list`` drops every name that contains an entry, as
    ColorHandPose3DNetwork.init (:55) does. The pickles were written by
    Python 2, so their numpy arrays need ``encoding="latin1"``.
    """
    with open(path, "rb") as f:
        weight_dict = pickle.load(f, encoding="latin1")
    exclude_var_list = exclude_var_list or []
    return {
        _clean_name(k): np.asarray(v)
        for k, v in weight_dict.items()
        if not any(x in k for x in exclude_var_list)
    }


def convert_reference_pickles(weight_files, exclude_var_list=None,
                              rename_dict=None):
    """Merge reference pickles into one param tree. A later file overrides
    an earlier one on a shared name, as net.init's sequential assignment
    (:51-59) does."""
    flat = {}
    for path in weight_files:
        flat.update(load_pickle_flat(path, exclude_var_list))
    flat = apply_discard_rename(flat, None, rename_dict)
    return flat_to_tree(flat)


def load_tf_checkpoint_flat(checkpoint_path, discard_list=None,
                            rename_dict=None):
    """A TF V2 checkpoint (the CPM-MPII warm start or a reference training
    snapshot) as a flat dict, with load_weights_from_snapshot's discard and
    rename (general.py:614-651). Read by weights/tf_ckpt.py, without
    tensorflow."""
    from hand3d_tpu_torch.weights.tf_ckpt import load_tf_checkpoint

    flat = load_tf_checkpoint(checkpoint_path)
    return apply_discard_rename(flat, discard_list, rename_dict)


# The reference training scripts' warm-start rules. The CPM-MPII person/pose
# model shares the encoders: its variables are renamed into our scopes and
# the heads that do not fit are dropped.
CPM_HANDSEGNET_RENAME = {"CPM/PersonNet": "HandSegNet", "_CPM": ""}
CPM_HANDSEGNET_DISCARD = ["PoseNet", "Mconv", "conv6"]  # training_handsegnet.py:73-75
CPM_POSENET_RENAME = {"CPM/PoseNet": "PoseNet2D", "_CPM": ""}
CPM_POSENET_DISCARD = ["PersonNet", "PoseNet/Mconv", "conv5_2_CPM"]  # training_posenet.py:74-76
SNAPSHOT_DISCARD = ["Adam", "global_step", "beta"]  # eval2d_gt_cropped.py:62


def convert_cpm_warmstart(flat, target="posenet"):
    """The param tree that the reference's CPM-MPII warm start takes from
    ``flat`` ({tf_variable_name: ndarray}) for ``target``, "posenet" or
    "handsegnet"."""
    if target == "posenet":
        flat = apply_discard_rename(flat, CPM_POSENET_DISCARD,
                                    CPM_POSENET_RENAME)
    elif target == "handsegnet":
        flat = apply_discard_rename(flat, CPM_HANDSEGNET_DISCARD,
                                    CPM_HANDSEGNET_RENAME)
    else:
        raise ValueError(f"Unknown warm-start target: {target}")
    return flat_to_tree(flat)
