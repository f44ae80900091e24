"""Shared helpers of the port's CLIs (counterpart of hand3d_tpu/cli/_common.py).

Weights are ``.npz`` files with '/'-joined keys, as the JAX package's
``save_npz`` exports them. Scopes and layers that no file names keep their
seeded random values.
"""

import argparse

from hand3d_tpu_torch.weights import load_npz


def base_parser(description):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there the two "
                        "CUDA kernels run). 'cpu' runs their plain twins.")
    p.add_argument("--weights", nargs="+", default=None,
                   help="Weight files: .npz (the JAX package's export).")
    return p


def load_weight_trees(paths):
    """Merge .npz files into one param tree."""
    merged = {}
    for path in paths:
        if not path.endswith(".npz"):
            raise ValueError(f"{path}: only .npz weights are read by the "
                             "PyTorch port")
        for scope, sub in load_npz(path).items():
            merged.setdefault(scope, {}).update(sub)
    return merged


def init_or_load(params, weight_paths):
    """Overlay the layers of ``weight_paths`` on the seeded tree ``params``,
    for the scopes it has."""
    if weight_paths:
        loaded = load_weight_trees(weight_paths)
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
