"""Average parameter trees: a model soup or a checkpoint average
(counterpart of tools/average_params.py).

    python -m hand3d_tpu_torch.tools.average_params a.npz b.npz --out soup.npz
    python -m hand3d_tpu_torch.tools.average_params \
        --snapshots snapshots_posenet --last 3 --out avg.npz

The uniform average of same-structure .npz param trees, or of the params of
the last K training snapshots in a directory (the port's snapshot-<step>.pt
or the JAX package's snapshot-<step>.msgpack, by step): tail averaging, a
cheap variance reducer for SGD-family training. The output is an .npz weight
file that every estimator, eval CLI and exporter reads.
"""

import argparse
import os
import re

import numpy as np

_SNAPSHOT = re.compile(r"snapshot-(\d+)\.(pt|msgpack)$")


def average_trees(trees):
    """The leafwise mean of TF-layout numpy trees of one structure, in
    each leaf's dtype."""
    from hand3d_tpu_torch.weights import flat_to_tree, tree_to_flat

    if not trees:
        raise ValueError("nothing to average")
    flat = [tree_to_flat(t) for t in trees]
    keys = set(flat[0])
    for i, f in enumerate(flat[1:], 1):
        if set(f) != keys:
            raise ValueError(f"tree {i} structure differs: "
                             f"{sorted(set(f) ^ keys)[:4]} ...")
    avg = {}
    for k in keys:
        stack = [np.asarray(f[k]) for f in flat]
        shapes = {a.shape for a in stack}
        if len(shapes) != 1:
            raise ValueError(f"shape mismatch at {k}: {shapes}")
        avg[k] = np.mean(np.stack(stack), axis=0).astype(stack[0].dtype)
    return flat_to_tree(avg)


def snapshots(directory):
    """[(step, path)] of the .pt and .msgpack snapshots, by step."""
    if not os.path.isdir(directory):
        return []
    return sorted((int(m.group(1)), os.path.join(directory, name))
                  for name in os.listdir(directory)
                  if (m := _SNAPSHOT.match(name)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("npz", nargs="*", help="npz weight files to average")
    p.add_argument("--snapshots", default=None,
                   help="snapshot directory: average the params of the "
                        "last --last snapshots instead of npz files")
    p.add_argument("--last", type=int, default=3)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    from hand3d_tpu_torch.train.checkpoints import load_snapshot_params
    from hand3d_tpu_torch.weights import load_npz, save_npz

    if args.snapshots:
        snaps = snapshots(args.snapshots)[-args.last:]
        if not snaps:
            p.error(f"no snapshots in {args.snapshots}")
        trees = [load_snapshot_params(path) for _, path in snaps]
        print(f"averaging params of {len(snaps)} snapshots: "
              f"{[s for s, _ in snaps]}")
    else:
        if len(args.npz) < 2:
            p.error("need >= 2 npz files (or --snapshots)")
        trees = [load_npz(path) for path in args.npz]
        print(f"averaging {len(trees)} npz trees")

    save_npz(args.out, average_trees(trees))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
