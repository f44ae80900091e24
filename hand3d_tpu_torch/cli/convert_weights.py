"""One-time converter: reference TF1 weights -> an .npz param tree
(counterpart of tools/convert_weights.py; numpy only, no TensorFlow).

Takes the reference's pickled weight dicts (handsegnet-rhd.pickle,
posenet3d-rhd-stb*.pickle, lifting-<variant>.pickle) and TF checkpoints
(training snapshots, the CPM-MPII warm start with the reference's rename and
discard rules):

    python -m hand3d_tpu_torch.cli.convert_weights --out weights.npz \
        weights/handsegnet-rhd.pickle weights/posenet3d-rhd-stb-slr-finetuned.pickle
    python -m hand3d_tpu_torch.cli.convert_weights --out cpm_posenet.npz \
        --tf-checkpoint weights/cpm-model-mpii --cpm-target posenet
    python -m hand3d_tpu_torch.cli.convert_weights --out snap.npz \
        --tf-checkpoint snapshots_posenet/model-30000 --snapshot
"""

import argparse

from hand3d_tpu_torch.weights import save_npz
from hand3d_tpu_torch.weights.convert import (SNAPSHOT_DISCARD,
                                              convert_cpm_warmstart,
                                              convert_reference_pickles,
                                              flat_to_tree,
                                              load_tf_checkpoint_flat,
                                              tree_to_flat)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pickles", nargs="*", help="Reference .pickle weight files")
    p.add_argument("--out", required=True, help="Output .npz path")
    p.add_argument("--exclude", nargs="*", default=None,
                   help="Substring exclusion list (net.init semantics)")
    p.add_argument("--tf-checkpoint", default=None,
                   help="TF V2 checkpoint prefix (read without tensorflow)")
    p.add_argument("--cpm-target", choices=["posenet", "handsegnet"],
                   default=None,
                   help="Apply the CPM-MPII warm-start rename/discard rules")
    p.add_argument("--snapshot", action="store_true",
                   help="Treat the checkpoint as a training snapshot "
                        "(discard Adam/global_step/beta like the reference)")
    args = p.parse_args(argv)

    tree = {}
    if args.pickles:
        tree = convert_reference_pickles(args.pickles, args.exclude)
    if args.tf_checkpoint:
        discard = SNAPSHOT_DISCARD if args.snapshot else None
        flat = load_tf_checkpoint_flat(args.tf_checkpoint,
                                       discard_list=discard)
        ck_tree = (convert_cpm_warmstart(flat, args.cpm_target)
                   if args.cpm_target else flat_to_tree(flat))
        merged = tree_to_flat(tree)
        merged.update(tree_to_flat(ck_tree))
        tree = flat_to_tree(merged)

    if not tree:
        raise SystemExit("nothing to convert: pass pickles and/or "
                         "--tf-checkpoint")
    save_npz(args.out, tree)
    scopes = {k: len(v) for k, v in tree.items()}
    print(f"Wrote {args.out}: {scopes}")


if __name__ == "__main__":
    main()
