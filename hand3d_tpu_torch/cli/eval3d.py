"""3D lifting-variant evaluation from GT scoremaps (<- eval3d.py).

Expected median EPE with the reference's shipped weights (BASELINE.md rows
7-11): direct 20.848 mm, bottleneck 21.907 mm, local 39.121 mm,
local_w_xyz_loss 21.950 mm, proposed 18.840 mm.

    python -m hand3d_tpu_torch.cli.eval3d --data rhd_evaluation.bin \
        --variant proposed --weights weights.npz
"""

import numpy as np

from hand3d_tpu_torch.cli._common import (add_quantize_arg, base_parser,
                                          init_or_load, maybe_quantize,
                                          progress_printer)
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.eval.harnesses import (eval3d_from_posenet,
                                             eval3d_lifting)
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.models.poseprior import VARIANTS
from hand3d_tpu_torch.weights import random_lifting_params


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--variant", choices=VARIANTS, default="proposed")
    p.add_argument("--data", default=None, help="Path to rhd_evaluation.bin")
    p.add_argument("--from-posenet", action="store_true",
                   help="lift from PoseNet's PREDICTED scoremaps on GT "
                        "crops instead of GT scoremaps (no reference "
                        "analog; weights must include the PoseNet2D scope)")
    add_quantize_arg(p)
    args = p.parse_args(argv)

    dataset = RHDDataset("evaluation", path=args.data)
    progress = progress_printer(len(dataset), args.batch_size)
    if args.from_posenet:
        params = {posenet.SCOPE: posenet.init(
            np.random.default_rng(args.seed))}
        params.update(random_lifting_params(args.variant, args.seed + 1))
        metrics = eval3d_from_posenet(
            args.variant, maybe_quantize(init_or_load(params, args.weights),
                                         args),
            dataset, args.batch_size, device=args.device, progress=progress)
    else:
        params = maybe_quantize(init_or_load(
            random_lifting_params(args.variant, args.seed), args.weights),
            args)
        metrics = eval3d_lifting(args.variant, params, dataset,
                                 args.batch_size, device=args.device,
                                 progress=progress)
    print("Evaluation results for %s:" % args.variant)
    print("Average mean EPE: %.3f mm" % metrics["epe_mean_mm"])
    print("Average median EPE: %.3f mm" % metrics["epe_median_mm"])
    print("Area under curve: %.3f" % metrics["auc_0_50mm"])


if __name__ == "__main__":
    main()
