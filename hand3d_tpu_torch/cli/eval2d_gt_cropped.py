"""PoseNet-only 2D evaluation on ground-truth crops (<- eval2d_gt_cropped.py).

Expected with the reference's shipped weights (BASELINE.md row 1):
mean EPE 9.135 px / median 5.001 px / AUC(0-30px) 0.724; retrained (row 2):
7.630 / 3.939 / 0.771.

    python -m hand3d_tpu_torch.cli.eval2d_gt_cropped --data rhd_evaluation.bin \
        --weights weights.npz
"""

import numpy as np

from hand3d_tpu_torch.cli._common import (base_parser, init_or_load,
                                          progress_printer)
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.eval.harnesses import eval2d_gt_cropped
from hand3d_tpu_torch.models import posenet


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--data", default=None, help="Path to rhd_evaluation.bin")
    args = p.parse_args(argv)

    dataset = RHDDataset("evaluation", path=args.data)
    params = init_or_load(
        {posenet.SCOPE: posenet.init(np.random.default_rng(args.seed))},
        args.weights,
        exclude_var_list=["PosePrior", "ViewpointNet", "HandSegNet"])
    metrics = eval2d_gt_cropped(
        params[posenet.SCOPE], dataset, args.batch_size, device=args.device,
        progress=progress_printer(len(dataset), args.batch_size))
    print("Evaluation results:")
    print("Average mean EPE: %.3f pixels" % metrics["epe_mean_px"])
    print("Average median EPE: %.3f pixels" % metrics["epe_median_px"])
    print("Area under curve: %.3f" % metrics["auc_0_30px"])


if __name__ == "__main__":
    main()
