"""PoseNet-only 2D evaluation on ground-truth crops (<- eval2d_gt_cropped.py).

Expected with the reference's shipped weights (BASELINE.md row 1):
mean EPE 9.135 px / median 5.001 px / AUC(0-30px) 0.724; retrained (row 2):
7.630 / 3.939 / 0.771.

    python -m hand3d_tpu_torch.cli.eval2d_gt_cropped --data rhd_evaluation.bin \
        --weights weights.npz
"""

import numpy as np

from hand3d_tpu_torch.cli._common import (add_mesh_arg, add_quantize_arg,
                                          base_parser, eval_mesh,
                                          init_or_load, maybe_quantize,
                                          progress_printer)
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.eval.harnesses import eval2d_gt_cropped
from hand3d_tpu_torch.models import posenet


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--data", default=None, help="Path to rhd_evaluation.bin")
    add_quantize_arg(p)
    add_mesh_arg(p)
    args = p.parse_args(argv)
    mesh = eval_mesh(args)

    dataset = RHDDataset("evaluation", path=args.data)
    params = maybe_quantize(init_or_load(
        {posenet.SCOPE: posenet.init(np.random.default_rng(args.seed))},
        args.weights,
        exclude_var_list=["PosePrior", "ViewpointNet", "HandSegNet"]), args)
    metrics = eval2d_gt_cropped(
        params[posenet.SCOPE], dataset, args.batch_size, mesh=mesh,
        device=args.device,
        progress=progress_printer(len(dataset), args.batch_size))
    print("Evaluation results:")
    print("Average mean EPE: %.3f pixels" % metrics["epe_mean_px"])
    print("Average median EPE: %.3f pixels" % metrics["epe_median_px"])
    print("Area under curve: %.3f" % metrics["auc_0_30px"])


if __name__ == "__main__":
    main()
