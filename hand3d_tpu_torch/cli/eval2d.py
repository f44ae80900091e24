"""HandSegNet + PoseNet full-image 2D evaluation (<- eval2d.py).

Expected with the reference's shipped weights (BASELINE.md rows 3-5):
paper setting (--wrist --scale-to-size): 17.041 / 5.833 / 0.663;
corrected (--no-wrist --scale-to-size): 16.561 / 5.275 / 0.679;
corrected, 320x320 frame (--no-wrist, no scaling): 18.741 / 6.745 / 0.635.

    python -m hand3d_tpu_torch.cli.eval2d --data rhd_evaluation.bin \
        --weights weights.npz --batch-size 16
"""

from hand3d_tpu_torch.cli._common import (add_quantize_arg, base_parser,
                                          init_or_load, maybe_quantize,
                                          progress_printer)
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.eval.harnesses import eval2d_full_image
from hand3d_tpu_torch.weights import random_params


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--data", default=None, help="Path to rhd_evaluation.bin")
    p.add_argument("--wrist", dest="wrist", action="store_true", default=True)
    p.add_argument("--no-wrist", dest="wrist", action="store_false")
    p.add_argument("--scale-to-size", dest="scale_to_size",
                   action="store_true", default=True)
    p.add_argument("--no-scale-to-size", dest="scale_to_size",
                   action="store_false")
    add_quantize_arg(p)
    args = p.parse_args(argv)

    dataset = RHDDataset("evaluation", path=args.data)
    params = maybe_quantize(init_or_load(
        random_params(args.seed), args.weights,
        exclude_var_list=["PosePrior", "ViewpointNet"]), args)
    metrics = eval2d_full_image(
        params, dataset, args.batch_size, use_wrist_coord=args.wrist,
        scale_to_size=args.scale_to_size, device=args.device,
        progress=progress_printer(len(dataset), args.batch_size))
    print("Evaluation results:")
    print("Average mean EPE: %.3f pixels" % metrics["epe_mean_px"])
    print("Average median EPE: %.3f pixels" % metrics["epe_median_px"])
    print("Area under curve: %.3f" % metrics["auc_0_30px"])


if __name__ == "__main__":
    main()
