"""Full-pipeline 3D evaluation on STB or RHD (<- eval_full.py).

Expected with the reference's shipped weights (BASELINE.md rows 12-13):
STB-e: mean 12.210 mm / median 9.405 mm / AUC(0-50) 0.764 / AUC(30-50) 0.941;
RHD-e: 35.606 / 28.686 / 0.424 / 0.603. ``--plot`` renders the paper's
Figure-9 PCK plot against the published STB baselines (needs matplotlib).

    python -m hand3d_tpu_torch.cli.eval_full --dataset stb --data stb_eval.bin \
        --weights weights.npz --batch-size 16
"""

from hand3d_tpu_torch.cli._common import (add_quantize_arg, base_parser,
                                          init_or_load, maybe_quantize,
                                          progress_printer)
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.stb import STBDataset
from hand3d_tpu_torch.eval.harnesses import eval_full_pipeline
from hand3d_tpu_torch.eval.metrics import get_stb_ref_curves
from hand3d_tpu_torch.weights import random_params


def write_plot(metrics, path):
    """The paper's Figure 9: PCK over 20-50 mm beside the STB baselines."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curves = get_stb_ref_curves()
    curves.append((metrics["thresholds_m"][8:] * 1000.0,
                   metrics["pck_curve"][8:],
                   "Ours (AUC=%.3f)" % metrics["auc_20_50mm"]))
    fig, ax = plt.subplots()
    for t, v, name in curves:
        ax.plot(t, v, label=name)
    ax.set_xlabel("threshold in mm")
    ax.set_ylabel("PCK")
    ax.legend(loc="lower right")
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--dataset", choices=["stb", "rhd"], default="stb")
    p.add_argument("--data", default=None, help="Path to the .bin file")
    p.add_argument("--plot", default=None, help="Write Figure-9 PCK plot here")
    add_quantize_arg(p)
    args = p.parse_args(argv)

    if args.dataset == "stb":
        dataset = STBDataset("evaluation", path=args.data)
    else:
        dataset = RHDDataset("evaluation", path=args.data)
    params = maybe_quantize(init_or_load(random_params(args.seed),
                                         args.weights), args)
    metrics = eval_full_pipeline(
        params, dataset, args.batch_size, device=args.device,
        progress=progress_printer(len(dataset), args.batch_size))
    print("Evaluation results")
    print("Average mean EPE: %.3f mm" % metrics["epe_mean_mm"])
    print("Average median EPE: %.3f mm" % metrics["epe_median_mm"])
    print("Area under curve between 0mm - 50mm: %.3f" % metrics["auc_0_50mm"])
    print("Area under curve between 20mm - 50mm: %.3f"
          % metrics["auc_20_50mm"])
    if args.plot and args.dataset == "stb":
        write_plot(metrics, args.plot)
        print(f"Wrote {args.plot}")


if __name__ == "__main__":
    main()
