"""Train a PosePriorNetwork lifting variant on RHD (<- training_lifting.py).

Reference hyperparameters (training_lifting.py:36-51): batch 8, Adam, LR
[1e-5, 1e-6] stepping at [60k], 80k iterations; inputs are GT scoremaps of
noisy GT crops (coord-uv, crop-center, crop-offset, crop-scale noise); the
loss depends on the variant (train.losses.lifting_loss).

    python -m hand3d_tpu_torch.cli.train_lifting --data rhd_training.bin \
        --variant proposed
"""

import numpy as np

from hand3d_tpu_torch.cli._common import (TrainJob, add_eval_args,
                                          add_train_args, base_parser,
                                          fit_options, init_or_load, maybe_qat,
                                          reject_unported, run, train_device)
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import InputPipeline
from hand3d_tpu_torch.data.preprocess import preprocess_rhd
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.models.poseprior import VARIANTS, PosePriorNetwork
from hand3d_tpu_torch.train.losses import lifting_loss
from hand3d_tpu_torch.train.trainer import fuse_preprocess, make_optimizer
from hand3d_tpu_torch.weights import params_from_jax


def make_loss(variant, dropout=False):
    net = PosePriorNetwork(variant)

    def loss_fn(params, batch, generator):
        # dropout off by default: the reference trained with it off
        # (training_lifting.py:54-56 never feeds its evaluation placeholder)
        out = net.apply(params, batch["scoremap"], batch["hand_side"],
                        train=dropout, generator=generator)
        return lifting_loss(variant, out, batch)

    return loss_fn, net


def setup(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--variant", choices=VARIANTS, default="proposed")
    p.add_argument("--dropout", action="store_true",
                   help="Enable the FC towers' dropout during training. OFF "
                        "by default because the reference's executed "
                        "training graph never activates it (the evaluation "
                        "placeholder defaults True and training_lifting.py "
                        "never feeds it).")
    add_train_args(p, 80000, [1e-5, 1e-6], [60000], None)
    add_eval_args(p, "run the GT-scoremap 3D EPE eval periodically during "
                     "training")
    args = p.parse_args(argv)
    reject_unported(args)
    device = train_device(args)
    snapshot_dir = args.snapshot_dir or f"snapshots_lifting_{args.variant}"

    dataset = RHDDataset("training", path=args.data)
    cfg = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                           coord_uv_noise=True, crop_center_noise=True,
                           crop_offset_noise=True, crop_scale_noise=True)
    pipeline = InputPipeline(dataset, cfg, args.batch_size, seed=args.seed,
                             yield_raw=args.fused, device=device)
    loss_fn, net = make_loss(args.variant, args.dropout)
    params = params_from_jax(init_or_load(
        net.init(np.random.default_rng(args.seed)), args.weights), device)
    train_loss = maybe_qat(loss_fn, args)
    if args.fused:
        train_loss = fuse_preprocess(train_loss, preprocess_rhd, cfg)

    eval_fn = None
    if args.eval_data:
        from hand3d_tpu_torch.eval.harnesses import eval3d_lifting

        eval_dataset = RHDDataset("evaluation", path=args.eval_data)

        def eval_fn(state, step):
            m = eval3d_lifting(
                args.variant, state.params, eval_dataset,
                batch_size=args.batch_size, max_batches=args.eval_batches,
                device=device)
            return {k: m[k] for k in
                    ("epe_mean_mm", "epe_median_mm", "auc_0_50mm")}

    return TrainJob(train_loss, params, make_optimizer(args.lr, args.lr_iter),
                    pipeline, args.max_iter,
                    fit_options(args, snapshot_dir, eval_fn))


def main(argv=None):
    return run(setup(argv))


if __name__ == "__main__":
    main()
