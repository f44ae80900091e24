"""Joint fine-tuning of PoseNet + the 3D lifting nets, end to end
(counterpart of hand3d_tpu/cli/train_joint.py).

PoseNet runs on GT crops, its PREDICTED final scoremap feeds
PosePrior(+ViewpointNet), and the step descends a weighted sum of the two
stage losses, so the lifting nets learn on the scoremaps they see at
inference and PoseNet learns what the 3D stage needs:

    total = w2d * posenet_scoremap_loss + w3d * lifting_loss(variant)

Defaults follow the stage trainers (batch 8, Adam, lifting-style noise);
warm-start both stages with --weights.

    python -m hand3d_tpu_torch.cli.train_joint --data rhd_training.bin \
        --weights posenet.npz lifting.npz
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
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.models.poseprior import (SCOREMAP_SIZE, VARIANTS,
                                               PosePriorNetwork)
from hand3d_tpu_torch.ops.image import resize_bilinear
from hand3d_tpu_torch.train.losses import lifting_loss, posenet_scoremap_loss
from hand3d_tpu_torch.train.trainer import fuse_preprocess, make_optimizer
from hand3d_tpu_torch.weights import params_from_jax


def make_joint_loss(variant, w2d, w3d, dropout=False):
    prior = PosePriorNetwork(variant)

    def loss_fn(params, batch, generator):
        preds = posenet.apply(params[posenet.SCOPE], batch["image_crop"])
        l2d = posenet_scoremap_loss(preds, batch["scoremap"],
                                    batch["keypoint_vis21"])
        scoremap = preds[-1]
        if scoremap.shape[1] != SCOREMAP_SIZE:
            # 32 at the reference's 256 crop; smaller smoke crops are
            # resized so the FC towers keep their shapes
            scoremap = resize_bilinear(scoremap,
                                       (SCOREMAP_SIZE, SCOREMAP_SIZE))
        # dropout off by default, as the reference's lifting training ran
        lift = prior.apply(params, scoremap, batch["hand_side"],
                           train=dropout, generator=generator)
        return w2d * l2d + w3d * lifting_loss(variant, lift, batch)

    return loss_fn, prior


def setup(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--variant", choices=VARIANTS, default="proposed")
    p.add_argument("--dropout", action="store_true",
                   help="Enable the lifting FC towers' dropout during "
                        "training. OFF by default because the reference's "
                        "executed training graph never activates it "
                        "(training_lifting.py:54-56 leaves the evaluation "
                        "placeholder at its default True).")
    add_train_args(p, 40000, [1e-5, 1e-6], [30000], None)
    p.add_argument("--w2d", type=float, default=1.0,
                   help="weight of the PoseNet scoremap loss")
    p.add_argument("--w3d", type=float, default=1.0,
                   help="weight of the lifting loss")
    p.add_argument("--crop-size", type=int, default=256,
                   help="GT crop resolution (reference: 256); smaller "
                        "values are useful for smoke tests")
    add_eval_args(p, "periodically eval 3D EPE of lifting from PREDICTED "
                     "scoremaps on GT crops (the hand-off this stage "
                     "fine-tunes)")
    args = p.parse_args(argv)
    reject_unported(args)
    device = train_device(args)
    snapshot_dir = args.snapshot_dir or f"snapshots_joint_{args.variant}"

    dataset = RHDDataset("training", path=args.data)
    cfg = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                           coord_uv_noise=True, crop_center_noise=True,
                           crop_offset_noise=True, crop_scale_noise=True,
                           crop_size=args.crop_size)
    pipeline = InputPipeline(dataset, cfg, args.batch_size, seed=args.seed,
                             yield_raw=args.fused, device=device)
    loss_fn, prior = make_joint_loss(args.variant, args.w2d, args.w3d,
                                     dropout=args.dropout)
    rng = np.random.default_rng(args.seed)
    params = {posenet.SCOPE: posenet.init(rng), **prior.init(rng)}
    params = params_from_jax(init_or_load(params, args.weights), device)
    train_loss = maybe_qat(loss_fn, args)
    if args.fused:
        train_loss = fuse_preprocess(train_loss, preprocess_rhd, cfg)

    eval_fn = None
    if args.eval_data:
        from hand3d_tpu_torch.eval.harnesses import eval3d_from_posenet

        eval_dataset = RHDDataset("evaluation", path=args.eval_data)

        def eval_fn(state, step):
            m = eval3d_from_posenet(
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
