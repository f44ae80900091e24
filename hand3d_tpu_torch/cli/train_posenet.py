"""Train PoseNet on RHD ground-truth crops (<- training_posenet.py).

Reference hyperparameters (training_posenet.py:29-42): batch 8, Adam, LR
[1e-4, 1e-5, 1e-6] stepping at [10k, 20k], 30k iterations, GT crops with
coord-uv + crop-center noise, visibility-masked scoremap loss over all three
prediction heads. Optionally warm-starts from --weights.

    python -m hand3d_tpu_torch.cli.train_posenet --data rhd_training.bin \
        --eval-data rhd_evaluation.bin --eval-freq 5000
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
from hand3d_tpu_torch.train.losses import posenet_scoremap_loss
from hand3d_tpu_torch.train.trainer import fuse_preprocess, make_optimizer
from hand3d_tpu_torch.weights import params_from_jax


def loss_fn(params, batch, generator):
    preds = posenet.apply(params[posenet.SCOPE], batch["image_crop"])
    return posenet_scoremap_loss(preds, batch["scoremap"],
                                 batch["keypoint_vis21"])


def setup(argv=None):
    p = base_parser(__doc__)
    add_train_args(p, 30000, [1e-4, 1e-5, 1e-6], [10000, 20000],
                   "snapshots_posenet")
    p.add_argument("--crop-size", type=int, default=256,
                   help="GT crop resolution (reference: 256); smaller "
                        "values are useful for smoke tests")
    add_eval_args(p, "run the GT-crop 2D EPE eval periodically during "
                     "training")
    args = p.parse_args(argv)
    reject_unported(args)
    device = train_device(args)

    dataset = RHDDataset("training", path=args.data)
    cfg = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                           coord_uv_noise=True, crop_center_noise=True,
                           crop_size=args.crop_size)
    pipeline = InputPipeline(dataset, cfg, args.batch_size, seed=args.seed,
                             yield_raw=args.fused, device=device)
    params = params_from_jax(init_or_load(
        {posenet.SCOPE: posenet.init(np.random.default_rng(args.seed))},
        args.weights), device)
    train_loss = maybe_qat(loss_fn, args)
    if args.fused:
        train_loss = fuse_preprocess(train_loss, preprocess_rhd, cfg)

    eval_fn = None
    if args.eval_data:
        from hand3d_tpu_torch.eval.harnesses import eval2d_gt_cropped

        eval_dataset = RHDDataset("evaluation", path=args.eval_data)

        def eval_fn(state, step):
            # the training tree, on the device as it is
            m = eval2d_gt_cropped(
                state.params[posenet.SCOPE], eval_dataset,
                batch_size=args.batch_size, max_batches=args.eval_batches,
                device=device)
            return {k: m[k] for k in
                    ("epe_mean_px", "epe_median_px", "auc_0_30px")}

    return TrainJob(train_loss, params, make_optimizer(args.lr, args.lr_iter),
                    pipeline, args.max_iter,
                    fit_options(args, args.snapshot_dir, eval_fn))


def main(argv=None):
    return run(setup(argv))


if __name__ == "__main__":
    main()
