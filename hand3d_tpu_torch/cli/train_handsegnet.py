"""Train HandSegNet on RHD full frames (<- training_handsegnet.py).

Reference hyperparameters (training_handsegnet.py:29-39): batch 8, Adam, LR
[1e-5, 1e-6, 1e-7] stepping at [20k, 30k], 40k iterations, hue augmentation
+ random 256x256 crops, softmax cross-entropy against the 2-class hand mask.

    python -m hand3d_tpu_torch.cli.train_handsegnet --data rhd_training.bin
"""

import numpy as np

from hand3d_tpu_torch.cli._common import (TrainJob, add_train_args,
                                          base_parser, fit_options,
                                          init_or_load, maybe_qat,
                                          reject_unported, run, train_device)
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import InputPipeline
from hand3d_tpu_torch.data.preprocess import preprocess_rhd
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.models import handsegnet
from hand3d_tpu_torch.train.losses import handsegnet_loss
from hand3d_tpu_torch.train.trainer import fuse_preprocess, make_optimizer
from hand3d_tpu_torch.weights import params_from_jax


def loss_fn(params, batch, generator):
    logits = handsegnet.apply(params[handsegnet.SCOPE], batch["image"])
    return handsegnet_loss(logits, batch["hand_mask"])


def setup(argv=None):
    p = base_parser(__doc__)
    add_train_args(p, 40000, [1e-5, 1e-6, 1e-7], [20000, 30000],
                   "snapshots_handsegnet")
    args = p.parse_args(argv)
    reject_unported(args)
    device = train_device(args)

    dataset = RHDDataset("training", path=args.data)
    cfg = PreprocessConfig(hue_aug=True, random_crop_to_size=True)
    pipeline = InputPipeline(dataset, cfg, args.batch_size, seed=args.seed,
                             yield_raw=args.fused, device=device)
    params = params_from_jax(init_or_load(
        {handsegnet.SCOPE: handsegnet.init(np.random.default_rng(args.seed))},
        args.weights), device)
    train_loss = maybe_qat(loss_fn, args)
    if args.fused:
        train_loss = fuse_preprocess(train_loss, preprocess_rhd, cfg)
    return TrainJob(train_loss, params, make_optimizer(args.lr, args.lr_iter),
                    pipeline, args.max_iter,
                    fit_options(args, args.snapshot_dir))


def main(argv=None):
    return run(setup(argv))


if __name__ == "__main__":
    main()
