"""Training losses of the three stages (counterpart of
hand3d_tpu/train/losses.py; reference: training_*.py)."""

import torch

from hand3d_tpu_torch.ops.image import resize_bilinear
from hand3d_tpu_torch.ops.kinematics import bone_rel_trafo_inv


def posenet_scoremap_loss(scoremap_preds, scoremap_gt, keypoint_vis):
    """Visibility-masked L2 scoremap loss, summed over the prediction heads
    (training_posenet.py:57-61): per head and keypoint
    vis * sqrt(mean over pixels of (pred - gt)^2), summed over keypoints and
    divided by (sum(vis) + 0.001). Each head is first upsampled to the
    ground truth's resolution with the TF1 legacy bilinear grid.

    Args:
      scoremap_preds: list of [B, h, w, K] predictions.
      scoremap_gt: [B, H, W, K] ground truth.
      keypoint_vis: [B, K] bool or float.
    """
    gh, gw = scoremap_gt.shape[1:3]
    vis = keypoint_vis.to(torch.float32)
    denom = vis.sum() + 0.001
    loss = 0.0
    for pred in scoremap_preds:
        pred = resize_bilinear(pred, (gh, gw))
        per_kp = torch.sqrt(torch.mean(torch.square(pred - scoremap_gt),
                                       dim=(1, 2)))
        loss = loss + torch.sum(vis * per_kp) / denom
    return loss


def handsegnet_loss(seg_logits_list, hand_mask):
    """Mean softmax cross-entropy over all pixels, summed over the heads
    (training_handsegnet.py:55-60; the reference has one head).

    Args:
      seg_logits_list: list of [B, H, W, 2] logits at the input size.
      hand_mask: [B, H, W, 2] one-hot labels.
    """
    labels = hand_mask.to(torch.float32)
    loss = 0.0
    for logits in seg_logits_list:
        logp = torch.log_softmax(logits, dim=-1)
        loss = loss - torch.mean(torch.sum(labels * logp, dim=-1))
    return loss


def lifting_loss(variant, lifting_output, batch):
    """The lifting variant's loss (training_lifting.py:64-77).

    Args:
      variant: one of models.poseprior.VARIANTS.
      lifting_output: models.poseprior.LiftingOutput.
      batch: features with keypoint_xyz21_normed / _local / _can and rot_mat,
        as the variant needs them.
    """
    coord3d = lifting_output.coord3d

    def mse(a, b):
        return torch.mean(torch.square(a - b))

    if variant in ("direct", "bottleneck"):
        return mse(coord3d, batch["keypoint_xyz21_normed"])
    if variant == "local":
        return mse(coord3d, batch["keypoint_xyz21_local"])
    if variant == "local_w_xyz_loss":
        return mse(bone_rel_trafo_inv(coord3d), batch["keypoint_xyz21_normed"])
    if variant == "proposed":
        return (mse(coord3d, batch["keypoint_xyz21_can"])
                + mse(lifting_output.rot_mat, batch["rot_mat"]))
    raise ValueError(f"Unknown variant: {variant}")
