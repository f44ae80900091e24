"""Training losses of the three stages (counterpart of
hand3d_tpu/train/losses.py; reference: training_*.py).

Under a data-parallel mesh each rank computes its share of the loss of the
global batch, so that the ranks' losses (and gradients) sum to the global
loss's. A loss reduces over the batch through ``batch_mean`` (a mean over
the global batch's rows: equal shares of it) and ``global_sum`` (a sum over
every rank's rows, for a normalizer that couples the samples, such as
PoseNet's visibility count). Outside ``batch_share`` both are the plain
reductions of the rows at hand.
"""

import contextlib
import contextvars

import torch
import torch.distributed as dist

from hand3d_tpu_torch.ops.image import resize_bilinear
from hand3d_tpu_torch.ops.kinematics import bone_rel_trafo_inv


class BatchShare:
    """This rank's share of a batch whose rows are spread over ranks: it
    holds ``rows`` of the batch's ``total``, and ``global_sum`` all-reduces
    over ``group``.

    The sums of one forward are kept in call order: a forward run again
    for the backward pass (remat) takes them from there after ``rewind``,
    so every rank makes the same collectives whatever it recomputes.
    ``record=True`` makes none and notes each sum's shape and dtype
    instead (what a rank that holds none of a batch must still join).
    """

    def __init__(self, group, rows, total, record=False):
        self.group = group
        self.rows = rows
        self.total = total
        self.sums = []
        self.pos = 0
        self.recorded = [] if record else None

    def rewind(self):
        self.pos = 0

    def sum(self, x):
        if self.recorded is not None:
            self.recorded.append((tuple(x.shape), x.dtype))
            return x
        if self.pos == len(self.sums):
            if x.requires_grad:
                raise ValueError("a normalizer summed over ranks must be a "
                                 "constant of the data: it needs no "
                                 "gradient")
            y = x.detach().clone()
            dist.all_reduce(y, group=self.group)
            self.sums.append(y)
        y = self.sums[self.pos]
        self.pos += 1
        return y

    def join(self, recorded, device):
        """The sums of a batch this rank holds no row of: zeros of each
        recorded shape, all-reduced with the ranks that hold rows."""
        for shape, dtype in recorded:
            dist.all_reduce(torch.zeros(shape, dtype=dtype, device=device),
                            group=self.group)


_SHARE = contextvars.ContextVar("batch_share", default=None)


@contextlib.contextmanager
def batch_share(share):
    """Losses computed inside reduce as ``share`` (a BatchShare) says."""
    token = _SHARE.set(share)
    try:
        yield share
    finally:
        _SHARE.reset(token)


def global_sum(x):
    """``x`` summed over the ranks that hold the batch's rows (``x`` alone
    outside ``batch_share``)."""
    share = _SHARE.get()
    return x if share is None else share.sum(x)


def batch_mean(x):
    """This rank's share of the mean of ``x`` over the whole batch, whose
    leading axis is the batch: the mean of its rows times rows / total."""
    mean = torch.mean(x)
    share = _SHARE.get()
    if share is None or share.rows == share.total:
        return mean
    return mean * (share.rows / share.total)


def posenet_scoremap_loss(scoremap_preds, scoremap_gt, keypoint_vis):
    """Visibility-masked L2 scoremap loss, summed over the prediction heads
    (training_posenet.py:57-61): per head and keypoint
    vis * sqrt(mean over pixels of (pred - gt)^2), summed over keypoints and
    divided by (sum(vis) + 0.001). Each head is first upsampled to the
    ground truth's resolution with the TF1 legacy bilinear grid.

    The count of visible keypoints is the global batch's under a mesh
    (``global_sum``).

    Args:
      scoremap_preds: list of [B, h, w, K] predictions.
      scoremap_gt: [B, H, W, K] ground truth.
      keypoint_vis: [B, K] bool or float.
    """
    vis = keypoint_vis.to(torch.float32)
    denom = global_sum(vis.sum()) + 0.001
    loss = 0.0
    for pred in scoremap_preds:
        loss = loss + scoremap_numerator(pred, scoremap_gt, vis) / denom
    return loss


def scoremap_numerator(pred, scoremap_gt, vis):
    """The numerator of one head's term of ``posenet_scoremap_loss``: the
    sum over samples and keypoints of vis * sqrt(mean over pixels of
    (pred - gt)^2), ``pred`` [B, h, w, K] upsampled to the ground truth's
    [B, H, W, K]; ``vis`` [B, K] float."""
    pred = resize_bilinear(pred, scoremap_gt.shape[1:3])
    per_kp = torch.sqrt(torch.mean(torch.square(pred - scoremap_gt),
                                   dim=(1, 2)))
    return torch.sum(vis * per_kp)


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
        loss = loss - batch_mean(torch.sum(labels * logp, dim=-1))
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
        return batch_mean(torch.square(a - b))

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
