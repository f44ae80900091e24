"""PosePrior + ViewpointNet: canonical 3D lifting from 2D scoremaps
(counterpart of hand3d_tpu/models/poseprior.py).

PosePrior (ColorHandPose3DNetwork.py:249-272): 3 conv pairs (stride 1, then
stride 2) with [32, 64, 128] channels, 32x32x21 -> 4x4x128, NHWC flatten,
concat the hand-side one-hot, FC(512) x 2, FC to 21*3 canonical coords.
ViewpointNet (:274-334): the same tower with [64, 128, 256] channels,
FC 256 -> 128, three scalar heads -> Rodrigues rotation matrix. The FC
dropouts (keep 0.8 in PosePrior, 0.75 in ViewpointNet) act only with
``train=True``; their masks come from a CPU ``torch.Generator``.

The standalone PosePriorNetwork with the reference's five lifting variants
(nets/PosePriorNetwork.py:30-234) is composed from the same pieces.
"""

from typing import NamedTuple, Optional

import torch

from hand3d_tpu_torch.ops import nn
from hand3d_tpu_torch.ops.canonical import flip_right_hand
from hand3d_tpu_torch.ops.kinematics import bone_rel_trafo_inv
from hand3d_tpu_torch.ops.rotations import rodrigues_rot_mat

NUM_KP = 21
SCOREMAP_SIZE = 32  # spatial size the lifting nets were built for
POSEPRIOR_SCOPE = "PosePrior"
VIEWPOINT_SCOPE = "ViewpointNet"
POSE_CHANS = (32, 64, 128)
VP_CHANS = (64, 128, 256)
VARIANTS = ("direct", "bottleneck", "local", "local_w_xyz_loss", "proposed")


def _prefix(chans):
    return "conv_pose" if chans == POSE_CHANS else "conv_vp"


def _tower_init(rng, chans):
    params = {}
    in_chan = NUM_KP
    for i, out_chan in enumerate(chans):
        params[f"{_prefix(chans)}_{i}_1"] = nn.conv_init(rng, 3, 3, in_chan,
                                                         out_chan)
        params[f"{_prefix(chans)}_{i}_2"] = nn.conv_init(rng, 3, 3, out_chan,
                                                         out_chan)
        in_chan = out_chan
    return params


def _tower_apply(params, scoremap, hand_side, chans, compute_dtype=None):
    """[B, 32, 32, 21] -> [B, 4*4*C + 2] flattened in NHWC order + hand side."""
    x = scoremap.permute(0, 3, 1, 2).contiguous()
    for i in range(len(chans)):
        x = nn.conv2d_relu(x, params[f"{_prefix(chans)}_{i}_1"],
                           compute_dtype=compute_dtype)
        x = nn.conv2d_relu(x, params[f"{_prefix(chans)}_{i}_2"], stride=2,
                           compute_dtype=compute_dtype)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return torch.cat([x, hand_side.to(x.dtype)], dim=1)


def init_poseprior(rng, bottleneck=False):
    """PosePrior params (TF scope 'PosePrior'); ``bottleneck`` adds the
    30-wide fc_bottleneck before the coordinate head."""
    params = _tower_init(rng, POSE_CHANS)
    flat = (SCOREMAP_SIZE // 8) ** 2 * POSE_CHANS[-1]
    params["fc_rel0"] = nn.dense_init(rng, flat + 2, 512)
    params["fc_rel1"] = nn.dense_init(rng, 512, 512)
    if bottleneck:
        params["fc_bottleneck"] = nn.dense_init(rng, 512, 30)
        params["fc_xyz"] = nn.dense_init(rng, 30, NUM_KP * 3)
    else:
        params["fc_xyz"] = nn.dense_init(rng, 512, NUM_KP * 3)
    return params


def init_viewpoint(rng):
    params = _tower_init(rng, VP_CHANS)
    flat = (SCOREMAP_SIZE // 8) ** 2 * VP_CHANS[-1]
    params["fc_vp0"] = nn.dense_init(rng, flat + 2, 256)
    params["fc_vp1"] = nn.dense_init(rng, 256, 128)
    for head in ("fc_vp_ux", "fc_vp_uy", "fc_vp_uz"):
        params[head] = nn.dense_init(rng, 128, 1)
    return params


def apply_poseprior(params, scoremap, hand_side, train=False, generator=None,
                    compute_dtype=None):
    """[B, 32, 32, 21] scoremap + [B, 2] hand side -> [B, 21, 3] canonical.
    ``compute_dtype``: the convs' and FCs' (``ops.nn``)."""
    cd = compute_dtype
    x = _tower_apply(params, scoremap, hand_side, POSE_CHANS, cd)
    x = nn.dropout(nn.dense_relu(x, params["fc_rel0"], cd), 0.8, train,
                   generator)
    x = nn.dropout(nn.dense_relu(x, params["fc_rel1"], cd), 0.8, train,
                   generator)
    if "fc_bottleneck" in params:
        x = nn.dense(x, params["fc_bottleneck"], cd)
    return nn.dense(x, params["fc_xyz"], cd).reshape(-1, NUM_KP, 3)


def apply_viewpoint(params, scoremap, hand_side, train=False, generator=None,
                    compute_dtype=None):
    """[B, 32, 32, 21] scoremap + [B, 2] hand side -> [B, 3, 3] rotation.
    ``compute_dtype``: the convs' and FCs' (``ops.nn``)."""
    cd = compute_dtype
    x = _tower_apply(params, scoremap, hand_side, VP_CHANS, cd)
    x = nn.dropout(nn.dense_relu(x, params["fc_vp0"], cd), 0.75, train,
                   generator)
    x = nn.dropout(nn.dense_relu(x, params["fc_vp1"], cd), 0.75, train,
                   generator)
    return rodrigues_rot_mat(nn.dense(x, params["fc_vp_ux"], cd),
                             nn.dense(x, params["fc_vp_uy"], cd),
                             nn.dense(x, params["fc_vp_uz"], cd))


def lift_to_relative(coord_can, rot_mat, hand_side):
    """Flip right hands, rotate canonical coords to the camera frame
    (ColorHandPose3DNetwork._inference_pose3d, :239-245). Exact f32 on the
    card as long as TF32 matmuls stay off (precision.exact_f32)."""
    cond_right = torch.argmax(hand_side, dim=1) == 1
    return torch.matmul(flip_right_hand(coord_can, cond_right), rot_mat)


class LiftingOutput(NamedTuple):
    coord_xyz_rel_normed: torch.Tensor  # [B, 21, 3]
    coord3d: torch.Tensor  # the variant's own prediction space
    rot_mat: Optional[torch.Tensor]  # [B, 3, 3] for 'proposed', else None


class PosePriorNetwork:
    """Standalone lifting network with the reference's five variants
    (nets/PosePriorNetwork.py:30-122)."""

    def __init__(self, variant="proposed"):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
        self.variant = variant

    def init(self, rng):
        """Seeded numpy params from the ``np.random.Generator`` ``rng``: the
        names and shapes of the JAX package's PosePriorNetwork(variant).init
        (ViewpointNet only for 'proposed')."""
        params = {POSEPRIOR_SCOPE: init_poseprior(
            rng, bottleneck=self.variant == "bottleneck")}
        if self.variant == "proposed":
            params[VIEWPOINT_SCOPE] = init_viewpoint(rng)
        return params

    def apply(self, params, scoremap, hand_side, train=False, generator=None):
        """scoremap [B, 256, 256, 21] (or already pooled [B, 32, 32, 21]) +
        hand side [B, 2] -> LiftingOutput (PosePriorNetwork.inference,
        :59-95). A 256x256 map is average pooled 8x8 first (:61).

        ``train=True`` turns the FC dropouts on; ``generator`` then draws
        their masks, PosePrior's two before ViewpointNet's two. The
        reference trained with them off (training_lifting.py:54-56 never
        feeds its ``evaluation`` placeholder), and so do the trainers by
        default.
        """
        if scoremap.shape[1] != SCOREMAP_SIZE:
            scoremap = nn.avg_pool(scoremap.permute(0, 3, 1, 2), 8) \
                .permute(0, 2, 3, 1)
        pred = apply_poseprior(params[POSEPRIOR_SCOPE], scoremap, hand_side,
                               train, generator)
        if self.variant in ("direct", "bottleneck"):
            return LiftingOutput(pred, pred, None)
        if self.variant in ("local", "local_w_xyz_loss"):
            return LiftingOutput(bone_rel_trafo_inv(pred), pred, None)
        rot_mat = apply_viewpoint(params[VIEWPOINT_SCOPE], scoremap, hand_side,
                                  train, generator)
        return LiftingOutput(lift_to_relative(pred, rot_mat, hand_side), pred,
                             rot_mat)
