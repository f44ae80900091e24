"""ColorHandPose3D: the full cascade (counterpart of
hand3d_tpu/models/cascade.py, float path).

HandSegNet -> single-blob mask (flood-fill kernel) -> bbox -> 256x256 crop
-> PoseNet -> PosePrior + ViewpointNet -> upsampled-argmax keypoint decode
(decode kernel) -> global (u, v). Params are the torch tree of
``weights.params_from_jax``. The defaults (f32, ``seg_scale=1.0``, argmax
decode) are reference parity.
"""

from typing import NamedTuple, Optional

import torch

from hand3d_tpu_torch.models import handsegnet, posenet, poseprior
from hand3d_tpu_torch.ops.image import crop_image_from_xy, resize_bilinear
from hand3d_tpu_torch.ops.keypoints import (decode_upsampled, soft_argmax_2d,
                                            trafo_coords)
from hand3d_tpu_torch.ops.segmentation import (calc_center_bb,
                                               single_obj_scoremap)

CROP_SIZE = 256  # ColorHandPose3DNetwork.py:31
NUM_KP = 21
DECODERS = ("argmax", "soft_argmax")
COMPUTE_DTYPES = {None: None, "bfloat16": torch.bfloat16,
                  torch.bfloat16: torch.bfloat16}


def compute_dtype_of(name):
    """None (f32) / "bfloat16" / torch.bfloat16 -> the ``ops.nn`` compute
    dtype: None or torch.bfloat16."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be None or 'bfloat16', got "
                         f"{name!r}")
    return COMPUTE_DTYPES[name]


class CascadeOutput(NamedTuple):
    """Outputs of ColorHandPose3DNetwork.inference (:61-99) + global uv."""

    hand_scoremap: torch.Tensor  # [B, H, W, 2]
    image_crop: torch.Tensor  # [B, 256, 256, 3]
    scale_crop: torch.Tensor  # [B, 1]
    center: torch.Tensor  # [B, 2]
    keypoints_scoremap: Optional[torch.Tensor]  # [B, 256, 256, 21]
    keypoint_coord3d: torch.Tensor  # [B, 21, 3]
    keypoint_uv21: torch.Tensor  # [B, 21, 2] global-frame (u, v)


class Pose2DOutput(NamedTuple):
    """Outputs of ColorHandPose3DNetwork.inference2d (:101-129) + global uv."""

    keypoints_scoremap: Optional[torch.Tensor]  # [B, 256, 256, 21]
    image_crop: torch.Tensor
    scale_crop: torch.Tensor
    center: torch.Tensor
    keypoint_uv21: torch.Tensor


class PoseFromBox(NamedTuple):
    """What the cascade computes from a crop box onward."""

    image_crop: torch.Tensor  # [B, 256, 256, 3]
    scoremap: torch.Tensor  # [B, 32, 32, 21], PoseNet's last scoremap
    keypoint_coord3d: torch.Tensor  # [B, 21, 3]
    keypoint_uv21: torch.Tensor  # [B, 21, 2]


class ColorHandPose3D:
    """Full cascade: HandSegNet -> crop -> PoseNet -> PosePrior/Viewpoint.

    Args:
      compute_dtype: None (f32, reference parity) or "bfloat16": the JAX
        package's bf16 mode for every conv and FC of HandSegNet, PoseNet,
        PosePrior and ViewpointNet (inputs and weights rounded to bf16,
        f32 sums and outputs; ``ops.nn.conv2d``). The glue and both
        kernels stay f32.
      decode: 2D keypoint decoder, "argmax" (reference parity) or
        "soft_argmax" (sub-pixel; an extension of the JAX package).
      seg_scale: localization resolution factor in (0, 1]. Below 1,
        HandSegNet, the flood fill and the bbox run on a downscaled image and
        the box is mapped back to full-resolution pixels; PoseNet still sees a
        full-resolution 256x256 crop. An opt-in speed preset whose accuracy
        is not validated against the reference.
    """

    def __init__(self, compute_dtype=None, decode="argmax", seg_scale=1.0):
        if decode not in DECODERS:
            raise ValueError(f"decode must be one of {DECODERS}, got {decode!r}")
        if not 0.0 < seg_scale <= 1.0:
            raise ValueError(f"seg_scale must be in (0, 1], got {seg_scale}")
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.decode = decode
        self.seg_scale = seg_scale

    def segment(self, params, image):
        """HandSegNet at the localization resolution: [B, sh, sw, 2]."""
        _, h, w, _ = image.shape
        if self.seg_scale != 1.0:
            image = resize_bilinear(image, (max(1, round(h * self.seg_scale)),
                                            max(1, round(w * self.seg_scale))))
        return handsegnet.apply(params[handsegnet.SCOPE], image,
                                self.compute_dtype)[-1]

    @staticmethod
    def box_from_scoremap(hand_scoremap, image_hw):
        """Single blob -> bbox at the scoremap's own resolution -> (center
        [B, 2], scale_crop [B, 1]) in ``image_hw`` pixels.

        The flood fill's pass count follows the scoremap's size
        (general.py:256). The empty-mask fallbacks are full-image constants
        (general.py:311-320), so on a downscaled map they are pre-divided by
        the upsampling factors that map center and size back.
        """
        h, w = image_hw
        sh, sw = hand_scoremap.shape[1:3]
        hand_mask = single_obj_scoremap(hand_scoremap)
        if (sh, sw) == (h, w):
            center, _, crop_size_best = calc_center_bb(hand_mask)
        else:
            center, _, crop_size_best = calc_center_bb(
                hand_mask, fallback_center=(160.0 * sh / h, 160.0 * sw / w),
                fallback_size=100.0 / max(h / sh, w / sw))
            factors = torch.tensor([h / sh, w / sw], dtype=center.dtype,
                                   device=center.device)
            center = center * factors
            crop_size_best = crop_size_best * factors.max()
        scale_crop = torch.clamp(CROP_SIZE / (crop_size_best * 1.25),
                                 0.25, 5.0)
        return center, scale_crop

    def localize(self, params, image):
        """HandSegNet -> single blob -> bbox (ColorHandPose3DNetwork.py:77-86).

        Returns (hand_scoremap [B, sh, sw, 2] at the localization resolution,
        center [B, 2], scale_crop [B, 1]).
        """
        hand_scoremap = self.segment(params, image)
        center, scale_crop = self.box_from_scoremap(hand_scoremap,
                                                    image.shape[1:3])
        return hand_scoremap, center, scale_crop

    def decode_uv(self, scoremap, center, scale_crop):
        """PoseNet's [B, 32, 32, 21] scoremap -> global (u, v) [B, 21, 2]."""
        if self.decode == "soft_argmax":
            coord_hw = soft_argmax_2d(
                resize_bilinear(scoremap, (CROP_SIZE, CROP_SIZE)))
        else:
            coord_hw = decode_upsampled(scoremap,
                                        CROP_SIZE // scoremap.shape[1])
        coord_hw = trafo_coords(coord_hw, center, scale_crop[:, 0], CROP_SIZE)
        return coord_hw.flip(-1)  # (row, col) -> (u, v)

    def crop_pose2d(self, params, image, center, scale_crop):
        """256x256 crop -> PoseNet: (image_crop, its last scoremap)."""
        image_crop = crop_image_from_xy(image, center, CROP_SIZE,
                                        scale_crop[:, 0])
        return image_crop, posenet.apply(params[posenet.SCOPE], image_crop,
                                         self.compute_dtype)[-1]

    def pose_from_box(self, params, image, center, scale_crop, hand_side):
        """Crop -> PoseNet -> 3D lifting and 2D decode, for a given box."""
        image_crop, scoremap = self.crop_pose2d(params, image, center,
                                                scale_crop)
        coord_can = poseprior.apply_poseprior(
            params[poseprior.POSEPRIOR_SCOPE], scoremap, hand_side,
            compute_dtype=self.compute_dtype)
        rot_mat = poseprior.apply_viewpoint(
            params[poseprior.VIEWPOINT_SCOPE], scoremap, hand_side,
            compute_dtype=self.compute_dtype)
        return PoseFromBox(
            image_crop, scoremap,
            poseprior.lift_to_relative(coord_can, rot_mat, hand_side),
            self.decode_uv(scoremap, center, scale_crop))

    def inference(self, params, image, hand_side, *,
                  keypoints_scoremap=True):
        """Full pipeline: [B, H, W, 3] mean-subtracted image -> CascadeOutput.

        hand_scoremap is at full resolution. ``keypoints_scoremap=False``
        leaves out the [B, 256, 256, 21] upsampled scoremap (None in the
        output). Eager PyTorch builds every tensor it is asked for, and
        serving drops this one.
        """
        hand_scoremap, center, scale_crop = self.localize(params, image)
        pose = self.pose_from_box(params, image, center, scale_crop,
                                  hand_side)
        if hand_scoremap.shape[1:3] != image.shape[1:3]:
            hand_scoremap = resize_bilinear(hand_scoremap, image.shape[1:3])
        return CascadeOutput(hand_scoremap, pose.image_crop, scale_crop,
                             center, self._large(pose.scoremap,
                                                 keypoints_scoremap),
                             pose.keypoint_coord3d, pose.keypoint_uv21)

    def inference2d(self, params, image, *, keypoints_scoremap=True):
        """The 2D half of the pipeline -> Pose2DOutput."""
        _, center, scale_crop = self.localize(params, image)
        image_crop, scoremap = self.crop_pose2d(params, image, center,
                                                scale_crop)
        return Pose2DOutput(self._large(scoremap, keypoints_scoremap),
                            image_crop, scale_crop, center,
                            self.decode_uv(scoremap, center, scale_crop))

    @staticmethod
    def _large(scoremap, keypoints_scoremap):
        if not keypoints_scoremap:
            return None
        return resize_bilinear(scoremap, (CROP_SIZE, CROP_SIZE))
