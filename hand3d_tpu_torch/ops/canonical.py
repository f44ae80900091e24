"""Canonical frame of a 21-keypoint hand (counterpart of
hand3d_tpu/ops/canonical.py).

The batched 3x3 products are exact f32 on the CPU, and on the card as long
as TF32 matmuls stay off (``precision.exact_f32``).
"""

import torch

from hand3d_tpu_torch.ops.numerics import PI, atan2_safe, device_constant
from hand3d_tpu_torch.ops.rotations import rot_mat_x, rot_mat_y, rot_mat_z

ROOT_NODE_ID = 0  # palm keypoint, placed at the origin
ALIGN_NODE_ID = 12  # beginning of middle finger, placed on the y axis
ROT_NODE_ID = 20  # beginning of pinky, placed at z=0, x>0


def canonical_trafo(coords_xyz):
    """Map (root-relative, normalized) xyz coords into the canonical frame
    (utils/canonical_trafo.py:94-136).

    Args:
      coords_xyz: [B, 21, 3].
    Returns:
      (coords_normed [B, 21, 3], total_rot_mat [B, 3, 3]) with
      ``coords_normed = (coords_xyz - root) @ total_rot_mat``.
    """
    coords_xyz = coords_xyz.reshape(-1, 21, 3)
    coords_t = coords_xyz - coords_xyz[:, ROOT_NODE_ID:ROOT_NODE_ID + 1]

    # rotate the align node into the yz-plane (about z)
    p = coords_t[:, ALIGN_NODE_ID]
    total = rot_mat_z(atan2_safe(p[:, 0], p[:, 1]))
    coords_r1 = torch.matmul(coords_t, total)

    # then within the yz-plane onto the (negative) y axis
    p = coords_r1[:, ALIGN_NODE_ID]
    rot = rot_mat_x(-atan2_safe(p[:, 2], p[:, 1]) + PI)
    coords_r2 = torch.matmul(coords_r1, rot)
    total = torch.matmul(total, rot)

    # the remaining rotation about y from the rot node
    p = coords_r2[:, ROT_NODE_ID]
    rot = rot_mat_y(atan2_safe(p[:, 2], p[:, 0]))
    return torch.matmul(coords_r2, rot), torch.matmul(total, rot)


def flip_right_hand(coords_xyz_canonical, cond_right):
    """Mirror canonical coords (z -> -z) where ``cond_right`` holds.

    Args:
      coords_xyz_canonical: [B, N, 3].
      cond_right: [B] bool.
    """
    sign = device_constant([1.0, 1.0, -1.0], coords_xyz_canonical.dtype,
                           coords_xyz_canonical.device)
    return torch.where(cond_right[:, None, None],
                       coords_xyz_canonical * sign, coords_xyz_canonical)
