"""21-joint kinematic-chain transforms, batched and inverse-free (counterpart
of hand3d_tpu/ops/kinematics.py).

The reference inverts the accumulated 4x4 transform with tf.matrix_inverse
(relative_trafo.py:117). Every accumulated transform is a product of
elementary rigid transforms, so the inverse is accumulated in closed form
beside it; ``torch.linalg.inv`` is never called. The 21-step chain is a
Python loop over [B, 4, 4] batches.
"""

import torch

from hand3d_tpu_torch.ops.numerics import atan2_safe
from hand3d_tpu_torch.ops.rotations import (rot_mat_x_hom, rot_mat_y_hom,
                                            trans_mat_z_hom)

# child -> parent of the 21-joint hand (relative_trafo.py:148-173)
KINEMATIC_CHAIN_DICT = {
    0: "root",
    4: "root", 3: 4, 2: 3, 1: 2,
    8: "root", 7: 8, 6: 7, 5: 6,
    12: "root", 11: 12, 10: 11, 9: 10,
    16: "root", 15: 16, 14: 15, 13: 14,
    20: "root", 19: 20, 18: 19, 17: 18,
}

# evaluation order, parents before children (relative_trafo.py:176-181)
KINEMATIC_CHAIN_LIST = [0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9,
                        16, 15, 14, 13, 20, 19, 18, 17]


def _mv(mat, vec):
    """[B, 4, 4] @ [B, 4] -> [B, 4]."""
    return torch.matmul(mat, vec[..., None])[..., 0]


def _homogeneous(xyz):
    return torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)


def _bone_trafo(length, angle_x, angle_y):
    """Trans(-l) Rx(-ax) Ry(-ay): global -> local of one bone (:108)."""
    return torch.matmul(trans_mat_z_hom(-length),
                        torch.matmul(rot_mat_x_hom(-angle_x),
                                     rot_mat_y_hom(-angle_y)))


def bone_rel_trafo(coords_xyz):
    """xyz -> per-bone local articulation (length, angle_x, angle_y), walking
    the chain root to leaves like relative_trafo.bone_rel_trafo (:184-240).

    Args:
      coords_xyz: [B, 21, 3].
    Returns:
      [B, 21, 3].
    """
    coords_xyz = coords_xyz.reshape(-1, 21, 3)
    batch = coords_xyz.shape[0]
    eye = torch.eye(4, dtype=coords_xyz.dtype,
                    device=coords_xyz.device).expand(batch, 4, 4)
    trafos, rel = {}, {}
    for bone_id in KINEMATIC_CHAIN_LIST:
        parent_id = KINEMATIC_CHAIN_DICT[bone_id]
        if parent_id == "root":
            delta = coords_xyz[:, bone_id]
            trafo = eye
        else:
            # the bone vector in the parent's local frame
            trafo = trafos[parent_id]
            delta = (_mv(trafo, _homogeneous(coords_xyz[:, bone_id]))
                     - _mv(trafo, _homogeneous(coords_xyz[:, parent_id])))[:, :3]
        # relative_trafo._backward (:121-145)
        length = torch.sqrt(delta[:, 0] ** 2 + delta[:, 1] ** 2
                            + delta[:, 2] ** 2)
        angle_y = atan2_safe(delta[:, 0], delta[:, 2])
        tmp = _mv(rot_mat_y_hom(-angle_y), _homogeneous(delta))
        angle_x = atan2_safe(-tmp[:, 1], tmp[:, 2])
        trafos[bone_id] = torch.matmul(_bone_trafo(length, angle_x, angle_y),
                                       trafo)
        rel[bone_id] = torch.stack([length, angle_x, angle_y], -1)
    return torch.stack([rel[i] for i in range(21)], 1)


def bone_rel_trafo_inv(coords_rel):
    """Forward kinematics: (length, angle_x, angle_y) -> xyz, the inverse of
    ``bone_rel_trafo`` (relative_trafo.bone_rel_trafo_inv, :243-295).

    Args:
      coords_rel: [B, 21, 3].
    Returns:
      [B, 21, 3] xyz.
    """
    coords_rel = coords_rel.reshape(-1, 21, 3)
    batch = coords_rel.shape[0]
    eye = torch.eye(4, dtype=coords_rel.dtype,
                    device=coords_rel.device).expand(batch, 4, 4)
    inv_trafos, xyz = {}, {}
    for bone_id in KINEMATIC_CHAIN_LIST:
        parent_id = KINEMATIC_CHAIN_DICT[bone_id]
        tinv = eye if parent_id == "root" else inv_trafos[parent_id]
        length, ax, ay = coords_rel[:, bone_id].unbind(-1)
        # closed-form inverse of _bone_trafo: Ry(ay) Rx(ax) Trans(l)
        this_inv = torch.matmul(rot_mat_y_hom(ay),
                                torch.matmul(rot_mat_x_hom(ax),
                                             trans_mat_z_hom(length)))
        tinv = torch.matmul(tinv, this_inv)
        # joint position = tinv @ [0, 0, 0, 1]: its translation column
        xyz[bone_id] = tinv[:, :3, 3]
        inv_trafos[bone_id] = tinv
    return torch.stack([xyz[i] for i in range(21)], 1)
