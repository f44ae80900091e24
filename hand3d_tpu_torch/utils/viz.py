"""Hand stick-figure visualization (matplotlib, host-side only; counterpart
of hand3d_tpu/utils/viz.py).

Same 20-bone connectivity and finger coloring as the reference's
plot_hand/plot_hand_3d (utils/general.py:360-477): four bones per finger
chained from the root keypoint 0 through each fingertip group, colored along
a blue->green->red map. matplotlib is imported lazily so the compute path
has no viz dependency.
"""

import numpy as np

# (parent, child) per bone, root -> tip-adjacent chains, per general.py:384-407
HAND_BONES = [
    (0, 4), (4, 3), (3, 2), (2, 1),
    (0, 8), (8, 7), (7, 6), (6, 5),
    (0, 12), (12, 11), (11, 10), (10, 9),
    (0, 16), (16, 15), (15, 14), (14, 13),
    (0, 20), (20, 19), (19, 18), (18, 17),
]


def _bone_colors():
    import matplotlib.cm as cm

    return [cm.jet(i / (len(HAND_BONES) - 1.0))[:3]
            for i in range(len(HAND_BONES))]


def plot_hand(coords_hw, axis, color_fixed=None, linewidth="1"):
    """Draw a 2D hand skeleton; coords_hw is [21, 2] (row, col)."""
    coords_hw = np.asarray(coords_hw)
    for (a, b), color in zip(HAND_BONES, _bone_colors()):
        seg = np.stack([coords_hw[a], coords_hw[b]])
        axis.plot(seg[:, 1], seg[:, 0],
                  color=color_fixed if color_fixed is not None else color,
                  linewidth=linewidth)


def plot_hand_3d(coords_xyz, axis, color_fixed=None, linewidth="1"):
    """Draw a 3D hand skeleton; coords_xyz is [21, 3]."""
    coords_xyz = np.asarray(coords_xyz)
    for (a, b), color in zip(HAND_BONES, _bone_colors()):
        seg = np.stack([coords_xyz[a], coords_xyz[b]])
        axis.plot(seg[:, 0], seg[:, 1], seg[:, 2],
                  color=color_fixed if color_fixed is not None else color,
                  linewidth=linewidth)
    axis.view_init(azim=-90.0, elev=90.0)
