"""Batched 3x3 / homogeneous 4x4 rotation-matrix constructors (counterpart
of hand3d_tpu/ops/rotations.py).

Element layout is the reference's, row-major: the 3x3 matrices are applied as
``coords @ R``; the homogeneous 4x4 ones of the kinematic chain use the
opposite sign convention and act on column vectors (``T @ x``,
relative_trafo.py:48-89). Every constructor takes angles of shape [B].
"""

import torch


def _stack_rows(rows):
    """N lists of N [B] tensors -> [B, N, N]."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _trig(angle):
    return (torch.cos(angle), torch.sin(angle), torch.ones_like(angle),
            torch.zeros_like(angle))


def rot_mat_x(angle):
    """[B] -> [B, 3, 3]; canonical_trafo.py:64-71."""
    c, s, one, zero = _trig(angle)
    return _stack_rows([[one, zero, zero], [zero, c, s], [zero, -s, c]])


def rot_mat_y(angle):
    """[B] -> [B, 3, 3]; canonical_trafo.py:74-81."""
    c, s, one, zero = _trig(angle)
    return _stack_rows([[c, zero, -s], [zero, one, zero], [s, zero, c]])


def rot_mat_z(angle):
    """[B] -> [B, 3, 3]; canonical_trafo.py:84-91."""
    c, s, one, zero = _trig(angle)
    return _stack_rows([[c, s, zero], [-s, c, zero], [zero, zero, one]])


def rodrigues_rot_mat(ux, uy, uz):
    """Axis-angle (an unnormalized 3-vector whose norm is the angle) ->
    [B, 3, 3], applied as ``coords @ R``.

    Matches ColorHandPose3DNetwork._get_rot_mat (:311-334), including the
    +1e-8 inside the norm's sqrt that the shipped weights were trained with.
    Inputs are [B] or [B, 1].
    """
    ux, uy, uz = ux.reshape(-1), uy.reshape(-1), uz.reshape(-1)
    theta = torch.sqrt(ux * ux + uy * uy + uz * uz + 1e-8)
    st, ct = torch.sin(theta), torch.cos(theta)
    one_ct = 1.0 - ct
    inv = 1.0 / theta
    x, y, z = ux * inv, uy * inv, uz * inv
    return _stack_rows([
        [ct + x * x * one_ct, x * y * one_ct - z * st, x * z * one_ct + y * st],
        [y * x * one_ct + z * st, ct + y * y * one_ct, y * z * one_ct - x * st],
        [z * x * one_ct - y * st, z * y * one_ct + x * st, ct + z * z * one_ct],
    ])


def rot_mat_x_hom(angle):
    """[B] -> [B, 4, 4]; relative_trafo.py:48-56."""
    c, s, one, zero = _trig(angle)
    return _stack_rows([[one, zero, zero, zero], [zero, c, -s, zero],
                        [zero, s, c, zero], [zero, zero, zero, one]])


def rot_mat_y_hom(angle):
    """[B] -> [B, 4, 4]; relative_trafo.py:59-67."""
    c, s, one, zero = _trig(angle)
    return _stack_rows([[c, zero, s, zero], [zero, one, zero, zero],
                        [-s, zero, c, zero], [zero, zero, zero, one]])


def trans_mat_z_hom(trans):
    """[B] -> [B, 4, 4]: translation along z; relative_trafo.py:81-89."""
    one, zero = torch.ones_like(trans), torch.zeros_like(trans)
    return _stack_rows([[one, zero, zero, zero], [zero, one, zero, zero],
                        [zero, zero, one, trans], [zero, zero, zero, one]])
