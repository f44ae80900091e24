"""The port's geometry (numerics, rotations, canonical frame, kinematic
chain) against hand3d_tpu's, on the CPU.

Inputs are seeded numpy hands in the normalized frame the data pipeline
makes (root-relative, bone 11-12 of length 1). Tolerance: atol 1e-5 on
coordinates and matrices (float32 products summed in another order);
angles are compared modulo 2 pi, since a value near +-pi may wrap to the
other end in either framework.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hand3d_tpu.ops import canonical as j_canonical
from hand3d_tpu.ops import kinematics as j_kinematics
from hand3d_tpu.ops import numerics as j_numerics
from hand3d_tpu.ops import rotations as j_rotations
from hand3d_tpu_torch.ops import canonical, kinematics, numerics, rotations

ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_angles_close(got, want, atol=ATOL):
    d = np.angle(np.exp(1j * (got.astype(np.float64) - want)))
    assert np.abs(d).max() <= atol, np.abs(d).max()


def hands(b, seed):
    """[b, 21, 3] normalized hand-like clouds (bone 11-12 of length 1)."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((b, 21, 3)) * 0.04 + [0.0, 0.0, 0.5]
    rel = xyz - xyz[:, :1]
    scale = np.linalg.norm(rel[:, 12] - rel[:, 11], axis=-1)
    return (rel / scale[:, None, None]).astype(np.float32)


def test_atan2_safe_matches_with_axes_and_quadrants():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(64).astype(np.float32)
    x = rng.standard_normal(64).astype(np.float32)
    # on the axes (x = 0 takes the +1e-8 shift), negative x, and both signs
    # of zero
    y[:8] = [1.0, -1.0, 0.0, 0.0, 1.0, -1.0, 0.0, -0.0]
    x[:8] = [0.0, 0.0, -1.0, 1.0, -1e-9, -1e-9, 0.0, -2.0]
    want = np.asarray(j_numerics.atan2_safe(jnp.asarray(y), jnp.asarray(x)))
    got = numerics.atan2_safe(t(y), t(x)).numpy()
    assert_angles_close(got, want)
    assert (got > -np.pi).all() and (got <= np.pi + 1e-6).all()
    # it is not torch.atan2: the shift moves x = 0, y = 0 off the origin
    assert got[6] == pytest.approx(0.0)


@pytest.mark.parametrize("name", ["rot_mat_x", "rot_mat_y", "rot_mat_z",
                                  "rot_mat_x_hom", "rot_mat_y_hom",
                                  "trans_mat_z_hom"])
def test_rotation_constructors_match(name):
    a = np.random.default_rng(1).uniform(-4, 4, 7).astype(np.float32)
    want = np.asarray(getattr(j_rotations, name)(jnp.asarray(a)))
    got = getattr(rotations, name)(t(a)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_canonical_trafo_matches():
    xyz = hands(6, 2)
    want_c, want_r = map(np.asarray, j_canonical.canonical_trafo(
        jnp.asarray(xyz)))
    got_c, got_r = (v.numpy() for v in canonical.canonical_trafo(t(xyz)))
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=ATOL)
    # the canonical frame: root at 0, keypoint 12 on the y axis, 20 at z=0
    np.testing.assert_allclose(got_c[:, 0], 0.0, atol=ATOL)
    np.testing.assert_allclose(got_c[:, 12, [0, 2]], 0.0, atol=ATOL)
    np.testing.assert_allclose(got_c[:, 20, 2], 0.0, atol=ATOL)


def test_bone_rel_trafo_matches():
    xyz = hands(6, 3)
    want = np.asarray(j_kinematics.bone_rel_trafo(jnp.asarray(xyz)))
    got = kinematics.bone_rel_trafo(t(xyz)).numpy()
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=ATOL)
    assert_angles_close(got[..., 1:], want[..., 1:])


def test_bone_rel_trafo_inv_matches_and_round_trips():
    xyz = hands(6, 4)
    rel = kinematics.bone_rel_trafo(t(xyz))
    got = kinematics.bone_rel_trafo_inv(rel).numpy()
    np.testing.assert_allclose(got, xyz, rtol=0, atol=ATOL)
    want = np.asarray(j_kinematics.bone_rel_trafo_inv(jnp.asarray(rel.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
