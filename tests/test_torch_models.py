"""The port's networks and param trees against hand3d_tpu's, on the CPU.

The networks have no width knob, so they run at full width on small inputs,
from JAX-initialized params passed through params_from_jax. Random init
keeps activations small (scoremaps ~1e-3), so each tolerance is stated
relative to the largest reference value: float32 convolutions summed in
another order differ by ~1e-6 of that.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand3d_tpu.models import handsegnet as j_handsegnet
from hand3d_tpu.models import posenet as j_posenet
from hand3d_tpu.models import poseprior as j_poseprior
from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.weights import save_npz, tree_to_flat
from hand3d_tpu_torch import weights
from hand3d_tpu_torch.models import handsegnet, posenet, poseprior

from torch_tmp import tmp_path  # noqa: F401

RTOL_OF_MAX = 1e-5  # allowed |got - want| as a share of max |want|


def assert_close(got, want):
    assert got.shape == want.shape
    atol = RTOL_OF_MAX * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def to_torch(tree):
    return weights.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   "cpu")


def test_handsegnet_matches():
    params = j_handsegnet.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).random((2, 48, 64, 3), np.float32) - 0.5
    want = np.asarray(j_handsegnet.apply(params, jnp.asarray(x))[0])
    got = handsegnet.apply(to_torch(params), torch.from_numpy(x))[0].numpy()
    assert_close(got, want)


def test_posenet_matches_all_scoremaps():
    params = j_posenet.init(jax.random.PRNGKey(1))
    x = np.random.default_rng(1).random((2, 64, 64, 3), np.float32) - 0.5
    want = j_posenet.apply(params, jnp.asarray(x))
    got = posenet.apply(to_torch(params), torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def lifting_inputs():
    rng = np.random.default_rng(2)
    sm = rng.random((2, 32, 32, 21), np.float32)
    hand_side = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    return sm, hand_side


def test_poseprior_matches(lifting_inputs):
    sm, hs = lifting_inputs
    params = j_poseprior.init_poseprior(jax.random.PRNGKey(2))
    want = np.asarray(j_poseprior.apply_poseprior(params, jnp.asarray(sm),
                                                  jnp.asarray(hs)))
    got = poseprior.apply_poseprior(to_torch(params), torch.from_numpy(sm),
                                    torch.from_numpy(hs)).numpy()
    assert_close(got, want)


def test_viewpoint_and_lifting_match(lifting_inputs):
    sm, hs = lifting_inputs
    params = j_poseprior.init_viewpoint(jax.random.PRNGKey(3))
    want_rot = np.array(j_poseprior.apply_viewpoint(
        params, jnp.asarray(sm), jnp.asarray(hs)))
    got_rot = poseprior.apply_viewpoint(to_torch(params), torch.from_numpy(sm),
                                        torch.from_numpy(hs))
    np.testing.assert_allclose(got_rot.numpy(), want_rot, rtol=0, atol=1e-6)

    coord = np.random.default_rng(3).standard_normal((2, 21, 3)).astype(
        np.float32)
    want = np.asarray(j_poseprior.lift_to_relative(
        jnp.asarray(coord), jnp.asarray(want_rot), jnp.asarray(hs)))
    got = poseprior.lift_to_relative(torch.from_numpy(coord),
                                     torch.from_numpy(want_rot),
                                     torch.from_numpy(hs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _shapes(tree, prefix=""):
    """{'scope/layer/weights': shape} of a tree of arrays or ShapeDtypeStructs."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_shapes(v, path) if isinstance(v, dict)
                   else {path: tuple(v.shape)})
    return out


def test_random_params_names_and_shapes_match_jax_init():
    want = jax.eval_shape(JaxCascade().init, jax.random.PRNGKey(0))
    got = weights.random_params(0)
    assert _shapes(got) == _shapes(want)
    assert all(v.dtype == np.float32 for v in tree_to_flat(got).values())
    again = weights.random_params(0)
    for k, v in tree_to_flat(got).items():
        np.testing.assert_array_equal(v, tree_to_flat(again)[k])


def test_load_npz_and_layout_conversion(tmp_path):
    tree = {"PoseNet2D": j_posenet.init(jax.random.PRNGKey(4))}
    path = tmp_path / "w.npz"
    save_npz(path, tree)
    loaded = weights.load_npz(path)
    assert _shapes(loaded) == _shapes(tree)
    conv = weights.params_from_jax(loaded, "cpu")["PoseNet2D"]["conv6_1"]
    hwio = np.asarray(tree["PoseNet2D"]["conv6_1"]["weights"])
    np.testing.assert_array_equal(conv["weights"].numpy(),
                                  hwio.transpose(3, 2, 0, 1))
    dense = weights.params_from_jax(
        {"fc": {"weights": np.ones((5, 3), np.float32)}}, "cpu")
    assert tuple(dense["fc"]["weights"].shape) == (5, 3)


def test_params_from_jax_rejects_unported_layouts():
    """The phase-packed layout (hand3d_tpu.ops.phasepack) is out of scope;
    the int8 and QAT layouts carry across (tests/test_torch_quant.py)."""
    with pytest.raises(ValueError, match="weights_p2"):
        weights.params_from_jax(
            {"HandSegNet": {"conv1_2": {
                "weights_p2": np.zeros((3, 4, 64, 128), np.float32),
                "biases": np.zeros(64, np.float32)}}}, "cpu")


@pytest.mark.parametrize("variant", j_poseprior.VARIANTS)
@pytest.mark.parametrize("size", [32, 256])
def test_poseprior_network_variants_match(variant, size):
    """PosePriorNetwork(variant).apply at the pooled 32x32 input and at the
    256x256 one it average-pools 8x8 first. 'local' variants run the
    kinematic chain, 'proposed' the viewpoint net."""
    net = j_poseprior.PosePriorNetwork(variant)
    params = net.init(jax.random.PRNGKey(5))
    rng = np.random.default_rng(size)
    sm = rng.random((2, size, size, 21), np.float32)
    hs = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    want = net.apply(params, jnp.asarray(sm), jnp.asarray(hs))
    got = poseprior.PosePriorNetwork(variant).apply(
        to_torch(params), torch.from_numpy(sm), torch.from_numpy(hs))
    for name in ("coord_xyz_rel_normed", "coord3d", "rot_mat"):
        w, g = getattr(want, name), getattr(got, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert_close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("variant", j_poseprior.VARIANTS)
def test_random_lifting_params_names_and_shapes_match_jax_init(variant):
    want = jax.eval_shape(j_poseprior.PosePriorNetwork(variant).init,
                          jax.random.PRNGKey(0))
    assert _shapes(weights.random_lifting_params(variant, 0)) == _shapes(want)


def test_poseprior_network_rejects_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        poseprior.PosePriorNetwork("nope")
