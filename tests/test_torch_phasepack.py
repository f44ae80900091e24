"""The port's phase-packed conv (hand3d_tpu_torch.ops.phasepack) against
hand3d_tpu.ops.phasepack, on the CPU: the kernel packing, the packed and the
fused layers, the tree transform alone and after int8, the weight files, the
packed cascade, the TP rule, the CLI flag and the refusals.

Inputs are seeded numpy arrays; the JAX side runs NHWC / HWIO, the port
NCHW / OIHW. A packed layer sums the plain layer's products and exact zeros
in another order, so layers are held at the JAX test's bounds (atol 2e-5,
rtol 1e-5), trees and kernels bit for bit, cascades flip-aware.
"""

import argparse

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand3d_tpu import weights as j_weights
from hand3d_tpu.cli import _common as j_common
from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.ops import phasepack as j_pp
from hand3d_tpu.ops.quant import quantize_params_int8 as j_quantize
from hand3d_tpu.parallel import mesh as j_mesh
from hand3d_tpu_torch import parity, weights
from hand3d_tpu_torch.cli import _common
from hand3d_tpu_torch.models import handsegnet
from hand3d_tpu_torch.ops import nn, phasepack, quant
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.serving import HandPoseEstimator

from test_torch_cascade import (COORD3D_ATOL, FLIP_BOUND, SCOREMAP_ATOL,
                                _jax_fields, _jax_rerun)
from torch_tmp import tmp_path  # noqa: F401

ATOL, RTOL = 2e-5, 1e-5
# (batch, height, width, in, out, seed): tests/test_ops_phasepack.py's
SHAPES = [(2, 24, 32, 64, 64, 0), (1, 15, 20, 3, 64, 1), (3, 8, 8, 21, 32, 2)]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def layer(seed, ic, oc, k=3):
    """A TF-layout conv layer with a bias that is not constant."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.2, 0.2, (k, k, ic, oc)).astype(np.float32)
    return {"weights": w,
            "biases": rng.normal(0, 0.1, oc).astype(np.float32)}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def assert_trees_equal(got, want):
    flat_got, flat_want = (weights.tree_to_flat(t) for t in (got, want))
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        g = flat_got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def cascade_params():
    return np_tree(JaxCascade().init(jax.random.PRNGKey(0)))


def test_pack_kernel_equals_jax():
    w = layer(3, 5, 7)["weights"]
    want = np.asarray(j_pp.pack_kernel(jnp.asarray(w)))
    got = phasepack.pack_kernel(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    assert tuple(got.shape) == (14, 5, 3, 4)
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(phasepack._pack_hwio(w), want)
    with pytest.raises(ValueError, match="3x3"):
        phasepack.pack_kernel(torch.zeros(4, 2, 1, 1))


@pytest.mark.parametrize("b, h, w, ic, oc, seed", SHAPES)
def test_packed_layers_match_jax_and_the_plain_layers(b, h, w, ic, oc, seed):
    p = layer(seed, ic, oc)
    x = np.random.default_rng(seed + 10).normal(size=(b, h, w, ic)).astype(
        np.float32)
    j_packed = {"weights_p2": j_pp.pack_kernel(jnp.asarray(p["weights"])),
                "biases": jnp.asarray(p["biases"])}
    t_plain = weights.params_from_jax(p, "cpu")
    t_packed = phasepack.phase_pack_params({"conv1_2": t_plain})["conv1_2"]
    xt = nchw(x)
    with torch.no_grad():
        plain = nn.conv2d(xt, t_plain)
        for interleave in (True, False):
            want = np.asarray(j_pp.conv2d_phase_packed(
                jnp.asarray(x), j_packed, interleave=interleave))
            got = phasepack.conv2d_phase_packed(xt, t_packed,
                                                interleave=interleave)
            np.testing.assert_allclose(nhwc(got), want, atol=ATOL, rtol=RTOL)
        dispatched = nn.conv2d(xt, t_packed)
        assert dispatched.shape == plain.shape
        np.testing.assert_allclose(nhwc(dispatched), nhwc(plain), atol=ATOL,
                                   rtol=RTOL)
        fused = phasepack.conv_relu_pool_packed(xt, t_packed)
        np.testing.assert_allclose(
            nhwc(fused), np.asarray(j_pp.conv_relu_pool_packed(
                jnp.asarray(x), j_packed)), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            nhwc(fused), nhwc(nn.max_pool_2x2(nn.leaky_relu(plain))),
            atol=ATOL, rtol=RTOL)


def test_bf16_packed_layer_rounds_like_the_plain_one():
    """compute_dtype: x and the kernel rounded to bf16, summed in f32, as
    JAX's bf16 packed layer and the port's plain bf16 conv do."""
    p = layer(4, 16, 32)
    x = np.random.default_rng(5).normal(size=(2, 12, 16, 16)).astype(
        np.float32)
    j_packed = {"weights_p2": j_pp.pack_kernel(jnp.asarray(p["weights"])),
                "biases": jnp.asarray(p["biases"])}
    t_plain = weights.params_from_jax(p, "cpu")
    t_packed = phasepack.phase_pack_params({"conv1_2": t_plain})["conv1_2"]
    with torch.no_grad():
        got = phasepack.conv2d_phase_packed(nchw(x), t_packed,
                                            compute_dtype=torch.bfloat16)
        plain = nn.conv2d(nchw(x), t_plain, compute_dtype=torch.bfloat16)
    want = np.asarray(j_pp.conv2d_phase_packed(jnp.asarray(x), j_packed,
                                               compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(nhwc(got), nhwc(plain), atol=ATOL, rtol=RTOL)


def test_phase_pack_params_equal_jax(cascade_params):
    """The transform on the TF-layout tree is JAX's bit for bit; on a torch
    tree it is JAX's after params_from_jax. conv1_2 of HandSegNet and
    PoseNet alone are packed."""
    want = np_tree(j_pp.phase_pack_params(cascade_params))
    got = phasepack.phase_pack_params(cascade_params)
    assert_trees_equal(got, want)
    packed = {(s, n) for s, t in got.items() for n, l in t.items()
              if "weights_p2" in l}
    assert packed == {("HandSegNet", "conv1_2"), ("PoseNet2D", "conv1_2")}
    assert_trees_equal(
        weights.params_to_jax(phasepack.phase_pack_params(
            weights.params_from_jax(cascade_params, "cpu"))), want)
    # a selector reaches other layers; the shape guards still hold
    sel = phasepack.phase_pack_params(
        cascade_params, packable=lambda n: n in ("conv1_1", "conv2_1"))
    assert "weights_p2" in sel["HandSegNet"]["conv1_1"]
    assert "weights" in sel["HandSegNet"]["conv2_1"]  # 128 out: too wide


def test_int8_then_pack_equals_jax(cascade_params):
    """quantize_params_int8(scopes={"handsegnet"}) then phase_pack_params:
    JAX's tree through params_from_jax equals the port's made on a torch
    tree, and packing leaves the int8 layers untouched."""
    want = np_tree(j_pp.phase_pack_params(j_quantize(
        cascade_params, scopes={"handsegnet"})))
    seg = quant.quantize_params_int8(
        weights.params_from_jax(cascade_params, "cpu"),
        scopes={"handsegnet"})
    got = phasepack.phase_pack_params(seg)
    assert_trees_equal(weights.params_to_jax(got), want)
    assert got["HandSegNet"]["conv3_1"]["weights_q"] is \
        seg["HandSegNet"]["conv3_1"]["weights_q"]
    assert "weights_p2" in got["HandSegNet"]["conv1_2"]
    # the int8 and QAT helpers pass a packed layer by
    assert quant.quantize_params_int8(got)["HandSegNet"]["conv1_2"][
        "weights_p2"] is got["HandSegNet"]["conv1_2"]["weights_p2"]
    assert quant.qat_view(got)["PoseNet2D"]["conv1_2"]["weights_p2"] is \
        got["PoseNet2D"]["conv1_2"]["weights_p2"]
    assert nn._kernel_key(got["PoseNet2D"]["conv1_2"]) == "weights_p2"


def test_packed_weight_files_load(cascade_params, tmp_path):  # noqa: F811
    """A JAX-written packed .npz loads through the port's load_npz and
    params_from_jax; params_to_jax gives the tree back bit for bit."""
    tree = np_tree(j_pp.phase_pack_params(cascade_params))
    path = str(tmp_path / "packed.npz")
    j_weights.save_npz(path, tree)
    loaded = weights.load_npz(path)
    assert_trees_equal(loaded, tree)
    back = weights.params_to_jax(weights.params_from_jax(loaded, "cpu"))
    assert_trees_equal(back, tree)
    assert tuple(weights.params_from_jax(loaded, "cpu")["HandSegNet"][
        "conv1_2"]["weights_p2"].shape) == (128, 64, 3, 4)


def test_packed_cascade_matches_jax_packed_cascade(cascade_params):
    """The golden inputs (PRNGKey(0) params, a PRNGKey(1) 2x120x160 image)
    through both packed cascades, held flip-aware; and the port's packed
    cascade against its plain one."""
    net = JaxCascade()
    packed = j_pp.phase_pack_params(
        jax.tree_util.tree_map(jnp.asarray, cascade_params))
    image = jax.random.uniform(jax.random.PRNGKey(1), (2, 120, 160, 3)) - 0.5
    side = jnp.asarray([[1.0, 0.0], [0.0, 1.0]])
    ref = _jax_fields(net, packed, image, side)
    t_image = torch.from_numpy(np.array(image))
    t_side = torch.from_numpy(np.array(side))
    t_packed = weights.params_from_jax(np_tree(packed), "cpu")
    got = parity.port_fields(t_packed, t_image, t_side)
    bounds = dict(scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
                  flip_bound=FLIP_BOUND)
    summary = parity.check_cascade(
        ref, got, _jax_rerun(net, packed, image, side), **bounds)
    assert summary["uv_keypoints_held_exact"] >= 10, summary
    t_plain = weights.params_from_jax(cascade_params, "cpu")
    plain = parity.port_fields(t_plain, t_image, t_side)
    summary = parity.check_cascade(
        plain, got, parity.port_rerun(t_plain, t_image, t_side), **bounds)
    assert summary["uv_keypoints_held_exact"] >= 10, summary


def test_odd_width_and_stride_raise():
    """Neither falls back to the plain conv."""
    packed = phasepack.phase_pack_params(
        {"conv1_2": weights.params_from_jax(layer(6, 4, 8), "cpu")})["conv1_2"]
    x = torch.zeros(1, 4, 6, 7)
    for op in (phasepack.conv2d_phase_packed, phasepack.conv_relu_pool_packed,
               nn.conv2d):
        with pytest.raises(ValueError, match="even input width"):
            op(x, packed)
    with pytest.raises(ValueError, match="stride 1, not 2"):
        nn.conv2d(torch.zeros(1, 4, 6, 8), packed, stride=2)


def test_packed_layer_under_a_one_rank_row_split():
    """Spatial partitioning's path (halo rows, marks, the pool's row rule)
    on a mesh of one rank: HandSegNet's packed forward equals the unsplit
    one to float noise (the halo rows change the conv's summation order).
    Two and four ranks: test_torch_parallel.py and chip_smoke.py."""
    params = phasepack.phase_pack_params(weights.params_from_jax(
        np_tree(JaxCascade().init(jax.random.PRNGKey(2)))["HandSegNet"],
        "cpu"))
    image = torch.from_numpy(np.random.default_rng(8).normal(
        0, 0.2, (1, 32, 48, 3)).astype(np.float32))
    constrain = mesh_lib.spatial_constrainer(mesh_lib.make_mesh())
    with torch.no_grad():
        want = handsegnet.apply(params, image)[0]
        got = handsegnet.apply(params, image, constrain=constrain)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=SCOREMAP_ATOL)


@pytest.mark.parametrize("model_size", [2, 4])
def test_tp_spec_of_a_packed_tree_is_jax_rule(cascade_params, model_size):
    """A packed layer stays replicated under "model" in both packages; the
    rest of the tree keeps its split."""
    tree = np_tree(j_pp.phase_pack_params(
        j_quantize(cascade_params, scopes={"handsegnet"})))
    t_tree = weights.tree_to_flat(weights.params_from_jax(tree, "cpu"))
    sharded = 0
    for path, value in weights.tree_to_flat(tree).items():
        keys = tuple(path.split("/"))
        spec = j_mesh._spec_for_param(keys, value, model_size)
        dim = next((i for i, a in enumerate(spec) if a == "model"), None)
        want = None if dim is None else (0 if value.ndim == 4 else dim)
        assert mesh_lib._spec_for_param(keys, t_tree[path],
                                        model_size) == want, path
        sharded += want is not None
        if keys[-1] == "weights_p2" or keys[-2] == "conv1_2":
            assert want is None, path
    assert sharded > 0


@pytest.mark.parametrize("flags", [["--phase-pack"],
                                   ["--quantize", "int8", "--phase-pack"]])
def test_phase_pack_flag_equals_jax(cascade_params, flags):
    """--phase-pack packs after --quantize, as the JAX CLIs do."""
    p = argparse.ArgumentParser()
    j_common.add_quantize_arg(p)
    j_args = p.parse_args(flags)
    p = argparse.ArgumentParser()
    _common.add_quantize_arg(p)
    args = p.parse_args(flags)
    args.device = "cpu"
    want = np_tree(j_common.maybe_quantize(cascade_params, j_args))
    got = _common.maybe_quantize(cascade_params, args)
    if "--quantize" in flags:
        got = weights.params_to_jax(got)
    assert_trees_equal(got, want)


def test_packed_estimator_serves_the_packed_cascade(cascade_params):
    """HandPoseEstimator(phase_pack=True), alone and after HandSegNet-scoped
    int8, answers as the cascade on the port's own packed tree does."""
    from hand3d_tpu_torch.models.cascade import ColorHandPose3D

    images = np.random.default_rng(9).integers(0, 256, (2, 48, 64, 3),
                                               dtype=np.uint8)
    image = torch.from_numpy(images.astype(np.float32) / 255.0 - 0.5)
    t_plain = weights.params_from_jax(cascade_params, "cpu")
    for kw, tree in (
            ({}, phasepack.phase_pack_params(t_plain)),
            ({"quantize": "int8", "quantize_scope": {"handsegnet"}},
             phasepack.phase_pack_params(quant.quantize_params_int8(
                 t_plain, scopes={"handsegnet"})))):
        est = HandPoseEstimator(cascade_params, batch_size=2,
                                input_hw=(48, 64), device="cpu",
                                phase_pack=True, **kw)
        out = est.predict(images)
        with torch.no_grad():
            want = ColorHandPose3D().inference(tree, image, est.hand_side)
        for k in ("keypoint_uv21", "keypoint_coord3d", "hand_scoremap"):
            np.testing.assert_array_equal(out[k], getattr(want, k).numpy(),
                                          err_msg=k)
