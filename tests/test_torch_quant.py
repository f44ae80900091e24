"""int8 quantization of the port (hand3d_tpu_torch.ops.quant) against
hand3d_tpu.ops.quant, on the CPU.

Params are the JAX cascade's PRNGKey(0) tree and the golden image of
tests/test_golden_regression.py (PRNGKey(1), 2 x 120 x 160), converted by
``weights.params_from_jax``. The JAX package's static act scales are keyed by
``id()`` of a weights leaf; the port's by the layer's path, so the JAX
scales are mapped from id to path before they are compared or used.

Tolerances:
  * quantized weights and scales: bit for bit (same f32 operations);
  * each int8 conv and FC on the same input: bit for bit while the integer
    accumulator stays below 2**24 (both sides sum exact integers in f32);
  * calibrated act scales: the port's and JAX's float activations differ
    by float noise, CALIB_RTOL_OF_MAX of each layer's largest scale;
  * cascades: flip-aware (parity.check_cascade) at the INT8_* bounds below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.ops import nn as j_nn
from hand3d_tpu.ops import quant as j_quant
from hand3d_tpu_torch import parity, weights
from hand3d_tpu_torch.models.cascade import ColorHandPose3D
from hand3d_tpu_torch.ops import nn, quant

from test_torch_cascade import _jax_fields, _jax_rerun
from torch_threads import torch_threads_per_worker  # noqa: F401

# the eager JAX calibration and the port's see the same activations up to
# float noise: each layer's per-channel scales agree within this share of
# the layer's largest scale (a small channel's own relative error is
# larger: 1.7e-5 on HandSegNet conv3_1's smallest, measured)
CALIB_RTOL_OF_MAX = 1e-5
# int8 cascade, port vs JAX on bit-equal quantized trees. Each int8 layer
# is bit-equal on the same input (below), but a float layer's output one ulp
# apart on the two sides (HandSegNet's and PoseNet's first four convs stay
# float) puts an activation on the other side of a rounding boundary of the
# next grid now and then, one step of that grid, which moves everything
# after it; a dynamic grid (max|x| / 127) moves with the ulp too. Measured
# on the golden input (int8 / int8_static): hand_scoremap 7.1e-5 / 3.0e-5,
# PoseNet's scoremap 3.4e-5 / 1.7e-5, coord3d 7.5e-9 / 7.5e-9, 175 / 107
# mask pixels flipped; int8 itself moves them from f32 by 9.8e-5 / 6.3e-5,
# 1.4e-4 / 1.6e-4 and 6.9e-4 / 6.2e-4. As bf16, two correct int8 runs
# differ by a good share of int8's distance from f32, so the cascade is held
# at these bounds (~3x the measured) and exactness is shown where no float
# layer comes first: a HandSegNet with every layer int8.
INT8_SCOREMAP_ATOL = 2e-4
INT8_FLIP_BOUND = 4e-4
INT8_COORD3D_ATOL = 1e-5
ACC_EXACT = 2.0 ** 24


@pytest.fixture(scope="module")
def golden():
    net = JaxCascade()
    params = net.init(jax.random.PRNGKey(0))
    image = jax.random.uniform(jax.random.PRNGKey(1), (2, 120, 160, 3)) - 0.5
    side = jnp.asarray([[1.0, 0.0], [0.0, 1.0]])
    return net, params, image, side


@pytest.fixture(scope="module")
def np_params(golden):
    return jax.tree_util.tree_map(np.asarray, golden[1])


def id_to_path(tree):
    """{id(weights leaf): path} of a JAX tree."""
    out = {}

    def walk(p, path):
        if isinstance(p, dict):
            if "weights" in p:
                out[id(p["weights"])] = path
            for k, v in p.items():
                walk(v, path + (k,))

    walk(tree, ())
    return out


def by_path(tree, act_scales):
    """JAX's id-keyed act scales of ``tree`` keyed by path."""
    paths = id_to_path(tree)
    return {paths[k]: np.asarray(v) for k, v in act_scales.items()}


@pytest.fixture(scope="module")
def jax_calibration(golden):
    """JAX's eager calibration on the golden image, by path."""
    net, params, image, side = golden
    scales = j_quant.calibrate_act_scales(
        lambda p, b: net.inference(p, b, side), params, [image])
    return by_path(params, scales)


def assert_trees_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert_trees_equal(got[k], v)
        else:
            assert got[k].dtype == v.dtype, k
            assert torch.equal(got[k], v), k


def as_port(tree):
    return weights.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   "cpu")


# --- the tree transform ------------------------------------------------------

TRANSFORMS = {
    "dynamic": {},
    "static": {"act_scales": "calibrated"},
    "scopes": {"scopes": {"handsegnet", "ViewpointNet"}},
    "include": {"scopes": {"posenet2d"},
                "include_substrings": {"conv6", "conv7"}},
    "all_channels": {"min_in_chan": 0, "min_out_chan": 0},
    "skip": {"skip_substrings": ("conv4", "fc_vp")},
}


@pytest.mark.parametrize("case", list(TRANSFORMS))
def test_quantized_tree_matches_jax(golden, np_params, jax_calibration,
                                    case):
    """quantize_params_int8 of the converted tree == the conversion of
    JAX's quantize_params_int8 of the JAX tree, leaf for leaf, bit for bit
    (int8 kernels OIHW, f32 scales); quantizing again changes nothing."""
    kw = dict(TRANSFORMS[case])
    j_kw, t_kw = dict(kw), dict(kw)
    if kw.get("act_scales") == "calibrated":
        ids = {path: i for i, path in id_to_path(golden[1]).items()}
        j_kw["act_scales"] = {ids[p]: s for p, s in jax_calibration.items()}
        t_kw["act_scales"] = jax_calibration
    want = as_port(j_quant.quantize_params_int8(golden[1], **j_kw))
    got = quant.quantize_params_int8(weights.params_from_jax(np_params,
                                                             "cpu"), **t_kw)
    assert_trees_equal(got, want)
    n_int8 = len([p for p, l in quant.layer_paths(got).items()
                  if "weights_q" in l])
    assert n_int8 > 0
    if case == "static":
        assert sum("act_scale" in l for l in quant.layer_paths(got).values()
                   ) == n_int8
    assert_trees_equal(quant.quantize_params_int8(got, **t_kw), got)
    # the QAT view gates the same layers
    view = quant.qat_view(weights.params_from_jax(np_params, "cpu"),
                          **{k: v for k, v in t_kw.items()
                             if k != "include_substrings"})
    fq = {p for p, l in quant.layer_paths(view).items() if "weights_fq" in l}
    if "include_substrings" not in kw:
        assert fq == {p for p, l in quant.layer_paths(got).items()
                      if "weights_q" in l}


def test_dequantize_and_unit_scales_match_jax(golden, np_params):
    params = golden[1]
    j_unit = j_quant.unit_act_scales(params)
    t_unit = quant.unit_act_scales(weights.params_from_jax(np_params, "cpu"))
    assert {k: v.tolist() for k, v in by_path(params, j_unit).items()} == {
        k: v.tolist() for k, v in t_unit.items()}
    q = j_quant.quantize_params_int8(params, act_scales=j_unit)
    t_q = as_port(q)
    for path, layer in quant.layer_paths(t_q).items():
        if "weights_q" not in layer:
            continue
        j_layer = q
        for k in path:
            j_layer = j_layer[k]
        want = as_port({"w": {"weights": j_quant.dequantize_weights(j_layer),
                              "biases": j_layer["biases"]}})["w"]["weights"]
        assert torch.equal(quant.dequantize_weights(layer), want), path


def test_calibrated_act_scales_match_jax(golden, np_params, jax_calibration):
    """calibrate_act_scales on the port's cascade (eager, the observer in
    ops.nn) against JAX's eager calibration: the same layers, by path, the
    same per-channel scales within CALIB_RTOL_OF_MAX."""
    _, _, image, side = golden
    net = ColorHandPose3D()
    t_params = weights.params_from_jax(np_params, "cpu")
    got = quant.calibrate_act_scales(
        lambda p, b: net.inference(p, b, torch.from_numpy(np.array(side))),
        t_params, [torch.from_numpy(np.array(image))])
    assert set(got) == set(jax_calibration)
    assert len(got) == 67  # 59 convs, 8 FCs
    worst = 0.0
    for path, want in jax_calibration.items():
        assert got[path].dtype == np.float32 and got[path].shape == want.shape
        worst = max(worst, np.abs(got[path] - want).max() / want.max())
    assert worst <= CALIB_RTOL_OF_MAX


def test_paths_that_name_no_layer_raise(np_params):
    t_params = weights.params_from_jax(np_params, "cpu")
    bad = {("PoseNet2D", "conv9_9"): np.ones(3, np.float32)}
    with pytest.raises(ValueError, match="name no layer"):
        quant.quantize_params_int8(t_params, act_scales=bad)
    with pytest.raises(ValueError, match="name no layer"):
        quant.qat_view(t_params, act_scales=bad)
    with pytest.raises(ValueError, match="unknown quantize scope"):
        quant.quantize_params_int8(t_params, scopes={"posenet3d"})
    # a model run on another tree: the observer meets no layer of this one
    other = weights.params_from_jax(np_params, "cpu")
    net = ColorHandPose3D()
    with pytest.raises(ValueError, match="ran no layer"):
        quant.calibrate_act_scales(
            lambda p, b: net.inference(other, b, torch.ones(1, 2)),
            t_params, [torch.zeros(1, 32, 32, 3)])
    assert nn._act_observer is None


# --- the int8 layers ---------------------------------------------------------


def recorded_layers(monkeypatch, run):
    """Every conv2d and dense call of the JAX ``run()``: (stride or None for
    an FC, x, params, y) as numpy."""
    calls = []
    conv, dense = j_nn.conv2d, j_nn.dense

    def conv2d(x, params, stride=1, compute_dtype=None):
        y = conv(x, params, stride, compute_dtype)
        calls.append((stride, np.asarray(x), params, np.asarray(y)))
        return y

    def fc(x, params, compute_dtype=None):
        y = dense(x, params, compute_dtype)
        calls.append((None, np.asarray(x), params, np.asarray(y)))
        return y

    monkeypatch.setattr(j_nn, "conv2d", conv2d)
    monkeypatch.setattr(j_nn, "dense", fc)
    run()
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_int8_layers_match_jax_layer_by_layer(golden, jax_calibration,
                                              monkeypatch, mode):
    """Each layer of JAX's eager int8 cascade, fed its recorded input: the
    port's layer on the converted layer dict gives the same output bit for
    bit (every accumulator of this run stays below 2**24)."""
    net, params, image, side = golden
    ids = {path: i for i, path in id_to_path(params).items()}
    act = ({ids[p]: s for p, s in jax_calibration.items()}
           if mode == "int8_static" else None)
    q = j_quant.quantize_params_int8(params, act_scales=act)
    calls = recorded_layers(monkeypatch,
                            lambda: net.inference(q, image[:1], side[:1]))
    assert len(calls) == 67
    n_int8 = 0
    for stride, x, p, want in calls:
        layer = as_port({"l": p})["l"]
        x = torch.from_numpy(x.copy())
        if stride is None:
            got = nn.dense(x, layer).numpy()
        else:
            got = nn.conv2d(x.permute(0, 3, 1, 2), layer,
                            stride).permute(0, 2, 3, 1).numpy()
        if "weights_q" in layer:
            n_int8 += 1
            if stride is not None:
                acc, _ = quant.conv2d_accumulator(x.permute(0, 3, 1, 2),
                                                  layer, stride)
                assert acc.abs().max() < ACC_EXACT
            assert np.array_equal(got, want), (stride, x.shape)
        else:  # float layers: summation order only
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert n_int8 == 46  # of 59 convs and 8 FCs


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_int8_cascade_matches_jax(golden, np_params, jax_calibration, mode):
    """ColorHandPose3D on the port's int8 tree against the JAX cascade (one
    jit) on JAX's: flip-aware at the INT8_* bounds. Both trees come from the
    same scales (int8_static: JAX's calibration), so they are bit-equal."""
    net, params, image, side = golden
    ids = {path: i for i, path in id_to_path(params).items()}
    act = ({ids[p]: s for p, s in jax_calibration.items()}
           if mode == "int8_static" else None)
    q = j_quant.quantize_params_int8(params, act_scales=act)
    t_q = quant.quantize_params_int8(
        weights.params_from_jax(np_params, "cpu"),
        act_scales=jax_calibration if act else None)
    ref = _jax_fields(net, q, image, side)
    got = parity.port_fields(t_q, torch.from_numpy(np.array(image)),
                             torch.from_numpy(np.array(side)))
    summary = parity.check_cascade(
        ref, got, _jax_rerun(net, q, image, side),
        scoremap_atol=INT8_SCOREMAP_ATOL, coord3d_atol=INT8_COORD3D_ATOL,
        flip_bound=INT8_FLIP_BOUND)
    # the quantization is there: int8 is far from f32
    f32 = parity.port_fields(weights.params_from_jax(np_params, "cpu"),
                             torch.from_numpy(np.array(image)),
                             torch.from_numpy(np.array(side)))
    assert summary["mask_pixels_flipped"] < 0.01 * got["detmap"].size
    assert np.abs(f32["scoremap"] - got["scoremap"]).max() \
        > 2 * summary["scoremap_max_abs_err"]


def test_all_int8_handsegnet_matches_jax_exactly(golden, np_params,
                                                 monkeypatch):
    """With every layer int8 (no channel gate) no float conv comes before a
    quantizer: quantize, the exact integer sums, dequant, bias, leaky ReLU
    and max pool are the same IEEE operations on both sides, so HandSegNet's
    logits are bit-equal to JAX's; only the final bilinear upsampling
    differs, by float noise."""
    from hand3d_tpu.models import handsegnet as j_handsegnet
    from hand3d_tpu_torch.models import handsegnet

    _, params, image, _ = golden
    kw = dict(min_in_chan=0, min_out_chan=0)
    q = j_quant.quantize_params_int8(params["HandSegNet"], **kw)
    t_q = quant.quantize_params_int8(
        weights.params_from_jax(np_params, "cpu")["HandSegNet"], **kw)
    assert len(quant.layer_paths(t_q)) == 16 and all(
        "weights_q" in l for l in quant.layer_paths(t_q).values())
    logits = {}

    def keep_logits(resize):
        def wrapped(x, hw):
            logits.setdefault("jax" if isinstance(x, jax.Array) else "port",
                              np.asarray(x))
            return resize(x, hw)
        return wrapped

    for mod in (j_handsegnet, handsegnet):
        monkeypatch.setattr(mod, "resize_bilinear",
                            keep_logits(mod.resize_bilinear))
    want = np.asarray(j_handsegnet.apply(q, image)[-1])
    with torch.inference_mode():
        got = handsegnet.apply(t_q, torch.from_numpy(np.array(image))
                               )[-1].numpy()
    assert np.array_equal(logits["port"], logits["jax"])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# --- conv2d_transpose ----------------------------------------------------------

TRANSPOSE_CASES = [((4, 3), (5, 6)), ((3, 4), (4, 7)), ((2, 2), (3, 3)),
                   ((1, 3), (4, 5))]


@pytest.mark.parametrize("form", ["float", "dequant", "fake_quant"])
@pytest.mark.parametrize("kernel, hw", TRANSPOSE_CASES)
def test_conv2d_transpose_matches_jax(form, kernel, hw):
    """TF conv2d_transpose (stride 2, SAME) with asymmetric [kh, kw, out,
    in] kernels on odd and even inputs, in its float form, the int8 dequant
    fallback and the QAT fake-quant form."""
    rng = np.random.default_rng(sum(kernel) * 10 + hw[0])
    kh, kw = kernel
    p = {"weights": rng.standard_normal((kh, kw, 6, 8)).astype(np.float32),
         "biases": rng.standard_normal(6).astype(np.float32)}
    x = rng.standard_normal((2, *hw, 8)).astype(np.float32)
    if form == "dequant":
        p = jax.tree_util.tree_map(np.asarray, j_quant.quantize_params_int8(
            p, min_in_chan=0, min_out_chan=0))
    elif form == "fake_quant":
        p = j_quant.qat_view(p, min_in_chan=0, min_out_chan=0)
    want = np.asarray(j_nn.conv2d_transpose_relu(jnp.asarray(x), p))
    got = nn.conv2d_transpose_relu(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        as_port(p)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 6)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# --- fake quantization -------------------------------------------------------


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_fake_quant_forward_and_ste_gradients_match_jax(static, kind):
    """A QAT layer (qat_view, dynamic or static) against JAX's: the same
    forward and, through the straight-through estimator, the same gradients
    of a weighted sum with respect to the kernel, the bias and the input
    (jax.grad), within summation-order noise."""
    rng = np.random.default_rng(7 + static)
    if kind == "conv":
        p = {"weights": rng.standard_normal((3, 3, 128, 32)).astype(
            np.float32) / 30, "biases": rng.standard_normal(32).astype(
                np.float32)}
        x = rng.standard_normal((2, 9, 10, 128)).astype(np.float32)
    else:
        p = {"weights": rng.standard_normal((130, 64)).astype(np.float32)
             / 11, "biases": rng.standard_normal(64).astype(np.float32)}
        x = rng.standard_normal((3, 130)).astype(np.float32)
    s_in = (np.abs(x).reshape(-1, x.shape[-1]).max(0) * 0.8 / 127).astype(
        np.float32)
    r = rng.standard_normal((*x.shape[:-1], p["weights"].shape[-1])).astype(
        np.float32)

    def j_loss(params, x):
        act = {id(params["weights"]): s_in} if static else None
        view = j_quant.qat_view(params, act_scales=act)
        y = (j_nn.conv2d(x, view) if kind == "conv" else j_nn.dense(x, view))
        return jnp.sum(y * r), y

    (_, j_y), (j_gp, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))

    t_p = {k: v.requires_grad_() for k, v in as_port(p).items()}
    t_x = torch.from_numpy(x).requires_grad_()
    view = quant.qat_view(t_p, act_scales={(): s_in} if static else None)
    assert ("act_scale_fq" in view) == static
    if kind == "conv":
        y = nn.conv2d(t_x.permute(0, 3, 1, 2), view).permute(0, 2, 3, 1)
    else:
        y = nn.dense(t_x, view)
    (y * torch.from_numpy(r)).sum().backward()

    def close(got, want):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    close(y.detach().numpy(), j_y)
    close(t_x.grad.numpy(), j_gx)
    close(t_p["biases"].grad.numpy(), j_gp["biases"])
    close(weights.params_to_jax({"w": {"weights": t_p["weights"].grad}})
          ["w"]["weights"], j_gp["weights"])


@pytest.mark.parametrize("static", [False, True])
def test_qat_forward_equals_ptq_forward(static):
    """conv(QDQ(x), QDQ(w)) == dequant(conv(quant(x), quant(w))): the QAT
    view sees the deployed int8 numerics (linearity), up to the float
    conv's rounding (JAX's bound, 2e-4)."""
    rng = np.random.default_rng(3)
    p = weights.params_from_jax(
        {"weights": rng.standard_normal((3, 3, 32, 64)).astype(np.float32)
         / 17, "biases": np.full(64, 1e-4, np.float32)}, "cpu")
    x = torch.from_numpy(rng.standard_normal((2, 32, 12, 14)).astype(
        np.float32))
    act = ({(): (x.abs().amax((0, 2, 3)) / 127).numpy()} if static
           else None)
    qat = nn.conv2d(x, quant.qat_view(p, min_in_chan=0, act_scales=act))
    ptq = nn.conv2d(x, quant.quantize_params_int8(p, min_in_chan=0,
                                                  act_scales=act))
    assert torch.allclose(qat, ptq, rtol=0, atol=2e-4)
    assert (qat - nn.conv2d(x, p)).abs().max() > 2e-3  # not the f32 conv
