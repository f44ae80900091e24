"""The port's serving surface against hand3d_tpu.serving, on the CPU:
any-resolution estimators (SnapEstimator, AutoBucketEstimator), seg_scale,
the int8 and bf16 compute modes, and DynamicBatcher.

Params are the JAX cascade's PRNGKey(0) tree, converted by
``weights.params_from_jax``; images are seeded numpy uint8 frames. With
random weights the cascade's discrete choices sit near ties, so cascades are
held flip-aware (``parity.check_cascade``) on the frames both sides feed
their bucket, and each side's served answers are held to its own cascade on
those frames.
"""

import ast
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import image as jax_image

from hand3d_tpu import serving as j_serving
from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.ops import nn as j_nn
from hand3d_tpu_torch import parity, precision, serving, weights
from hand3d_tpu_torch.models.cascade import ColorHandPose3D
from hand3d_tpu_torch.ops import nn, quant

from test_torch_cascade import (COORD3D_ATOL, FLIP_BOUND, SCOREMAP_ATOL,
                                _jax_fields, _jax_rerun)

BUCKET = (120, 160)
# jax.image.resize vs F.interpolate(antialias=True): ~1e-7 (measured 9e-8
# shrinking or enlarging, 8e-7 shrinking one axis and enlarging the other)
RESIZE_ATOL = 1e-6
# served answers vs the same side's cascade fields: continuous outputs of
# two jitted JAX programs (the estimator's and the fields') may differ by
# float noise; the port's on the CPU are equal
SERVED_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return JaxCascade().init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def np_params(jax_params):
    return jax.tree_util.tree_map(np.asarray, jax_params)


def frames(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def left_hands(n):
    return np.tile(np.float32([[1.0, 0.0]]), (n, 1))


def hold_to_jax(jax_net, port_net, jax_params, np_params, j_image, t_image):
    """Flip-aware check of the port's cascade on ``t_image`` against the
    JAX cascade on ``j_image``; returns (ref fields, got fields, summary)."""
    side = left_hands(len(j_image))
    ref = _jax_fields(jax_net, jax_params, jnp.asarray(j_image),
                      jnp.asarray(side))
    got = parity.port_fields(weights.params_from_jax(np_params, "cpu"),
                             torch.from_numpy(t_image),
                             torch.from_numpy(side), net=port_net)
    summary = parity.check_cascade(
        ref, got, _jax_rerun(jax_net, jax_params, jnp.asarray(j_image),
                             jnp.asarray(side)),
        scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
        flip_bound=FLIP_BOUND)
    return ref, got, summary


def assert_served(out, fields, scale_uv=(1.0, 1.0), atol=0.0):
    """Served answers are the fields' (uv and center mapped back)."""
    scale = np.float32(scale_uv)
    want = {"keypoint_uv21": fields["keypoint_uv21"] * scale,
            "center": fields["center"] * scale[::-1],
            "scale_crop": fields["scale_crop"],
            "keypoint_coord3d": fields["keypoint_coord3d"]}
    for k, v in want.items():
        np.testing.assert_allclose(out[k], v, atol=atol, rtol=0, err_msg=k)


# --- resize -----------------------------------------------------------------


@pytest.mark.parametrize("src, dst", [((480, 640), (240, 320)),
                                      ((300, 500), (240, 320)),
                                      ((90, 100), (120, 160)),
                                      ((200, 100), (120, 160))])
def test_resize_matches_jax_image_resize(src, dst):
    """_resize_to is jax.image.resize(..., "bilinear"): half-pixel centers,
    antialiased where it shrinks."""
    x = serving.normalize_images(frames(2, *src, seed=sum(src)))
    want = np.asarray(jax_image.resize(x, (2, *dst, 3), "bilinear"))
    got = serving._resize_to(x, dst)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)
    np.testing.assert_array_equal(serving._resize_to(x, src), x)


# --- any-resolution estimators ----------------------------------------------


def test_auto_bucket_snap_matches_jax(jax_params, np_params):
    """AutoBucketEstimator snapping 100x140 frames into a 120x160 bucket:
    the port's cascade on its resized frames is held flip-aware to JAX's on
    JAX's, and each side serves its own cascade with uv and center mapped
    back to 100x140. SnapEstimator over a HandPoseEstimator of the bucket
    serves the same."""
    images = frames(2, 100, 140, seed=1)
    j_auto = j_serving.AutoBucketEstimator(jax_params, batch_size=2,
                                           snap_hws=[BUCKET])
    t_auto = serving.AutoBucketEstimator(np_params, batch_size=2,
                                         snap_hws=[BUCKET], device="cpu")
    j_out, t_out = j_auto.predict(images), t_auto.predict(images)
    for out, auto in ((j_out, j_auto), (t_out, t_auto)):
        assert list(auto._buckets) == [BUCKET]
        np.testing.assert_array_equal(out["snap_hw"], BUCKET)
        assert out["hand_scoremap"].shape == (2, *BUCKET, 2)

    norm = serving.normalize_images(images)
    j_img = np.asarray(jax_image.resize(norm, (2, *BUCKET, 3), "bilinear"))
    t_img = serving._resize_to(norm, BUCKET)
    np.testing.assert_allclose(t_img, j_img, atol=RESIZE_ATOL, rtol=0)
    ref, got, _ = hold_to_jax(JaxCascade(), ColorHandPose3D(), jax_params,
                              np_params, j_img, t_img)
    scale = (140 / 160, 100 / 120)
    assert_served(j_out, ref, scale, atol=SERVED_ATOL)
    assert_served(t_out, got, scale)
    assert (t_out["keypoint_uv21"][..., 0] <= 140).all()

    snap = serving.SnapEstimator(serving.HandPoseEstimator(
        np_params, batch_size=2, input_hw=BUCKET, device="cpu"))
    j_snap = j_serving.SnapEstimator(j_serving.HandPoseEstimator(
        jax_params, batch_size=2, input_hw=BUCKET))
    for got_out, want_out, atol in ((snap.predict(images), t_out, 0.0),
                                    (j_snap.predict(images), j_out,
                                     SERVED_ATOL)):
        for k, v in want_out.items():
            np.testing.assert_allclose(got_out[k], v, atol=atol, err_msg=k)


def test_auto_bucket_caps_its_buckets(np_params):
    """One bucket per resolution without snap_hws, sharing one converted
    param tree, up to max_buckets; the JAX package's error past it."""
    auto = serving.AutoBucketEstimator(np_params, batch_size=1, max_buckets=2,
                                       device="cpu")
    for hw in ((48, 64), (40, 40)):
        out = auto.predict(frames(1, *hw, seed=2))
        np.testing.assert_array_equal(out["snap_hw"], hw)
        assert out["keypoint_coord3d"].shape == (1, 21, 3)
    assert all(b.params is auto.params for b in auto._buckets.values())
    with pytest.raises(RuntimeError, match="over 2 resolution buckets"):
        auto.predict(np.zeros((1, 30, 40, 3), np.uint8))


def test_snap_path_normalizes_exactly_once(np_params):
    """An all-bright float image is still in [0, 1] after mean subtraction;
    a second normalize_images pass would shift it again. The snap path must
    match normalize -> resize -> predict(normalized=True), as the JAX
    package's does (tests/test_cli.py)."""
    auto = serving.AutoBucketEstimator(np_params, batch_size=1,
                                       snap_hws=[(48, 64)], device="cpu")
    bright = np.full((1, 40, 56, 3), 0.9, np.float32)
    got = auto.predict(bright)
    manual = serving._resize_to(serving.normalize_images(bright), (48, 64))
    want = auto._bucket((48, 64)).predict(manual, normalized=True)
    np.testing.assert_array_equal(
        got["keypoint_uv21"],
        want["keypoint_uv21"] * np.float32([56 / 64, 40 / 48]))
    np.testing.assert_array_equal(got["keypoint_coord3d"],
                                  want["keypoint_coord3d"])


def test_seg_scale_estimator_matches_jax(jax_params, np_params):
    """HandPoseEstimator(seg_scale=0.5): localization at 60x80, held
    flip-aware to the JAX estimator's cascade; each side serves its own."""
    images = frames(2, *BUCKET, seed=3)
    j_out = j_serving.HandPoseEstimator(jax_params, batch_size=2,
                                        input_hw=BUCKET,
                                        seg_scale=0.5).predict(images)
    t_out = serving.HandPoseEstimator(np_params, batch_size=2,
                                      input_hw=BUCKET, seg_scale=0.5,
                                      device="cpu").predict(images)
    norm = serving.normalize_images(images)
    ref, got, _ = hold_to_jax(JaxCascade(seg_scale=0.5),
                              ColorHandPose3D(seg_scale=0.5), jax_params,
                              np_params, norm, norm)
    assert got["hand_scoremap"].shape == (2, 60, 80, 2)
    assert t_out["hand_scoremap"].shape == (2, *BUCKET, 2)
    assert_served(j_out, ref, atol=SERVED_ATOL)
    assert_served(t_out, got)


@pytest.mark.parametrize("kwargs, queue", [
    ({"phase_pack": True}, "even input width")])
def test_unported_options_raise(np_params, kwargs, queue):
    """phase_pack runs (tests/test_torch_phasepack.py) but refuses an odd
    input width rather than fall back to the plain conv."""
    odd = frames(1, 32, 34 - 1, seed=4)
    with pytest.raises(ValueError, match=queue):
        serving.HandPoseEstimator(np_params, batch_size=1, input_hw=(32, 33),
                                  device="cpu", **kwargs).predict(odd)
    with pytest.raises(ValueError, match=queue):
        serving.AutoBucketEstimator(np_params, batch_size=1, device="cpu",
                                    **kwargs).predict(odd)


def test_estimator_on_a_one_rank_mesh_equals_no_mesh(np_params):
    """mesh= (tests/test_torch_mesh.py runs two ranks): on a mesh of one
    rank, the estimator and a bucket of AutoBucketEstimator answer as
    without one, bit for bit."""
    from hand3d_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    images = frames(3, *BUCKET, seed=21)
    want = serving.HandPoseEstimator(np_params, batch_size=2,
                                     input_hw=BUCKET, device="cpu")
    for est in (serving.HandPoseEstimator(np_params, batch_size=2,
                                          input_hw=BUCKET, device="cpu",
                                          mesh=mesh),
                serving.AutoBucketEstimator(np_params, batch_size=2,
                                            device="cpu", mesh=mesh)):
        got, ref = est.predict(images), want.predict(images)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# --- int8 -------------------------------------------------------------------

QUANTIZE_CASES = {
    "int8": {"quantize": "int8"},
    "int8_seg": {"quantize": "int8", "quantize_scope": {"handsegnet"}},
    "int8_static": {"quantize": "int8_static",
                    "calibration_images": frames(3, *BUCKET, seed=12)},
}


@pytest.mark.parametrize("case", list(QUANTIZE_CASES))
def test_quantized_estimators_match_jax(jax_params, np_params, case):
    """HandPoseEstimator(quantize=..., quantize_scope=...,
    calibration_images=...) on both sides: the port's int8 tree is JAX's
    (bit for bit; int8_static's scales, calibrated by each side's own float
    cascade on the same images, within CALIB_RTOL_OF_MAX of each layer's
    largest), its cascade is held flip-aware to JAX's at the int8 bounds of
    tests/test_torch_quant.py, each side serves its own cascade, and
    AutoBucketEstimator serves the same as the estimator."""
    from test_torch_quant import (CALIB_RTOL_OF_MAX, INT8_COORD3D_ATOL,
                                  INT8_FLIP_BOUND, INT8_SCOREMAP_ATOL)

    kwargs = QUANTIZE_CASES[case]
    images = frames(2, *BUCKET, seed=6)
    j_est = j_serving.HandPoseEstimator(jax_params, batch_size=2,
                                        input_hw=BUCKET, **kwargs)
    est = serving.HandPoseEstimator(np_params, batch_size=2, input_hw=BUCKET,
                                    device="cpu", **kwargs)
    assert est.params.quantize is not None
    want_tree = weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, j_est.params), "cpu")
    n_int8 = 0
    for path, layer in quant.layer_paths(want_tree).items():
        got = quant.layer_paths(est.params)[path]
        assert set(got) == set(layer), path
        n_int8 += "weights_q" in layer
        if "act_scale" in layer:
            s, w = got["act_scale"], layer["act_scale"]
            assert (s - w).abs().max() <= CALIB_RTOL_OF_MAX * w.max(), path
            continue
        for k in layer:
            assert torch.equal(got[k], layer[k]), (path, k)
    assert n_int8 == (12 if case == "int8_seg" else 46)

    j_out = j_est.predict(images)
    t_out = est.predict(images)
    norm = serving.normalize_images(images)
    side = left_hands(2)
    ref = _jax_fields(JaxCascade(), j_est.params, jnp.asarray(norm),
                      jnp.asarray(side))
    got = parity.port_fields(est.params, torch.from_numpy(norm),
                             torch.from_numpy(side))
    parity.check_cascade(
        ref, got, _jax_rerun(JaxCascade(), j_est.params, jnp.asarray(norm),
                             jnp.asarray(side)),
        scoremap_atol=INT8_SCOREMAP_ATOL, coord3d_atol=INT8_COORD3D_ATOL,
        flip_bound=INT8_FLIP_BOUND)
    assert_served(j_out, ref, atol=SERVED_ATOL)
    assert_served(t_out, got)
    auto = serving.AutoBucketEstimator(np_params, batch_size=2, device="cpu",
                                       **kwargs)
    assert auto.params.quantize == est.params.quantize
    for k, v in auto.predict(images).items():
        if k != "snap_hw":
            np.testing.assert_array_equal(v, t_out[k], err_msg=k)


def test_quantize_options_are_checked(np_params):
    with pytest.raises(ValueError, match="quantize must be one of"):
        serving.HandPoseEstimator(np_params, device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="requires quantize"):
        serving.HandPoseEstimator(np_params, device="cpu",
                                  quantize_scope={"handsegnet"})
    with pytest.raises(ValueError, match="needs calibration_images"):
        serving.HandPoseEstimator(np_params, device="cpu",
                                  quantize="int8_static")
    with pytest.raises(ValueError, match="unknown quantize scope"):
        serving.HandPoseEstimator(np_params, device="cpu", quantize="int8",
                                  quantize_scope={"posenet3d"})


# --- bf16 -------------------------------------------------------------------


# bf16 operands, f32 sums: the port and XLA differ in summation order only
BF16_RTOL_OF_MAX = 1e-5


@pytest.mark.parametrize("stride, ksize, cin, cout",
                         [(1, 3, 64, 128), (2, 3, 21, 32), (1, 7, 149, 128),
                          (1, 1, 512, 2)])
def test_bf16_conv_matches_jax(stride, ksize, cin, cout):
    rng = np.random.default_rng(ksize * cin)
    x = rng.standard_normal((2, 17, 20, cin)).astype(np.float32)
    p = {"weights": (rng.standard_normal((ksize, ksize, cin, cout))
                     / np.sqrt(ksize * ksize * cin)).astype(np.float32),
         "biases": rng.standard_normal(cout).astype(np.float32)}
    want = np.asarray(j_nn.conv2d(jnp.asarray(x), p, stride,
                                  compute_dtype=jnp.bfloat16))
    t = weights.params_from_jax(p, "cpu")
    got = nn.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), t, stride,
                    torch.bfloat16).permute(0, 2, 3, 1).numpy()
    f32 = nn.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), t,
                    stride).permute(0, 2, 3, 1).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_RTOL_OF_MAX * scale
    # the rounding is there: bf16 differs from f32 by far more
    assert np.abs(f32 - want).max() > 100 * BF16_RTOL_OF_MAX * scale


def test_bf16_dense_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 2050)).astype(np.float32)
    p = {"weights": (rng.standard_normal((2050, 512)) / 45).astype(
        np.float32), "biases": rng.standard_normal(512).astype(np.float32)}
    want = np.asarray(j_nn.dense(jnp.asarray(x), p,
                                 compute_dtype=jnp.bfloat16))
    got = nn.dense(torch.from_numpy(x), weights.params_from_jax(p, "cpu"),
                   torch.bfloat16).numpy()
    assert np.abs(got - want).max() <= BF16_RTOL_OF_MAX * np.abs(want).max()


# bf16 cascade, port vs JAX. Each layer agrees on the same input (above),
# but an activation that the two sums place on either side of a bf16
# rounding boundary becomes one bf16 ulp (2^-8 relative) apart, and moves
# everything after it: on these frames the port and JAX differ by ~75 % of
# what bf16 differs from f32 (measured, hand_scoremap 1.7e-5 against
# 2.1e-5, PoseNet's scoremap 1.3e-4 against 1.0e-4, coord3d 1.9e-4 against
# 2.9e-4; tens of mask pixels flip). So the cascade is held at those bounds,
# and every conv and FC of JAX's bf16 cascade is held on its own input.
BF16_SCOREMAP_ATOL = 3e-4
BF16_FLIP_BOUND = 6e-4
BF16_COORD3D_ATOL = 5e-4


def test_bf16_cascade_matches_jax(jax_params, np_params, monkeypatch):
    """ColorHandPose3D(compute_dtype="bfloat16") against the JAX cascade in
    its bf16 mode: flip-aware at bf16's bounds, and layer by layer, every
    conv and FC of the JAX cascade's run fed to the port's layer; the bf16
    estimator serves the port's cascade."""
    images = frames(2, *BUCKET, seed=4)
    norm = serving.normalize_images(images)
    side = left_hands(2)
    net = JaxCascade(compute_dtype=jnp.bfloat16)
    ref = _jax_fields(net, jax_params, jnp.asarray(norm), jnp.asarray(side))
    port = ColorHandPose3D(compute_dtype="bfloat16")
    t_params = weights.params_from_jax(np_params, "cpu")
    got = parity.port_fields(t_params, torch.from_numpy(norm),
                             torch.from_numpy(side), net=port)
    parity.check_cascade(
        ref, got, _jax_rerun(net, jax_params, jnp.asarray(norm),
                             jnp.asarray(side)),
        scoremap_atol=BF16_SCOREMAP_ATOL, coord3d_atol=BF16_COORD3D_ATOL,
        flip_bound=BF16_FLIP_BOUND)
    out = serving.HandPoseEstimator(np_params, batch_size=2, input_hw=BUCKET,
                                    compute_dtype="bfloat16",
                                    device="cpu").predict(images)
    assert_served(out, got)

    calls = []  # (stride or None for an FC, x, params, compute dtype, y)
    conv, dense = j_nn.conv2d, j_nn.dense

    def conv2d(x, params, stride=1, compute_dtype=None):
        y = conv(x, params, stride, compute_dtype)
        calls.append((stride, np.asarray(x), params, compute_dtype,
                      np.asarray(y)))
        return y

    def fc(x, params, compute_dtype=None):
        y = dense(x, params, compute_dtype)
        calls.append((None, np.asarray(x), params, compute_dtype,
                      np.asarray(y)))
        return y

    monkeypatch.setattr(j_nn, "conv2d", conv2d)
    monkeypatch.setattr(j_nn, "dense", fc)
    net.inference(jax_params, jnp.asarray(norm[:1]), jnp.asarray(side[:1]))
    # HandSegNet 16, PoseNet 17 + 2 x 7, the lifting towers 12 convs, 8 FCs
    assert sum(c[0] is not None for c in calls) == 59
    assert sum(c[0] is None for c in calls) == 8
    for stride, x, params, compute_dtype, want in calls:
        assert compute_dtype == jnp.bfloat16
        p = weights.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
        x = torch.from_numpy(x.copy())
        if stride is None:
            y = nn.dense(x, p, torch.bfloat16)
        else:
            y = nn.conv2d(x.permute(0, 3, 1, 2), p, stride,
                          torch.bfloat16).permute(0, 2, 3, 1)
        err = np.abs(y.numpy() - want).max()
        assert err <= BF16_RTOL_OF_MAX * np.abs(want).max(), (stride, err)


def test_bf16_predict_scopes_tf32_to_its_convs(np_params, monkeypatch):
    """On a (stubbed) card every bf16 conv runs with cuDNN's TF32 flag on
    and cuBLAS's off, and both flags are off again after predict. The CPU
    forward stands in for the card's: tf32_convs is made to act as on a
    CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    precision.exact_f32("cuda")
    seen = []
    real_scope = precision.tf32_convs

    def as_on_card(device):
        seen.append(torch.device(device).type)
        return real_scope("cuda")

    conv = nn._conv2d

    def recording(*args):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return conv(*args)

    monkeypatch.setattr(precision, "tf32_convs", as_on_card)
    monkeypatch.setattr(nn, "_conv2d", recording)
    est = serving.HandPoseEstimator(np_params, batch_size=1, input_hw=(32, 32),
                                    compute_dtype="bfloat16", device="cpu")
    est.predict(frames(1, 32, 32, seed=6))
    convs = [s for s in seen if isinstance(s, tuple)]
    # HandSegNet 16, PoseNet 17 + 2 x 7, PosePrior and ViewpointNet 6 each
    assert len(convs) == 59 and set(convs) == {(True, False)}
    assert seen.count("cpu") == 59
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (False, False)


def test_tf32_convs_restores_the_flag(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    with precision.tf32_convs("cuda"):
        assert torch.backends.cudnn.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    with pytest.raises(KeyError):
        with precision.tf32_convs("cuda:0"):
            raise KeyError("boom")
    assert not torch.backends.cudnn.allow_tf32
    with precision.tf32_convs("cpu"):
        assert not torch.backends.cudnn.allow_tf32


def test_compute_dtype_names():
    assert ColorHandPose3D("bfloat16").compute_dtype == torch.bfloat16
    assert ColorHandPose3D(torch.bfloat16).compute_dtype == torch.bfloat16
    assert ColorHandPose3D().compute_dtype is None
    with pytest.raises(ValueError, match="compute_dtype"):
        ColorHandPose3D("float16")


# --- DynamicBatcher (tests/test_cli.py's cases, against the port) -----------


def test_dynamic_batcher_coalesces_concurrent_requests(np_params):
    est = serving.HandPoseEstimator(np_params, batch_size=4, input_hw=(48, 64),
                                    device="cpu").warmup()
    calls = []
    inner = est.predict

    def counting_predict(images, normalized=False):
        calls.append(images.shape[0])
        return inner(images, normalized=normalized)

    est.predict = counting_predict
    batcher = serving.DynamicBatcher(est, max_batch=4, max_wait_ms=500.0)
    try:
        imgs = frames(4, 48, 64, seed=7)
        with ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(batcher.predict, imgs[i:i + 1])
                    for i in range(4)]
            outs = [f.result(timeout=120) for f in futs]
        assert calls == [4], calls  # ONE device batch
        ref = inner(imgs)
        for i, out in enumerate(outs):
            for k, v in out.items():
                np.testing.assert_array_equal(v[0], ref[k][i], err_msg=k)

        # errors reach the caller, not the batcher thread
        with pytest.raises(ValueError, match="expected"):
            batcher.predict(np.zeros((1, 30, 40, 3), np.uint8))
        ok = batcher.predict(imgs[:1])  # the batcher is still alive
        assert ok["keypoint_uv21"].shape == (1, 21, 2)
    finally:
        batcher.close()


class _FakeEstimator:
    """Minimal predict() contract for batcher lifecycle tests: returns each
    input image's mean as a 'keypoint'."""

    def __init__(self, delay=0.0):
        self.calls = []
        self.delay = delay

    def predict(self, images, normalized=False):
        self.calls.append(images.shape[0])
        if self.delay:
            time.sleep(self.delay)
        return {"mean": images.reshape(images.shape[0], -1).mean(axis=1)}


def test_dynamic_batcher_respects_max_batch():
    est = _FakeEstimator()
    batcher = serving.DynamicBatcher(est, max_batch=8, max_wait_ms=200.0)
    try:
        imgs = np.zeros((5, 8, 8, 3), np.float32)
        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(batcher.predict, imgs) for _ in range(2)]
            outs = [f.result(timeout=30) for f in futs]
        # two 5-image requests with max_batch=8 must NOT fuse into 10
        assert sorted(est.calls) == [5, 5], est.calls
        assert all(out["mean"].shape == (5,) for out in outs)
    finally:
        batcher.close()


def test_dynamic_batcher_keeps_resolutions_apart():
    est = _FakeEstimator(delay=0.1)
    batcher = serving.DynamicBatcher(est, max_batch=8, max_wait_ms=300.0)
    try:
        reqs = [np.full((1, 8, 8, 3), 0.25, np.float32),
                np.full((1, 6, 6, 3), 0.75, np.float32),
                np.full((1, 8, 8, 3), 0.25, np.float32)]
        with ThreadPoolExecutor(3) as pool:
            outs = list(pool.map(batcher.predict, reqs))
        assert sorted(est.calls) == [1, 2], est.calls
        np.testing.assert_allclose([o["mean"][0] for o in outs],
                                   [-0.25, 0.25, -0.25])
    finally:
        batcher.close()


def test_dynamic_batcher_close_semantics():
    # requests already queued when close() lands still complete
    est = _FakeEstimator(delay=0.2)
    batcher = serving.DynamicBatcher(est, max_batch=1, max_wait_ms=1.0)
    imgs = np.zeros((1, 8, 8, 3), np.float32)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(batcher.predict(imgs)))
        for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # all three enqueue while the first is in flight
    batcher.close()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 3 and all(r["mean"].shape == (1,)
                                     for r in results)
    # after close(): fail fast instead of hanging
    with pytest.raises(RuntimeError, match="closed"):
        batcher.predict(imgs)
    batcher.close()  # idempotent


def test_dynamic_batcher_scatters_snap_hw():
    class Snapping(_FakeEstimator):
        def predict(self, images, normalized=False):
            return dict(super().predict(images, normalized),
                        snap_hw=np.asarray([6, 6], np.int32))

    batcher = serving.DynamicBatcher(Snapping(), max_batch=4,
                                     max_wait_ms=200.0)
    try:
        with ThreadPoolExecutor(2) as pool:
            outs = list(pool.map(batcher.predict,
                                 [np.zeros((2, 8, 8, 3), np.float32)] * 2))
        for out in outs:
            assert out["mean"].shape == (2,)
            np.testing.assert_array_equal(out["snap_hw"], [6, 6])
    finally:
        batcher.close()


# --- the port imports neither jax nor the JAX package -----------------------


def test_no_port_module_imports_jax_or_the_jax_package():
    """Every module of hand3d_tpu_torch, and chip_smoke.py, read as source:
    no import of jax, of hand3d_tpu (which imports jax) or of the root
    tools/ (the JAX tools)."""
    repo = Path(__file__).resolve().parents[1]
    files = sorted((repo / "hand3d_tpu_torch").rglob("*.py"))
    files.append(repo / "chip_smoke.py")
    assert len(files) > 40
    assert {"parallel/mesh.py", "utils/debug.py", "utils/profiling.py",
            "tools/profile_stages.py", "tools/memory_report.py",
            "tools/roofline.py"} <= {
        str(p.relative_to(repo / "hand3d_tpu_torch")) for p in files[:-1]}
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "hand3d_tpu",
                                          "flax", "optax", "tools"):
                    bad.append(f"{path.relative_to(repo)}: {name}")
    assert bad == []
