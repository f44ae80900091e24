"""The port's ops (hand3d_tpu_torch.ops) against hand3d_tpu's, on the CPU.

Inputs come from numpy seeds and go through both packages. Where the JAX
op reaches a Pallas kernel, it runs in interpret mode, as
tests/test_ops_segmentation.py runs it. On the CPU the port runs the plain
twins of its CUDA kernels; the kernels themselves are held to the twins on
the card (chip_smoke.py, tests/test_torch_kernels.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand3d_tpu.ops import canonical as j_canonical
from hand3d_tpu.ops import image as j_image
from hand3d_tpu.ops import keypoints as j_keypoints
from hand3d_tpu.ops import nn as j_nn
from hand3d_tpu.ops import rotations as j_rotations
from hand3d_tpu.ops import segmentation as j_seg
from hand3d_tpu.ops.pallas.decode import decode_keypoints_upsampled_pallas
from hand3d_tpu.ops.pallas.floodfill import flood_fill_pallas
from hand3d_tpu_torch.ops import canonical, image, keypoints, nn, rotations
from hand3d_tpu_torch.ops import segmentation as seg


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


# --- nn ----------------------------------------------------------------------


@pytest.mark.parametrize("k,stride,hw", [
    (1, 1, (15, 20)), (3, 1, (15, 20)), (7, 1, (8, 8)),
    # stride 2 on an even size pads one row/col more at the end
    # (poseprior.py:55-57); on an odd size symmetrically
    (3, 2, (32, 32)), (3, 2, (15, 20)),
])
def test_conv2d_tf_same(k, stride, hw):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(j_nn.conv2d(jnp.asarray(x), {"weights": jnp.asarray(w),
                                                   "biases": jnp.asarray(b)},
                                  stride=stride))
    got = nhwc(nn.conv2d(nchw(x), {"weights": t(w.transpose(3, 2, 0, 1)),
                                   "biases": t(b)}, stride=stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 16), (15, 21)])
def test_max_pool_and_leaky_relu_exact(hw):
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(j_nn.leaky_relu(j_nn.max_pool_2x2(jnp.asarray(x))))
    got = nhwc(nn.leaky_relu(nn.max_pool_2x2(nchw(x))))
    np.testing.assert_array_equal(got, want)


def test_dense_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    p = {"weights": rng.standard_normal((40, 7)).astype(np.float32),
         "biases": rng.standard_normal(7).astype(np.float32)}
    want = np.asarray(j_nn.dense_relu(jnp.asarray(x), p))
    got = nn.dense_relu(t(x), {k: t(v) for k, v in p.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- image -------------------------------------------------------------------


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 32, 32, 21), (256, 256)),
    ((1, 30, 40, 2), (240, 320)),
    ((2, 15, 20, 2), (120, 160)),
    ((1, 12, 9, 3), (5, 27)),  # down on one axis, up by 3 on the other
])
def test_resize_bilinear_bit_equal(shape, out_hw):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_image.resize_bilinear(jnp.asarray(x), out_hw))
    got = image.resize_bilinear(t(x), out_hw).numpy()
    np.testing.assert_array_equal(got, want)


def test_crop_image_from_xy_matches():
    """Centers in and out of the image, and both clip ends of the cascade's
    scale (0.25: the box is 4x the crop, mostly outside; 5.0: a 51 px box)."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((4, 30, 40, 3)).astype(np.float32)
    centers = np.array([[15.0, 20.0], [-20.0, 100.0], [29.0, 0.0],
                        [7.5, 33.25]], np.float32)
    scale = np.array([0.25, 5.0, 1.0, 2.5], np.float32)
    want = np.asarray(j_image.crop_image_from_xy(
        jnp.asarray(img), jnp.asarray(centers), 32, jnp.asarray(scale)))
    got = image.crop_image_from_xy(t(img), t(centers), 32, t(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("crop_hw", [(9, 7), (1, 5)])
def test_crop_and_resize_matches(crop_hw):
    rng = np.random.default_rng(4)
    img = rng.standard_normal((3, 20, 24, 2)).astype(np.float32)
    boxes = np.array([[0.1, 0.2, 0.8, 0.9], [-0.5, -0.3, 1.4, 1.2],
                      [0.5, 0.5, 0.5, 0.6]], np.float32)
    want = np.asarray(j_image.crop_and_resize(jnp.asarray(img),
                                              jnp.asarray(boxes), crop_hw))
    got = image.crop_and_resize(t(img), t(boxes), crop_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- rotations / canonical ---------------------------------------------------


def test_rodrigues_rot_mat_matches():
    u = np.random.default_rng(5).standard_normal((3, 6, 1)).astype(np.float32)
    u[:, 0] = 0.0  # zero axis: only the +1e-8 bias keeps theta > 0
    want = np.asarray(j_rotations.rodrigues_rot_mat(*map(jnp.asarray, u)))
    got = rotations.rodrigues_rot_mat(*map(t, u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_flip_right_hand_exact():
    c = np.random.default_rng(6).standard_normal((4, 21, 3)).astype(np.float32)
    cond = np.array([True, False, True, False])
    want = np.asarray(j_canonical.flip_right_hand(jnp.asarray(c),
                                                  jnp.asarray(cond)))
    got = canonical.flip_right_hand(t(c), t(cond)).numpy()
    np.testing.assert_array_equal(got, want)


# --- segmentation ------------------------------------------------------------


def test_find_max_location_exact_with_ties():
    sm = np.random.default_rng(7).random((3, 16, 20)).astype(np.float32)
    sm[1, 3, 4] = sm[1, 10, 2] = 2.0  # first occurrence wins
    sm[2] = 0.0
    want = np.asarray(j_seg.find_max_location(jnp.asarray(sm)))
    got = seg.find_max_location(t(sm)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_calc_center_bb_exact_with_empty_fallback():
    rng = np.random.default_rng(8)
    mask = (rng.random((4, 24, 30)) > 0.97).astype(np.float32)
    mask[1] = 0.0  # empty: center (160, 160), crop size 100
    mask[2] = 0.0
    mask[2, 5, 7] = 1.0  # one pixel: crop size 0
    want = j_seg.calc_center_bb(jnp.asarray(mask))
    got = seg.calc_center_bb(t(mask)[..., None])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0][1].numpy(), [160.0, 160.0])
    np.testing.assert_array_equal(got[2][1].numpy(), [100.0])


def _two_blob_logits(h=64, w=64):
    """fg logits with two blobs; blob A holds the global max (as in
    tests/test_ops_segmentation.py)."""
    logits = np.zeros((1, h, w, 2), np.float32)
    logits[..., 0] = 5.0
    logits[0, 8:16, 8:16, 1] = 10.0
    logits[0, 10, 10, 1] = 12.0
    logits[0, 40:50, 40:50, 1] = 10.0
    return logits


def _logit_cases():
    bridged = _two_blob_logits()
    bridged[0, 12, 16:40, 1] = 10.0
    bridged[0, 12:40, 39:41, 1] = 10.0
    empty = np.zeros((1, 48, 64, 2), np.float32)
    empty[..., 0] = 9.0
    # random blobs, every logit margin >= 1 so no rounding can flip the mask
    rng = np.random.default_rng(9)
    sign = np.where(rng.random((2, 48, 64)) > 0.8, 1.0, -1.0)
    rand = np.zeros((2, 48, 64, 2), np.float32)
    rand[..., 1] = sign * (1.0 + rng.random((2, 48, 64)))
    return {"two_blob": _two_blob_logits(), "bridged": bridged,
            "empty": empty, "random": rand}


@pytest.mark.parametrize("case", ["two_blob", "bridged", "empty", "random"])
def test_single_obj_scoremap_matches_xla(case):
    logits = _logit_cases()[case]
    want = np.asarray(j_seg.single_obj_scoremap(jnp.asarray(logits),
                                                method="xla"))
    got = seg.single_obj_scoremap(t(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def _flood_cases():
    """(detmap, seeds, num_passes) cases for the flood fill itself."""
    rng = np.random.default_rng(10)
    cases = {}
    for name, logits in _logit_cases().items():
        fg, det, seed = seg.foreground(t(logits))
        cases[name] = (det.numpy(), seed.numpy(), max(logits.shape[1:3]) // 10)
    det = np.zeros((3, 48, 64), np.float32)
    det[:, 10:20, 10:20] = 1.0
    # background seeds: 5 px from the blob (grows into it) / far (nothing)
    cases["seed_on_background"] = (
        det, np.array([[5, 5], [40, 60], [12, 12]], np.int32), 6)
    det = np.zeros((1, 64, 64), np.float32)
    det[0, 10:20, 10:20] = 1.0
    # far more passes than needed: the converged blob, not an overgrown one
    cases["early_exit"] = (det, np.array([[12, 12]], np.int32), 50)
    blobs = (rng.random((2, 40, 56)) > 0.6).astype(np.float32)
    cases["zero_passes"] = (blobs, np.array([[3, 3], [20, 30]], np.int32), 0)
    cases["noise"] = (blobs, np.array([[3, 3], [20, 30]], np.int32), 5)
    return cases


def _xla_flood_fill(det, seed, passes):
    """The XLA formulation of the JAX package (segmentation.py:91-124, fixed
    trip count): obj = det * 21x21 SAME max-pool(obj)."""
    b, h, w = det.shape
    obj = np.zeros_like(det)
    obj[np.arange(b), seed[:, 0], seed[:, 1]] = 1.0
    obj = jnp.asarray(obj)
    for _ in range(passes):
        grown = jax.lax.reduce_window(obj, -jnp.inf, jax.lax.max,
                                      (1, 21, 21), (1, 1, 1), "SAME")
        obj = jnp.asarray(det) * grown
    return np.asarray(obj)


FLOOD_CASES = ["two_blob", "bridged", "empty", "random", "seed_on_background",
               "early_exit", "zero_passes", "noise"]


@pytest.mark.parametrize("case", FLOOD_CASES)
def test_flood_fill_twin_matches_xla(case):
    det, seed, passes = _flood_cases()[case]
    got = seg.flood_fill_torch(t(det), t(seed), passes).numpy()
    np.testing.assert_array_equal(got, _xla_flood_fill(det, seed, passes))


# "random" and "noise" grow blobs within 10 px of the top/left edges, where
# the Pallas kernel is wrong (next test)
@pytest.mark.parametrize("case", [c for c in FLOOD_CASES
                                  if c not in ("random", "noise")])
def test_flood_fill_twin_matches_pallas(case):
    det, seed, passes = _flood_cases()[case]
    want = np.asarray(flood_fill_pallas(jnp.asarray(det), jnp.asarray(seed),
                                        passes, interpret=True))
    got = seg.flood_fill_torch(t(det), t(seed), passes).numpy()
    np.testing.assert_array_equal(got, want)


def test_pallas_flood_fill_top_left_edge_fault():
    """A fault of the reference's Pallas kernel that the port does not copy:
    _win21_max takes L16[i-10] through _shift(l16, -10), which is zero for
    i < 10, so the window of a pixel within 10 px of the top or left edge
    loses rows/cols [0, i+5]. A seed at (0, 0) then does not even keep its
    own pixel. The XLA formulation (and the port) grows the 11x11 corner."""
    det = np.ones((1, 24, 24), np.float32)
    seed = np.array([[0, 0]], np.int32)
    pallas = np.asarray(flood_fill_pallas(jnp.asarray(det), jnp.asarray(seed),
                                          1, interpret=True))
    got = seg.flood_fill_torch(t(det), t(seed), 1).numpy()
    want = np.zeros_like(det)
    want[0, :11, :11] = 1.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _xla_flood_fill(det, seed, 1))
    assert pallas[0, 0, 0] == 0.0 and (pallas != want).sum() == 120


def test_dispatch_rejects_other_devices():
    logits = torch.zeros((1, 8, 8, 2), device="meta")
    with pytest.raises(ValueError, match="no flood fill"):
        seg.single_obj_scoremap(logits)
    with pytest.raises(ValueError, match="no keypoint decode"):
        keypoints.decode_upsampled(torch.zeros((1, 4, 4, 2), device="meta"), 2)


# --- keypoints ---------------------------------------------------------------


def _decode_cases():
    rng = np.random.default_rng(11)
    sm = rng.standard_normal((3, 32, 32, 21)).astype(np.float32)
    sm[0, :, :, 0] = 0.0  # all-equal channel: index 0
    sm[1, 5, 5, 3] = sm[1].max() + 1.0  # exact tie of two peaks
    sm[1, 20, 20, 3] = sm[1, 5, 5, 3]
    sm[2, 31, 31, 4] = 10.0  # peaks on the last row / col (edge clamp)
    sm[2, 0, 31, 5] = 10.0
    sm[2, 31, 0, 6] = 10.0
    edge = rng.random((1, 16, 16, 4)).astype(np.float32)
    edge[0, 15, 15, 0] = 10.0
    edge[0, 0, 15, 1] = 10.0
    edge[0, 15, 0, 2] = 10.0
    return {"ties_f8": (sm, 8), "edges_f4": (edge, 4)}


@pytest.mark.parametrize("case", ["ties_f8", "edges_f4"])
def test_decode_twin_matches_pallas(case):
    sm, factor = _decode_cases()[case]
    want = np.asarray(decode_keypoints_upsampled_pallas(
        jnp.asarray(sm), factor, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(j_keypoints.decode_upsampled(jnp.asarray(sm), factor,
                                                      method="xla")))
    got = keypoints.decode_upsampled(t(sm), factor).numpy()
    np.testing.assert_array_equal(got, want)


def test_detect_keypoints_and_trafo_coords_exact():
    rng = np.random.default_rng(12)
    sm = rng.random((2, 32, 32, 21)).astype(np.float32)
    want = np.asarray(j_keypoints.detect_keypoints_2d(jnp.asarray(sm)))
    got = keypoints.detect_keypoints_2d(t(sm))
    np.testing.assert_array_equal(got.numpy(), want)
    centers = rng.random((2, 2)).astype(np.float32) * 100
    scale = np.array([0.3, 4.7], np.float32)
    want = np.asarray(j_keypoints.trafo_coords(jnp.asarray(want),
                                               jnp.asarray(centers),
                                               jnp.asarray(scale), 256))
    got = keypoints.trafo_coords(got, t(centers), t(scale), 256).numpy()
    np.testing.assert_array_equal(got, want)


# --- nn.avg_pool, image extras, soft-argmax ----------------------------------


@pytest.mark.parametrize("size,stride,hw", [
    (8, None, (32, 40)),  # evenly tiling: VALID
    (8, None, (20, 27)),  # ragged: TF-SAME puts the odd pixels after
    (3, 2, (9, 10)),  # overlapping windows, ragged on one axis
])
def test_avg_pool_tf_same(size, stride, hw):
    """F.avg_pool2d pads symmetrically; TF-SAME pads the odd pixel after and
    divides by the real pixels of each window. Only a ragged input tells the
    two apart."""
    x = np.random.default_rng(13).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(j_nn.avg_pool(jnp.asarray(x), size, stride))
    got = nhwc(nn.avg_pool(nchw(x), size, stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,out_hw", [((2, 32, 32, 21), (256, 256)),
                                          ((1, 12, 9, 3), (5, 27)),
                                          ((1, 6, 7, 2), (1, 13))])
def test_resize_bilinear_align_corners_bit_equal(shape, out_hw):
    x = np.random.default_rng(14).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_image.resize_bilinear(jnp.asarray(x), out_hw,
                                              align_corners=True))
    got = image.resize_bilinear(t(x), out_hw, align_corners=True).numpy()
    np.testing.assert_array_equal(got, want)


TINY = np.finfo(np.float32).tiny


def test_create_gaussian_maps_matches():
    """Truncation toward zero (negative coords too), the open interval
    (0, size - 1), and the visibility mask: the same maps are all zero, the
    rest agrees within 2 ulp (XLA's and torch's exp differ in the last bit)
    or below the smallest normal float32 (XLA flushes denormals to zero)."""
    rng = np.random.default_rng(15)
    coords = rng.uniform(-5, 45, (3, 21, 2)).astype(np.float32)
    coords[0, :4] = [[0.9, 10.0], [10.0, 38.99], [-0.5, 10.0], [1.0, 1.0]]
    valid = rng.random((3, 21)) > 0.3
    want = np.asarray(j_image.create_gaussian_maps(
        jnp.asarray(coords), (32, 40), 25.0, jnp.asarray(valid)))
    got = image.create_gaussian_maps(t(coords), (32, 40), 25.0,
                                     t(valid)).numpy()
    np.testing.assert_array_equal(got.max((1, 2)) == 0, want.max((1, 2)) == 0)
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=TINY)
    want = np.asarray(j_image.create_gaussian_maps(jnp.asarray(coords),
                                                   (32, 40), 3.0))
    got = image.create_gaussian_maps(t(coords), (32, 40), 3.0).numpy()
    np.testing.assert_array_equal(got.max((1, 2)) == 0, want.max((1, 2)) == 0)
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=TINY)


def test_soft_argmax_2d_matches():
    sm = np.random.default_rng(16).standard_normal((2, 16, 12, 5)).astype(
        np.float32) * 4
    want = np.asarray(j_keypoints.soft_argmax_2d(jnp.asarray(sm), beta=2.0))
    got = keypoints.soft_argmax_2d(t(sm), beta=2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
