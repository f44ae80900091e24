"""The port's cascade and estimator against hand3d_tpu's, on the CPU.

Inputs are the golden ones of tests/test_golden_regression.py: PRNGKey(0)
params and a PRNGKey(1) 2x120x160 image. With random weights the
foreground probability lies within ~5e-4 of 0.5 and the keypoint peaks are
within ~1e-5 of their runners-up, so no second framework can promise the
golden's discrete choices; the comparison is flip-aware
(hand3d_tpu_torch.parity.check_cascade).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.ops import segmentation as j_seg
from hand3d_tpu.ops.image import crop_image_from_xy as j_crop
from hand3d_tpu.ops.image import resize_bilinear as j_resize
from hand3d_tpu.serving import normalize_images as j_normalize_images
from hand3d_tpu_torch import parity, weights
from hand3d_tpu_torch.models.cascade import ColorHandPose3D
from hand3d_tpu_torch.serving import HandPoseEstimator

# Scoremaps are ~1e-3 in size here; float32 noise between the frameworks is
# ~1e-9 (measured). FLIP_BOUND = 10 x SCOREMAP_ATOL (>= 2x, as check_cascade
# requires); coord3d is ~5e-2 in size.
SCOREMAP_ATOL = 1e-6
FLIP_BOUND = 1e-5
COORD3D_ATOL = 1e-6


@pytest.fixture(scope="module")
def golden():
    net = JaxCascade()
    params = net.init(jax.random.PRNGKey(0))
    image = jax.random.uniform(jax.random.PRNGKey(1), (2, 120, 160, 3)) - 0.5
    hand_side = jnp.asarray([[1.0, 0.0], [0.0, 1.0]])
    return net, params, image, hand_side


def _jax_segment(net, params, image):
    """HandSegNet's scoremap at the JAX cascade's localization resolution."""
    h, w = image.shape[1:3]
    if net.seg_scale != 1.0:
        image = j_resize(image, (max(1, round(h * net.seg_scale)),
                                 max(1, round(w * net.seg_scale))))
    return net.inference_detection(params, image)[-1]


def _jax_fields(net, params, image, hand_side):
    """parity.FIELDS of the JAX cascade. One jit, so the mask and seed are
    the ones the cascade itself computed."""
    @jax.jit
    def run(params, image, hand_side):
        out = net.inference(params, image, hand_side)
        seg = _jax_segment(net, params, image)
        fg = jnp.max(jax.nn.softmax(seg, -1)[..., 1:], -1)
        mask = j_seg.single_obj_scoremap(seg)[..., 0]
        return (seg, fg, jnp.round(fg),
                j_seg.find_max_location(fg), mask, out.center, out.scale_crop,
                net.inference_pose2d(params, out.image_crop)[-1],
                out.keypoint_coord3d, out.keypoint_uv21)

    vals = run(params, image, hand_side)
    return {k: np.asarray(v) for k, v in zip(parity.FIELDS, vals)}


def _jax_rerun(net, params, image, hand_side):
    @jax.jit
    def run(center, scale_crop):
        crop = j_crop(image, center, 256, scale_crop[:, 0])
        sm = net.inference_pose2d(params, crop)[-1]
        return (sm, net.inference_pose3d(params, sm, hand_side),
                net._decode_uv(sm, center, scale_crop))

    def rerun(center, scale_crop):
        vals = run(jnp.asarray(center), jnp.asarray(scale_crop))
        return {k: np.asarray(v) for k, v in zip(parity.DOWNSTREAM, vals)}
    return rerun


def test_cascade_matches_jax_flip_aware(golden):
    net, params, image, hand_side = golden
    ref = _jax_fields(net, params, image, hand_side)
    # the reference fields are consistent with the cascade's own box
    center, _, _ = j_seg.calc_center_bb(jnp.asarray(ref["hand_mask"]))
    np.testing.assert_array_equal(np.asarray(center), ref["center"])

    t_params = weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    got = parity.port_fields(t_params, torch.from_numpy(np.array(image)),
                             torch.from_numpy(np.array(hand_side)))
    for k in parity.FIELDS:
        assert got[k].shape == ref[k].shape, k
    summary = parity.check_cascade(
        ref, got, _jax_rerun(net, params, image, hand_side),
        scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
        flip_bound=FLIP_BOUND)
    assert summary["uv_keypoints_held_exact"] >= 10, summary
    # every keypoint with a clear peak is held, exactly or on its edge
    # plateau (22 here: 18 and 4)
    clear = int((parity.top2_gap(ref["scoremap"]) > FLIP_BOUND).sum())
    assert clear >= 20
    assert summary["uv_keypoints_held_exact"] \
        + summary["uv_keypoints_held_on_plateau"] == clear, summary
    # port_fields reads localize and pose_from_box: what inference returns
    with torch.no_grad():
        out = ColorHandPose3D().inference(
            t_params, torch.from_numpy(np.array(image)),
            torch.from_numpy(np.array(hand_side)))
    for k in ("hand_scoremap", "center", "scale_crop", "keypoint_coord3d",
              "keypoint_uv21"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), got[k],
                                      err_msg=k)


def _plateau_case():
    """A reference whose keypoint 0 has a clear 32x32 peak in the last
    column (row 5) and keypoint 1 a clear peak inside the map, with its
    check_cascade kwargs and a rerun that must not be needed."""
    b, k = 1, 21
    sm = np.zeros((b, 32, 32, k), np.float32)
    sm[0, 5, 31, 0] = 1.0
    sm[0, 7, 9, 1] = 1.0
    seg = np.zeros((b, 8, 8, 2), np.float32)
    seg[..., 0] = 1.0
    ref = {"hand_scoremap": seg, "fg": np.zeros((b, 8, 8), np.float32),
           "detmap": np.zeros((b, 8, 8), np.float32),
           "seed": np.zeros((b, 2), np.int64),
           "hand_mask": np.zeros((b, 8, 8), np.float32),
           "center": np.array([[100.0, 120.0]], np.float32),
           "scale_crop": np.array([[0.5]], np.float32),
           "scoremap": sm,
           "keypoint_coord3d": np.zeros((b, k, 3), np.float32),
           "keypoint_uv21": np.zeros((b, k, 2), np.float32)}
    # (u, v) of the decoded crop pixels, through trafo_coords
    crop = np.full((b, k, 2), 128.0, np.float32)
    crop[0, 0] = (248.0, 40.0)
    crop[0, 1] = (72.0, 56.0)
    ref["keypoint_uv21"] = ((crop - 128.0) / 0.5
                            + ref["center"][:, None, ::-1]).astype(np.float32)

    def rerun(center, scale_crop):
        raise AssertionError("same masks need no rerun")
    kw = dict(scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
              flip_bound=FLIP_BOUND)
    return ref, rerun, kw


@pytest.mark.parametrize("move, ok", [
    ((0, 0, 7.0), True),  # u across the plateau of the last column
    ((0, 0, 8.0), False),  # u one crop pixel past it
    ((0, 1, 1.0), False),  # v, which has no plateau at this peak
    ((1, 0, 1.0), False),  # a clear peak inside the map: exact uv
])
def test_check_cascade_holds_edge_peaks_to_their_plateau(move, ok):
    """A clear peak in the last row or column is an upsampled plateau of 8
    positions along that axis: its uv may move across the plateau (7 crop
    pixels / scale_crop) and no further, and not at all along the other
    axis or for a peak inside the map."""
    ref, rerun, kw = _plateau_case()
    kp, axis, crop_px = move
    got = dict(ref, keypoint_uv21=ref["keypoint_uv21"].copy())
    got["keypoint_uv21"][0, kp, axis] += crop_px / ref["scale_crop"][0, 0]
    if ok:
        summary = parity.check_cascade(ref, got, rerun, **kw)
        assert summary["uv_keypoints_held_exact"] == 1
        assert summary["uv_keypoints_held_on_plateau"] == 1
    else:
        with pytest.raises(AssertionError, match="uv"):
            parity.check_cascade(ref, got, rerun, **kw)


def test_check_cascade_allows_flips_only_near_ties():
    """The comparison rejects a mask flip at a clear margin, and holds a run
    whose blob changed to the reference's stages rerun from its own box."""
    # seed 3 gives a pixel with logit margin 1.2e-7, below FLIP_BOUND
    params = weights.params_from_jax(weights.random_params(3), "cpu")
    image = torch.from_numpy(
        np.random.default_rng(1).random((1, 48, 64, 3), np.float32) - 0.5)
    hand_side = torch.tensor([[1.0, 0.0]])
    ref = parity.port_fields(params, image, hand_side)
    rerun = parity.port_rerun(params, image, hand_side)
    kw = dict(scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
              flip_bound=FLIP_BOUND)
    assert parity.check_cascade(ref, ref, rerun, **kw)["images_rerun"] == []

    margin = np.abs(np.diff(ref["hand_scoremap"], axis=-1))[..., 0]
    bad = dict(ref, detmap=ref["detmap"].copy())
    r, c = np.unravel_index(np.argmax(margin[0]), margin[0].shape)
    bad["detmap"][0, r, c] = 1.0 - bad["detmap"][0, r, c]
    with pytest.raises(AssertionError, match="logit margin"):
        parity.check_cascade(ref, bad, rerun, **kw)

    # a near-tie flip that moved the blob: another box, the rest from it
    moved = dict(ref, detmap=ref["detmap"].copy(),
                 hand_mask=np.zeros_like(ref["hand_mask"]),
                 center=ref["center"] + 3.0, scale_crop=ref["scale_crop"] * 2)
    r, c = np.unravel_index(np.argmin(margin[0]), margin[0].shape)
    assert margin[0, r, c] < FLIP_BOUND
    moved["detmap"][0, r, c] = 1.0 - moved["detmap"][0, r, c]
    moved.update(rerun(moved["center"], moved["scale_crop"]))
    summary = parity.check_cascade(ref, moved, rerun, **kw)
    assert summary["images_rerun"] == [0]
    assert summary["mask_pixels_flipped"] == 1


def test_estimator_predict_ragged_batch():
    """predict pads the last chunk, trims it, and serves what the cascade
    computes; normalize_images matches the JAX package's."""
    p = weights.random_params(2)
    est = HandPoseEstimator(p, batch_size=2, input_hw=(48, 64), device="cpu")
    images = np.random.default_rng(2).integers(0, 256, (3, 48, 64, 3),
                                               dtype=np.uint8)
    out = est.predict(images)
    norm = j_normalize_images(images)
    padded = np.concatenate([norm, np.zeros_like(norm[:1])])
    net = ColorHandPose3D()
    params = weights.params_from_jax(p, "cpu")
    hand_side = torch.tensor([[1.0, 0.0]] * 2)
    with torch.no_grad():
        chunks = [net.inference(params, torch.from_numpy(padded[i:i + 2]),
                                hand_side) for i in (0, 2)]
    assert set(out) == {"keypoint_coord3d", "keypoint_uv21", "hand_scoremap",
                        "scale_crop", "center"}
    for k, v in out.items():
        want = np.concatenate([getattr(c, k).numpy() for c in chunks])[:3]
        assert v.shape == want.shape and v.dtype == np.float32, k
        np.testing.assert_array_equal(v, want, err_msg=k)
    with pytest.raises(ValueError, match="expected"):
        est.predict(images[:, :40])


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("mode", ["seg_scale_0.5", "soft_argmax"])
def test_cascade_modes_match_jax_flip_aware(golden, mode):
    """seg_scale < 1 (HandSegNet, flood fill and box at 60x80, the box
    mapped back with the pre-scaled fallbacks) and the soft-argmax decoder,
    each against the JAX cascade built the same way. Soft-argmax has no
    flips: its uv is held within 1e-3 px (an expectation over 256^2 pixels
    summed in another order)."""
    _, params, image, hand_side = golden
    kw = ({"seg_scale": 0.5} if mode == "seg_scale_0.5"
          else {"decode": "soft_argmax"})
    net = JaxCascade(**kw)
    ref = _jax_fields(net, params, image, hand_side)
    t_params = weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    port = ColorHandPose3D(**kw)
    got = parity.port_fields(t_params, _t(image), _t(hand_side), net=port)
    for k in parity.FIELDS:
        assert got[k].shape == ref[k].shape, k
    if mode == "seg_scale_0.5":
        assert got["hand_scoremap"].shape == (2, 60, 80, 2)
    summary = parity.check_cascade(
        ref, got, _jax_rerun(net, params, image, hand_side),
        scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
        flip_bound=FLIP_BOUND,
        uv_atol=1e-3 if mode == "soft_argmax" else None)
    assert summary["images_rerun"] == [] or mode == "seg_scale_0.5", summary
    with torch.no_grad():  # the full-resolution scoremap of the output
        out = port.inference(t_params, _t(image), _t(hand_side))
    assert tuple(out.hand_scoremap.shape) == (2, 120, 160, 2)


def test_seg_scale_empty_mask_keeps_the_reference_fallbacks():
    """An empty mask at reduced resolution gives the full-image fallbacks
    of the reference, center (160, 160) and crop size 100 (scale
    256 / 125), as the JAX cascade does."""
    logits = np.zeros((1, 60, 80, 2), np.float32)
    logits[..., 0] = 5.0
    want = JaxCascade(seg_scale=0.5)._crop_from_scoremap(
        jnp.zeros((1, 120, 160, 3)), jnp.asarray(logits))
    center, scale = ColorHandPose3D(seg_scale=0.5).box_from_scoremap(
        torch.from_numpy(logits), (120, 160))
    np.testing.assert_array_equal(center.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(center.numpy(), [[160.0, 160.0]])
    np.testing.assert_allclose(scale.numpy(), [[256 / 125]])


def test_inference2d_is_the_2d_half_of_inference(golden):
    """The port's inference2d equals its inference on every shared output
    (which test_cascade_matches_jax_flip_aware holds to JAX), and so does
    the JAX package's."""
    net, params, image, hand_side = golden
    t_params = weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    port = ColorHandPose3D()
    with torch.no_grad():
        out2d = port.inference2d(t_params, _t(image))
        out = port.inference(t_params, _t(image), _t(hand_side))
    for k in ("keypoints_scoremap", "image_crop", "scale_crop", "center",
              "keypoint_uv21"):
        assert torch.equal(getattr(out2d, k), getattr(out, k)), k
    j2d = jax.jit(net.inference2d)(params, image)
    j3d = jax.jit(net.inference)(params, image, hand_side)
    for k in ("center", "scale_crop", "keypoint_uv21"):
        np.testing.assert_array_equal(np.asarray(getattr(j2d, k)),
                                      np.asarray(getattr(j3d, k)))
    with torch.no_grad():
        assert port.inference2d(t_params, _t(image),
                                keypoints_scoremap=False) \
            .keypoints_scoremap is None


def test_cascade_rejects_bad_modes():
    with pytest.raises(ValueError, match="decode"):
        ColorHandPose3D(decode="nope")
    with pytest.raises(ValueError, match="seg_scale"):
        ColorHandPose3D(seg_scale=0.0)
