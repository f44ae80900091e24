"""Flip-aware comparison of two runs of the cascade.

Two correct implementations of the cascade (JAX and this port, or this port
on the card and on the CPU) agree on every scoremap up to float noise, but
the glue makes discrete choices from those scoremaps: the binary mask rounds
the foreground probability at 0.5, the seed is an argmax, and the keypoints
are argmaxes. Where a logit margin or an argmax gap is within the noise, the
two runs may choose differently, and with random weights (foreground
probability within ~1e-3 of 0.5 everywhere) they often come close. So the
comparison checks:

1. hand_scoremap agrees within ``scoremap_atol``;
2. the binary masks (round(fg)) disagree only where the reference's logit
   margin |l1 - l0| is below ``flip_bound``, and the seeds differ only
   between foreground values within ``flip_bound`` of the maximum;
3. with equal binary masks and seeds, the single-blob masks are equal;
4. with equal single-blob masks, center and scale_crop are exactly equal;
   otherwise the reference's stages from the crop onward are rerun from the
   tested run's center and scale_crop, and the rest is held to that;
5. PoseNet's scoremap agrees within ``scoremap_atol``, keypoint_coord3d
   within ``coord3d_atol``, and for every keypoint whose 32x32 peak in the
   reference is clear (a top-2 gap above ``flip_bound``) both runs pick the
   same 32x32 cell and keypoint_uv21 agrees: exactly, or, along an axis where
   that cell is in the last row or column, within the plateau there
   (``peak_slack``). For the soft-argmax decoder, which has no flips, every
   keypoint is held within ``uv_atol`` instead.

hand_scoremap is compared at the localization resolution, where the mask is
made (``ColorHandPose3D.localize``).

``flip_bound`` has to be at least twice ``scoremap_atol``: a flip that
scoremap noise within the tolerance can cause is then always allowed.
"""

import numpy as np
import torch

from hand3d_tpu_torch.models.cascade import CROP_SIZE, ColorHandPose3D
from hand3d_tpu_torch.ops import segmentation

FIELDS = ("hand_scoremap", "fg", "detmap", "seed", "hand_mask", "center",
          "scale_crop", "scoremap", "keypoint_coord3d", "keypoint_uv21")
DOWNSTREAM = ("scoremap", "keypoint_coord3d", "keypoint_uv21")


def _require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def top2_gap(scoremap):
    """[B, h, w, K] -> [B, K] gap between each channel's two largest values."""
    b, h, w, k = scoremap.shape
    top = np.sort(scoremap.reshape(b, h * w, k), axis=1)
    return top[:, -1] - top[:, -2]


def peak_slack(scoremap, flip_bound):
    """[B, h, w, K] -> (clear [B, K] bool, slack [B, K, 2] float, (u, v)).

    clear: the keypoint's argmax decode is no float near-tie, its 32x32
    top-2 gap exceeds ``flip_bound``. slack: how many pixels of the
    upsampled crop two correct runs may place a clear keypoint apart along
    each axis. It is 0, or factor - 1 along an axis where the 32x32 peak is
    in the last row or column: the TF1 upsampling clamps there (hi = lo), so
    the peak becomes a plateau of ``factor`` positions along that axis whose
    values differ by rounding alone.
    """
    b, h, w, k = scoremap.shape
    idx = scoremap.reshape(b, h * w, k).argmax(1)
    on_edge = np.stack([idx % w == w - 1, idx // w == h - 1], -1)
    return (top2_gap(scoremap) > flip_bound,
            on_edge * float(CROP_SIZE // h - 1))


def _crop_px(uv, center, scale_crop):
    """Global (u, v) [B, K, 2] -> the upsampled-crop pixel it was decoded
    at (the inverse of ``trafo_coords``, rounded)."""
    return np.rint((uv - center[:, None, ::-1]) * scale_crop[:, :, None]
                   + CROP_SIZE // 2)


def port_fields(params, image, hand_side, net=None):
    """Every FIELDS entry of this port's cascade ``net`` (default
    ``ColorHandPose3D()``), as numpy arrays: ``localize`` and
    ``pose_from_box``, which are what ``inference`` runs. hand_scoremap and
    the mask fields are at the localization resolution.

    params: torch tree; image [B, H, W, 3] and hand_side [B, 2] tensors, all
    on one device.
    """
    net = net or ColorHandPose3D()
    with torch.inference_mode():
        seg, center, scale_crop = net.localize(params, image)
        fg, detmap, seed = segmentation.foreground(seg)
        mask = segmentation.single_obj_scoremap(seg)[..., 0]
        pose = net.pose_from_box(params, image, center, scale_crop, hand_side)
    fields = dict(zip(FIELDS, (seg, fg, detmap, seed, mask, center,
                               scale_crop, pose.scoremap,
                               pose.keypoint_coord3d, pose.keypoint_uv21)))
    return {k: v.cpu().numpy() for k, v in fields.items()}


def port_rerun(params, image, hand_side, net=None):
    """rerun(center, scale_crop) for check_cascade with this port's cascade
    ``net`` as the reference: its stages from the crop onward, as numpy
    arrays."""
    net = net or ColorHandPose3D()

    def rerun(center, scale_crop):
        dev = image.device
        with torch.inference_mode():
            pose = net.pose_from_box(
                params, image, torch.from_numpy(center).to(dev),
                torch.from_numpy(scale_crop).to(dev), hand_side)
        return {k: getattr(pose, k).cpu().numpy() for k in DOWNSTREAM}
    return rerun


def check_cascade(ref, got, rerun, *, scoremap_atol, coord3d_atol,
                  flip_bound, uv_atol=None):
    """Raise AssertionError unless ``got`` matches ``ref`` as set out in the
    module docstring.

    Args:
      ref, got: dicts of numpy arrays with the FIELDS keys.
      rerun: (center [B, 2], scale_crop [B, 1]) -> dict of the DOWNSTREAM
        keys, computed by the reference implementation.
      uv_atol: for a continuous decoder (soft-argmax) every keypoint_uv21 is
        held within this tolerance instead of the argmax rule of step 5.
    Returns:
      a summary dict: mask pixels flipped, images rerun, max errors, and how
      many keypoints were held to exact uv and to an edge plateau.
    """
    _require(flip_bound >= 2 * scoremap_atol, "flip_bound < 2 * scoremap_atol")
    err = float(np.abs(got["hand_scoremap"] - ref["hand_scoremap"]).max())
    _require(err <= scoremap_atol, f"hand_scoremap differs by {err}")

    logits = ref["hand_scoremap"]
    margin = np.abs(logits[..., 1] - logits[..., 0])
    flipped = got["detmap"] != ref["detmap"]
    _require(not (flipped & (margin >= flip_bound)).any(),
             "binary mask differs where the logit margin exceeds the bound")

    batch = ref["center"].shape[0]
    rerun_rows = []
    for b in range(batch):
        fg = ref["fg"][b]
        seed_same = (got["seed"][b] == ref["seed"][b]).all()
        r, c = got["seed"][b]
        _require(seed_same or fg[r, c] >= fg.max() - flip_bound,
                 f"image {b}: seed moved to a non-tie ({r}, {c})")
        same_mask = (got["hand_mask"][b] == ref["hand_mask"][b]).all()
        _require(same_mask or not seed_same or flipped[b].any(),
                 f"image {b}: same binary mask and seed, different blob")
        if same_mask:
            _require((got["center"][b] == ref["center"][b]).all()
                     and (got["scale_crop"][b] == ref["scale_crop"][b]).all(),
                     f"image {b}: same blob, different crop box")
        else:
            rerun_rows.append(b)

    down = {k: ref[k].copy() for k in DOWNSTREAM}
    if rerun_rows:
        again = rerun(got["center"], got["scale_crop"])
        for k in DOWNSTREAM:
            down[k][rerun_rows] = again[k][rerun_rows]

    sm_err = float(np.abs(got["scoremap"] - down["scoremap"]).max())
    _require(sm_err <= scoremap_atol, f"PoseNet scoremap differs by {sm_err}")
    c3_err = float(np.abs(got["keypoint_coord3d"]
                          - down["keypoint_coord3d"]).max())
    _require(c3_err <= coord3d_atol, f"keypoint_coord3d differs by {c3_err}")
    summary = {"mask_pixels_flipped": int(flipped.sum()),
               "images_rerun": rerun_rows,
               "hand_scoremap_max_abs_err": err,
               "scoremap_max_abs_err": sm_err,
               "coord3d_max_abs_err": c3_err}
    if uv_atol is not None:
        uv_err = float(np.abs(got["keypoint_uv21"]
                              - down["keypoint_uv21"]).max())
        _require(uv_err <= uv_atol, f"keypoint_uv21 differs by {uv_err}")
        return dict(summary, uv_max_abs_err=uv_err)
    clear, slack = peak_slack(down["scoremap"], flip_bound)
    b, h, w, k = down["scoremap"].shape
    same_cell = (got["scoremap"].reshape(b, h * w, k).argmax(1)
                 == down["scoremap"].reshape(b, h * w, k).argmax(1))
    _require(same_cell[clear].all(), "32x32 argmax differs at keypoints "
             f"with a clear peak: {np.argwhere(clear & ~same_cell).tolist()}")
    got_uv, want_uv = got["keypoint_uv21"], down["keypoint_uv21"]
    exact = (slack == 0).all(-1)
    same_uv = (got_uv == want_uv).all(-1)
    _require(same_uv[clear & exact].all(), "uv differs at keypoints with a "
             f"clear peak: {np.argwhere(clear & exact & ~same_uv).tolist()}")
    # both runs decode within one crop box: got's (down is rerun from it)
    moved = np.abs(_crop_px(got_uv, got["center"], got["scale_crop"])
                   - _crop_px(want_uv, got["center"], got["scale_crop"]))
    on_plateau = (moved <= slack).all(-1)
    plateau = clear & ~exact
    _require(on_plateau[plateau].all(), "uv leaves the edge plateau at "
             f"keypoints {np.argwhere(plateau & ~on_plateau).tolist()}")
    return dict(summary, uv_keypoints_held_exact=int((clear & exact).sum()),
                uv_keypoints_held_on_plateau=int(plateau.sum()))
