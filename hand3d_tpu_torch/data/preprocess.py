"""Batched preprocessing on the device: raw records -> training and eval
features (counterpart of hand3d_tpu/data/preprocess.py).

The derived-data graph of data/BinaryDbReader.py:126-459 and
data/BinaryDbReaderSTB.py:96-410 in torch, on whatever device the raw
tensors lie on. The reference's quirks are kept: uv truncated to integer
pixels, palm-vs-wrist keypoints, the hand side from part-pixel counts, the
visible-extent crop size with its clamps and non-finite fallbacks, and the
exact f32 cam_mat update under cropping.

A config whose ``needs_rng`` holds (hue, uv and crop noise, random crop,
scoremap dropout) takes the draws of ``draw_noise`` as ``noise``: they are
made on a CPU generator, and the preprocessing applies them on the batch's
device (``data/augment.py``). Such a config without draws raises; nothing
skips an augmentation silently.
"""

import torch

from hand3d_tpu_torch.data import augment
from hand3d_tpu_torch.data.codec import RHD_IMAGE_SIZE, STB_IMAGE_SIZE
from hand3d_tpu_torch.ops.canonical import canonical_trafo, flip_right_hand
from hand3d_tpu_torch.ops.image import (create_gaussian_maps,
                                        crop_image_from_xy, resize_bilinear)
from hand3d_tpu_torch.ops.kinematics import bone_rel_trafo
from hand3d_tpu_torch.ops.numerics import device_constant

# STB -> reference keypoint order (BinaryDbReaderSTB.convert_kp, :396-410):
# new[0] = old[0], new[i] = old[21 - i] for i in 1..20
STB_KP_PERM = [0] + list(range(20, 0, -1))
# BB-camera intrinsics of STB (BinaryDbReaderSTB.py:180-185)
STB_CAM_MAT = [[822.79041, 0.0, 318.47345], [0.0, 822.79041, 250.31296],
               [0.0, 0.0, 1.0]]


def draw_noise(cfg, raw, generator):
    """The draws of ``cfg``'s augmentations for the raw batch ``raw`` (RHD's
    42 keypoints or STB's 21), as CPU tensors from the CPU ``generator``:

      uv [B, kp, 2]          coord-uv noise, N(0, 2.5) cut at 2 sigma
      hue [B, 1, 1]          hue delta, U[-0.1, 0.1)
      crop_center [B, 2]     crop-center noise, N(0, 20) cut at 2 sigma
      crop_scale [B]         crop-scale factor, U[1, 1.2)
      crop_offset [B, 2]     crop-offset noise, N(0, 10) cut at 2 sigma
      crop_rows, crop_cols   random-crop corners [B] (RHD)
      scoremap_keep          kept scoremap channels, [B, 1, 1, 21] bool

    Only the entries ``cfg`` turns on are drawn, in this order
    (BinaryDbReader.py:160-367 for the reference's draws).
    """
    b, kp = raw["kp_xyz"].shape[:2]
    noise = {}
    if cfg.coord_uv_noise:
        noise["uv"] = augment.truncated_normal(generator, (b, kp, 2),
                                               cfg.coord_uv_noise_sigma)
    if cfg.hue_aug:
        noise["hue"] = augment.draw_hue(generator, b, cfg.hue_aug_max)
    if cfg.crop_center_noise:
        noise["crop_center"] = augment.truncated_normal(
            generator, (b, 2), cfg.crop_center_noise_sigma)
    if cfg.crop_scale_noise:
        noise["crop_scale"] = augment.uniform(generator, (b,), 1.0, 1.2)
    if cfg.crop_offset_noise:
        noise["crop_offset"] = augment.truncated_normal(
            generator, (b, 2), cfg.crop_offset_noise_sigma)
    if cfg.random_crop_to_size:
        size = (cfg.random_crop_size, cfg.random_crop_size)
        noise["crop_rows"], noise["crop_cols"] = augment.draw_crop_offsets(
            generator, b, tuple(raw["image"].shape[1:3]), size)
    if cfg.scoremap_dropout:
        noise["scoremap_keep"] = augment.draw_channel_keep(
            generator, b, 21, cfg.scoremap_dropout_prob)
    return noise


def _noise_on(cfg, noise, device):
    """``noise`` on ``device``; a config that augments must be given it."""
    if not cfg.needs_rng:
        return {}
    if noise is None:
        raise ValueError(
            "this config augments at random (hue, noise, random crop or "
            "scoremap dropout): pass its draws, "
            "noise=draw_noise(cfg, raw, generator)")
    return {k: v.to(device) for k, v in noise.items()}


def _xyz_representations(kp_xyz21, flip_cond=None):
    """Root-relative, normalized, local and canonical frames
    (BinaryDbReader.py:237-254; BinaryDbReaderSTB.py:192-209 has no flip).

    Args:
      kp_xyz21: [B, 21, 3].
      flip_cond: optional [B] bool, true for right hands (RHD only).
    """
    rel = kp_xyz21 - kp_xyz21[:, :1]
    scale = torch.linalg.vector_norm(rel[:, 12] - rel[:, 11], dim=-1)
    normed = rel / scale[:, None, None]
    can, rot = canonical_trafo(normed)
    if flip_cond is not None:
        can = flip_right_hand(can, flip_cond)
    return {
        "keypoint_scale": scale,
        "keypoint_xyz21_normed": normed,
        "keypoint_xyz21_local": bone_rel_trafo(normed),
        "keypoint_xyz21_can": can,
        # rot is orthogonal, so its inverse (tf.matrix_inverse in the
        # reference, :254) is its transpose
        "rot_mat": rot.transpose(-1, -2),
    }


def _uv_to_crop(uv, center, scale, crop_size):
    """Full-frame (u, v) -> crop frame (BinaryDbReader.py:319-323)."""
    half = crop_size // 2
    u = (uv[:, :, 0] - center[:, None, 1]) * scale[:, None] + half
    v = (uv[:, :, 1] - center[:, None, 0]) * scale[:, None] + half
    return torch.stack([u, v], -1)


def _hand_crop_features(cfg, image, uv21, vis21, cam_mat, image_size, noise):
    """Ground-truth hand crop with its uv and intrinsics
    (BinaryDbReader.py:268-346): centered at keypoint 12, sized by the
    visible-keypoint extent (clamped to [50, 500] px, 200 where not finite),
    scale clamped to [1, 10], with the optional center, scale and offset
    noise of ``noise``."""
    crop_size = cfg.crop_size
    crop_center = uv21[:, 12].flip(-1)  # (row, col)
    crop_center = torch.where(
        torch.isfinite(crop_center).all(-1, keepdim=True), crop_center,
        torch.zeros_like(crop_center))
    if cfg.crop_center_noise:
        crop_center = crop_center + noise["crop_center"]

    # visible-extent bounding box, clamped to the image
    coord_hw = uv21.flip(-1)
    vis = vis21[..., None]
    inf = torch.full((), float("inf"), device=uv21.device)
    min_coord = torch.clamp(torch.where(vis, coord_hw, inf).amin(1), min=0.0)
    max_coord = torch.minimum(
        torch.where(vis, coord_hw, -inf).amax(1),
        device_constant(image_size, torch.float32, uv21.device))
    crop_size_best = 2.0 * torch.maximum(max_coord - crop_center,
                                         crop_center - min_coord).amax(-1)
    crop_size_best = torch.clamp(crop_size_best, 50.0, 500.0)
    crop_size_best = torch.where(torch.isfinite(crop_size_best),
                                 crop_size_best,
                                 torch.full_like(crop_size_best, 200.0))
    scale = torch.clamp(crop_size / crop_size_best, 1.0, 10.0)
    if cfg.crop_scale_noise:
        scale = scale * noise["crop_scale"]
    if cfg.crop_offset_noise:
        crop_center = crop_center + noise["crop_offset"]

    # intrinsics: K' = T(-center * scale + half) @ S(scale) @ K (:325-346),
    # exact f32 (precision.exact_f32 keeps TF32 matmuls off on the card)
    half = crop_size // 2
    zeros, ones = torch.zeros_like(scale), torch.ones_like(scale)
    t1 = crop_center[:, 0] * scale - half  # row translation
    t2 = crop_center[:, 1] * scale - half  # col translation
    scale_mat = torch.stack([torch.stack([scale, zeros, zeros], -1),
                             torch.stack([zeros, scale, zeros], -1),
                             torch.stack([zeros, zeros, ones], -1)], -2)
    trans_mat = torch.stack([torch.stack([ones, zeros, -t2], -1),
                             torch.stack([zeros, ones, -t1], -1),
                             torch.stack([zeros, zeros, ones], -1)], -2)
    return {
        "crop_scale": scale,
        "image_crop": crop_image_from_xy(image, crop_center, crop_size, scale),
        "keypoint_uv21": _uv_to_crop(uv21, crop_center, scale, crop_size),
        "cam_mat": torch.matmul(trans_mat, torch.matmul(scale_mat, cam_mat)),
        "_crop_center": crop_center,
    }


def _gaussian_scoremap(cfg, uv21, vis21, size, noise):
    """Ground-truth scoremaps with the optional channel dropout
    (BinaryDbReader.py:348-367)."""
    scoremap = create_gaussian_maps(uv21.flip(-1), size, cfg.sigma, vis21)
    if cfg.scoremap_dropout:
        scoremap = augment.scoremap_channel_dropout(scoremap,
                                                    noise["scoremap_keep"])
    return scoremap


def preprocess_rhd(cfg, raw, noise=None):
    """RHD raw record batch -> feature dict.

    Args:
      cfg: PreprocessConfig.
      raw: dict of tensors on one device, as ``RHDDataset.raw_batch`` makes
        them: kp_xyz [B,42,3] f32, kp_uv [B,42,2] f32, cam_mat [B,3,3] f32,
        image [B,320,320,3] u8, hand_parts [B,320,320] u8, kp_vis [B,42] u8.
      noise: ``draw_noise(cfg, raw, generator)``, required iff
        ``cfg.needs_rng``.
    """
    noise = _noise_on(cfg, noise, raw["kp_xyz"].device)
    kp_xyz = raw["kp_xyz"].to(torch.float32)
    # the reference casts uv to int32 and back before any use (:149-152)
    kp_uv = raw["kp_uv"].to(torch.float32).to(torch.int32).to(torch.float32)
    kp_vis = raw["kp_vis"].to(torch.bool)
    cam_mat = raw["cam_mat"].to(torch.float32)
    parts = raw["hand_parts"].to(torch.int32)

    if not cfg.use_wrist_coord:
        # palm = midpoint of wrist and middle-finger root, per hand (:141-158)
        def palmify(arr):
            palm_l = 0.5 * (arr[:, 0] + arr[:, 12])
            palm_r = 0.5 * (arr[:, 21] + arr[:, 33])
            return torch.cat([palm_l[:, None], arr[:, 1:21], palm_r[:, None],
                              arr[:, 22:]], 1)

        kp_xyz = palmify(kp_xyz)
        kp_uv = palmify(kp_uv)
        kp_vis = torch.cat([(kp_vis[:, 0] | kp_vis[:, 12])[:, None],
                            kp_vis[:, 1:21],
                            (kp_vis[:, 21] | kp_vis[:, 33])[:, None],
                            kp_vis[:, 22:]], 1)
    if cfg.coord_uv_noise:
        kp_uv = kp_uv + noise["uv"]

    image = raw["image"].to(torch.float32) / 255.0 - 0.5
    if cfg.hue_aug:
        image = augment.random_hue(image, noise["hue"])
    hand_mask_fg = parts > 1
    data = {
        "image": image,
        "hand_parts": parts,
        "hand_mask": torch.stack([~hand_mask_fg, hand_mask_fg], -1)
        .to(torch.int32),
        "keypoint_xyz": kp_xyz,
        "keypoint_uv": kp_uv,
        "keypoint_vis": kp_vis,
        "cam_mat": cam_mat,
    }

    # the dominant hand by part-pixel counts (:213-233): parts 2..17 are
    # left-hand segments, 18 and above right-hand
    num_l = ((parts > 1) & (parts < 18)).sum((1, 2))
    num_r = (parts > 17).sum((1, 2))
    left = num_l > num_r  # [B]
    data["hand_side"] = torch.stack([left, ~left], -1).to(torch.float32)

    sel = left[:, None, None]
    kp_xyz21 = torch.where(sel, kp_xyz[:, :21], kp_xyz[:, 21:])
    uv21 = torch.where(sel, kp_uv[:, :21], kp_uv[:, 21:])
    vis21 = torch.where(left[:, None], kp_vis[:, :21], kp_vis[:, 21:])

    if cfg.scale_to_size:
        # eval2d's downscale mode (:369-380): the scaling invalidates every
        # other item, so none is computed
        th, tw = cfg.scale_target_size
        h, w = RHD_IMAGE_SIZE
        scale_uv = device_constant([tw / w, th / h], torch.float32,
                                   uv21.device)
        return {"image": resize_bilinear(image, (th, tw)),
                "keypoint_uv21": uv21 * scale_uv,
                "keypoint_vis21": vis21}

    if cfg.random_crop_to_size:
        # segmentation-training mode (:382-392): the crop invalidates every
        # other item
        stacked = torch.cat([image, parts[..., None].to(torch.float32),
                             data["hand_mask"].to(torch.float32)], -1)
        size = (cfg.random_crop_size, cfg.random_crop_size)
        cropped = augment.random_crop_hw(stacked, noise["crop_rows"],
                                         noise["crop_cols"], size)
        return {"image": cropped[..., :3],
                "hand_parts": cropped[..., 3].to(torch.int32),
                "hand_mask": cropped[..., 4:].to(torch.int32)}

    data["keypoint_xyz21"] = kp_xyz21
    data["keypoint_vis21"] = vis21
    data["keypoint_uv21"] = uv21
    data.update(_xyz_representations(kp_xyz21, flip_cond=~left))

    if cfg.hand_crop:
        crop = _hand_crop_features(cfg, image, uv21, vis21, cam_mat,
                                   RHD_IMAGE_SIZE, noise)
        crop.pop("_crop_center")
        data.update(crop)
        scoremap_size = (cfg.crop_size, cfg.crop_size)
    else:
        scoremap_size = RHD_IMAGE_SIZE
    if cfg.render_scoremap:
        data["scoremap"] = _gaussian_scoremap(cfg, data["keypoint_uv21"],
                                              vis21, scoremap_size, noise)
    return data


def _extrapolate_wrist(arr):
    """STB stores the palm at kp0; the wrist lies past it:
    kp0' = kp16 + 2 * (kp0 - kp16) (BinaryDbReaderSTB.py:131-154)."""
    wrist = arr[:, 16] + 2.0 * (arr[:, 0] - arr[:, 16])
    return torch.cat([wrist[:, None], arr[:, 1:]], 1)


def preprocess_stb(cfg, raw, noise=None):
    """STB raw record batch -> feature dict (BinaryDbReaderSTB.py:96-343).

    xyz arrives in mm (scaled to meters); keypoints are reordered by
    STB_KP_PERM; with use_wrist_coord the wrist is extrapolated from the
    palm; the intrinsics are dataset constants; every hand is a left hand,
    and the canonical frame has no right-hand flip. ``scale_to_size`` does
    not apply to STB and is ignored, as is ``random_crop_to_size``, as in the
    JAX package.

    Args:
      cfg: PreprocessConfig.
      raw: dict of tensors on one device, as ``STBDataset.raw_batch`` makes
        them: kp_xyz [B,21,3] f32 (mm), kp_uv_vis [B,21,3] f32,
        image [B,480,640,3] u8.
      noise: ``draw_noise(cfg, raw, generator)``, required iff
        ``cfg.needs_rng``.
    """
    dev = raw["kp_xyz"].device
    noise = _noise_on(cfg, noise, dev)
    perm = device_constant(STB_KP_PERM, torch.int64, dev)
    b = raw["kp_xyz"].shape[0]
    kp_xyz21 = raw["kp_xyz"].to(torch.float32)[:, perm] / 1000.0
    uv_vis = raw["kp_uv_vis"].to(torch.float32)[:, perm]
    uv21 = uv_vis[:, :, :2]
    vis21 = uv_vis[:, :, 2] == 1.0

    if cfg.use_wrist_coord:
        kp_xyz21 = _extrapolate_wrist(kp_xyz21)
        uv21 = _extrapolate_wrist(uv21)
        vis21 = torch.cat([(vis21[:, 16] | vis21[:, 0])[:, None],
                           vis21[:, 1:]], 1)
    if cfg.coord_uv_noise:
        uv21 = uv21 + noise["uv"]

    image = raw["image"].to(torch.float32) / 255.0 - 0.5
    if cfg.hue_aug:
        image = augment.random_hue(image, noise["hue"])
    cam_mat = device_constant(STB_CAM_MAT, torch.float32,
                              dev).expand(b, 3, 3)
    data = {
        "image": image,
        "keypoint_xyz21": kp_xyz21,
        "keypoint_uv21": uv21,
        "keypoint_vis21": vis21,
        "cam_mat": cam_mat,
        "hand_side": device_constant([[1.0, 0.0]], torch.float32,
                                     dev).expand(b, 2),
    }
    data.update(_xyz_representations(kp_xyz21))

    if cfg.hand_crop:
        # without use_wrist_coord the reference still extrapolates a wrist
        # for the crop extent (:228-231)
        uv_for_crop = uv21 if cfg.use_wrist_coord else _extrapolate_wrist(uv21)
        crop = _hand_crop_features(cfg, image, uv_for_crop, vis21, cam_mat,
                                   STB_IMAGE_SIZE, noise)
        # the uv in the crop are the original uv21, mapped with the crop's
        # effective (noise-shifted) center and scale (:266-271)
        center = crop.pop("_crop_center")
        crop["keypoint_uv21"] = _uv_to_crop(uv21, center, crop["crop_scale"],
                                            cfg.crop_size)
        data.update(crop)
        scoremap_size = (cfg.crop_size, cfg.crop_size)
    else:
        scoremap_size = STB_IMAGE_SIZE
    if cfg.render_scoremap:
        data["scoremap"] = _gaussian_scoremap(cfg, data["keypoint_uv21"],
                                              vis21, scoremap_size, noise)
    return data
