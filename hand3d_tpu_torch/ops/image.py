"""Batched image ops with TF1 sampling semantics (counterpart of
hand3d_tpu/ops/image.py). Images are NHWC float32.

``resize_bilinear`` is the TF1 legacy asymmetric grid (src = dst * in/out),
not ``F.interpolate``'s half-pixel centers; its two-tap lerp is written in
the same op order as the JAX version, so the two are bit-equal.
``crop_and_resize`` samples with a direct two-tap gather where the TPU
version built one-hot interpolation matrices for the MXU.
"""

import numpy as np
import torch

from hand3d_tpu_torch.ops.numerics import cache_plain


def _legacy_lin_coeffs(in_size, out_size, align_corners=False):
    """Gather indices + f32 lerp weights of one axis (numpy, float64 grid)."""
    if align_corners and out_size > 1:
        src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    else:
        src = np.arange(out_size) * (in_size / out_size)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


@cache_plain
def _lin_coeffs_on(in_size, out_size, align_corners, device):
    """:func:`_legacy_lin_coeffs` as tensors on ``device``, copied there
    once: a training step captured in a CUDA graph copies no host memory.
    Made outside inference mode, so that an eval's first call leaves tensors
    a later training step can save for its backward pass."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in
                     _legacy_lin_coeffs(in_size, out_size, align_corners))


def _resize_axis(x, axis, out_size, align_corners):
    lo, hi, wt = _lin_coeffs_on(x.shape[axis], out_size, align_corners,
                                x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    wt = wt.reshape(shape)
    return (x.index_select(axis, lo) * (1.0 - wt)
            + x.index_select(axis, hi) * wt)


def resize_bilinear(x, out_hw, align_corners=False):
    """Bilinear resize of [B, H, W, C] float32 to ``out_hw`` (rows, then cols).

    Matches TF1 tf.image.resize_images(..., BILINEAR): asymmetric source grid
    (src = dst * in / out) with edge clamp, or with ``align_corners`` the
    grid src = dst * (in - 1) / (out - 1).
    """
    oh, ow = out_hw
    if oh != x.shape[1]:
        x = _resize_axis(x, 1, oh, align_corners)
    if ow != x.shape[2]:
        x = _resize_axis(x, 2, ow, align_corners)
    return x


def _axis_sample(x, axis, pos, size):
    """Per-sample two-tap lerp of ``x`` [B, ...] along ``axis`` at float
    positions ``pos`` [B, n]; samples outside [0, size-1] become 0."""
    b, n = pos.shape
    shape = [b] + [1] * (x.ndim - 1)  # pos broadcast along ``axis``
    shape[axis] = n
    expand = list(x.shape)
    expand[axis] = n
    lo_f = torch.floor(pos)
    frac = (pos - lo_f).reshape(shape)
    valid = ((pos >= 0.0) & (pos <= size - 1.0)).reshape(shape)

    def gather(idx_f):
        idx = idx_f.clamp(0, size - 1).long().reshape(shape).expand(expand)
        return torch.gather(x, axis, idx)

    out = gather(lo_f) * (1.0 - frac) + gather(lo_f + 1.0) * frac
    return torch.where(valid, out, torch.zeros_like(out))


def crop_and_resize(image, boxes, crop_size):
    """TF-parity crop_and_resize with zero extrapolation.

    Args:
      image: [B, H, W, C] float32.
      boxes: [B, 4] normalized (y1, x1, y2, x2); may leave [0, 1].
      crop_size: (crop_h, crop_w) ints.
    Returns:
      [B, crop_h, crop_w, C] float32.
    """
    b, h, w, _ = image.shape
    ch, cw = crop_size
    y1, x1, y2, x2 = boxes.unbind(1)

    def grid(lo, hi, n, size):
        if n == 1:
            return (0.5 * (lo + hi) * (size - 1))[:, None]
        i = torch.arange(n, dtype=torch.float32, device=image.device)
        step = (hi - lo) * (size - 1) / (n - 1)
        return lo[:, None] * (size - 1) + i[None, :] * step[:, None]

    out = _axis_sample(image, 1, grid(y1, y2, ch, h), h)
    return _axis_sample(out, 2, grid(x1, x2, cw, w), w)


def crop_image_from_xy(image, crop_location, crop_size, scale):
    """Crop around per-sample centers at per-sample scale.

    Mirrors utils/general.crop_image_from_xy (:163-196), float floor
    division when centering the box included.

    Args:
      image: [B, H, W, C].
      crop_location: [B, 2] (row, col) centers in pixels.
      crop_size: int, output height == width.
      scale: [B]; the crop covers crop_size / scale source pixels.
    Returns:
      [B, crop_size, crop_size, C] float32.
    """
    _, h, w, _ = image.shape
    size_scaled = float(crop_size) / scale
    half = torch.floor(size_scaled / 2.0)
    y1 = crop_location[:, 0] - half
    x1 = crop_location[:, 1] - half
    boxes = torch.stack(
        [y1 / h, x1 / w, (y1 + size_scaled) / h, (x1 + size_scaled) / w], 1)
    return crop_and_resize(image, boxes, (crop_size, crop_size))


def create_gaussian_maps(coords_hw, output_size, sigma, valid=None):
    """Per-keypoint Gaussian scoremaps
    (BinaryDbReader.create_multiple_gaussian_map, :412-459).

    Keypoints are truncated toward zero to integer pixels first; one outside
    the open interval (0, size - 1), or not ``valid``, renders as zeros. The
    map is exp(-d^2 / sigma^2), with no factor 2.

    Args:
      coords_hw: [B, K, 2] (row, col) in pixels.
      output_size: (H, W).
      sigma: Gaussian width.
      valid: optional [B, K] bool visibility.
    Returns:
      [B, H, W, K] float32.
    """
    oh, ow = output_size
    coords_i = coords_hw.to(torch.float32).to(torch.int32)  # trunc to zero
    cond_in = ((coords_i[..., 0] < oh - 1) & (coords_i[..., 0] > 0)
               & (coords_i[..., 1] < ow - 1) & (coords_i[..., 1] > 0))
    if valid is not None:
        cond_in = cond_in & (valid.to(torch.float32) > 0.5)
    coords_f = coords_i.to(torch.float32)
    dev = coords_hw.device
    rows = torch.arange(oh, dtype=torch.float32, device=dev)[None, :, None, None]
    cols = torch.arange(ow, dtype=torch.float32, device=dev)[None, None, :, None]
    du = rows - coords_f[:, None, None, :, 0]
    dv = cols - coords_f[:, None, None, :, 1]
    maps = torch.exp(-(du * du + dv * dv) / float(np.float32(sigma)) ** 2)
    return maps * cond_in[:, None, None, :].to(torch.float32)
