"""Keypoint decoding + coordinate transforms (counterpart of
hand3d_tpu/ops/keypoints.py).

``decode_upsampled`` is the registered op ``torch.ops.hand3d.decode_upsampled``
(``ops/kernels/decode.py``): the CUDA kernel for a CUDA tensor and
``decode_upsampled_torch``, its plain twin, for a CPU tensor.
"""

import torch

from hand3d_tpu_torch.ops.image import resize_bilinear
from hand3d_tpu_torch.ops.kernels import decode


def detect_keypoints_2d(scoremaps):
    """[B, H, W, K] -> [B, K, 2] float32 (row, col) of each channel's first
    argmax (utils/general.detect_keypoints, :331-344)."""
    b, h, w, k = scoremaps.shape
    flat = scoremaps.permute(0, 3, 1, 2).reshape(b, k, h * w)
    idx = torch.argmax(flat, dim=-1)
    return torch.stack([idx // w, idx % w], dim=-1).to(torch.float32)


def soft_argmax_2d(scoremaps, beta=1.0):
    """Sub-pixel keypoints as the softmax expectation of each channel:
    [B, H, W, K] -> [B, K, 2] float32 (row, col). An extension of the JAX
    package; the reference decodes by argmax."""
    b, h, w, k = scoremaps.shape
    flat = scoremaps.permute(0, 3, 1, 2).reshape(b, k, h * w)
    weights = torch.softmax(beta * flat, dim=-1)
    dev = scoremaps.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    grid = torch.stack([rows.repeat_interleave(w), cols.repeat(h)], -1)
    return torch.matmul(weights, grid)


def decode_upsampled_torch(scoremap, factor):
    """Plain twin of the decode kernel: argmax of the materialized
    ``factor``-times TF1 bilinear upsampling of [B, h, w, K] -> [B, K, 2]."""
    _, h, w, _ = scoremap.shape
    return detect_keypoints_2d(
        resize_bilinear(scoremap, (h * factor, w * factor)))


def decode_upsampled(scoremap, factor):
    """Argmax keypoint decode over a ``factor``-times bilinear upsampling of
    ``scoremap`` [B, h, w, K] -> [B, K, 2] (row, col in the upsampled grid).
    Ties go to the smallest row-major index of the upsampled map."""
    if scoremap.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no keypoint decode for device {scoremap.device}")
    return decode.decode_upsampled(scoremap, factor)


def trafo_coords(keypoints_crop_coords, centers, scale, crop_size):
    """Crop-frame -> global-image coordinates (general.py:347-357).

    Args:
      keypoints_crop_coords: [B, K, 2].
      centers: [B, 2], same axis order as the coords.
      scale: [B] crop scale.
      crop_size: int.
    Returns:
      [B, K, 2] float32.
    """
    coords = keypoints_crop_coords - crop_size // 2
    return coords / scale.reshape(-1, 1, 1) + centers[:, None, :]
