"""Mask post-processing: blob selection and bounding boxes (counterpart of
hand3d_tpu/ops/segmentation.py).

The flood fill of ``single_obj_scoremap`` is the registered op
``torch.ops.hand3d.flood_fill`` (``ops/kernels/floodfill.py``): the CUDA
kernel for a CUDA tensor, ``flood_fill_torch``, its plain twin, for a CPU
tensor. Nothing else selects between them.
"""

import torch
import torch.nn.functional as F

from hand3d_tpu_torch.ops.kernels import floodfill
from hand3d_tpu_torch.ops.numerics import device_constant

DILATION_FILTER_SIZE = 21  # general.py:236


def find_max_location(scoremap):
    """[B, H, W] -> [B, 2] int32 (row, col) of each sample's first argmax."""
    b, _, w = scoremap.shape
    idx = torch.argmax(scoremap.reshape(b, -1), dim=1)
    return torch.stack([idx // w, idx % w], dim=-1).to(torch.int32)


def foreground(scoremap):
    """[B, H, W, C] logits -> (fg prob [B, H, W], binary mask, seed [B, 2]).

    Softmax over classes, foreground = max over the non-background classes,
    binarized by rounding (half to even, as jnp.round); the seed is the
    foreground argmax (general.py:233-268).
    """
    fg = torch.softmax(scoremap, dim=-1)[..., 1:].amax(dim=-1)
    return fg, torch.round(fg), find_max_location(fg)


def flood_fill_torch(detmap, seed_rc, num_passes):
    """Plain twin of the flood-fill kernel: grow each one-pixel seed by
    ``obj = det * maxpool21(obj)`` until the map stops changing, at most
    ``num_passes`` times (segmentation.py:91-124 of the JAX package).

    Extra passes past the fixed point are no-ops, so stopping there equals
    the full trip count. The 21x21 max pool is separable, rows then cols,
    and ``max_pool2d`` pads with -inf like reduce_window SAME.

    Args: detmap [B, H, W] f32 in {0, 1}; seed_rc [B, 2] int32.
    """
    b, h, w = detmap.shape
    rows = torch.arange(h, device=detmap.device)[None, :, None]
    cols = torch.arange(w, device=detmap.device)[None, None, :]
    seed = seed_rc.long()
    obj = ((rows == seed[:, 0, None, None])
           & (cols == seed[:, 1, None, None])).to(torch.float32)
    k, half = DILATION_FILTER_SIZE, DILATION_FILTER_SIZE // 2
    for _ in range(num_passes):
        grown = F.max_pool2d(obj[:, None], (k, 1), 1, (half, 0))
        grown = F.max_pool2d(grown, (1, k), 1, (0, half))
        new = detmap * grown[:, 0]
        if torch.equal(new, obj):
            break
        obj = new
    return obj


def single_obj_scoremap(scoremap, num_passes=None):
    """Keep only the connected foreground blob containing the foreground max.

    Args:
      scoremap: [B, H, W, C] segmentation logits (channel 0 = background).
      num_passes: dilation pass count; defaults to the reference's
        max(H, W) // 10 (general.py:256).
    Returns:
      [B, H, W, 1] float32 binary object map.
    """
    _, h, w, _ = scoremap.shape
    if num_passes is None:
        num_passes = max(h, w) // (DILATION_FILTER_SIZE // 2)
    _, detmap, seed = foreground(scoremap)
    if detmap.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flood fill for device {detmap.device}")
    return floodfill.flood_fill(detmap, seed, num_passes)[..., None]


def calc_center_bb(binary_class_mask, fallback_center=(160.0, 160.0),
                   fallback_size=100.0):
    """Bounding box, center and square crop size of a binary mask.

    Mirrors utils/general.calc_center_bb (:271-328) with +/-inf-masked
    reductions: an empty mask gives non-finite values and the reference's
    fallbacks, center (160, 160) and crop size 100.

    Args:
      binary_class_mask: [B, H, W] or [B, H, W, 1]; 1 == foreground.
    Returns:
      center [B, 2] (row, col), bb [B, 2, 2] (bb[:, :, 0] min corner,
      bb[:, :, 1] max corner), crop_size [B, 1]; all float32.
    """
    if binary_class_mask.ndim == 4:
        binary_class_mask = binary_class_mask[..., 0]
    mask = binary_class_mask.to(torch.int32) == 1
    _, h, w = mask.shape
    dev = mask.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    inf = torch.full((), float("inf"), device=dev)

    def masked(vals, fill):
        return torch.where(mask, vals, fill)

    x_min = masked(rows, inf).amin(dim=(1, 2))
    x_max = masked(rows, -inf).amax(dim=(1, 2))
    y_min = masked(cols, inf).amin(dim=(1, 2))
    y_max = masked(cols, -inf).amax(dim=(1, 2))

    start = torch.stack([x_min, y_min], dim=1)
    end = torch.stack([x_max, y_max], dim=1)
    bb = torch.stack([start, end], dim=2)

    center = 0.5 * (start + end)
    center_ok = torch.isfinite(center).all(dim=1, keepdim=True)
    center = torch.where(center_ok, center,
                         device_constant(fallback_center, torch.float32, dev))

    crop_size = torch.maximum(x_max - x_min, y_max - y_min)[:, None]
    crop_size = torch.where(torch.isfinite(crop_size), crop_size,
                            torch.full((), float(fallback_size), device=dev))
    return center, bb, crop_size
