"""Binding of the CUDA flood-fill kernel (``csrc/floodfill.cu``), the port
of hand3d_tpu/ops/pallas/floodfill.py, and the registered op
``torch.ops.hand3d.flood_fill`` that every caller goes through.

The op's CUDA implementation is ``flood_fill_cuda``; its CPU implementation
is the plain twin ``ops.segmentation.flood_fill_torch``, looked up at each
call. Its fake implementation gives the output's shape, so ``torch.export``
traces the cascade through the op without running the fill (the twin stops
at a data-dependent fixed point, the kernel takes raw pointers).
"""

import ctypes
import functools

import torch

from hand3d_tpu_torch.ops.kernels import build

launches = 0  # kernel launches made by flood_fill_cuda


@functools.cache
def _lib():
    lib = build.load_kernel("floodfill")
    lib.h3d_flood_fill.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.h3d_flood_fill.restype = ctypes.c_int
    lib.h3d_flood_fill_plan.argtypes = [ctypes.c_int] * 3 \
        + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.h3d_flood_fill_plan.restype = ctypes.c_int
    lib.h3d_error_string.argtypes = [ctypes.c_int]
    lib.h3d_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(h, w):
    """Shared memory of the kernel's one-CTA-per-image launch: det, the
    vertical OR and obj as bit masks, 32 pixels a word. The kernel takes a
    cluster only where its CTAs' bands fit, so this is the size limit."""
    return 3 * h * ((w + 31) // 32) * 4


def cluster_plan(b, h, w, device):
    """(CTAs a cluster, clusters the card holds at once) that
    ``flood_fill_cuda`` takes for [b, h, w] maps on the CUDA ``device``; a
    cluster of one CTA, one image, reports (1, 0)."""
    lib = _lib()
    size, held = ctypes.c_int(), ctypes.c_int()
    with build.on_device(device):
        err = lib.h3d_flood_fill_plan(b, h, w, ctypes.byref(size),
                                      ctypes.byref(held))
    build.check(err, lib, "flood fill plan")
    return size.value, held.value


def flood_fill_cuda(detmap, seed_rc, num_passes):
    """Grow one-pixel seeds into their connected foreground blobs on the card.

    Args:
      detmap: [B, H, W] float32 CUDA tensor, contiguous, values in {0, 1}
        (any nonzero counts as foreground).
      seed_rc: [B, 2] int32 CUDA tensor, contiguous: (row, col) per sample;
        a seed outside the image grows nothing.
      num_passes: most 21x21 dilation passes (the reference's max(H, W)//10).
    Returns:
      [B, H, W] float32 object map, bit-equal to ``flood_fill_torch``.
    """
    global launches
    if not (detmap.is_cuda and seed_rc.device == detmap.device):
        raise ValueError("flood_fill_cuda needs both tensors on one CUDA device")
    if detmap.dtype != torch.float32 or seed_rc.dtype != torch.int32:
        raise ValueError("flood_fill_cuda needs float32 detmap, int32 seeds")
    if detmap.ndim != 3 or tuple(seed_rc.shape) != (detmap.shape[0], 2):
        raise ValueError(f"bad shapes {tuple(detmap.shape)}, "
                         f"{tuple(seed_rc.shape)}")
    if not (detmap.is_contiguous() and seed_rc.is_contiguous()):
        raise ValueError("flood_fill_cuda needs contiguous tensors")
    b, h, w = detmap.shape
    if smem_bytes(h, w) > build.MAX_SMEM_BYTES or min(h, w) < 1 \
            or b > 65535:
        raise ValueError(f"flood_fill_cuda: unsupported shape {b}x{h}x{w}")
    if num_passes < 0:
        raise ValueError("num_passes must be >= 0")
    out = torch.empty_like(detmap)
    if b == 0:
        return out
    lib = _lib()
    with build.on_device(detmap.device):
        err = lib.h3d_flood_fill(detmap.data_ptr(), seed_rc.data_ptr(),
                                 out.data_ptr(), b, h, w, num_passes,
                                 build.current_stream(detmap.device))
    build.check(err, lib, "flood fill kernel")
    launches += 1
    return out


@torch.library.custom_op("hand3d::flood_fill", mutates_args=(),
                         device_types="cuda")
def flood_fill(detmap: torch.Tensor, seed_rc: torch.Tensor,
               num_passes: int) -> torch.Tensor:
    """``flood_fill_cuda`` on a CUDA tensor, the twin on a CPU tensor."""
    return flood_fill_cuda(detmap, seed_rc, num_passes)


@flood_fill.register_kernel("cpu")
def _flood_fill_cpu(detmap, seed_rc, num_passes):
    from hand3d_tpu_torch.ops import segmentation

    return segmentation.flood_fill_torch(detmap, seed_rc, num_passes)


@flood_fill.register_fake
def _flood_fill_fake(detmap, seed_rc, num_passes):
    return torch.empty_like(detmap)
