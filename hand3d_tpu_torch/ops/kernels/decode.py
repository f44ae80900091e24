"""Binding of the CUDA upsampled-argmax decode kernel (``csrc/decode.cu``),
the port of hand3d_tpu/ops/pallas/decode.py, and the registered op
``torch.ops.hand3d.decode_upsampled`` that every caller goes through.

The op's CUDA implementation is ``decode_upsampled_cuda``; its CPU
implementation is the plain twin ``ops.keypoints.decode_upsampled_torch``,
looked up at each call; its fake implementation gives the [B, K, 2] shape
to ``torch.export``.
"""

import ctypes
import functools

import torch

from hand3d_tpu_torch.ops.kernels import build
from hand3d_tpu_torch.utils import profiling


@functools.cache
def _lib():
    lib = build.load_kernel("decode")
    lib.h3d_decode_upsampled.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.h3d_decode_upsampled.restype = ctypes.c_int
    lib.h3d_error_string.argtypes = [ctypes.c_int]
    lib.h3d_error_string.restype = ctypes.c_char_p
    return lib


def overlay_path(factor):
    """Power-of-two factors take the kernel's overlay path, the others its
    table path (csrc/decode.cu): for them the twin's float64 grid can leave
    the overlay form (at f = 49 it does)."""
    return factor & (factor - 1) == 0


def smem_bytes(h, w, k, factor):
    """Least shared memory a block of the kernel needs."""
    if overlay_path(factor):
        # per-channel planes of a band's source rows: at least one row and
        # the row below it, the plane stride odd
        return 4 * k * ((min(h, 2) * w) | 1) + 16
    # the channel's h*w values + (lo, hi, weight) of every upsampled row/col
    return 4 * h * w + 12 * (h + w) * factor


def decode_upsampled_cuda(scoremap, factor):
    """Per image and keypoint, the argmax of the ``factor``-times TF1
    bilinear upsampling of ``scoremap``, without building it in memory.

    Args:
      scoremap: [B, h, w, K] float32 CUDA tensor, contiguous.
      factor: integer upsampling factor (8 in the cascade: 32 -> 256).
    Returns:
      [B, K, 2] float32 (row, col) in the upsampled grid, bit-equal to
      ``decode_upsampled_torch``; ties go to the smallest row-major index.
    """
    if not scoremap.is_cuda:
        raise ValueError("decode_upsampled_cuda needs a CUDA tensor")
    if scoremap.dtype != torch.float32 or scoremap.ndim != 4:
        raise ValueError("decode_upsampled_cuda needs [B, h, w, K] float32")
    if not scoremap.is_contiguous():
        raise ValueError("decode_upsampled_cuda needs a contiguous tensor")
    b, h, w, k = scoremap.shape
    if factor < 1 or min(h, w) < 1 \
            or smem_bytes(h, w, k, factor) > build.MAX_SMEM_BYTES \
            or h * w * factor * factor >= 2**31:
        raise ValueError(f"decode_upsampled_cuda: unsupported {h}x{w} "
                         f"at factor {factor}")
    out = torch.empty((b, k, 2), dtype=torch.float32, device=scoremap.device)
    if b == 0 or k == 0:
        return out
    # the overlay path's band keys [b * k] and per-image tickets [b], zeroed
    # by the C entry on the stream
    scratch = torch.empty(b * k + b, dtype=torch.int64,
                          device=scoremap.device) \
        if overlay_path(factor) else None
    lib = _lib()
    with build.on_device(scoremap.device):
        err = lib.h3d_decode_upsampled(
            scoremap.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, h, w, k, factor, build.current_stream(scoremap.device))
    build.check(err, lib, "decode kernel")
    profiling.count("kernels.decode_upsampled.launches")
    return out


@torch.library.custom_op("hand3d::decode_upsampled", mutates_args=(),
                         device_types="cuda")
def decode_upsampled(scoremap: torch.Tensor, factor: int) -> torch.Tensor:
    """``decode_upsampled_cuda`` on a CUDA tensor, the twin on a CPU one."""
    return decode_upsampled_cuda(scoremap, factor)


@decode_upsampled.register_kernel("cpu")
def _decode_upsampled_cpu(scoremap, factor):
    from hand3d_tpu_torch.ops import keypoints

    return keypoints.decode_upsampled_torch(scoremap, factor)


@decode_upsampled.register_fake
def _decode_upsampled_fake(scoremap, factor):
    b, _, _, k = scoremap.shape
    return scoremap.new_empty((b, k, 2), dtype=torch.float32)
