"""The port's exact-f32 contract on a CUDA device.

Parity with the JAX package is stated in float32. cuDNN convolutions default
to TF32 (``torch.backends.cudnn.allow_tf32 = True``), which keeps about three
decimal digits: enough to flip the mask and keypoint argmaxes the parity
checks rely on. Every entry point that puts parameters on a CUDA device calls
``exact_f32`` first. The two flags are process-wide.

Two modes are the exception: a convolution of operands rounded to bf16 (8
significant bits) or of int8-valued operands (|q| <= 127, 7 bits) is exact
in TF32 (11 bits), so ``tf32_convs`` lets cuDNN use the tensor cores for
exactly those calls and restores the flag after each. cuBLAS stays exact
f32 throughout.
"""

import contextlib

import torch


def exact_f32(device):
    """Resolve ``device``; for a CUDA device, require one and turn TF32 off.

    Raises RuntimeError when a CUDA device is asked for and none is present:
    nothing carries on on the CPU instead.
    Returns the ``torch.device``.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} was asked for, but no CUDA "
                               "device is present")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def tf32_convs(device):
    """Context in which cuDNN may use TF32 on a CUDA ``device``; the flag is
    restored on exit. Only for convolutions whose operands TF32 holds
    exactly, where it multiplies exactly and accumulates in f32: operands
    rounded to bf16 (the JAX package's bf16 semantics) and int8-valued ones
    (its int8 semantics off the TPU, ``ops.quant``). A no-op on the CPU.

    The flag is process-wide, so the card is driven from one thread at a
    time (``serving.DynamicBatcher``, the HTTP server's lock).
    """
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return _cudnn_tf32()


@contextlib.contextmanager
def _cudnn_tf32():
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before
