"""The port's exact-f32 contract on a CUDA device.

Parity with the JAX package is stated in float32. cuDNN convolutions default
to TF32 (``torch.backends.cudnn.allow_tf32 = True``), which keeps about three
decimal digits: enough to flip the mask and keypoint argmaxes the parity
checks rely on. Every entry point that puts parameters on a CUDA device calls
``exact_f32`` first. The two flags are process-wide.
"""

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
