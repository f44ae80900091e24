"""The port's hand-written CUDA kernels: nvcc build (``build``) and their
bindings, each registered as a ``torch.ops.hand3d`` op. Importing this
package registers both ops, as a loaded ``torch.export`` program needs."""

import re

import torch

from hand3d_tpu_torch.ops.kernels import decode, floodfill  # noqa: F401
from hand3d_tpu_torch.utils import profiling

KERNELS = ("flood_fill", "decode_upsampled")
# each kernel's device functions as a device trace names them (csrc/*.cu)
DEVICE_NAMES = {"flood_fill": re.compile(r"\bflood_fill_kernel\b"),
                "decode_upsampled": re.compile(
                    r"\bdecode_(table|overlay)_kernel\b")}


def kernel_counts():
    """{kernel: launches} of both wrappers since the process started: each
    adds one to the recorder's counter ``kernels.<kernel>.launches`` where
    it launches its kernel, and nowhere else. A launch that a CUDA graph's
    capture records counts once there; the graph's replays run the kernel
    without entering the wrapper, and ``kernel_runs`` sees them."""
    counts = profiling.counters()
    return {k: counts.get(f"kernels.{k}.launches", 0) for k in KERNELS}


def kernel_runs(call):
    """(``call()``, {kernel: its runs on the card in a torch.profiler device
    trace of the call}): launched by a wrapper or replayed in a CUDA graph.
    Synchronizes the device before the trace ends."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, {k: sum(1 for n in names if pattern.search(n))
                 for k, pattern in DEVICE_NAMES.items()}
