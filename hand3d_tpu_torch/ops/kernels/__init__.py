"""The port's hand-written CUDA kernels: nvcc build (``build``) and their
bindings, each registered as a ``torch.ops.hand3d`` op. Importing this
package registers both ops, as a loaded ``torch.export`` program needs."""

from hand3d_tpu_torch.ops.kernels import decode, floodfill  # noqa: F401
from hand3d_tpu_torch.utils import profiling

KERNELS = ("flood_fill", "decode_upsampled")


def kernel_counts():
    """{kernel: launches} of both wrappers since the process started: each
    adds one to the recorder's counter ``kernels.<kernel>.launches`` where
    it launches its kernel, and nowhere else."""
    counts = profiling.counters()
    return {k: counts.get(f"kernels.{k}.launches", 0) for k in KERNELS}
