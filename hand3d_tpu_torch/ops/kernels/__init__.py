"""The port's hand-written CUDA kernels: nvcc build (``build``) and their
bindings, each registered as a ``torch.ops.hand3d`` op. Importing this
package registers both ops, as a loaded ``torch.export`` program needs."""

from hand3d_tpu_torch.ops.kernels import decode, floodfill  # noqa: F401
