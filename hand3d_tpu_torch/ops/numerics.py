"""Numeric helpers with reference-parity semantics (counterpart of
hand3d_tpu/ops/numerics.py)."""

import functools

import torch

PI = 3.141592653589793


def atan2_safe(y, x):
    """atan2 built from atan with quadrant corrections, returning (-pi, pi].

    The reference's hand-rolled atan2 (utils/canonical_trafo.py:21-38),
    including its x + 1e-8 shift, which changes results near the axes. It is
    not ``torch.atan2``: the published metrics were made with these values.
    """
    x_eps = x + 1e-8
    t = torch.atan(y / x_eps)  # (-pi/2, pi/2)
    t = torch.where(x_eps < 0.0, t + PI, t)  # (-pi/2, 3pi/2)
    t = torch.where(t < 0.0, t + 2.0 * PI, t)  # [0, 2pi)
    return torch.where(t > PI, t - 2.0 * PI, t)  # (-pi, pi]


def cache_plain(fn):
    """Memoise ``fn``, a maker of device tensors from hashable arguments,
    keeping a result only when it is made of plain tensors: one made while
    ``torch.export`` traces is a fake tensor, which a later eager call must
    not be handed. At most 256 results are kept."""
    cache = {}

    @functools.wraps(fn)
    def cached(*key):
        hit = cache.get(key)
        if hit is not None:
            return hit
        out = fn(*key)
        parts = out if isinstance(out, tuple) else (out,)
        if len(cache) < 256 and all(type(t) is torch.Tensor for t in parts):
            cache[key] = out
        return out

    cached.cache_clear = cache.clear
    return cached


@cache_plain
def _constant(values, dtype, device):
    # outside inference mode: an eval's first call must leave a tensor that
    # a later training step can use under autograd
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


def device_constant(values, dtype, device):
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    device and shared: a training step reads its constants from device
    memory and copies none from pageable host memory, which a captured CUDA
    graph cannot do. The tensor must not be written to."""
    return _constant(_frozen(values), dtype, torch.device(device))
