"""Numeric helpers with reference-parity semantics (counterpart of
hand3d_tpu/ops/numerics.py)."""

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
