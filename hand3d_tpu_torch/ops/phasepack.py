"""Output-phase-packed 3x3 convolution (counterpart of
hand3d_tpu/ops/phasepack.py).

A stride-1 SAME 3x3 conv with ``oc`` output channels, written as one conv of
stride (1, 2) and kernel width 4 with ``2 oc`` output channels: channel block
[0:oc] computes the even output columns (taps 0..2 of the width-4 window
anchored at column 2k - 1), block [oc:2oc] the odd ones (taps 1..3); the
remaining tap of each block is an exact zero. The JAX package packs conv1_2
this way to fill the TPU's 128-lane MXU; here the packed layer runs on
cuDNN, a plain conv that spends 4/3 of the plain layer's multiply-adds.

The packed layer computes the same products plus exact zeros in another
summation order, so it equals the plain conv to float reassociation
(~1e-6), not bit for bit. It is an opt-in param-tree transform
(``phase_pack_params``); ``ops.nn.conv2d`` dispatches on the layout
{"weights_p2", "biases"}, and the models fuse a packed layer that feeds a
2x2 pool into ``conv_relu_pool_packed`` (``maybe_fused_conv_pool``).

Layouts are the port's: activations NCHW, the packed kernel OIHW
[2 oc, ic, 3, 4]. ``phase_pack_params`` also takes the TF-layout numpy tree,
whose packed kernel is HWIO [3, 4, ic, 2 oc] as in the JAX package, so it
composes before or after ``weights.params_from_jax``.

Conditions: 3x3 float layers with at most 64 output channels, stride 1 (the
tree records no stride, so the selector picks stride-1 layers), an even
input width when the layer runs. An odd width or another stride raises.
"""

import numpy as np
import torch
import torch.nn.functional as F

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.ops import nn
from hand3d_tpu_torch.parallel import collectives, spatial

MAX_OUT_CHAN = 64  # the JAX package's bound: 2 oc fills 128 lanes


def pack_kernel(w):
    """OIHW [oc, ic, 3, 3] -> [2 oc, ic, 3, 4]: block [0:oc] the even phase
    (taps 0..2), block [oc:2oc] the odd phase (taps 1..3), zeros elsewhere."""
    oc, ic, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"phase packing takes 3x3 kernels, got {kh}x{kw}")
    wp = w.new_zeros((2 * oc, ic, kh, 4))
    wp[:oc, :, :, 0:3] = w
    wp[oc:, :, :, 1:4] = w
    return wp


def _pack_hwio(w):
    """The TF-layout form of :func:`pack_kernel`: HWIO [3, 3, ic, oc] ->
    [3, 4, ic, 2 oc] (``hand3d_tpu.ops.phasepack.pack_kernel``)."""
    kh, kw, ic, oc = w.shape
    wp = np.zeros((kh, 4, ic, 2 * oc), w.dtype)
    wp[:, 0:3, :, :oc] = w
    wp[:, 1:4, :, oc:] = w
    return wp


def conv2d_phase_packed(x, params, compute_dtype=None, interleave=True):
    """A packed layer {"weights_p2": [2oc, ic, 3, 4], "biases": [oc]} on
    NCHW ``x`` of even width: the plain SAME conv + bias to float
    reassociation. ``interleave=False`` leaves the packed layout
    [B, 2oc, H, W/2] (phase blocks along channels) for a fused consumer.

    ``compute_dtype``: bf16 rounding of x and the kernel, as
    ``ops.nn.conv2d``. Rows split by ``parallel.spatial`` take a one-row
    halo from each neighbour, as a 3x3 conv does."""
    if x.shape[3] % 2:
        raise ValueError(f"a phase-packed conv needs an even input width, "
                         f"got {tuple(x.shape)}")
    w, b = params["weights_p2"], params["biases"]
    rows = spatial.rows_of(x)
    pad_h = 1
    if rows is not None:
        w, b = (collectives.copy_to_model(t, rows.group) for t in (w, b))
        x, pad_h = rows.halo(x, 3), 0
    bias = torch.cat([b, b])
    if compute_dtype is None:
        y = F.conv2d(x, w, bias, stride=(1, 2), padding=(pad_h, 1))
    else:
        with precision.tf32_convs(x.device):
            y = F.conv2d(nn.rounded(x, compute_dtype),
                         nn.rounded(w, compute_dtype), bias, stride=(1, 2),
                         padding=(pad_h, 1))
    if interleave:
        bb, oc2, hh, wh = y.shape
        # [B, 2, oc, H, W/2] -> [B, oc, H, W/2, 2]: column 2k + p from block p
        y = (y.reshape(bb, 2, oc2 // 2, hh, wh).permute(0, 2, 3, 4, 1)
             .reshape(bb, oc2 // 2, hh, 2 * wh))
    return spatial.mark(y, rows)


def conv_relu_pool_packed(x, params, compute_dtype=None):
    """Fused packed conv + leaky ReLU + 2x2 stride-2 VALID max pool:
    ``max_pool_2x2(leaky_relu(conv2d(x, unpacked)))``. The pool's
    horizontal max over columns (2j, 2j + 1) is the max of the two phase
    blocks, the vertical max a (2, 1) pool over rows (an odd last row
    dropped), and the leaky ReLU, monotone, runs last on the pooled map."""
    y = conv2d_phase_packed(x, params, compute_dtype, interleave=False)
    rows = spatial.rows_of(y)
    oc = y.shape[1] // 2
    h = torch.maximum(y[:, :oc], y[:, oc:])
    if rows is not None:
        rows.check_pool(h)
    v = F.max_pool2d(h, (2, 1), (2, 1))
    return nn.leaky_relu(spatial.mark(v, rows))


def maybe_fused_conv_pool(x, layer_params, next_is_pool, compute_dtype=None):
    """The encoders' fusion rule: a packed layer whose next entry is a 2x2
    pool runs ``conv_relu_pool_packed`` and returns its output (the caller
    then skips the pool); otherwise None and the caller runs the layer
    through ``ops.nn.conv2d``."""
    if "weights_p2" in layer_params and next_is_pool:
        return conv_relu_pool_packed(x, layer_params, compute_dtype)
    return None


def _default_packable(name):
    """conv1_2 of HandSegNet and PoseNet: the 64-channel stride-1 layer at
    full resolution that feeds a 2x2 pool, the one layer the JAX package
    packs by default."""
    return name == "conv1_2"


def _packable_kernel(w):
    """Whether kernel ``w`` is a 3x3 conv with at most MAX_OUT_CHAN outputs:
    OIHW for a tensor, HWIO for a TF-layout array."""
    if getattr(w, "ndim", 0) != 4:
        return False
    if isinstance(w, torch.Tensor):
        return tuple(w.shape[2:]) == (3, 3) and w.shape[0] <= MAX_OUT_CHAN
    return tuple(w.shape[:2]) == (3, 3) and w.shape[3] <= MAX_OUT_CHAN


@torch.no_grad()
def phase_pack_params(params, packable=_default_packable):
    """Param-tree transform: each float conv layer that ``packable(name)``
    selects and that passes the shape guards (3x3, at most 64 output
    channels) becomes {"weights_p2", "biases"}; every other layer (wide or
    1x1 convs, dense layers, int8 and QAT layouts) is kept as it is.

    Takes a torch tree (OIHW kernels) or the TF-layout numpy tree (HWIO),
    and packs into the same layout. Compose with int8 quantization by
    quantizing first: quantized layers are skipped here."""

    def visit(name, layer):
        if not isinstance(layer, dict):
            return layer
        if "weights" in layer:
            w = layer["weights"]
            if not (packable(name) and _packable_kernel(w)):
                return layer
            wp = (pack_kernel(w) if isinstance(w, torch.Tensor)
                  else _pack_hwio(np.asarray(w)))
            return {"weights_p2": wp, "biases": layer["biases"]}
        return {k: visit(k, v) for k, v in layer.items()}

    return visit("", params)
