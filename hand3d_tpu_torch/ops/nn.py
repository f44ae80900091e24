"""NN primitives, float path (counterpart of hand3d_tpu/ops/nn.py).

Activations here are NCHW and conv weights OIHW (torch layout); the model
modules convert at their NHWC boundaries and ``weights.params_from_jax``
converts the TF-layout HWIO kernels once. Dense kernels stay [in, out].
Dropout masks are drawn on a CPU ``torch.Generator`` and moved to the
device (or taken from a draw source's plan, already there), so a training
step's masks do not depend on where it runs.
Convolutions and matmuls go to cuDNN / cuBLAS, as the JAX package left them
to XLA. With ``compute_dtype=torch.bfloat16`` a conv or matmul follows
the JAX package's bf16 mode: its input and weights are rounded to bf16, the
products summed in f32, the output f32 and the bias added in f32. That is
an f32 conv on bf16-rounded operands, not PyTorch's bf16 conv, which rounds
its output to bf16 too. The initializers are numpy so
``weights.random_params`` needs no torch RNG and no jax.

A layer dict in the int8 layout ({"weights_q", ...},
``ops.quant.quantize_params_int8``) takes the int8 path and ignores
``compute_dtype``; one in the QAT layout ({"weights_fq", ...},
``ops.quant.qat_view``) fake-quantizes its weights and input, then runs the
float path.

A layer dict sharded over a mesh's "model" axis (it carries a
``parallel.mesh.ModelShard`` under ``SHARD_KEY``; ``parallel.shard_params``)
runs as a column-parallel layer: the input through ``copy_to_model``, this
rank's output channels, then ``gather_channels``; in the int8 and QAT
layouts too. An activation split by rows (``parallel.spatial``) runs each
conv after a halo exchange.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.data import augment
from hand3d_tpu_torch.parallel import collectives, spatial
from hand3d_tpu_torch.parallel.mesh import SHARD_KEY

NEG_SLOPE_OF_RELU = 0.01  # general.py:28
CONV_BIAS_INIT = 1e-4  # general.py:50
FC_BIAS_INIT = 1e-4  # general.py:126


def leaky_relu(x):
    """max(x, 0.01 x) — general.py:30-33. Keeps a row split's mark."""
    return spatial.mark(torch.maximum(x, NEG_SLOPE_OF_RELU * x),
                        spatial.rows_of(x))


def _kernel_key(params):
    return next(k for k in ("weights", "weights_q", "weights_fq")
                if k in params)


def _sharded(op, x, params, *args):
    """``op(x, params, *args)`` of a layer dict sharded over "model".

    A conv or dense layer shards its output channels (conv OIHW dim 0,
    dense dim 1), and so do its 1-dim leaves (biases, weight scales); it
    runs column-parallel: the whole input through ``copy_to_model`` (its
    gradient all-reduced), this rank's channels, then ``gather_channels``
    (output whole again, gradient sliced). A leaf sharded otherwise raises.
    A transposed conv (its TF-layout last dim is its input) gathers its
    sharded leaves and runs whole.
    """
    shard = params[SHARD_KEY]
    local = {k: v for k, v in params.items() if k != SHARD_KEY}
    if op is conv2d_transpose:
        for k in local:
            if shard.dim(k) is not None:
                local[k] = collectives.gather_channels(local[k], shard.group,
                                                       shard.dim(k))
        return op(x, local, *args)
    kernel = local[_kernel_key(local)]
    out_dim = 0 if kernel.ndim == 4 else kernel.ndim - 1
    for k, v in local.items():
        if k in ("weights", "weights_q", "weights_fq", "biases",
                 "weight_scale") and shard.dim(k) != (
                     out_dim if v.ndim > 1 else 0):
            raise ValueError(
                f"a sharded {op.__name__} layer splits its output channels; "
                f"its {k!r} is split on dim {shard.dim(k)}")
    if spatial.rows_of(x) is not None:
        raise ValueError("spatial partitioning takes replicated params; "
                         "this layer is sharded over 'model'")
    y = op(collectives.copy_to_model(x, shard.group), local, *args)
    return collectives.gather_channels(y, shard.group, 1)


def _same_pads(size, k, s):
    """TF-SAME (before, after) padding of one axis: the odd pixel goes after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


# Activation-range observer of ops.quant.calibrate_act_scales: a callable
# (x, layer params) while a calibration runs, None otherwise.
_act_observer = None


def rounded(x, compute_dtype):
    """``x`` rounded to ``compute_dtype`` (bf16) and held in f32; ``x`` when
    ``compute_dtype`` is None."""
    if compute_dtype is None:
        return x
    return x.to(compute_dtype).to(torch.float32)


def conv2d(x, params, stride=1, compute_dtype=None):
    """TF-SAME conv + bias on NCHW ``x``; params {"weights": OIHW, "biases"}.

    ``compute_dtype=torch.bfloat16``: x and the weights rounded to bf16, the
    conv in f32 with TF32 allowed for this call on the card (exact for such
    operands, ``precision.tf32_convs``). int8 and QAT layer dicts: see the
    module docstring.
    """
    if SHARD_KEY in params:
        return _sharded(conv2d, x, params, stride, compute_dtype)
    if _act_observer is not None:
        _act_observer(x, params)
    rows = spatial.rows_of(x)
    if rows is not None and ("weights_q" in params or "weights_fq" in params):
        raise ValueError("spatial partitioning runs the float and bf16 "
                         "convs; int8 and QAT scale each sample as a whole")
    if "weights_q" in params:
        from hand3d_tpu_torch.ops import quant

        return quant.conv2d_int8(x, params, stride)
    if "weights_fq" in params:
        from hand3d_tpu_torch.ops import quant

        x, params = quant.fake_quant_layer(x, params)
    w, b = params["weights"], params["biases"]
    if rows is not None:
        # replicated params applied to this rank's rows: their gradient is
        # the sum of the ranks'
        w, b = (collectives.copy_to_model(t, rows.group) for t in (w, b))
    if compute_dtype is None:
        return _conv2d(x, w, b, stride, rows)
    with precision.tf32_convs(x.device):
        return _conv2d(rounded(x, compute_dtype), rounded(w, compute_dtype),
                       b, stride, rows)


def same_padded(x, kh, kw, stride):
    """(x, [pad_h, pad_w]) such that ``F.conv2d(x, w, stride=stride,
    padding=[pad_h, pad_w])`` is the TF-SAME conv of NCHW ``x``: uneven
    padding (stride-2 layers on even inputs pad one more row / col at the
    end) is applied to ``x`` here."""
    pt, pb = _same_pads(x.shape[2], kh, stride)
    pl, pr = _same_pads(x.shape[3], kw, stride)
    if pt == pb and pl == pr:
        return x, [pt, pl]
    return F.pad(x, (pl, pr, pt, pb)), [0, 0]


def _conv2d(x, w, b, stride, rows=None):
    if rows is None:
        x, padding = same_padded(x, w.shape[2], w.shape[3], stride)
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    # this rank's rows: the halo rows stand for the SAME padding of H
    if stride != 1:
        raise ValueError("spatial partitioning runs stride-1 convs")
    x = rows.halo(x, w.shape[2])
    pl, pr = _same_pads(x.shape[3], w.shape[3], 1)
    return spatial.mark(F.conv2d(F.pad(x, (pl, pr, 0, 0)), w, b), rows)


def conv2d_relu(x, params, stride=1, compute_dtype=None):
    return leaky_relu(conv2d(x, params, stride, compute_dtype))


def conv2d_transpose(x, params, stride=2, compute_dtype=None):
    """TF-SAME transposed conv + bias on NCHW ``x`` (general.py:67-84,
    ``upconv``): ``tf.nn.conv2d_transpose``, the gradient of conv2d with
    respect to its input, output size ``stride`` times the input's.

    params["weights"] is the reference's [kh, kw, out, in] filter as
    ``weights.params_from_jax`` converts it, [in, out, kh, kw]: exactly
    ``F.conv_transpose2d``'s layout, no flip. TF-SAME crops the full
    transposed conv by the forward conv's leading pad and drops the odd
    pixel at the end. An int8 layer dict is dequantized first, a QAT one
    fake-quantizes its weights (not its input), as in the JAX package.
    """
    if SHARD_KEY in params:
        return _sharded(conv2d_transpose, x, params, stride, compute_dtype)
    if "weights_q" in params:
        from hand3d_tpu_torch.ops import quant

        params = {"weights": quant.dequantize_weights(params),
                  "biases": params["biases"]}
    elif "weights_fq" in params:
        from hand3d_tpu_torch.ops import quant

        params = {"weights": quant.fake_quant_weights(params["weights_fq"]),
                  "biases": params["biases"]}
    w, b = params["weights"], params["biases"]
    pads, out_pads = [], []
    for k, n in zip(w.shape[2:], x.shape[2:]):
        lead = max(k - stride, 0) // 2
        pads.append(lead)
        # where the full conv less the leading pads falls short of n * stride
        out_pads.append(max(n * stride - ((n - 1) * stride + k - 2 * lead),
                            0))
    scope = (precision.tf32_convs(x.device) if compute_dtype is not None
             else contextlib.nullcontext())
    with scope:
        y = F.conv_transpose2d(rounded(x, compute_dtype),
                               rounded(w, compute_dtype), b, stride=stride,
                               padding=pads, output_padding=out_pads)
    return y[:, :, :x.shape[2] * stride, :x.shape[3] * stride]


def conv2d_transpose_relu(x, params, stride=2, compute_dtype=None):
    """upconv_relu (general.py:87-90)."""
    return leaky_relu(conv2d_transpose(x, params, stride, compute_dtype))


def max_pool_2x2(x):
    """2x2 stride-2 VALID max pool of NCHW ``x`` — general.py:61-65. Rows
    split over ranks pool where they lie: an even number a rank."""
    rows = spatial.rows_of(x)
    if rows is not None:
        rows.check_pool(x)
    return spatial.mark(F.max_pool2d(x, 2, 2), rows)


def avg_pool(x, size, stride=None):
    """TF-SAME average pool of NCHW ``x`` (PosePriorNetwork.py:61).

    Evenly tiling windows are VALID. A ragged edge pads TF-SAME (the odd
    pixel after, unlike ``F.avg_pool2d``'s symmetric padding) and divides
    each window by its count of real pixels.
    """
    stride = stride or size
    h, w = x.shape[2:]
    if size == stride and h % stride == 0 and w % stride == 0:
        return F.avg_pool2d(x, size, stride)
    pt, pb = _same_pads(h, size, stride)
    pl, pr = _same_pads(w, size, stride)

    def window_sums(t):
        return F.avg_pool2d(F.pad(t, (pl, pr, pt, pb)), size, stride,
                            divisor_override=1)

    return window_sums(x) / window_sums(torch.ones_like(x[:1, :1]))


def dense(x, params, compute_dtype=None):
    """matmul + bias; params {"weights": [in, out], "biases": [out]}.

    ``compute_dtype=torch.bfloat16``: x and the weights rounded to bf16, the
    matmul in exact f32 (these layers are small; TF32 stays off for cuBLAS).
    int8 and QAT layer dicts: see the module docstring.
    """
    if SHARD_KEY in params:
        return _sharded(dense, x, params, compute_dtype)
    if _act_observer is not None:
        _act_observer(x, params)
    if "weights_q" in params:
        from hand3d_tpu_torch.ops import quant

        return quant.dense_int8(x, params)
    if "weights_fq" in params:
        from hand3d_tpu_torch.ops import quant

        x, params = quant.fake_quant_layer(x, params)
    return (torch.matmul(rounded(x, compute_dtype),
                         rounded(params["weights"], compute_dtype))
            + params["biases"])


def dense_relu(x, params, compute_dtype=None):
    return leaky_relu(dense(x, params, compute_dtype))


def keep_mask(generator, keep_prob, shape, device):
    """Bernoulli(keep_prob) keep mask of ``shape``, drawn on the CPU
    ``generator`` and moved to ``device``: the card and the CPU draw the
    same mask at the same step. A draw source in the generator's place
    gives the mask it planned (``data.augment.drawn``)."""
    return augment.keep(generator, keep_prob, tuple(shape)).to(device)


def dropout(x, keep_prob, train, generator=None):
    """Inverted dropout gated on ``train`` (general.py:138-148): kept values
    are scaled by 1 / keep_prob. The mask comes from ``generator``."""
    if not train or keep_prob >= 1.0:
        return x
    mask = keep_mask(generator, keep_prob, x.shape, x.device)
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


def spatial_dropout(x, keep_prob, train, generator=None):
    """Channel-wise inverted dropout of NHWC ``x``, one draw per (sample,
    channel): noise shape [B, 1, 1, C] (general.py:150-160)."""
    if not train or keep_prob >= 1.0:
        return x
    mask = keep_mask(generator, keep_prob, (x.shape[0], 1, 1, x.shape[3]),
                     x.device)
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


# --- Initializers (numpy, TF layout) ----------------------------------------


def conv_init(rng, kh, kw, in_chan, out_chan):
    """Glorot-uniform HWIO kernel + 1e-4 bias, like hand3d_tpu.ops.nn.conv_init."""
    limit = math.sqrt(6.0 / (kh * kw * (in_chan + out_chan)))
    return {
        "weights": rng.uniform(-limit, limit, (kh, kw, in_chan, out_chan))
        .astype(np.float32),
        "biases": np.full((out_chan,), CONV_BIAS_INIT, np.float32),
    }


def dense_init(rng, in_chan, out_chan):
    """Glorot-uniform [in, out] kernel + 1e-4 bias."""
    limit = math.sqrt(6.0 / (in_chan + out_chan))
    return {
        "weights": rng.uniform(-limit, limit, (in_chan, out_chan))
        .astype(np.float32),
        "biases": np.full((out_chan,), FC_BIAS_INIT, np.float32),
    }
