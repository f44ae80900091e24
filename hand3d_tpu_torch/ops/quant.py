"""Post-training int8 quantization and quantization-aware training
(counterpart of hand3d_tpu/ops/quant.py).

Scheme, as the JAX package's: weights per-output-channel symmetric int8
(``w_q = round(w / s_w)``, ``s_w[oc] = max|w[oc]| / 127``); activations
either dynamic per-sample symmetric int8, or static per-input-channel
scales calibrated on the float model and folded into the kernel
(``conv(x, w) == conv(x / s_in, w * s_in)``); the integer product summed
exactly, then dequantized and biased in f32. Quantization is a param-tree
transform: ``quantize_params_int8`` rewrites a layer dict
{"weights", "biases"} into {"weights_q", "weight_scale", ["act_scale"],
"biases"} and ``ops.nn.conv2d`` / ``dense`` dispatch on that layout.

Layouts are the port's: conv kernels OIHW (output channel dim 0, input
channel dim 1), dense kernels [in, out] (output dim 1, input dim 0),
activations NCHW or [B, C]. A transposed conv's [in, out, kh, kw] kernel is
read the way the JAX package reads its [kh, kw, out, in] one, so both
quantize the same axis of the same layer.

Static act scales are keyed by the layer's path in the tree, a tuple of keys
such as ("PoseNet2D", "conv4_1"), not by ``id()`` of a leaf: the keys hold
across a ``params_from_jax`` conversion, a copy to the device and a
training step. A path that names no layer of the tree raises.

The int8 product: the JAX package accumulates int8 x int8 in int32 on the
TPU and, on every other backend, runs f32 arithmetic over the same integer
values. Here it is the latter: ``F.conv2d`` of integer-valued f32 operands
(|q| <= 127, exact in TF32's 11 significant bits), with TF32 allowed for
that call on a CUDA device (``precision.tf32_convs``), so the tensor cores
multiply exactly and sum in f32; a sum is exact while its partial sums stay
below 2**24. The conv goes through the registered op
``torch.ops.hand3d.int8_conv``, which scopes the TF32 flag itself, so an
exported program runs it the same way. ``dense_int8`` is a plain f32 matmul
(TF32 off for cuBLAS).
"""

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.parallel import mesh as mesh_lib

QMAX = 127.0
EPS = 1e-12  # guards all-zero tensors; the scale of a zero tensor is moot
SKIP_SUBSTRINGS = ("upconv", "deconv")


def _oc_axis(w):
    """The output-channel axis of a kernel: 0 of OIHW, 1 of dense [in, out]."""
    return 0 if w.ndim == 4 else w.ndim - 1


def _ic_axis(w):
    """The input-channel axis of a kernel: 1 of OIHW, 0 of dense [in, out]."""
    return 1 if w.ndim == 4 else 0


def _along(v, w, axis):
    """[C] ``v`` shaped to broadcast along ``axis`` of ``w``."""
    shape = [1] * w.ndim
    shape[axis] = -1
    return v.reshape(shape)


def _over_qmax(t):
    """t / 127 as a true division on every device: a CUDA tensor divided by
    a Python scalar is multiplied by its reciprocal instead, which is not
    the same f32 number, so the divisor is a tensor here."""
    return t / torch.full_like(t, QMAX)


def _weight_scale(w):
    """Per-output-channel symmetric scale [oc]: the one definition shared by
    deployment quantization and the QAT fake-quant view."""
    axes = tuple(d for d in range(w.ndim) if d != _oc_axis(w))
    return _over_qmax(w.abs().amax(dim=axes).clamp_min(EPS))


def quantize_weights_int8(w):
    """Float kernel -> (int8 kernel, [oc] float32 scale)."""
    scale = _weight_scale(w)
    w_q = torch.clamp(torch.round(w / _along(scale, w, _oc_axis(w))),
                      -QMAX, QMAX).to(torch.int8)
    return w_q, scale.to(torch.float32)


def _act_scale(x):
    """Per-sample symmetric scale of [B, ...] ``x``, shaped [B, 1, ...]."""
    axes = tuple(range(1, x.ndim))
    return _over_qmax(x.abs().amax(dim=axes, keepdim=True).clamp_min(EPS))


def quantize_act_int8(x):
    """Per-sample dynamic quantization of [B, ...] activations: (int8
    values, [B, 1, ...] float32 scale). Per-sample scales keep a padded
    serving batch from perturbing its real samples."""
    scale = _act_scale(x)
    x_q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return x_q, scale.to(torch.float32)


def is_quantized(params):
    return isinstance(params, dict) and "weights_q" in params


def _is_layer(p):
    return isinstance(p, dict) and "weights" in p and "biases" in p


def layer_paths(params, prefix=()):
    """{path tuple: layer dict} of every layer dict of the tree (float,
    int8, QAT or phase-packed layout; the quantizers pass a packed layer
    by)."""
    if not isinstance(params, dict):
        return {}
    if "biases" in params and any(k in params for k in (
            "weights", "weights_q", "weights_fq", "weights_p2")):
        return {prefix: params}
    out = {}
    for k, v in params.items():
        out.update(layer_paths(v, prefix + (k,)))
    return out


def _check_paths(params, act_scales):
    """Raise unless every key of ``act_scales`` is the path of a layer of
    ``params``."""
    if not act_scales:
        return
    known = layer_paths(params)
    unknown = [p for p in act_scales if tuple(p) not in known]
    if unknown:
        raise ValueError(f"act scales for paths that name no layer of the "
                         f"tree: {sorted(map(tuple, unknown))[:5]}")


# --- static per-channel activation scales (calibrated) ----------------------


def calibrate_act_scales(run_float, params, batches, margin=1.0):
    """Observe per-input-channel activation ranges of every conv / FC layer.

    ``run_float(params, batch)`` runs the FLOAT model on ``params`` itself
    (the observer in ``ops.nn`` records each layer it meets under that
    layer's path in ``params``). Raises when it met no layer of
    ``params``: the model ran on another tree.

    Returns {path: s_in} with s_in = margin * amax[ic] / 127, float32
    numpy.
    """
    from hand3d_tpu_torch.ops import nn as _nn

    paths = {id(layer["weights"]): path
             for path, layer in layer_paths(params).items()
             if "weights" in layer}
    amax = {}

    def observe(x, layer_params):
        path = paths.get(id(layer_params.get("weights")))
        if path is None:
            return
        dims = tuple(d for d in range(x.ndim) if d != 1)
        m = x.detach().abs().amax(dim=dims)
        amax[path] = torch.maximum(amax[path], m) if path in amax else m

    prev = _nn._act_observer
    _nn._act_observer = observe
    try:
        with torch.inference_mode():
            for batch in batches:
                run_float(params, batch)
    finally:
        _nn._act_observer = prev
    if not amax:
        raise ValueError("calibrate_act_scales: run_float ran no layer of "
                         "the params it was given")
    out = {}
    for path, m in amax.items():
        m = m.cpu().numpy().astype(np.float32)
        out[path] = (margin * np.maximum(m, EPS) / QMAX).astype(np.float32)
    return out


def _eligible(w, min_in_chan, min_out_chan, shard=None):
    """Shared PTQ / QAT layer gate: the two paths quantize the same set.
    ``min_in_chan`` keeps the early narrow layers float, ``min_out_chan``
    the prediction heads (21- and 2-channel scoremaps). ``shard``: the
    layer's ModelShard, whose slice of the output channels counts whole."""
    out = w.shape[_oc_axis(w)]
    if shard is not None and shard.dim("weights") == _oc_axis(w):
        out = shard.width
    return w.shape[_ic_axis(w)] >= min_in_chan and out >= min_out_chan


def unit_act_scales(params, min_in_chan=128, min_out_chan=32,
                    skip_substrings=SKIP_SUBSTRINGS):
    """All-ones "calibration" {path: ones[ic]} for every eligible layer:
    the deployed static-int8 graph without a calibration run, for speed
    work only (the grid is wrong unless activations lie in [-127, 127])."""
    out = {}

    def walk(p, path):
        if not isinstance(p, dict):
            return
        if _is_layer(p):
            w = p["weights"]
            if _eligible(w, min_in_chan, min_out_chan):
                out[path] = np.ones((w.shape[_ic_axis(w)],), np.float32)
            return
        for k, v in p.items():
            if not any(s in k for s in skip_substrings):
                walk(v, path + (k,))

    walk(params, ())
    return out


def resolve_scopes(params, scopes):
    """Case-insensitive stage names -> the tree's top-level keys
    ({"handsegnet"} -> {"HandSegNet"}). Raises on a name that matches no
    scope: a typo must not serve the float model under an int8 name."""
    by_lower = {k.lower(): k for k in params}
    out = set()
    for s in scopes:
        k = by_lower.get(str(s).lower())
        if k is None:
            raise ValueError(
                f"unknown quantize scope {s!r}; available: {sorted(params)}")
        out.add(k)
    return out


def _scale_tensor(s_in, like):
    """``s_in`` (numpy or tensor) as float32 on ``like``'s device; a tensor
    already there is returned as it is (no copy inside a captured step)."""
    if not isinstance(s_in, torch.Tensor):
        s_in = torch.from_numpy(np.asarray(s_in, np.float32))
    return s_in.to(device=like.device, dtype=torch.float32)


def _quantize_layer(layer, s_in):
    w = layer["weights"]
    biases = layer["biases"].to(torch.float32)
    if s_in is None:
        w_q, scale = quantize_weights_int8(w)
        return {"weights_q": w_q, "weight_scale": scale, "biases": biases}
    s_in = _scale_tensor(s_in, w)
    # fold the static input scale into the kernel: conv(x, w) ==
    # conv(x / s_in, w * s_in) exactly (per-ic scale)
    w_q, scale = quantize_weights_int8(w * _along(s_in, w, _ic_axis(w)))
    return {"weights_q": w_q, "weight_scale": scale, "act_scale": s_in,
            "biases": biases}


@torch.no_grad()
def quantize_params_int8(params, min_in_chan=128, min_out_chan=32,
                         skip_substrings=SKIP_SUBSTRINGS, scopes=None,
                         act_scales=None, include_substrings=None):
    """Rewrite the tree's {"weights", "biases"} layer dicts into the int8
    layout {"weights_q", "weight_scale", "biases"}. Idempotent.

    ``scopes``: top-level stage names (case-insensitive); only those
    subtrees are quantized. ``min_in_chan`` / ``min_out_chan``: layers with
    fewer input / output channels stay float (0 disables). ``skip_substrings``:
    subtrees whose key contains one stay float (transposed convs).
    ``act_scales``: {path: s_in} (``calibrate_act_scales``); a layer found
    there takes the static scheme, its s_in folded into the kernel and kept
    as "act_scale"; others stay dynamic. A path naming no layer raises.
    ``include_substrings``: only subtrees whose key contains one are
    quantized; composes with ``scopes``. A deployment transform: no
    gradient reaches the new leaves.
    """
    _check_paths(params, act_scales)
    if mesh_lib.is_sharded(params):
        raise ValueError("quantize the whole tree, then shard it "
                         "(parallel.shard_params covers the int8 layout)")
    act_scales = {tuple(k): v for k, v in (act_scales or {}).items()}

    def walk(p, path, include):
        if not isinstance(p, dict):
            return p
        if _is_layer(p):
            if include is not None or not _eligible(
                    p["weights"], min_in_chan, min_out_chan):
                return dict(p)
            return _quantize_layer(p, act_scales.get(path))
        if is_quantized(p):
            return dict(p)
        out = {}
        for k, v in p.items():
            if any(s in k for s in skip_substrings):
                out[k] = v
                continue
            inc = include
            if inc is not None and any(s in k for s in inc):
                inc = None  # matched: quantize this whole subtree
            out[k] = walk(v, path + (k,), inc)
        return out

    if scopes is not None:
        keys = resolve_scopes(params, scopes)
        return {k: (walk(v, (k,), include_substrings) if k in keys else v)
                for k, v in params.items()}
    return walk(params, (), include_substrings)


def dequantize_weights(params):
    """The float kernel of a quantized layer dict (to within the original
    rounding), for ops with no int8 path."""
    w_q = params["weights_q"]
    w = w_q.to(torch.float32) * _along(params["weight_scale"], w_q,
                                       _oc_axis(w_q))
    if "act_scale" in params:
        # static layers store w * s_in: unfold to recover the kernel
        w = w / _along(params["act_scale"], w, _ic_axis(w))
    return w


# --- quantization-aware training --------------------------------------------


def _ste(x, quantized):
    """Straight-through estimator: forward = quantized, gradient = identity."""
    return x + (quantized - x).detach()


def fake_quant_weights(w):
    """QDQ view of a kernel with quantize_weights_int8's per-output-channel
    scales; gradients pass straight through (the scales are detached)."""
    scale = _along(_weight_scale(w).detach(), w, _oc_axis(w))
    q = torch.clamp(torch.round(w / scale), -QMAX, QMAX) * scale
    return _ste(w, q)


def fake_quant_act(x):
    """QDQ view of activations with quantize_act_int8's per-sample scales."""
    scale = _act_scale(x).detach()
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX) * scale
    return _ste(x, q)


def fake_quant_weights_static(w, s_in):
    """QDQ kernel view of the static deployment: the kernel folded by s_in,
    quantized per output channel and unfolded; gradients pass straight
    through to ``w``."""
    s_in = _along(_scale_tensor(s_in, w).detach(), w, _ic_axis(w))
    folded = w * s_in
    scale = _along(_weight_scale(folded).detach(), w, _oc_axis(w))
    q = torch.clamp(torch.round(folded / scale), -QMAX, QMAX) * scale / s_in
    return _ste(w, q)


def fake_quant_act_static(x, s_in):
    """QDQ activation view of the static scheme: the per-input-channel grid
    of the deployed round(x / s_in), clipping at +-127 s_in."""
    s_in = _along(_scale_tensor(s_in, x).detach(), x, 1)
    q = torch.clamp(torch.round(x / s_in), -QMAX, QMAX) * s_in
    return _ste(x, q)


def fake_quant_layer(x, params):
    """(fake-quantized x, float layer dict) of a QAT layer dict
    {"weights_fq", "biases", ["act_scale_fq"]}: the static twin when the
    layer carries "act_scale_fq", else the dynamic one."""
    s_in = params.get("act_scale_fq")
    if s_in is not None:
        return (fake_quant_act_static(x, s_in),
                {"weights": fake_quant_weights_static(params["weights_fq"],
                                                      s_in),
                 "biases": params["biases"]})
    return (fake_quant_act(x),
            {"weights": fake_quant_weights(params["weights_fq"]),
             "biases": params["biases"]})


def qat_view(params, min_in_chan=128, min_out_chan=32,
             skip_substrings=SKIP_SUBSTRINGS, scopes=None, act_scales=None):
    """Quantization-aware-training view of a param tree.

    Each eligible layer's "weights" is renamed "weights_fq" (the same
    tensor, so gradients reach the original leaf); ``ops.nn.conv2d`` /
    ``dense`` then fake-quantize weights and activations before the float
    op. Same gate and ``scopes`` as :func:`quantize_params_int8`, so
    training and deployment quantize the same layers. ``act_scales``
    ({path: s_in}) puts a layer on the static fake quantizer
    ("act_scale_fq"); a path naming no layer raises. Inside a captured
    CUDA graph pass the scales as tensors on the device.

    Usage: ``loss_qat = lambda p, batch, g: loss_fn(qat_view(p), batch, g)``;
    after training, ``quantize_params_int8(params)`` is the deployment tree.
    """
    _check_paths(params, act_scales)
    act_scales = {tuple(k): v for k, v in (act_scales or {}).items()}

    def walk(p, path):
        if not isinstance(p, dict):
            return p
        if _is_layer(p):
            shard = p.get(mesh_lib.SHARD_KEY)
            if not _eligible(p["weights"], min_in_chan, min_out_chan, shard):
                return p
            out = {"weights_fq": p["weights"], "biases": p["biases"]}
            if shard is not None:  # the same slices, renamed
                out[mesh_lib.SHARD_KEY] = shard._replace(dims=tuple(
                    ("weights_fq" if k == "weights" else k, d)
                    for k, d in shard.dims))
            s_in = act_scales.get(path)
            if s_in is not None:
                out["act_scale_fq"] = s_in
            return out
        return {k: (v if any(s in k for s in skip_substrings)
                    else walk(v, path + (k,)))
                for k, v in p.items()}

    if scopes is not None:
        keys = resolve_scopes(params, scopes)
        return {k: (walk(v, (k,)) if k in keys else v)
                for k, v in params.items()}
    return walk(params, ())


# --- the int8 layers ---------------------------------------------------------


@torch.library.custom_op("hand3d::int8_conv", mutates_args=())
def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
              padding: List[int]) -> torch.Tensor:
    """``F.conv2d`` of integer-valued f32 operands: the int8 product's
    accumulator. On a CUDA device with TF32 allowed for this call only."""
    with precision.tf32_convs(x_q.device):
        return F.conv2d(x_q, w_q, stride=stride, padding=padding)


@int8_conv.register_fake
def _int8_conv_fake(x_q, w_q, stride, padding):
    b, _, h, w = x_q.shape
    oc, _, kh, kw = w_q.shape
    return x_q.new_empty((b, oc, (h + 2 * padding[0] - kh) // stride + 1,
                          (w + 2 * padding[1] - kw) // stride + 1))


def _quantize_input(x, params):
    """(integer-valued f32 x_q, s_x): static (elementwise by "act_scale",
    s_x None since the scale is folded into the kernel) or dynamic
    per-sample."""
    s_in = params.get("act_scale")
    if s_in is not None:
        x_q = torch.clamp(torch.round(x / _along(s_in, x, 1)), -QMAX, QMAX)
        return x_q, None
    scale = _act_scale(x)
    return torch.clamp(torch.round(x / scale), -QMAX, QMAX), scale


def _dequantized(acc, s_x, params, axis):
    scale = _along(params["weight_scale"], acc, axis)
    if s_x is not None:
        scale = s_x * scale
    return acc * scale + _along(params["biases"], acc, axis)


def conv2d_accumulator(x, params, stride=1):
    """(accumulator, s_x) of the int8 conv of NCHW ``x``: the conv of the
    integer operands before the dequant, TF-SAME padded."""
    from hand3d_tpu_torch.ops import nn

    x_q, s_x = _quantize_input(x, params)
    w_q = params["weights_q"].to(torch.float32)
    x_q, padding = nn.same_padded(x_q, w_q.shape[2], w_q.shape[3], stride)
    return torch.ops.hand3d.int8_conv(x_q, w_q, stride, padding), s_x


def conv2d_int8(x, params, stride=1):
    """int8 conv of NCHW ``x``: exact integer accumulation, then
    ``acc * (s_x * weight_scale) + biases`` in f32."""
    acc, s_x = conv2d_accumulator(x, params, stride)
    return _dequantized(acc, s_x, params, 1)


def dense_int8(x, params):
    """int8 matmul of [B, in] ``x`` + f32 dequant + bias."""
    x_q, s_x = _quantize_input(x, params)
    acc = torch.matmul(x_q, params["weights_q"].to(torch.float32))
    return _dequantized(acc, s_x, params, 1)
