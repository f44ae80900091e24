"""PoseNet: CPM-style 2D keypoint heatmaps with two refinement units
(counterpart of hand3d_tpu/models/posenet.py, float path).

Encoder [2, 2, 4, 2] x [64, 128, 256, 512] with 3 pools, conv4_3..4_6 (256)
and conv4_7 (128) as the encoding, a 1x1 head conv5_1(512) -> conv5_2(21),
then two units of concat(scoremap, encoding) -> 5 x 7x7 conv(128) ->
1x1(128) -> 1x1(21) (ColorHandPose3DNetwork.inference_pose2d, :170-219).
"""

import torch

from hand3d_tpu_torch.ops import nn, phasepack
from hand3d_tpu_torch.parallel import spatial

SCOPE = "PoseNet2D"
NUM_KP = 21
ENC_CHAN = 128
NUM_REFINEMENT_UNITS = 2

ENCODER = (
    [(f"conv1_{i}", 3, 64) for i in (1, 2)]
    + ["pool"]
    + [(f"conv2_{i}", 3, 128) for i in (1, 2)]
    + ["pool"]
    + [(f"conv3_{i}", 3, 256) for i in (1, 2, 3, 4)]
    + ["pool"]
    + [(f"conv4_{i}", 3, 512) for i in (1, 2)]
    + [(f"conv4_{i}", 3, 256) for i in (3, 4, 5, 6)]
    + [("conv4_7", 3, ENC_CHAN)]
)


def refinement_layers(unit):
    """(name, kernel, out_chan) of refinement unit ``unit`` (0 or 1)."""
    n = unit + 6
    specs = [(f"conv{n}_{i}", 7, 128) for i in range(1, 6)]
    return specs + [(f"conv{n}_6", 1, 128), (f"conv{n}_7", 1, NUM_KP)]


def init(rng):
    """TF-layout numpy param tree (Xavier / 1e-4)."""
    params = {}
    in_chan = 3
    for layer in ENCODER:
        if layer == "pool":
            continue
        name, ksize, out_chan = layer
        params[name] = nn.conv_init(rng, ksize, ksize, in_chan, out_chan)
        in_chan = out_chan
    params["conv5_1"] = nn.conv_init(rng, 1, 1, ENC_CHAN, 512)
    params["conv5_2"] = nn.conv_init(rng, 1, 1, 512, NUM_KP)
    for unit in range(NUM_REFINEMENT_UNITS):
        in_chan = NUM_KP + ENC_CHAN
        for name, ksize, out_chan in refinement_layers(unit):
            params[name] = nn.conv_init(rng, ksize, ksize, in_chan, out_chan)
            in_chan = out_chan
    return params


def apply_trunk(params, image_crop, compute_dtype=None, constrain=None):
    """Encoder + initial 1x1 head: image_crop [B, H, W, 3] -> (encoding,
    scoremap), NCHW [B, 128, H/8, W/8] and [B, 21, H/8, W/8]: everything
    before the two structurally identical refinement units, which the
    pipeline-parallel layer (``parallel.pipeline``) runs apart.

    ``constrain``: the spatial-partitioning hook
    (``parallel.spatial_constrainer``), applied after each encoder conv as
    in the JAX package; the encoding leaves the constrained region whole.
    A phase-packed layer that feeds a pool runs fused with it
    (``ops.phasepack.maybe_fused_conv_pool``).
    """
    x = image_crop.permute(0, 3, 1, 2).contiguous()
    with spatial.region(constrain):
        i = 0
        while i < len(ENCODER):
            layer = ENCODER[i]
            i += 1
            if layer == "pool":
                x = nn.max_pool_2x2(x)
                continue
            p = params[layer[0]]
            next_is_pool = i < len(ENCODER) and ENCODER[i] == "pool"
            fused = phasepack.maybe_fused_conv_pool(x, p, next_is_pool,
                                                    compute_dtype)
            if fused is not None:
                x = fused
                i += 1  # the pool ran fused
            else:
                x = nn.conv2d_relu(x, p, compute_dtype=compute_dtype)
            if constrain is not None:
                x = constrain(x)
        encoding = spatial.whole(x)
    x = nn.conv2d_relu(encoding, params["conv5_1"],
                       compute_dtype=compute_dtype)
    return encoding, nn.conv2d(x, params["conv5_2"],
                               compute_dtype=compute_dtype)


def apply_refinement_unit(layer_params, scoremap, encoding,
                          compute_dtype=None):
    """One refinement unit: concat(scoremap, encoding) -> new scoremap, all
    NCHW. ``layer_params``: the unit's 7 conv layer dicts in order; the
    caller names them, so the reference layout (conv6_* / conv7_*) and the
    pipeline's stage-stacked one share this code."""
    x = torch.cat([scoremap, encoding], dim=1)
    layer_params = list(layer_params)
    for i, p in enumerate(layer_params):
        x = nn.conv2d(x, p, compute_dtype=compute_dtype)
        if i < len(layer_params) - 1:
            x = nn.leaky_relu(x)
    return x


def apply(params, image_crop, compute_dtype=None, constrain=None):
    """image_crop [B, H, W, 3] -> three [B, H/8, W/8, 21] scoremaps.
    ``compute_dtype``: the convs' (``ops.nn.conv2d``); ``constrain``: see
    :func:`apply_trunk`."""
    encoding, scoremap = apply_trunk(params, image_crop, compute_dtype,
                                     constrain)
    scoremaps = [scoremap]
    for unit in range(NUM_REFINEMENT_UNITS):
        scoremaps.append(apply_refinement_unit(
            [params[name] for name, _, _ in refinement_layers(unit)],
            scoremaps[-1], encoding, compute_dtype))
    return [s.permute(0, 2, 3, 1).contiguous() for s in scoremaps]
