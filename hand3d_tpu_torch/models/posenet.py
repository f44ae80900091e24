"""PoseNet: CPM-style 2D keypoint heatmaps with two refinement units
(counterpart of hand3d_tpu/models/posenet.py, float path).

Encoder [2, 2, 4, 2] x [64, 128, 256, 512] with 3 pools, conv4_3..4_6 (256)
and conv4_7 (128) as the encoding, a 1x1 head conv5_1(512) -> conv5_2(21),
then two units of concat(scoremap, encoding) -> 5 x 7x7 conv(128) ->
1x1(128) -> 1x1(21) (ColorHandPose3DNetwork.inference_pose2d, :170-219).
"""

import torch

from hand3d_tpu_torch.ops import nn

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


def apply(params, image_crop, compute_dtype=None):
    """image_crop [B, H, W, 3] -> three [B, H/8, W/8, 21] scoremaps.
    ``compute_dtype``: the convs' (``ops.nn.conv2d``)."""
    x = image_crop.permute(0, 3, 1, 2).contiguous()
    for layer in ENCODER:
        if layer == "pool":
            x = nn.max_pool_2x2(x)
        else:
            x = nn.conv2d_relu(x, params[layer[0]],
                               compute_dtype=compute_dtype)
    encoding = x
    x = nn.conv2d_relu(encoding, params["conv5_1"],
                       compute_dtype=compute_dtype)
    scoremaps = [nn.conv2d(x, params["conv5_2"], compute_dtype=compute_dtype)]
    for unit in range(NUM_REFINEMENT_UNITS):
        layers = refinement_layers(unit)
        x = torch.cat([scoremaps[-1], encoding], dim=1)
        for i, (name, _, _) in enumerate(layers):
            x = nn.conv2d(x, params[name], compute_dtype=compute_dtype)
            if i < len(layers) - 1:
                x = nn.leaky_relu(x)
        scoremaps.append(x)
    return [s.permute(0, 2, 3, 1).contiguous() for s in scoremaps]
