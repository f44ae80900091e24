"""HandSegNet: VGG-style encoder -> 2-class hand segmentation scoremap
(counterpart of hand3d_tpu/models/handsegnet.py, float path).

Blocks of [2, 2, 4, 4] 3x3 convs with [64, 128, 256, 512] channels, a 2x2
max pool after the first three, conv5_1(512)/conv5_2(128), then a 1x1 head
conv6_1(512) -> conv6_2(2), bilinearly upsampled to the input resolution
(ColorHandPose3DNetwork.inference_detection, :131-168).
"""

from hand3d_tpu_torch.ops import nn
from hand3d_tpu_torch.ops.image import resize_bilinear
from hand3d_tpu_torch.parallel import spatial

SCOPE = "HandSegNet"

# (name, kernel, out_chan, relu); "pool" entries are 2x2 max pools
LAYERS = (
    [(f"conv1_{i}", 3, 64, True) for i in (1, 2)]
    + ["pool"]
    + [(f"conv2_{i}", 3, 128, True) for i in (1, 2)]
    + ["pool"]
    + [(f"conv3_{i}", 3, 256, True) for i in (1, 2, 3, 4)]
    + ["pool"]
    + [(f"conv4_{i}", 3, 512, True) for i in (1, 2, 3, 4)]
    + [("conv5_1", 3, 512, True), ("conv5_2", 3, 128, True)]
    + [("conv6_1", 1, 512, True), ("conv6_2", 1, 2, False)]
)


def init(rng):
    """TF-layout numpy {layer: {"weights", "biases"}} tree (Xavier / 1e-4)."""
    params = {}
    in_chan = 3
    for layer in LAYERS:
        if layer == "pool":
            continue
        name, ksize, out_chan, _ = layer
        params[name] = nn.conv_init(rng, ksize, ksize, in_chan, out_chan)
        in_chan = out_chan
    return params


def apply(params, image, compute_dtype=None, constrain=None):
    """image [B, H, W, 3] -> list of one [B, H, W, 2] segmentation scoremap.
    ``compute_dtype``: the convs' (``ops.nn.conv2d``). ``constrain``: the
    spatial-partitioning hook (``parallel.spatial_constrainer``), applied
    after each conv block as in the JAX package; the scoremap is whole
    again before the upsampling."""
    _, h, w, _ = image.shape
    x = image.permute(0, 3, 1, 2).contiguous()
    with spatial.region(constrain):
        for layer in LAYERS:
            if layer == "pool":
                x = nn.max_pool_2x2(x)
                continue
            name, _, _, relu = layer
            x = nn.conv2d(x, params[name], compute_dtype=compute_dtype)
            if relu:
                x = nn.leaky_relu(x)
            if constrain is not None:
                x = constrain(x)
        x = spatial.whole(x)
    return [resize_bilinear(x.permute(0, 2, 3, 1), (h, w))]
