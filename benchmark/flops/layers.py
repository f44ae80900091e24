"""Frozen layer tables of ColorHandPose3D and the operation and byte counts
the benchmark divides by.

The tables restate the published networks (Zimmermann & Brox, ICCV 2017,
lmb-freiburg/hand3d ``nets/ColorHandPose3DNetwork.py`` and
``nets/PosePriorNetwork.py``): layer names, kernels and widths. They are
kept here, apart from the program, so that the yardstick does not move when
the program does. FLOPs are the direct convolution's, 2 h w k^2 cin cout a
frame at the layer's output resolution.
"""

CROP = 256
NUM_KP = 21
SCOREMAP = 32  # PoseNet's output resolution at a 256 crop, the priors' input

# HandSegNet: (name, kernel, out channels, leaky ReLU after), "pool" a 2x2 pool
HANDSEGNET = (
    [(f"conv1_{i}", 3, 64, True) for i in (1, 2)] + ["pool"]
    + [(f"conv2_{i}", 3, 128, True) for i in (1, 2)] + ["pool"]
    + [(f"conv3_{i}", 3, 256, True) for i in (1, 2, 3, 4)] + ["pool"]
    + [(f"conv4_{i}", 3, 512, True) for i in (1, 2, 3, 4)]
    + [("conv5_1", 3, 512, True), ("conv5_2", 3, 128, True)]
    + [("conv6_1", 1, 512, True), ("conv6_2", 1, 2, False)])

# PoseNet's encoder: (name, kernel, out channels), every conv with a ReLU
POSENET_ENCODER = (
    [(f"conv1_{i}", 3, 64) for i in (1, 2)] + ["pool"]
    + [(f"conv2_{i}", 3, 128) for i in (1, 2)] + ["pool"]
    + [(f"conv3_{i}", 3, 256) for i in (1, 2, 3, 4)] + ["pool"]
    + [(f"conv4_{i}", 3, 512) for i in (1, 2)]
    + [(f"conv4_{i}", 3, 256) for i in (3, 4, 5, 6)]
    + [("conv4_7", 3, 128)])
ENC_CHAN = 128
REFINEMENT_UNITS = 2


def refinement(unit):
    """(name, kernel, out channels) of refinement unit 0 or 1: five 7x7
    convs, a 1x1 and the 1x1 head; the head has no ReLU."""
    n = unit + 6
    return ([(f"conv{n}_{i}", 7, 128) for i in range(1, 6)]
            + [(f"conv{n}_6", 1, 128), (f"conv{n}_7", 1, NUM_KP)])


POSE_CHANS = (32, 64, 128)  # PosePrior's tower
VP_CHANS = (64, 128, 256)  # ViewpointNet's tower


def tower_prefix(chans):
    return "conv_pose" if chans == POSE_CHANS else "conv_vp"


# --- conv walks: (name, out h, out w, kernel, cin, cout, stride) ------------


def handsegnet_convs(h, w):
    cin = 3
    for entry in HANDSEGNET:
        if entry == "pool":
            h, w = h // 2, w // 2
            continue
        name, k, cout, _ = entry
        yield name, h, w, k, cin, cout, 1
        cin = cout


def posenet_convs(crop=CROP):
    h = w = crop
    cin = 3
    for entry in POSENET_ENCODER:
        if entry == "pool":
            h, w = h // 2, w // 2
            continue
        name, k, cout = entry
        yield name, h, w, k, cin, cout, 1
        cin = cout
    yield "conv5_1", h, w, 1, ENC_CHAN, 512, 1
    yield "conv5_2", h, w, 1, 512, NUM_KP, 1
    for unit in range(REFINEMENT_UNITS):
        cin = NUM_KP + ENC_CHAN
        for name, k, cout in refinement(unit):
            yield name, h, w, k, cin, cout, 1
            cin = cout


def prior_convs():
    """Both lifting towers: per width a stride-1 and a stride-2 3x3 conv."""
    for chans in (POSE_CHANS, VP_CHANS):
        prefix = tower_prefix(chans)
        h = w = SCOREMAP
        cin = NUM_KP
        for i, cout in enumerate(chans):
            yield f"{prefix}_{i}_1", h, w, 3, cin, cout, 1
            yield f"{prefix}_{i}_2", h // 2, w // 2, 3, cout, cout, 2
            h, w, cin = h // 2, w // 2, cout


def prior_dense():
    """(scope, name, in, out) of the lifting nets' fully connected layers."""
    pose_flat = (SCOREMAP // 8) ** 2 * POSE_CHANS[-1] + 2
    vp_flat = (SCOREMAP // 8) ** 2 * VP_CHANS[-1] + 2
    return [("PosePrior", "fc_rel0", pose_flat, 512),
            ("PosePrior", "fc_rel1", 512, 512),
            ("PosePrior", "fc_xyz", 512, NUM_KP * 3),
            ("ViewpointNet", "fc_vp0", vp_flat, 256),
            ("ViewpointNet", "fc_vp1", 256, 128),
            ("ViewpointNet", "fc_vp_ux", 128, 1),
            ("ViewpointNet", "fc_vp_uy", 128, 1),
            ("ViewpointNet", "fc_vp_uz", 128, 1)]


def conv_flops(convs):
    return sum(2.0 * h * w * k * k * cin * cout
               for _, h, w, k, cin, cout, _ in convs)


def cascade_flops(image_hw=(240, 320)):
    """{stage: FLOPs a frame} of the f32 cascade's convolutions."""
    return {"HandSegNet": conv_flops(handsegnet_convs(*image_hw)),
            "PoseNet": conv_flops(posenet_convs()),
            "Prior+Viewpoint": conv_flops(prior_convs())}


def frame_flops(image_hw=(240, 320)):
    """Conv FLOPs of one frame through the whole cascade."""
    return sum(cascade_flops(image_hw).values())


def posenet_train_flops(crop=CROP):
    """Conv FLOPs of one sample of a PoseNet training step: the forward, the
    input gradient and the weight gradient of every conv (each as many as
    the forward), less the first layer's input gradient, which nothing
    needs."""
    convs = list(posenet_convs(crop))
    first = conv_flops(convs[:1])
    return 3.0 * conv_flops(convs) - first


# --- the parameter tree (TF layout) -----------------------------------------


def param_shapes(scopes=("HandSegNet", "PoseNet2D", "PosePrior",
                         "ViewpointNet")):
    """[(scope, layer, {"weights": shape, "biases": shape}, fan_in)] of the
    TF-layout tree the port's loaders take: conv kernels HWIO, dense
    kernels [in, out]."""
    out = []

    def conv(scope, name, k, cin, cout):
        out.append((scope, name, {"weights": (k, k, cin, cout),
                                  "biases": (cout,)}, k * k * cin))

    if "HandSegNet" in scopes:
        for name, _, _, k, cin, cout, _ in handsegnet_convs(8, 8):
            conv("HandSegNet", name, k, cin, cout)
    if "PoseNet2D" in scopes:
        for name, _, _, k, cin, cout, _ in posenet_convs(8):
            conv("PoseNet2D", name, k, cin, cout)
    for name, _, _, k, cin, cout, _ in prior_convs():
        scope = "PosePrior" if name.startswith("conv_pose") else "ViewpointNet"
        if scope in scopes:
            conv(scope, name, k, cin, cout)
    for scope, name, n_in, n_out in prior_dense():
        if scope in scopes:
            out.append((scope, name, {"weights": (n_in, n_out),
                                      "biases": (n_out,)}, n_in))
    return out


# --- the two hand-written kernels -------------------------------------------
# The flood fill works on binary maps as 32-pixel words: per word and pass
# 43.125 integer operations (the 21-row OR tree 89 per 8 rows, the two +-10
# column reach trees 14 each, combine and mask 2, change test 2), plus 2 a
# pixel to pack and unpack; the detmap is read once and the mask written once
# (f32), the seeds read once. The decode does 6 operations a source value and
# upsampled offset; the scoremap is read once, the (row, col) pairs written
# once.

FLOOD_OPS_PER_WORD_PASS = 89 / 8 + 14 + 14 + 2 + 2
FLOOD_OPS_PER_PX = 2
DECODE_OPS_PER_VALUE = 6
DILATION = 21


def flood_cost(h, w, passes):
    """(int32 operations, bytes) of one flood fill of an h x w map that
    needs ``passes`` passes to reach its fixed point."""
    words = h * ((w + 31) // 32)
    return (FLOOD_OPS_PER_WORD_PASS * words * passes + FLOOD_OPS_PER_PX * h * w,
            2 * 4 * h * w + 8)


def decode_cost(batch, h=SCOREMAP, w=SCOREMAP, k=NUM_KP, factor=CROP // SCOREMAP):
    """(f32 operations, bytes) of one decode of a [batch, h, w, k] scoremap."""
    return (DECODE_OPS_PER_VALUE * factor * factor * batch * h * w * k,
            4 * batch * h * w * k + 4 * batch * k * 2)
