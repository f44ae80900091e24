"""Plain PyTorch reference of the ColorHandPose3D cascade (f32 inference).

Written from the published networks and the reference TF code of
lmb-freiburg/hand3d (``nets/ColorHandPose3DNetwork.py``,
``nets/PosePriorNetwork.py``, ``utils/general.py``), with the benchmark's
frozen layer tables. It imports nothing of the program and takes nothing the
program made: the weights are the benchmark's TF-layout arrays and the
frames its uint8 pool. Images are NHWC at the interfaces, NCHW inside the
networks. Departures from the TF code, none of which changes a value:
separable max pools for the flood fill's 21x21 window, and a flood fill that
stops at its fixed point (extra passes change nothing).
"""

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.flops import layers

CROP = layers.CROP
SLOPE = 0.01  # leaky ReLU, general.py:28


def set_tf32(on):
    """TF32 in cuDNN and cuBLAS: off for the reference, on for its control."""
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def to_torch(tree, device):
    """TF-layout numpy tree -> {scope: {layer: (weight, bias)}} on
    ``device``, conv kernels OIHW, dense kernels [in, out]."""
    out = {}
    for scope, sub in tree.items():
        out[scope] = {}
        for name, leaf in sub.items():
            w = np.asarray(leaf["weights"], np.float32)
            if w.ndim == 4:
                w = w.transpose(3, 2, 0, 1)
            out[scope][name] = (torch.tensor(w, device=device),
                                torch.tensor(np.asarray(leaf["biases"],
                                                        np.float32),
                                             device=device))
    return out


def lrelu(x):
    return torch.maximum(x, SLOPE * x)


def _same(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, wb, stride=1):
    """TF-SAME convolution + bias of NCHW ``x``: the padding is the conv's
    own where it is even, else applied first (the odd pixel after)."""
    w, b = wb
    pt, pb = _same(x.shape[2], w.shape[2], stride)
    pl, pr = _same(x.shape[3], w.shape[3], stride)
    if pt == pb and pl == pr:
        return F.conv2d(x, w, b, stride=stride, padding=(pt, pl))
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, b, stride=stride)


def resize(x, out_hw):
    """TF1 bilinear resize of NHWC ``x`` (asymmetric grid src = dst * in /
    out, edge clamp), rows then cols."""
    for axis, n_out in ((1, out_hw[0]), (2, out_hw[1])):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        src = np.arange(n_out) * (n_in / n_out)
        lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
        hi = np.minimum(lo + 1, n_in - 1)
        shape = [1] * x.ndim
        shape[axis] = n_out
        wt = torch.tensor((src - lo).astype(np.float32),
                          device=x.device).reshape(shape)
        lo = torch.tensor(lo, device=x.device)
        hi = torch.tensor(hi, device=x.device)
        x = x.index_select(axis, lo) * (1.0 - wt) + x.index_select(axis, hi) * wt
    return x


def handsegnet(p, image):
    """[B, H, W, 3] mean-subtracted -> [B, H, W, 2] logits."""
    h, w = image.shape[1:3]
    x = image.permute(0, 3, 1, 2)
    for entry in layers.HANDSEGNET:
        if entry == "pool":
            x = F.max_pool2d(x, 2, 2)
            continue
        name, _, _, relu = entry
        x = conv(x, p[name])
        if relu:
            x = lrelu(x)
    return resize(x.permute(0, 2, 3, 1), (h, w))


def posenet(p, crop):
    """[B, 256, 256, 3] -> PoseNet's three [B, 32, 32, 21] scoremaps."""
    x = crop.permute(0, 3, 1, 2)
    for entry in layers.POSENET_ENCODER:
        if entry == "pool":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = lrelu(conv(x, p[entry[0]]))
    encoding = x
    maps = [conv(lrelu(conv(encoding, p["conv5_1"])), p["conv5_2"])]
    for unit in range(layers.REFINEMENT_UNITS):
        x = torch.cat([maps[-1], encoding], 1)
        specs = layers.refinement(unit)
        for i, (name, _, _) in enumerate(specs):
            x = conv(x, p[name])
            if i < len(specs) - 1:
                x = lrelu(x)
        maps.append(x)
    return [m.permute(0, 2, 3, 1) for m in maps]


def _tower(p, scoremap, hand_side, chans):
    x = scoremap.permute(0, 3, 1, 2)
    prefix = layers.tower_prefix(chans)
    for i in range(len(chans)):
        x = lrelu(conv(x, p[f"{prefix}_{i}_1"]))
        x = lrelu(conv(x, p[f"{prefix}_{i}_2"], stride=2))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return torch.cat([x, hand_side], 1)


def dense(x, wb):
    return x @ wb[0] + wb[1]


def lift(pp, vp, scoremap, hand_side):
    """PosePrior + ViewpointNet on the [B, 32, 32, 21] scoremap ->
    root-relative normalized [B, 21, 3] (ColorHandPose3DNetwork.py:221-245,
    _get_rot_mat :311-334)."""
    x = _tower(pp, scoremap, hand_side, layers.POSE_CHANS)
    x = lrelu(dense(x, pp["fc_rel0"]))
    x = lrelu(dense(x, pp["fc_rel1"]))
    can = dense(x, pp["fc_xyz"]).reshape(-1, layers.NUM_KP, 3)
    v = _tower(vp, scoremap, hand_side, layers.VP_CHANS)
    v = lrelu(dense(v, vp["fc_vp0"]))
    v = lrelu(dense(v, vp["fc_vp1"]))
    ux, uy, uz = (dense(v, vp[k])[:, 0] for k in
                  ("fc_vp_ux", "fc_vp_uy", "fc_vp_uz"))
    theta = torch.sqrt(ux * ux + uy * uy + uz * uz + 1e-8)
    st, ct = torch.sin(theta), torch.cos(theta)
    one = 1.0 - ct
    x_, y_, z_ = ux / theta, uy / theta, uz / theta
    rot = torch.stack([
        torch.stack([ct + x_ * x_ * one, x_ * y_ * one - z_ * st,
                     x_ * z_ * one + y_ * st], -1),
        torch.stack([y_ * x_ * one + z_ * st, ct + y_ * y_ * one,
                     y_ * z_ * one - x_ * st], -1),
        torch.stack([z_ * x_ * one - y_ * st, z_ * y_ * one + x_ * st,
                     ct + z_ * z_ * one], -1)], -2)
    right = hand_side.argmax(1) == 1
    sign = torch.tensor([1.0, 1.0, -1.0], device=can.device)
    can = torch.where(right[:, None, None], can * sign, can)
    return can @ rot


# --- the glue ---------------------------------------------------------------


def foreground(logits):
    """(fg probability [B, H, W], binary map, seed [B, 2] (row, col) at the
    first argmax of fg), general.py:233-268."""
    fg = torch.softmax(logits, -1)[..., 1]
    b, _, w = fg.shape
    idx = fg.reshape(b, -1).argmax(1)
    return fg, torch.round(fg), torch.stack([idx // w, idx % w], -1)


def flood(det, seed, max_passes):
    """The blob of ``det`` [B, H, W] {0, 1} that holds ``seed``: grow the
    seed pixel by a 21x21 max pool masked by det, to the fixed point or
    ``max_passes``. Returns (mask, passes each image took)."""
    b, h, w = det.shape
    rows = torch.arange(h, device=det.device)[None, :, None]
    cols = torch.arange(w, device=det.device)[None, None, :]
    obj = ((rows == seed[:, 0, None, None])
           & (cols == seed[:, 1, None, None])).to(torch.float32)
    half = layers.DILATION // 2
    active = torch.ones(b, dtype=torch.bool, device=det.device)
    passes = torch.zeros(b, dtype=torch.int64, device=det.device)
    for _ in range(max_passes):
        passes += active
        grown = F.max_pool2d(obj[:, None], (layers.DILATION, 1), 1, (half, 0))
        grown = F.max_pool2d(grown, (1, layers.DILATION), 1, (0, half))
        new = det * grown[:, 0]
        active &= (new != obj).flatten(1).any(1)
        obj = new
        if not active.any():
            break
    return obj, passes


def bbox(mask):
    """(row min, row max, col min, col max) [B] of each mask; +-inf where a
    mask is empty."""
    b, h, w = mask.shape
    on = mask > 0.5
    rows = torch.arange(h, dtype=torch.float32, device=mask.device)
    cols = torch.arange(w, dtype=torch.float32, device=mask.device)
    inf = torch.tensor(float("inf"), device=mask.device)
    r = torch.where(on, rows[None, :, None], inf)
    c = torch.where(on, cols[None, None, :], inf)
    r2 = torch.where(on, rows[None, :, None], -inf)
    c2 = torch.where(on, cols[None, None, :], -inf)
    return (r.amin((1, 2)), r2.amax((1, 2)), c.amin((1, 2)), c2.amax((1, 2)))


def box_of(mask):
    """center [B, 2] (row, col) and scale_crop [B] of the blob masks, with
    the empty-mask fallbacks (general.py:271-328,
    ColorHandPose3DNetwork.py:81-86)."""
    r0, r1, c0, c1 = bbox(mask)
    center = torch.stack([0.5 * (r0 + r1), 0.5 * (c0 + c1)], 1)
    ok = torch.isfinite(center).all(1, keepdim=True)
    center = torch.where(ok, center, torch.full_like(center, 160.0))
    size = torch.maximum(r1 - r0, c1 - c0)
    size = torch.where(torch.isfinite(size), size, torch.full_like(size, 100.0))
    return center, scale_of(size)


def scale_of(size):
    return torch.clamp(CROP / (size * 1.25), 0.25, 5.0)


def crop(image, center, scale, size=CROP):
    """crop_image_from_xy (general.py:163-196) with tf.image.crop_and_resize's
    sampling and zero extrapolation: [B, size, size, C]."""
    _, h, w, _ = image.shape
    scaled = float(size) / scale
    half = torch.floor(scaled / 2.0)
    y1, x1 = center[:, 0] - half, center[:, 1] - half
    # the normalized box of tf.image.crop_and_resize
    by1, bx1, by2, bx2 = y1 / h, x1 / w, (y1 + scaled) / h, (x1 + scaled) / w
    i = torch.arange(size, dtype=torch.float32, device=image.device)

    def grid(lo, hi, n):
        step = (hi - lo) * (n - 1) / (size - 1)
        return lo[:, None] * (n - 1) + i[None, :] * step[:, None]

    def sample(x, axis, pos, n):
        lo_f = torch.floor(pos)
        frac = pos - lo_f
        valid = (pos >= 0.0) & (pos <= n - 1.0)
        shape = [x.shape[0]] + [1] * (x.ndim - 1)
        shape[axis] = size
        expand = list(x.shape)
        expand[axis] = size

        def take(idx):
            idx = idx.clamp(0, n - 1).long().reshape(shape).expand(expand)
            return torch.gather(x, axis, idx)

        out = (take(lo_f) * (1.0 - frac.reshape(shape))
               + take(lo_f + 1.0) * frac.reshape(shape))
        return torch.where(valid.reshape(shape), out, torch.zeros_like(out))

    out = sample(image, 1, grid(by1, by2, h), h)
    return sample(out, 2, grid(bx1, bx2, w), w)


def decode(scoremap, center, scale):
    """Argmax of each keypoint's 8x TF1-upsampled map -> global (u, v)
    [B, 21, 2] (general.py:331-357)."""
    up = resize(scoremap, (CROP, CROP))
    b, h, w, k = up.shape
    idx = up.reshape(b, h * w, k).argmax(1)
    rc = torch.stack([idx // w, idx % w], -1).to(torch.float32)
    rc = (rc - CROP // 2) / scale[:, None, None] + center[:, None, :]
    return rc.flip(-1)


def normalize(frames_u8, device):
    return torch.from_numpy(np.asarray(frames_u8)).to(device) \
        .to(torch.float32) / 255.0 - 0.5


def infer(p, frames_u8, device):
    """The whole cascade on uint8 frames, a left hand: the served outputs as
    numpy, plus the flood fill's passes per frame."""
    image = normalize(frames_u8, device)
    b, h, w, _ = image.shape
    logits = handsegnet(p["HandSegNet"], image)
    _, det, seed = foreground(logits)
    mask, passes = flood(det, seed, max(h, w) // (layers.DILATION // 2))
    center, scale = box_of(mask)
    sm = posenet(p["PoseNet2D"], crop(image, center, scale))[-1]
    side = torch.tensor([[1.0, 0.0]], device=device).expand(b, 2)
    coord3d = lift(p["PosePrior"], p["ViewpointNet"], sm, side)
    uv = decode(sm, center, scale)
    out = {"hand_scoremap": logits, "center": center,
           "scale_crop": scale[:, None], "keypoint_uv21": uv,
           "keypoint_coord3d": coord3d, "passes": passes}
    return {k: v.cpu().numpy() for k, v in out.items()}
