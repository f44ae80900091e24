"""What the benchmark makes from ``--seed`` and hands to both the program and
the reference: weights, camera frames and RHD training records.

Everything is drawn on the run's device by seeded ``torch.Generator``s, in a
few large calls, and copied to the host once: the program's loaders take
numpy trees, frames and record files. The same seed gives the same arrays on
the same device type.
"""

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.flops import layers

# one generator per kind of input, so that adding a kind changes no other
_WEIGHTS, _FRAMES, _RECORDS, _SAMPLE = range(4)

# the RHD record layout (create_binary_db.py:44-90 of lmb-freiburg/hand3d)
RHD_IMAGE = (320, 320)
RHD_RECORD = np.dtype([
    ("kp_xyz", "<f4", (42, 3)),
    ("kp_uv", "<f4", (42, 2)),
    ("cam_mat", "<f4", (3, 3)),
    ("pad", "u1", (2,)),
    ("image", "u1", (*RHD_IMAGE, 3)),
    ("hand_parts", "u1", RHD_IMAGE),
    ("kp_vis", "u1", (42,)),
])
assert RHD_RECORD.itemsize == 410520


def generator(seed, kind, device):
    """The generator of one kind of input of run ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + kind) % (1 << 63))
    return g


BIAS = 0.05  # biases uniform within +-BIAS


def make_weights(seed, device, scopes=("HandSegNet", "PoseNet2D", "PosePrior",
                                       "ViewpointNet")):
    """TF-layout numpy tree {scope: {layer: {"weights", "biases"}}} with the
    published names and shapes: kernels uniform within +-sqrt(6 / fan_in)
    (variance 2 / fan_in, which keeps activations in range through the leaky
    ReLUs), biases uniform within +-BIAS. One draw on ``device``."""
    shapes = layers.param_shapes(scopes)
    sizes = []
    for _, _, leaf, _ in shapes:
        sizes += [int(np.prod(leaf["weights"])), int(np.prod(leaf["biases"]))]
    g = generator(seed, _WEIGHTS, device)
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    limits = []
    for _, _, _, fan_in in shapes:
        limits += [float(np.sqrt(6.0 / fan_in)), BIAS]
    scale = torch.repeat_interleave(
        torch.tensor(limits, device=device),
        torch.tensor(sizes, device=device))
    host = (flat * scale).cpu().numpy()
    tree, off = {}, 0
    for scope, name, leaf, _ in shapes:
        layer = {}
        for key in ("weights", "biases"):
            n = int(np.prod(leaf[key]))
            layer[key] = host[off:off + n].reshape(leaf[key])
            off += n
        tree.setdefault(scope, {})[name] = layer
    return tree


def smooth_images(n, hw, g, device):
    """[n, h, w, 3] uint8 images: low-frequency colour fields with some
    pixel noise, so that a segmentation net makes blobs of them."""
    h, w = hw
    low = torch.rand((n, 3, max(2, h // 20), max(2, w // 20)), generator=g,
                     device=device)
    img = F.interpolate(low, size=(h, w), mode="bilinear",
                        align_corners=False)
    img = img + 0.15 * torch.rand((n, 3, h, w), generator=g, device=device)
    img = (img / 1.15 * 255.0).clamp_(0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous()


def make_frames(seed, n, hw, device):
    """The cell's pool of ``n`` camera frames, [n, h, w, 3] uint8 numpy."""
    return smooth_images(n, hw, generator(seed, _FRAMES, device),
                         device).cpu().numpy()


def sample_rows(seed, population, k):
    """``k`` distinct indices of ``population`` items, sorted, drawn from the
    seed (all of them when there are no more than ``k``)."""
    if population <= k:
        return np.arange(population)
    rng = np.random.default_rng([int(seed), _SAMPLE])
    return np.sort(rng.choice(population, size=k, replace=False))


def make_records(seed, n, device):
    """``n`` RHD training records as a structured numpy array: a hand of 21
    keypoints per side about a random centre (one side larger in the part
    mask), visibility at 0.8, smooth images, a pinhole camera."""
    g = generator(seed, _RECORDS, device)
    h, w = RHD_IMAGE
    rec = np.zeros(n, RHD_RECORD)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    centre = 80.0 + 160.0 * rand(n, 2, 1, 2)  # per hand, (u, v)
    uv = centre + (rand(n, 2, 21, 2) - 0.5) * 120.0
    rec["kp_uv"] = uv.reshape(n, 42, 2).clamp(1.0, 318.0).cpu().numpy()
    xyz = torch.cat([(rand(n, 42, 2) - 0.5) * 0.2,
                     0.4 + 0.2 * rand(n, 42, 1)], -1)
    rec["kp_xyz"] = xyz.cpu().numpy()
    focal = 250.0 + 100.0 * rand(n)
    cam = torch.zeros((n, 3, 3), device=device)
    cam[:, 0, 0], cam[:, 1, 1] = focal, focal
    cam[:, 0, 2], cam[:, 1, 2], cam[:, 2, 2] = 160.0, 160.0, 1.0
    rec["cam_mat"] = cam.cpu().numpy()
    rec["pad"] = 255
    rec["image"] = smooth_images(n, RHD_IMAGE, g, device).cpu().numpy()
    # parts: a square about the dominant hand's centre, a left-hand part id
    # (2..17) or a right-hand one (18..33)
    left = rand(n) < 0.5
    ctr = torch.where(left[:, None], centre[:, 0, 0], centre[:, 1, 0])
    half = 20.0 + 40.0 * rand(n)
    rows = torch.arange(h, device=device, dtype=torch.float32)
    cols = torch.arange(w, device=device, dtype=torch.float32)
    inside = (((rows[None, :, None] - ctr[:, 1, None, None]).abs()
               < half[:, None, None])
              & ((cols[None, None, :] - ctr[:, 0, None, None]).abs()
                 < half[:, None, None]))
    part = torch.where(left, 5, 22).to(torch.uint8)
    rec["hand_parts"] = (inside.to(torch.uint8) * part[:, None, None]) \
        .cpu().numpy()
    rec["kp_vis"] = (rand(n, 42) < 0.8).to(torch.uint8).cpu().numpy()
    return rec
