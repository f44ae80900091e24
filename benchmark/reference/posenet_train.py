"""Plain PyTorch reference of the PoseNet training step of
``training_posenet.py`` (lmb-freiburg/hand3d): ground-truth crops of RHD
records with coord-uv and crop-center noise (data/BinaryDbReader.py:126-367),
PoseNet forward, the visibility-masked scoremap loss over the three heads
(training_posenet.py:57-61), its gradients and Adam (b1 0.9, b2 0.999, eps
1e-8) at LR 1e-4.

It imports nothing of the program. The records are the benchmark's raw
file; the weights its TF-layout arrays. Which records a step reads and what
noise it adds follow the training job's published rules, restated here:

* epoch e shuffles the record indices with ``numpy.random.RandomState(seed +
  e)``; under data parallelism over n ranks rank r takes the strided slice
  ``perm[r::n][:N // n]``, its batches in order, and a step's global batch
  is the ranks' batches in rank order;
* step i draws its noise from a CPU ``torch.Generator`` seeded through
  ``numpy.random.SeedSequence([3, 1, seed, i])`` (the count of words, the
  train step's stream 1, the seed, the step): first the uv noise [B, 42, 2],
  then the crop-center noise [B, 2], each ``torch.nn.init.trunc_normal_``
  at (0, 1) cut at +-2, times 2.5 and 20 px, for the global batch.
"""

import numpy as np
import torch

from benchmark.flops import layers
from benchmark.reference import cascade

B1, B2, EPS = 0.9, 0.999, 1e-8
LR = 1e-4  # the schedule's first value, held to step 10000
SIGMA = 25.0
UV_NOISE, CENTER_NOISE = 2.5, 20.0
IMAGE = 320


def step_generator(seed, step):
    hi, lo = np.random.SeedSequence([3, 1, int(seed), int(step)]) \
        .generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(hi) << 32 | int(lo))


def noise(seed, step, batch):
    g = step_generator(seed, step)

    def trunc(shape, std):
        out = torch.empty(shape)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=g)
        return out * std

    return trunc((batch, 42, 2), UV_NOISE), trunc((batch, 2), CENTER_NOISE)


def step_rows(seed, step, n_records, batch, ranks=1):
    """Record indices of step ``step``'s global batch (``batch`` a rank)."""
    shard = n_records // ranks
    spe = shard // batch
    epoch, pos = divmod(step, spe)
    perm = np.arange(n_records)
    np.random.RandomState(seed + epoch).shuffle(perm)
    rows = []
    for r in range(ranks):
        mine = perm[r::ranks][:shard] if ranks > 1 else perm
        rows.append(mine[:spe * batch].reshape(spe, batch)[pos])
    return np.concatenate(rows)


def gaussian_maps(coords_hw, size, vis):
    """exp(-d^2 / sigma^2) about each keypoint truncated to integer pixels;
    zero for keypoints not strictly inside or not visible."""
    ci = coords_hw.to(torch.int32)
    ok = ((ci[..., 0] < size - 1) & (ci[..., 0] > 0)
          & (ci[..., 1] < size - 1) & (ci[..., 1] > 0) & vis)
    cf = ci.to(torch.float32)
    r = torch.arange(size, dtype=torch.float32,
                     device=coords_hw.device)[None, :, None, None]
    c = torch.arange(size, dtype=torch.float32,
                     device=coords_hw.device)[None, None, :, None]
    d2 = (r - cf[:, None, None, :, 0]) ** 2 + (c - cf[:, None, None, :, 1]) ** 2
    return torch.exp(-d2 / SIGMA ** 2) * ok[:, None, None, :].to(torch.float32)


def features(rec, uv_noise, center_noise, device, crop_size=layers.CROP):
    """Raw records (a structured numpy array) and their noise -> (image crop
    [B, S, S, 3], ground-truth scoremaps [B, S, S, 21], visibility [B, 21])."""
    t = {k: torch.from_numpy(np.ascontiguousarray(rec[k])).to(device)
         for k in ("kp_uv", "image", "hand_parts", "kp_vis")}
    uv = t["kp_uv"].to(torch.int32).to(torch.float32)
    vis = t["kp_vis"].to(torch.bool)
    # the palm replaces the wrist: the midpoint of keypoints 0 and 12
    uv = torch.cat([0.5 * (uv[:, 0] + uv[:, 12])[:, None], uv[:, 1:21],
                    0.5 * (uv[:, 21] + uv[:, 33])[:, None], uv[:, 22:]], 1)
    vis = torch.cat([(vis[:, 0] | vis[:, 12])[:, None], vis[:, 1:21],
                     (vis[:, 21] | vis[:, 33])[:, None], vis[:, 22:]], 1)
    uv = uv + uv_noise.to(device)
    image = t["image"].to(torch.float32) / 255.0 - 0.5
    parts = t["hand_parts"].to(torch.int32)
    left = ((parts > 1) & (parts < 18)).sum((1, 2)) > (parts > 17).sum((1, 2))
    uv21 = torch.where(left[:, None, None], uv[:, :21], uv[:, 21:])
    vis21 = torch.where(left[:, None], vis[:, :21], vis[:, 21:])

    center = uv21[:, 12].flip(-1)
    center = torch.where(torch.isfinite(center).all(-1, keepdim=True), center,
                         torch.zeros_like(center))
    center = center + center_noise.to(device)
    hw = uv21.flip(-1)
    inf = torch.tensor(float("inf"), device=device)
    lo = torch.where(vis21[..., None], hw, inf).amin(1).clamp_min(0.0)
    hi = torch.minimum(torch.where(vis21[..., None], hw, -inf).amax(1),
                       torch.tensor([float(IMAGE), float(IMAGE)],
                                    device=device))
    best = 2.0 * torch.maximum(hi - center, center - lo).amax(-1)
    best = best.clamp(50.0, 500.0)
    best = torch.where(torch.isfinite(best), best, torch.full_like(best, 200.0))
    scale = torch.clamp(crop_size / best, 1.0, 10.0)
    crop = cascade.crop(image, center, scale, crop_size)
    half = crop_size // 2
    u = (uv21[..., 0] - center[:, None, 1]) * scale[:, None] + half
    v = (uv21[..., 1] - center[:, None, 0]) * scale[:, None] + half
    maps = gaussian_maps(torch.stack([v, u], -1), crop_size, vis21)
    return crop, maps, vis21.to(torch.float32)


def loss_numerator(p, crop, maps, vis):
    """Sum over heads, samples and keypoints of vis * sqrt(mean over pixels
    of (upsampled prediction - ground truth)^2)."""
    total = 0.0
    for pred in cascade.posenet(p, crop):
        up = cascade.resize(pred, maps.shape[1:3])
        per_kp = torch.sqrt(torch.mean((up - maps) ** 2, dim=(1, 2)))
        total = total + (vis * per_kp).sum()
    return total


def run(tree, records, seed, batch, ranks, steps, device, block=8,
        crop_size=layers.CROP, tf32=False, fault=None, delta_at=None):
    """``steps`` training steps of the reference from the TF-layout PoseNet
    weights ``tree`` on ``records`` (the whole raw array), ``batch`` rows a
    rank over ``ranks`` ranks. Returns {"loss": [steps], "grad0": {leaf:
    norm of step 0's gradient}, "delta": {leaf: norm of the change after
    ``delta_at`` steps (all of them by default)}}. Each step runs in blocks
    of ``block`` rows; the loss's denominator is the global batch's.

    ``tf32`` runs it in TF32 (the control). ``fault`` plants a fault of the
    program for the readings that set the limits: "half" leaves out the
    second half of every batch and takes the loss over the rest;
    "no_exchange" keeps rank 0's share of the loss and gradients, as a rank
    whose gradient all-reduce is left out holds; "unchanged" leaves the
    state as it was at every step after the first ``delta_at``."""
    delta_at = steps if delta_at is None else delta_at
    cascade.set_tf32(tf32)
    block = min(block, batch)
    torch_tree = cascade.to_torch(tree, device)["PoseNet2D"]
    names, leaves = [], []
    for layer in sorted(torch_tree):
        w, b = torch_tree[layer]
        for key, t in (("biases", b), ("weights", w)):
            names.append(f"PoseNet2D/{layer}/{key}")
            leaves.append(t.requires_grad_(True))
    start = [t.detach().clone() for t in leaves]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    p = {layer: (leaves[2 * i + 1], leaves[2 * i])
         for i, layer in enumerate(sorted(torch_tree))}
    losses, grad0, delta = [], None, None
    for i in range(steps):
        rows = step_rows(seed, i, len(records), batch, ranks)
        uv_n, c_n = noise(seed, i, len(rows))
        counted = len(rows) // 2 if fault == "half" else len(rows)
        summed = batch if fault == "no_exchange" else counted
        grads = [torch.zeros_like(t) for t in leaves]
        numer, count = 0.0, 0.0
        parts = []
        for a in range(0, counted, block):
            sl = slice(a, min(a + block, counted))
            parts.append(features(records[rows[sl]], uv_n[sl], c_n[sl],
                                  device, crop_size))
            count += float(parts[-1][2].sum())
        denom = count + 0.001
        for a, (crop, maps, vis) in zip(range(0, counted, block), parts):
            if a >= summed:
                break
            part = loss_numerator(p, crop, maps, vis) / denom
            g = torch.autograd.grad(part, leaves)
            for acc, gi in zip(grads, g):
                acc.add_(gi)
            numer += float(part.detach())
        losses.append(numer)
        if grad0 is None:
            grad0 = {n: float(g.norm()) for n, g in zip(names, grads)}
        t = i + 1
        if fault == "unchanged" and i >= delta_at:
            continue
        with torch.no_grad():
            for leaf, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(B1).add_(g, alpha=1 - B1)
                vi.mul_(B2).addcmul_(g, g, value=1 - B2)
                denom_t = (vi / (1 - B2 ** t)).sqrt_().add_(EPS)
                leaf.addcdiv_(mi, denom_t, value=-LR / (1 - B1 ** t))
        if t == delta_at:
            delta = {n: float((t.detach() - s).norm())
                     for n, t, s in zip(names, leaves, start)}
    return {"loss": losses, "grad0": grad0, "delta": delta}
