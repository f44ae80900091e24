"""The comparison that decides ``correct`` for the served cascade.

For a sample of served frames the plain reference (``cascade.py``) works out
every stage again from the frame and the benchmark's weights, and reads the
program's answers only to judge them. The cascade makes discrete choices (a
binary mask, a seed, argmax keypoints) from float scoremaps, so two correct
f32 runs may choose differently wherever a choice is a near-tie. Each
number is therefore a gap that a near-tie keeps small:

  seg_err   max |hand_scoremap - reference| over the sample, over the
            sample's max |reference| (served by the offline cell only);
  pose_gap  the largest over the sample of three gaps of the served pose:
            box_tau, per frame the smallest logit margin tau (over the
            frame's largest |l1 - l0|) such that the served box (center and
            scale_crop) is the box of some blob between the reference's blob
            with every pixel of margin under tau dropped and the one with
            every such pixel added (0 where the boxes are equal);
            uv_gap, from the served box on (the reference crops at the
            served center and scale_crop), the gap by which the reference's
            upsampled PoseNet scoremap at each served keypoint lies below
            its maximum, over that map's range; and coord3d_err,
            max |keypoint_coord3d - reference| (from the served box) over
            the sample's max |reference|.

The three parts of pose_gap are one number because the box is judged by
them together: a wrong box shows in box_tau alone, and the TF32 control
moves a box rarely but every keypoint map and 3D pose.
"""

import numpy as np
import torch

from benchmark.flops import layers
from benchmark.reference import cascade as ref

# tau grid: 0, then quarter decades from 1e-12 to 1 of the frame's largest
# logit margin
TAUS = np.concatenate([[0.0], 10.0 ** (-12.0 + np.arange(49) / 4.0)])
CENTER_TOL = 1e-3  # px: center is half a sum of integer rows
SCALE_TOL = 1e-5  # relative: scale_crop is one f32 division and a clamp
UNEXPLAINED = 2.0  # box_tau of a box no blob between the bounds gives


def _box_explained(got_center, got_scale, lo, hi):
    """Whether the served boxes lie between the boxes of the blobs ``lo``
    and ``hi`` [B, H, W] (lo within hi), or are the empty-mask fallback
    where ``lo`` may be empty."""
    lr0, lr1, lc0, lc1 = ref.bbox(lo)
    hr0, hr1, hc0, hc1 = ref.bbox(hi)
    lo_empty = ~torch.isfinite(lr0)
    hi_empty = ~torch.isfinite(hr0)

    def span(l0, l1, h0, h1):
        low = 0.5 * (h0 + torch.maximum(l1, h0))
        high = 0.5 * (torch.minimum(l0, h1) + h1)
        return low, high

    r_lo, r_hi = span(lr0, lr1, hr0, hr1)
    c_lo, c_hi = span(lc0, lc1, hc0, hc1)
    zero = torch.zeros_like(lr0)
    size_lo = torch.where(lo_empty, zero, torch.maximum(lr1 - lr0, lc1 - lc0))
    size_hi = torch.maximum(hr1 - hr0, hc1 - hc0)
    s_lo = ref.scale_of(size_hi) * (1 - SCALE_TOL)
    s_hi = torch.where(size_lo > 0, ref.scale_of(size_lo),
                       torch.full_like(size_lo, 5.0)) * (1 + SCALE_TOL)
    cr, cc = got_center[:, 0], got_center[:, 1]
    inside = ((cr >= r_lo - CENTER_TOL) & (cr <= r_hi + CENTER_TOL)
              & (cc >= c_lo - CENTER_TOL) & (cc <= c_hi + CENTER_TOL)
              & (got_scale >= s_lo) & (got_scale <= s_hi) & ~hi_empty)
    fallback = ((cr - 160.0).abs() <= CENTER_TOL)
    fallback &= (cc - 160.0).abs() <= CENTER_TOL
    fallback &= (got_scale - ref.scale_of(torch.full_like(got_scale, 100.0))
                 ).abs() <= SCALE_TOL * got_scale
    return inside | (lo_empty & fallback)


def box_taus(logits, got_center, got_scale):
    """box_tau of each frame (see the module docstring) and the passes the
    reference's own flood fill took."""
    b, h, w, _ = logits.shape
    max_passes = max(h, w) // (layers.DILATION // 2)
    _, det, seed = ref.foreground(logits)
    margin = (logits[..., 1] - logits[..., 0]).abs()
    scale = margin.flatten(1).amax(1).clamp_min(1e-30)
    own, passes = ref.flood(det, seed, max_passes)

    def explained(tau_idx):
        tau = torch.as_tensor(TAUS, device=logits.device,
                              dtype=torch.float32)[tau_idx] * scale
        sure = margin >= tau[:, None, None]
        lo, _ = ref.flood(det * sure, seed, max_passes)
        hi, _ = ref.flood(torch.maximum(det, (~sure).to(det.dtype)), seed,
                          max_passes)
        return _box_explained(got_center, got_scale, lo, hi)

    tau = torch.full((b,), UNEXPLAINED, device=logits.device)
    exact = _box_explained(got_center, got_scale, own, own)
    tau[exact] = 0.0
    todo = ~exact
    if todo.any():
        # binary search of the grid for the frames whose box differs
        lo_i = torch.ones(b, dtype=torch.long, device=logits.device)
        hi_i = torch.full((b,), len(TAUS), dtype=torch.long,
                          device=logits.device)
        while bool(((lo_i < hi_i) & todo).any()):
            mid = torch.clamp((lo_i + hi_i) // 2, max=len(TAUS) - 1)
            ok = explained(mid)
            hi_i = torch.where(todo & ok & (lo_i < hi_i), mid, hi_i)
            lo_i = torch.where(todo & ~ok & (lo_i < hi_i), mid + 1, lo_i)
        found = todo & (hi_i < len(TAUS))
        grid = torch.as_tensor(TAUS, device=logits.device,
                               dtype=torch.float32)
        tau[found] = grid[hi_i[found].clamp(max=len(TAUS) - 1)]
    return tau, passes


def uv_gaps(scoremap, got_uv, got_center, got_scale):
    """[B, 21] gap of each served keypoint below the reference's maximum of
    the upsampled map, over the map's range (1 where it leaves the crop)."""
    up = ref.resize(scoremap, (ref.CROP, ref.CROP))
    b, h, w, k = up.shape
    flat = up.reshape(b, h * w, k)
    top, low = flat.amax(1), flat.amin(1)
    uv = got_uv.to(torch.float64)
    col = torch.round((uv[..., 0] - got_center[:, None, 1].double())
                      * got_scale[:, None].double() + ref.CROP // 2)
    row = torch.round((uv[..., 1] - got_center[:, None, 0].double())
                      * got_scale[:, None].double() + ref.CROP // 2)
    inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
    idx = (row.clamp(0, h - 1) * w + col.clamp(0, w - 1)).long()
    value = flat.gather(1, idx[:, None, :])[:, 0, :]
    gap = (top - value) / (top - low).clamp_min(1e-30)
    return torch.where(inside, gap, torch.ones_like(gap))


def judge(params, frames, got, device, block=16):
    """The numbers seg_err (only where ``got`` holds
    hand_scoremap) for uint8 ``frames`` [N, H, W, 3] and the program's
    served answers ``got`` (numpy, leading N); and the parts of pose_gap,
    with each frame's flood-fill passes and box_tau. ``params``:
    ``cascade.to_torch`` of the weights."""
    ref.set_tf32(False)
    n = len(frames)
    seg_diff, seg_top = 0.0, 0.0
    c3_diff, c3_top = 0.0, 0.0
    taus, gaps, passes = [], [], []
    side = torch.tensor([[1.0, 0.0]], device=device)

    def served(key, sl):
        return torch.from_numpy(np.asarray(got[key][sl], np.float32)).to(device)

    with torch.no_grad():
        for a in range(0, n, block):
            sl = slice(a, min(n, a + block))
            image = ref.normalize(frames[sl], device)
            logits = ref.handsegnet(params["HandSegNet"], image)
            if "hand_scoremap" in got:
                seg_diff = max(seg_diff, float(
                    (served("hand_scoremap", sl) - logits).abs().max()))
                seg_top = max(seg_top, float(logits.abs().max()))
            center = served("center", sl)
            scale = served("scale_crop", sl).reshape(-1)
            tau, p = box_taus(logits, center, scale)
            taus.append(tau.cpu().numpy())
            passes.append(p.cpu().numpy())
            sm = ref.posenet(params["PoseNet2D"],
                             ref.crop(image, center, scale))[-1]
            c3 = ref.lift(params["PosePrior"], params["ViewpointNet"], sm,
                          side.expand(len(image), 2))
            c3_diff = max(c3_diff, float(
                (served("keypoint_coord3d", sl) - c3).abs().max()))
            c3_top = max(c3_top, float(c3.abs().max()))
            gaps.append(uv_gaps(sm, served("keypoint_uv21", sl), center,
                                scale).cpu().numpy())
    parts = {"box_tau": float(np.concatenate(taus).max()),
             "uv_gap": float(np.concatenate(gaps).max()),
             "coord3d_err": c3_diff / max(c3_top, 1e-30)}
    out = {"pose_gap": max(parts.values())}
    if "hand_scoremap" in got:
        out["seg_err"] = seg_diff / max(seg_top, 1e-30)
    return out, dict(parts, passes=np.concatenate(passes),
                     box_taus=np.concatenate(taus))


def report(parts, out):
    """The parts of pose_gap and how many boxes differ, on ``out``."""
    taus = parts["box_taus"]
    print(f"pose_gap parts: box_tau {parts['box_tau']!r} ({int((taus > 0).sum())}"
          f" of {len(taus)} boxes differ), uv_gap {parts['uv_gap']!r}, "
          f"coord3d_err {parts['coord3d_err']!r}", file=out)
