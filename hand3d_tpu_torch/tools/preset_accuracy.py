"""Drift of the speed presets from the f32 cascade (counterpart of
tools/preset_accuracy.py).

The f32 cascade (reference parity) and each preset run on the same synthetic
RHD frames with the same weights, and each preset's outputs are held to the
f32 ones:

  * crop box: center drift (px) and relative crop-scale drift (the failure
    mode of ``seg_scale``, which changes localization alone);
  * 2D keypoints: uv EPE against the f32 cascade (px, global frame);
  * 3D: coord3d drift (canonical units, middle-MCP bone = 1);
  * PoseNet's scoremap: relative L2 per image (immune to argmax ties).

Rows: ``seg_scale=0.5``, ``bf16``, ``int8`` (dynamic activation scales),
``int8_static`` (static scales calibrated on the first half of the
batches), ``int8_seg`` (HandSegNet alone) and ``int8_seg_refiners``
(HandSegNet and PoseNet's refinement units conv6 / conv7). The JAX tool's
``int8_seg_pp`` and ``phase_pack`` rows are left out: phase packing is out
of scope for the port.

Weights: the snapshots that ``overfit_check --keep DIR`` leaves
(``--overfit-dir DIR``; nets that localize the synthetic hands), or
seeded random ones (``--random-init``), a weak oracle for localization.

    python -m hand3d_tpu_torch.tools.overfit_check --keep /tmp/of
    python -m hand3d_tpu_torch.tools.preset_accuracy --overfit-dir /tmp/of \
        --write-doc presets.md
    python -m hand3d_tpu_torch.tools.preset_accuracy --random-init \
        --device cpu --images 4 --batch 2                   # plumbing

The last line of standard output is one JSON summary.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

LEFT_OUT = {"int8_seg_pp": "phase_pack is out of scope for the port "
                           "(ROADMAP.md)",
            "phase_pack": "phase_pack is out of scope for the port "
                          "(ROADMAP.md)"}


def load_overfit_params(overfit_dir):
    """Seeded random params with every scope that an ``overfit_check
    --keep`` snapshot holds taken from the newest snapshot of its
    ``snap_*`` dir (seg -> HandSegNet, pose -> PoseNet2D, lifting ->
    PosePrior and ViewpointNet); TF-layout numpy."""
    from hand3d_tpu_torch.train.checkpoints import (latest_snapshot,
                                                    load_snapshot_params)
    from hand3d_tpu_torch.weights import random_params

    params = random_params(0)
    found = set()
    for sub in sorted(os.listdir(overfit_dir)):
        path = os.path.join(overfit_dir, sub)
        if not (sub.startswith("snap") and os.path.isdir(path)):
            continue
        snap = latest_snapshot(path)
        if snap is None:
            continue
        for scope, tree in load_snapshot_params(snap).items():
            if scope in params:
                params[scope] = tree
                found.add(scope)
    if not found:
        raise SystemExit(f"no snapshots under {overfit_dir}: run "
                         "hand3d_tpu_torch.tools.overfit_check --keep first")
    print(f"overfit weights loaded for scopes: {sorted(found)}",
          file=sys.stderr)
    return params


def fixture_batches(n_images, batch):
    """``n_images`` synthetic RHD frames (several seeds, alternating the
    dominant hand), mean-subtracted float32, in whole batches."""
    from hand3d_tpu_torch.data.rhd import RHDDataset
    from hand3d_tpu_torch.data.synthetic import make_rhd_bin

    images = []
    with tempfile.TemporaryDirectory() as d:
        seed = 0
        while sum(len(x) for x in images) < n_images:
            path = os.path.join(d, f"rhd_{seed}.bin")
            make_rhd_bin(path, num_records=min(16, n_images), seed=seed,
                         dominant="left" if seed % 2 == 0 else "right")
            ds = RHDDataset("evaluation", path=path)
            raw = ds.raw_batch(np.arange(len(ds)))
            images.append(raw["image"].astype(np.float32) / 255.0 - 0.5)
            seed += 1
    images = np.concatenate(images)[:n_images]
    return [images[i:i + batch] for i in range(0, n_images, batch)
            if len(images[i:i + batch]) == batch]


def run_cascade(net, params, batches, hand_side):
    """The outputs the drift metrics read, over every batch, as numpy."""
    outs = []
    with torch.inference_mode():
        for b in batches:
            image = torch.from_numpy(b).to(hand_side.device)
            o = net.inference(params, image, hand_side)
            outs.append({"center": o.center, "scale_crop": o.scale_crop,
                         "uv21": o.keypoint_uv21,
                         "coord3d": o.keypoint_coord3d,
                         "scoremap": o.keypoints_scoremap})
    return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
            for k in outs[0]}


def _stats(x):
    x = np.asarray(x, np.float64).ravel()
    return {"mean": float(x.mean()), "p50": float(np.percentile(x, 50)),
            "p95": float(np.percentile(x, 95)), "max": float(x.max())}


def deltas(base, var):
    """Drift metrics of a preset's outputs against the f32 cascade's."""
    n = len(base["uv21"])
    center_px = np.linalg.norm(var["center"] - base["center"], axis=-1)
    scale_rel = np.abs(var["scale_crop"] - base["scale_crop"]) / np.maximum(
        np.abs(base["scale_crop"]), 1e-6)
    uv_epe = np.linalg.norm(var["uv21"] - base["uv21"], axis=-1)
    c3d = np.linalg.norm(var["coord3d"] - base["coord3d"], axis=-1)
    num = np.linalg.norm((var["scoremap"] - base["scoremap"]).reshape(n, -1),
                         axis=1)
    den = np.maximum(np.linalg.norm(base["scoremap"].reshape(n, -1), axis=1),
                     1e-12)
    return {"crop_center_px": _stats(center_px),
            "crop_scale_rel": _stats(scale_rel),
            "uv21_epe_px": _stats(uv_epe),
            "coord3d_drift": _stats(c3d),
            "scoremap_rel_l2": _stats(num / den)}


def presets(params, batches, hand_side):
    """{name: (cascade, torch param tree)} of every row; ``params`` is the
    f32 tree on the device, the int8 trees are made from it there."""
    from hand3d_tpu_torch.models.cascade import ColorHandPose3D
    from hand3d_tpu_torch.ops.quant import (calibrate_act_scales,
                                            quantize_params_int8)

    net = ColorHandPose3D()
    device = hand_side.device
    calib = calibrate_act_scales(
        lambda p, b: net.inference(p, torch.from_numpy(b).to(device),
                                   hand_side, keypoints_scoremap=False),
        params, batches[:max(1, len(batches) // 2)])
    seg = quantize_params_int8(params, scopes={"handsegnet"})
    return {
        "seg_scale=0.5": (ColorHandPose3D(seg_scale=0.5), params),
        "bf16": (ColorHandPose3D(compute_dtype="bfloat16"), params),
        "int8": (net, quantize_params_int8(params)),
        "int8_static": (net, quantize_params_int8(params, act_scales=calib)),
        "int8_seg": (net, seg),
        "int8_seg_refiners": (net, quantize_params_int8(
            seg, scopes={"posenet2d"}, include_substrings={"conv6", "conv7"})),
    }


def markdown(summary):
    lines = [
        "",
        f"## Preset accuracy ({summary['weights']} weights, "
        f"{summary['images']} synthetic RHD frames, {summary['device']})",
        "",
        "Drift against the f32 cascade (same weights, same frames); coord3d "
        "in canonical units (middle-MCP bone = 1).",
        "",
        "| Preset | crop center px (p95 / max) | crop scale rel (p95) "
        "| uv21 EPE px (mean / p95 / max) | coord3d drift (mean / p95) "
        "| scoremap rel-L2 (p50 / p95) |",
        "|---|---|---|---|---|---|",
    ]
    for name, r in summary["presets"].items():
        c, s, u, d, sm = (r["crop_center_px"], r["crop_scale_rel"],
                          r["uv21_epe_px"], r["coord3d_drift"],
                          r["scoremap_rel_l2"])
        lines.append(
            f"| {name} | {c['p95']:.2f} / {c['max']:.2f} | {s['p95']:.4f} "
            f"| {u['mean']:.2f} / {u['p95']:.2f} / {u['max']:.2f} "
            f"| {d['mean']:.4f} / {d['p95']:.4f} "
            f"| {sm['p50']:.4f} / {sm['p95']:.4f} |")
    for name, why in summary["left_out"].items():
        lines.append(f"| {name} | left out: {why} | | | | |")
    return "\n".join(lines + [""])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--overfit-dir", default=None,
                    help="work dir of hand3d_tpu_torch.tools.overfit_check "
                         "--keep")
    ap.add_argument("--random-init", action="store_true",
                    help="seeded random weights (weak localization oracle)")
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the CUDA kernels)")
    ap.add_argument("--write-doc", default=None,
                    help="append a markdown table to this file")
    ap.add_argument("--label", default=None,
                    help="weights label of the table (default: overfit or "
                         "random_init)")
    args = ap.parse_args(argv)
    if not args.overfit_dir and not args.random_init:
        ap.error("pass --overfit-dir DIR or --random-init")

    from hand3d_tpu_torch import precision
    from hand3d_tpu_torch.models.cascade import ColorHandPose3D
    from hand3d_tpu_torch.serving import hand_side_tensor
    from hand3d_tpu_torch.weights import params_from_jax, random_params

    device = precision.exact_f32(args.device)
    params_np = (load_overfit_params(args.overfit_dir) if args.overfit_dir
                 else random_params(0))
    params = params_from_jax(params_np, device)
    batches = fixture_batches(args.images, args.batch)
    hand_side = hand_side_tensor(True, args.batch, device)
    print(f"f32 cascade on {len(batches)} x {args.batch} frames ...",
          file=sys.stderr)
    base = run_cascade(ColorHandPose3D(), params, batches, hand_side)
    results = {}
    for name, (net, tree) in presets(params, batches, hand_side).items():
        print(f"running {name} ...", file=sys.stderr)
        results[name] = deltas(base, run_cascade(net, tree, batches,
                                                 hand_side))
    for name, why in LEFT_OUT.items():
        print(f"{name}: left out, {why}")
    summary = {"gate": "preset_accuracy",
               "weights": args.label or ("overfit" if args.overfit_dir
                                         else "random_init"),
               "images": len(batches) * args.batch,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "presets": results, "left_out": LEFT_OUT}
    if args.write_doc:
        with open(args.write_doc, "a") as f:
            f.write(markdown(summary))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
