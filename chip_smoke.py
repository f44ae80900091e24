"""Drive the PyTorch port (hand3d_tpu_torch) once on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the result
line is printed:

1. device: nvidia-smi's name and power limit, torch and CUDA versions;
   a CUDA device is required;
2. build: both CUDA kernels compiled from csrc/ with nvcc (sm_90a);
3. kernel parity: each kernel against its plain PyTorch twin, bit for bit,
   on synthetic masks and scoremaps at the cascade's shapes;
4. slice: HandPoseEstimator at full width (random weights from a seed) on
   240x320 images answers three requests; both kernels must have launched;
   the kernels must equal their twins on the slice's own tensors; the card's
   outputs are held to the port's CPU run (plain twins) by the flip-aware
   comparison of hand3d_tpu_torch.parity;
5. times: CUDA-event times of the served slice and of each kernel beside its
   twin at batches 1, 32 and 128;
6. eval: synthetic RHD (320x320) and STB (480x640) files in the reference's
   record layouts go through the five eval harnesses at their CLI batch
   sizes (eval2d_full_image with both scale_to_size settings, eval3d_lifting
   for all five variants). Each harness is called once to warm up, then
   once more, timed by CUDA events, with its kernel launches counted and its
   per-sample dists recorded; metrics must be finite, the kernels must have
   launched where the harness runs them, and TF32 must stay off. The first
   batch of those dists is held to the port's CPU run of the same records,
   flip-aware for the cascade harnesses. One harness call per harness (one
   lifting variant) is also timed over a longer file: 10 or 20 batches,
   and its steady-state pace read from the drains of batches inside the
   streaming loop (each right after a launch). The cascade with seg_scale=0.5 and with the soft-argmax decoder is
   held to the CPU run, and the flood-fill kernel to its twin, bit for bit,
   on the 120x160 maps that seg_scale=0.5 makes.

Standard output ends with one JSON line per timed batch and per eval
harness, the kernels line, nvidia-smi's line, and
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from hand3d_tpu_torch import parity, precision, weights
from hand3d_tpu_torch.data import codec
from hand3d_tpu_torch.data.preprocess import preprocess_rhd, preprocess_stb
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.stb import STBDataset
from hand3d_tpu_torch.eval import harnesses
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.models.cascade import ColorHandPose3D
from hand3d_tpu_torch.models.poseprior import VARIANTS
from hand3d_tpu_torch.ops import keypoints, segmentation
from hand3d_tpu_torch.ops.image import resize_bilinear
from hand3d_tpu_torch.ops.kernels import build, decode, floodfill
from hand3d_tpu_torch.serving import HandPoseEstimator, normalize_images

CPU = torch.device("cpu")
H, W = 240, 320  # the serving bucket of the JAX package's bench and demo
NUM_PASSES = max(H, W) // 10
FACTOR = 8  # 32x32 PoseNet scoremap -> 256x256 crop
SLICE_BATCH = 8
REQUESTS = (5, 8, 17)  # a partial, a full and a ragged multi-chunk request
PARITY_FLOOD_BATCHES = (1, 8, 32)
PARITY_DECODE_BATCHES = (1, 32)
TIME_BATCHES = (1, 32, 128)
TIME_ITERS = {1: 30, 32: 10, 128: 5}
# card vs CPU: scoremaps are ~1e-3 in size with random weights; cuDNN and
# the CPU convolutions differ by ~1e-6 of that. coord3d is ~5e-2 in size.
SCOREMAP_ATOL = 1e-6
FLIP_BOUND = 1e-5
COORD3D_ATOL = 1e-5

EVAL_RHD_RECORDS = 64
EVAL_STB_RECORDS = 32
EVAL_BATCHES = {"eval2d_gt_cropped": 32, "eval2d_full_image": 16,
                "eval3d_lifting": 32, "eval3d_from_posenet": 32,
                "eval_full_pipeline": 16}  # the harnesses' defaults
EVAL_DIST_ATOL = 1e-4  # px for 2D dists, m for 3D dists
# steady-state files: 10 batches of 32 or 20 of 16 RHD, 10 of 16 STB
STEADY_RHD_RECORDS = 320
STEADY_STB_RECORDS = 160
WINDOW = 3  # the harnesses' launch window (harnesses._run)
MODE_PARITY_IMAGES = 2  # card vs CPU for seg_scale=0.5 and soft-argmax
# soft-argmax uv is an expectation over 256^2 crop pixels, summed by cuBLAS
# in another order than on the CPU: ~1e-5 of a 256 px coordinate, times 4
# at the smallest crop scale (0.25)
SOFT_ARGMAX_UV_ATOL = 2e-2  # px

KERNELS = {
    "flood_fill": ("hand3d_tpu_torch/csrc/floodfill.cu",
                   "hand3d_tpu/ops/pallas/floodfill.py:58"),
    "decode_upsampled": ("hand3d_tpu_torch/csrc/decode.cu",
                         "hand3d_tpu/ops/pallas/decode.py:36"),
}


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn()`` over ``iters`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    require(torch.cuda.is_available(), "no CUDA device: the port's main "
            "path runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return smi


def phase_build():
    for name in ("floodfill", "decode"):
        t0 = time.perf_counter()
        report = build.compile_kernel(name)
        log(f"built csrc/{name}.cu -> {build.library_path(name).name} in "
            f"{time.perf_counter() - t0:.2f} s")
        for line in report.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"  {line.strip()}")


def flood_cases(b, rng):
    """[b, H, W] masks and seeds: two blobs, bridged, empty, a seed on
    background 5 px from a blob, random noise."""
    cases = {}
    two = np.zeros((b, H, W), np.float32)
    two[:, 40:80, 40:90] = 1.0
    two[:, 150:200, 200:280] = 1.0
    seed_a = np.tile(np.array([[60, 60]], np.int32), (b, 1))
    cases["two_blob"] = (two, seed_a)
    bridged = two.copy()
    bridged[:, 60, 90:240] = 1.0
    bridged[:, 60:150, 239] = 1.0
    cases["bridged"] = (bridged, seed_a)
    cases["empty"] = (np.zeros((b, H, W), np.float32), seed_a)
    bg = np.zeros((b, H, W), np.float32)
    bg[:, 100:140, 100:160] = 1.0
    cases["seed_on_background"] = (bg, np.tile(np.array([[95, 95]], np.int32),
                                               (b, 1)))
    noise = (rng.random((b, H, W)) > 0.6).astype(np.float32)
    seeds = np.stack([rng.integers(0, H, b), rng.integers(0, W, b)], 1)
    cases["random"] = (noise, seeds.astype(np.int32))
    return cases


def decode_cases(b, rng):
    """[b, 32, 32, 21] scoremaps with exact ties, edge peaks and the
    cascade's ~1e-3 value scale."""
    sm = rng.standard_normal((b, 32, 32, 21)).astype(np.float32)
    sm[0, :, :, 0] = 0.0
    sm[0, 5, 5, 3] = sm[0, 20, 20, 3] = sm[0].max() + 1.0
    sm[-1, 31, 31, 4] = sm[-1, 0, 31, 5] = sm[-1, 31, 0, 6] = 10.0
    small = (rng.standard_normal((b, 32, 32, 21)) * 1e-3).astype(np.float32)
    return {"ties_edges": sm, "small_values": small}


def phase_kernel_parity(dev):
    rng = np.random.default_rng(0)
    err = {"flood_fill": 0.0, "decode_upsampled": 0.0}
    for b in PARITY_FLOOD_BATCHES:
        for name, (det, seed) in flood_cases(b, rng).items():
            det_t = torch.from_numpy(det).to(dev)
            seed_t = torch.from_numpy(seed).to(dev)
            got = floodfill.flood_fill_cuda(det_t, seed_t, NUM_PASSES)
            want = segmentation.flood_fill_torch(det_t, seed_t, NUM_PASSES)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            err["flood_fill"] = max(err["flood_fill"], e)
            require(torch.equal(got, want), f"flood fill differs: {name} B={b}")
            log(f"flood fill == twin: {name:18s} B={b:3d} "
                f"({int(want.sum().item())} px kept)")
    for b in PARITY_DECODE_BATCHES:
        for name, sm in decode_cases(b, rng).items():
            sm_t = torch.from_numpy(sm).to(dev)
            got = decode.decode_upsampled_cuda(sm_t, FACTOR)
            want = keypoints.decode_upsampled_torch(sm_t, FACTOR)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            err["decode_upsampled"] = max(err["decode_upsampled"], e)
            require(torch.equal(got, want), f"decode differs: {name} B={b}")
            log(f"decode == twin:     {name:18s} B={b:3d}")
    return err


def slice_inputs(params, image, hand_side):
    """The flood fill's and the decode's inputs as the cascade makes them."""
    net = ColorHandPose3D()
    with torch.inference_mode():
        hand_scoremap, center, scale = net.localize(params, image)
        _, det, seed = segmentation.foreground(hand_scoremap)
        pose = net.pose_from_box(params, image, center, scale, hand_side)
    return det, seed, pose.scoremap


def phase_slice(dev, params_np, err):
    est = HandPoseEstimator(params_np, batch_size=SLICE_BATCH,
                            input_hw=(H, W), device=dev).warmup()
    rng = np.random.default_rng(1)
    requests = [rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
                for n in REQUESTS]
    floodfill.launches = 0
    decode.launches = 0
    outs = [est.predict(r) for r in requests]
    counts = {"flood_fill": floodfill.launches,
              "decode_upsampled": decode.launches}
    log(f"served {len(requests)} requests of {REQUESTS} images; "
        f"kernel launches {counts}")
    for name, n in counts.items():
        require(n > 0, f"the served requests never launched {name}")
    shapes = {"keypoint_coord3d": (21, 3), "keypoint_uv21": (21, 2),
              "hand_scoremap": (H, W, 2), "scale_crop": (1,), "center": (2,)}
    for n, out in zip(REQUESTS, outs):
        require(set(out) == set(shapes), f"served keys {sorted(out)}")
        for k, tail in shapes.items():
            require(out[k].shape == (n, *tail), f"{k} shape {out[k].shape}")
            require(np.isfinite(out[k]).all(), f"{k} not finite")

    # kernels vs twins on the slice's own tensors (one full batch)
    image = torch.from_numpy(normalize_images(requests[2][:SLICE_BATCH])).to(dev)
    det, seed, sm = slice_inputs(est.params, image, est.hand_side)
    pairs = {
        "flood_fill": (floodfill.flood_fill_cuda(det, seed, NUM_PASSES),
                       segmentation.flood_fill_torch(det, seed, NUM_PASSES)),
        "decode_upsampled": (decode.decode_upsampled_cuda(sm, FACTOR),
                             keypoints.decode_upsampled_torch(sm, FACTOR)),
    }
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        err[name] = max(err[name], (got - want).abs().max().item())
        require(torch.equal(got, want), f"{name} differs on the slice's input")
    log("kernels == twins on the slice's own flood-fill and decode inputs")
    ms = kernel_times(det, seed, sm)

    # the card's cascade held to the port's CPU run (the plain twins)
    image2 = image[:2]
    hand_side = est.hand_side[:2]
    got = parity.port_fields(est.params, image2, hand_side)
    cpu_params = weights.params_from_jax(params_np, "cpu")
    ref = parity.port_fields(cpu_params, image2.cpu(), hand_side.cpu())
    summary = parity.check_cascade(
        ref, got, parity.port_rerun(cpu_params, image2.cpu(), hand_side.cpu()),
        scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
        flip_bound=FLIP_BOUND)
    log("card vs CPU (flip-aware; atol scoremap "
        f"{SCOREMAP_ATOL}, coord3d {COORD3D_ATOL}, flip bound {FLIP_BOUND}): "
        + json.dumps(summary))
    return [{"name": name, "route": "cuda", "source": KERNELS[name][0],
             "replaces": KERNELS[name][1], "launches": counts[name],
             "max_abs_err": err[name], "ms": ms[name][0],
             "plain_ms": ms[name][1], "batch": SLICE_BATCH}
            for name in KERNELS]


def kernel_times(det, seed, sm, iters=20):
    """{kernel: (kernel ms, twin ms)} at the given slice tensors."""
    def run(fn):
        fn()  # warm-up
        return cuda_ms(fn, iters)
    return {
        "flood_fill": (
            run(lambda: floodfill.flood_fill_cuda(det, seed, NUM_PASSES)),
            run(lambda: segmentation.flood_fill_torch(det, seed, NUM_PASSES))),
        "decode_upsampled": (
            run(lambda: decode.decode_upsampled_cuda(sm, FACTOR)),
            run(lambda: keypoints.decode_upsampled_torch(sm, FACTOR))),
    }


def phase_times(dev, params_np):
    rng = np.random.default_rng(2)
    for b in TIME_BATCHES:
        torch.cuda.reset_peak_memory_stats(dev)
        est = HandPoseEstimator(params_np, batch_size=b, input_hw=(H, W),
                                device=dev)
        images = rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)
        for _ in range(2):
            est.predict(images)
        per_batch = []
        for _ in range(TIME_ITERS[b]):
            per_batch.append(cuda_ms(lambda: est.predict(images), 1))
        det, seed, sm = slice_inputs(
            est.params, torch.from_numpy(normalize_images(images)).to(dev),
            est.hand_side)
        kt = kernel_times(det, seed, sm)
        med = float(np.median(per_batch))
        log(json.dumps({
            "batch": b, "input_hw": [H, W], "slice_ms_per_batch_median": med,
            "slice_ms_per_batch": per_batch, "frames_per_s": b * 1000.0 / med,
            "flood_fill_ms": kt["flood_fill"][0],
            "flood_fill_plain_ms": kt["flood_fill"][1],
            "decode_ms": kt["decode_upsampled"][0],
            "decode_plain_ms": kt["decode_upsampled"][1],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}))
        del est
        torch.cuda.empty_cache()


def write_rhd_file(path, n, rng):
    """n RHD records: a plausible 42-keypoint cloud whose uv is the
    K-projection of xyz, noise images, a part mask whose dominant hand
    alternates between left and right."""
    cam = np.array([[283.0, 0.0, 160.0], [0.0, 283.0, 160.0],
                    [0.0, 0.0, 1.0]], np.float32)
    h, w = codec.RHD_IMAGE_SIZE
    with open(path, "wb") as f:
        for i in range(n):
            xyz = (rng.standard_normal((42, 3)) * 0.04 + [0.0, 0.0, 0.5]
                   + rng.uniform(-0.1, 0.1, (1, 3))).astype(np.float32)
            proj = xyz @ cam.T
            uv = (proj[:, :2] / proj[:, 2:]).astype(np.float32)
            left = i % 2 == 0
            hand = uv[:21] if left else uv[21:]
            c0, r0 = np.clip(hand.mean(0).astype(int) - 20, 0, h - 40)
            parts = np.zeros((h, w), np.uint8)
            parts[:50, :50] = 1  # person pixels outside the hands
            parts[r0:r0 + 40, c0:c0 + 40] = 5 if left else 20
            parts[0:5, 300:305] = 20 if left else 5  # a bit of the other hand
            vis = rng.random(42) > 0.2
            vis[[12, 33]] = True
            codec.write_rhd_record(
                f, xyz, uv, cam, rng.integers(0, 256, (h, w, 3), np.uint8),
                parts, vis)


def write_stb_file(path, n, rng):
    """n STB records: 21 keypoints in mm whose uv is the K-projection."""
    cam = np.array([[822.79041, 0.0, 318.47345], [0.0, 822.79041, 250.31296],
                    [0.0, 0.0, 1.0]], np.float32)
    with open(path, "wb") as f:
        for _ in range(n):
            xyz = (rng.standard_normal((21, 3)) * 25 + [0.0, 0.0, 600.0]
                   + rng.uniform(-60, 60, (1, 3))).astype(np.float32)
            proj = xyz @ cam.T
            codec.write_stb_record(
                f, xyz, proj[:, :2] / proj[:, 2:], np.ones(21, np.float32),
                rng.integers(0, 256, (*codec.STB_IMAGE_SIZE, 3), np.uint8))


def require_exact_f32():
    require(not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32,
            "TF32 was turned back on")


@contextlib.contextmanager
def recorded_dists():
    """Make the harnesses record every batch of per-sample dists that they
    feed to EvalUtil, in order."""
    rows = []
    base = harnesses.EvalUtil

    class Recording(base):
        def feed_batch(self, dists, vis):
            rows.append(np.array(dists))
            super().feed_batch(dists, vis)

    harnesses.EvalUtil = Recording
    try:
        yield rows
    finally:
        harnesses.EvalUtil = base


def preprocessed(pre, cfg, raw, device):
    """A raw batch preprocessed on ``device`` as the harnesses do it."""
    return harnesses.run_step(lambda _, data: data, pre, cfg, None,
                              harnesses.host_tensors(raw, device), device)


class EvalRun(NamedTuple):
    label: str
    harness: str  # key of EVAL_BATCHES
    dataset: str  # "rhd" or "stb"
    needs: tuple  # the kernels it must launch
    call: Callable  # (dataset, batch, device, **kw) -> metrics
    held: Callable  # (raw first batch) -> (held [B, 21], tol, note)
    steady: bool  # also timed in a long steady-state run


def hand_side_of(data):
    """The batch's hand side; where the preprocessing makes none (the 2D
    harnesses with scale_to_size), the left hand."""
    if "hand_side" in data:
        return data["hand_side"]
    image = data["image"]
    return torch.tensor([[1.0, 0.0]], device=image.device).expand(
        len(image), 2)


def held_everywhere(raw):
    """Dists that are continuous in the inputs: every keypoint."""
    return (np.ones((len(raw["image"]), 21), bool), EVAL_DIST_ATOL,
            "every keypoint")


def held_crop2d(posenet_np, raw, dev):
    """eval2d_gt_cropped: the card's PoseNet scoremap of the batch's GT
    crops is held to the CPU's, and the dists at the CPU's clear keypoints,
    within EVAL_DIST_ATOL plus an edge plateau in source pixels."""
    sm, data = {}, None
    for key, device in (("card", dev), ("cpu", CPU)):
        data = preprocessed(preprocess_rhd, harnesses.GT_CROP_CONFIG, raw,
                            device)
        with torch.inference_mode():
            sm[key] = posenet.apply(
                weights.params_from_jax(posenet_np, device),
                data["image_crop"])[-1].cpu().numpy()
    err = float(np.abs(sm["card"] - sm["cpu"]).max())
    require(err <= SCOREMAP_ATOL, f"PoseNet scoremap differs by {err}")
    clear, slack = parity.peak_slack(sm["cpu"], FLIP_BOUND)
    crop_scale = data["crop_scale"].numpy()
    tol = EVAL_DIST_ATOL + np.linalg.norm(slack, axis=-1) / crop_scale[:, None]
    return clear, tol, (f"PoseNet scoremap within {err:.3g}; "
                        f"{int((slack > 0).any(-1)[clear].sum())} on a plateau")


def held_cascade(params_np, pre, cfg, raw, dev, argmax):
    """A cascade harness: the card's cascade on its own preprocessing of the
    batch is held to the CPU's, flip-aware. Dists are held on the images
    with the CPU's mask: at the clear keypoints, within EVAL_DIST_ATOL plus
    an edge plateau in dataset pixels, if they come from the argmax decode;
    else at every keypoint."""
    fields = {}
    for key, device in (("card", dev), ("cpu", CPU)):
        data = preprocessed(pre, cfg, raw, device)
        image = resize_bilinear(data["image"], harnesses.NET_INPUT_HW)
        params = weights.params_from_jax(params_np, device)
        fields[key] = parity.port_fields(params, image, hand_side_of(data))
    ref, got = fields["cpu"], fields["card"]
    summary = parity.check_cascade(
        ref, got, parity.port_rerun(params, image, hand_side_of(data)),
        scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
        flip_bound=FLIP_BOUND)
    if argmax:
        clear, slack = parity.peak_slack(ref["scoremap"], FLIP_BOUND)
        h, w = data["image"].shape[1:3]
        frame = np.array([w / harnesses.NET_INPUT_HW[1],
                          h / harnesses.NET_INPUT_HW[0]])  # (u, v)
        tol = EVAL_DIST_ATOL + np.linalg.norm(
            slack * frame / got["scale_crop"][:, :, None], axis=-1)
    else:
        clear, tol = np.ones((len(ref["center"]), 21), bool), EVAL_DIST_ATOL
    clear[summary["images_rerun"]] = False
    return clear, tol, "cascade " + json.dumps(summary)


def cascade_parity(params_np, dev, image, hand_side, net, uv_atol=None):
    """The card's cascade ``net`` held to the port's CPU run, flip-aware."""
    cpu_params = weights.params_from_jax(params_np, "cpu")
    got = parity.port_fields(weights.params_from_jax(params_np, dev),
                             image.to(dev), hand_side.to(dev), net=net)
    ref = parity.port_fields(cpu_params, image, hand_side, net=net)
    return parity.check_cascade(
        ref, got, parity.port_rerun(cpu_params, image, hand_side, net=net),
        scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
        flip_bound=FLIP_BOUND, uv_atol=uv_atol)


def timed_call(call, dev):
    """Run ``call(progress=...)`` with the kernel counts set to 0; return
    (ms by CUDA events, metrics, launch counts, host time of each batch's
    drain, peak device memory)."""
    floodfill.launches = 0
    decode.launches = 0
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = call(progress=lambda bi, valid: stamps.append(
        time.perf_counter()))
    end.record()
    torch.cuda.synchronize()
    counts = {"flood_fill": floodfill.launches,
              "decode_upsampled": decode.launches}
    require_exact_f32()
    return (start.elapsed_time(end), metrics, counts, stamps,
            torch.cuda.max_memory_allocated(dev))


def eval_run(run, datasets, dev):
    """One harness: a warm-up call, the timed call with its dists recorded,
    the CPU run of its first batch held to the card's first batch, and, if
    ``run.steady``, a timed call over the long file. Returns the launch
    counts of the timed call."""
    batch = EVAL_BATCHES[run.harness]
    dataset = datasets[run.dataset]
    run.call(dataset, batch, dev)  # warm-up: cuDNN plans for new shapes
    with recorded_dists() as card_rows:
        ms, metrics, counts, _, peak = timed_call(
            lambda **kw: run.call(dataset, batch, dev, **kw), dev)
    scalars = {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}
    require(all(np.isfinite(v).all() for v in metrics.values()),
            f"{run.label}: metrics not finite: {scalars}")
    for name in run.needs:
        require(counts[name] > 0, f"{run.label} never launched {name}")
    line = {"eval": run.label, "batch": batch, "images": len(dataset),
            "ms": ms, "images_per_s": len(dataset) * 1000.0 / ms,
            "peak_mem_bytes": peak, "launches": counts, "metrics": scalars}

    t0 = time.perf_counter()
    with recorded_dists() as cpu_rows:
        run.call(dataset, batch, CPU, max_batches=1)
    held, tol, note = run.held(dataset.raw_batch(np.arange(batch)))
    require(card_rows[0].shape == cpu_rows[0].shape == (batch, 21),
            f"{run.label}: first batch {card_rows[0].shape}")
    err = np.abs(card_rows[0] - cpu_rows[0])
    beyond = (err > tol) & held
    require(not beyond.any(), f"{run.label}: card dists differ from the "
            f"CPU's beyond the bound at {np.argwhere(beyond).tolist()}; {note}")
    log(f"{run.label}: first batch of {batch}: card dists == CPU at "
        f"{int(held.sum())} of {held.size} keypoints (max err "
        f"{float(err[held].max()) if held.any() else 0.0:.3g}; CPU side "
        f"{time.perf_counter() - t0:.1f} s); {note}")

    if run.steady:
        long = datasets[run.dataset + "_long"]
        ms, _, _, stamps, peak = timed_call(
            lambda **kw: run.call(long, batch, dev, **kw), dev)
        # inside the loop, batch i is drained right after batch
        # i + WINDOW - 1 is launched; the last WINDOW - 1 drains follow
        # with no launch between them, so the loop's pace is read from
        # the first drain to the last one inside the loop
        loop = len(stamps) - WINDOW
        line["steady"] = {
            "images": len(long), "ms": ms,
            "images_per_s": len(long) * 1000.0 / ms,
            "loop_images_per_s": loop * batch / (stamps[loop] - stamps[0]),
            "peak_mem_bytes": peak}
    log(json.dumps(line))
    return counts


def from_posenet_params(params_np):
    return dict(weights.random_lifting_params("proposed", 1),
                **{posenet.SCOPE: params_np[posenet.SCOPE]})


def eval_runs(params_np, dev):
    both = ("flood_fill", "decode_upsampled")
    runs = [EvalRun(
        "eval2d_gt_cropped", "eval2d_gt_cropped", "rhd", ("decode_upsampled",),
        lambda ds, b, d, **kw: harnesses.eval2d_gt_cropped(
            params_np[posenet.SCOPE], ds, b, device=d, **kw),
        lambda raw: held_crop2d(params_np[posenet.SCOPE], raw, dev), True)]
    runs += [EvalRun(
        f"eval2d_full_image scale_to_size={s}", "eval2d_full_image", "rhd",
        both, lambda ds, b, d, s=s, **kw: harnesses.eval2d_full_image(
            params_np, ds, b, use_wrist_coord=False, scale_to_size=s,
            device=d, **kw),
        lambda raw, s=s: held_cascade(
            params_np, preprocess_rhd, harnesses.full_image_config(False, s),
            raw, dev, argmax=True), s)
        for s in (True, False)]
    runs += [EvalRun(
        f"eval3d_lifting {v}", "eval3d_lifting", "rhd", (),
        lambda ds, b, d, v=v, **kw: harnesses.eval3d_lifting(
            v, weights.random_lifting_params(v, 1), ds, b, device=d, **kw),
        held_everywhere, v == "proposed")
        for v in VARIANTS]
    runs += [EvalRun(
        "eval3d_from_posenet proposed", "eval3d_from_posenet", "rhd", (),
        lambda ds, b, d, **kw: harnesses.eval3d_from_posenet(
            "proposed", from_posenet_params(params_np), ds, b, device=d,
            **kw),
        held_everywhere, True)]
    runs += [EvalRun(
        "eval_full_pipeline stb", "eval_full_pipeline", "stb", both,
        lambda ds, b, d, **kw: harnesses.eval_full_pipeline(
            params_np, ds, b, device=d, **kw),
        lambda raw: held_cascade(params_np, preprocess_stb,
                                 harnesses.FULL_PIPELINE_CONFIG, raw, dev,
                                 argmax=False), True)]
    return runs


def phase_cascade_modes(dev, params_np, rhd):
    """seg_scale=0.5 and the soft-argmax decoder, card against CPU, on the
    full-image harness's input."""
    data = preprocessed(preprocess_rhd, harnesses.full_image_config(),
                        rhd.raw_batch(np.arange(MODE_PARITY_IMAGES)), CPU)
    image = resize_bilinear(data["image"], harnesses.NET_INPUT_HW)
    for label, net, uv_atol in (
            ("seg_scale=0.5", ColorHandPose3D(seg_scale=0.5), None),
            ("soft_argmax", ColorHandPose3D(decode="soft_argmax"),
             SOFT_ARGMAX_UV_ATOL)):
        summary = cascade_parity(params_np, dev, image, hand_side_of(data),
                                 net, uv_atol)
        log(f"cascade {label}: card vs CPU (flip-aware): "
            + json.dumps(summary))


def phase_flood_fill_half_scale(dev, params_np, rhd, batch):
    """The flood-fill kernel against its twin, bit for bit, on the 120x160
    maps of seg_scale=0.5, at the full-image harness's batch."""
    data = preprocessed(preprocess_rhd, harnesses.full_image_config(),
                        rhd.raw_batch(np.arange(batch)), dev)
    net = ColorHandPose3D(seg_scale=0.5)
    with torch.inference_mode():
        _, det, seed = segmentation.foreground(net.segment(
            weights.params_from_jax(params_np, dev),
            resize_bilinear(data["image"], harnesses.NET_INPUT_HW)))
    require(tuple(det.shape) == (batch, 120, 160), f"{tuple(det.shape)}")
    passes = max(det.shape[1:]) // 10
    got = floodfill.flood_fill_cuda(det, seed, passes)
    want = segmentation.flood_fill_torch(det, seed, passes)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "flood fill differs at 120x160")
    ms = (cuda_ms(lambda: floodfill.flood_fill_cuda(det, seed, passes), 20),
          cuda_ms(lambda: segmentation.flood_fill_torch(det, seed, passes),
                  20))
    log(json.dumps({"flood_fill_120x160": "bit-equal to its twin",
                    "batch": batch, "passes": passes, "ms": ms[0],
                    "plain_ms": ms[1], "px_kept": int(want.sum().item())}))
    return float((got - want).abs().max().item())


def phase_eval(dev, params_np, err):
    """The eval harnesses on synthetic RHD / STB files; returns the kernel
    launches of the timed calls on the 64 / 32 record files."""
    rng = np.random.default_rng(3)
    totals = {"flood_fill": 0, "decode_upsampled": 0}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        datasets = {}
        for name, n, write, cls in (
                ("rhd", EVAL_RHD_RECORDS, write_rhd_file, RHDDataset),
                ("rhd_long", STEADY_RHD_RECORDS, write_rhd_file, RHDDataset),
                ("stb", EVAL_STB_RECORDS, write_stb_file, STBDataset),
                ("stb_long", STEADY_STB_RECORDS, write_stb_file, STBDataset)):
            path = os.path.join(tmp, name + ".bin")
            write(path, n, rng)
            datasets[name] = cls("evaluation", path)
        log("wrote " + ", ".join(f"{len(d)} {k}" for k, d in datasets.items())
            + f" records in {time.perf_counter() - t0:.1f} s")

        phase_cascade_modes(dev, params_np, datasets["rhd"])
        err["flood_fill"] = max(err["flood_fill"], phase_flood_fill_half_scale(
            dev, params_np, datasets["rhd"], EVAL_BATCHES["eval2d_full_image"]))
        for run in eval_runs(params_np, dev):
            counts = eval_run(run, datasets, dev)
            for k in totals:
                totals[k] += counts[k]
    return totals


def main():
    smi = phase_device()
    dev = torch.device("cuda", 0)
    precision.exact_f32(dev)
    phase_build()
    err = phase_kernel_parity(dev)
    params_np = weights.random_params(0)
    kernels = phase_slice(dev, params_np, err)
    phase_times(dev, params_np)
    eval_launches = phase_eval(dev, params_np, err)
    for k in kernels:
        k["launches"] += eval_launches[k["name"]]
        k["max_abs_err"] = err[k["name"]]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
