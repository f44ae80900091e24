"""The evaluation harnesses (counterpart of hand3d_tpu/eval/harnesses.py).

Library equivalents of the reference's eval scripts, with the same data
settings, metric math and threshold grids, streaming batches through one
device:

  * eval2d_gt_cropped   <- eval2d_gt_cropped.py (PoseNet on GT crops, px)
  * eval2d_full_image   <- eval2d.py (HandSegNet + PoseNet on full frames)
  * eval3d_lifting      <- eval3d.py (lifting variants from GT scoremaps, m)
  * eval3d_from_posenet    (lifting from PoseNet's predicted scoremaps)
  * eval_full_pipeline  <- eval_full.py (image -> 3D, m, + 20-50 mm AUC)

Each takes a TF-layout numpy param tree (``weights.load_npz`` or
``weights.random_params``), or a torch tree already on the device (a
training run's), and an explicit ``device``; on a CUDA device the
cascade's two kernels run, and TF32 is turned off first
(``precision.exact_f32``). Each returns a dict of metrics; the reference's
values are in BASELINE.md rows 1-13.

``mesh=`` (``parallel.make_mesh``, any layout) spreads each batch over the
mesh's batch axes: every rank walks the same global batch list, uploads and
runs only its rows (the ranks of a "model" group the same rows, with the
params sharded over them), and the outputs are all-gathered before the
metrics, so every rank reports the same numbers. ``batch_size`` is the
global batch, as in the JAX package.
"""

import collections
import functools
import queue
import threading

import numpy as np
import torch

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import host_tensors
from hand3d_tpu_torch.data.preprocess import preprocess_rhd, preprocess_stb
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.eval.metrics import EvalUtil, calc_auc
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.models.cascade import CROP_SIZE, ColorHandPose3D
from hand3d_tpu_torch.models.poseprior import SCOREMAP_SIZE, PosePriorNetwork
from hand3d_tpu_torch.ops.image import resize_bilinear
from hand3d_tpu_torch.ops.keypoints import decode_upsampled
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.weights import params_from_jax

NET_INPUT_HW = (240, 320)  # eval2d.py:53, eval_full.py:50

GT_CROP_CONFIG = PreprocessConfig(hand_crop=True, use_wrist_coord=False)
FROM_POSENET_CONFIG = PreprocessConfig(hand_crop=True, use_wrist_coord=False,
                                       render_scoremap=False)
FULL_PIPELINE_CONFIG = PreprocessConfig(use_wrist_coord=False,
                                        render_scoremap=False)


def full_image_config(use_wrist_coord=True, scale_to_size=True):
    return PreprocessConfig(use_wrist_coord=use_wrist_coord,
                            scale_to_size=scale_to_size,
                            render_scoremap=False)


def _preprocess_fn(dataset):
    return preprocess_rhd if isinstance(dataset, RHDDataset) \
        else preprocess_stb


def eval_batches(n, batch_size):
    """Yield (indices, valid_count); the last batch is padded by repeating
    record n - 1."""
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        valid = len(idx)
        if valid < batch_size:
            idx = np.concatenate([idx, np.full(batch_size - valid, n - 1)])
        yield idx, valid


def run_step(step, pre, cfg, params, host, device):
    """One batch: upload, preprocess, ``step(params, data)``. Returns the
    step's dict of device tensors without waiting for them."""
    data = {k: v.to(device, non_blocking=True) for k, v in host.items()}
    with torch.inference_mode():
        return step(params, pre(cfg, data))


class _ProducerError:
    """Queue sentinel carrying the IO thread's exception to the consumer."""

    def __init__(self, exc):
        self.exc = exc


def _run(dataset, cfg, batch_size, step, params, util_feed, device,
         progress=None, window=3, max_batches=None, mesh=None):
    """Stream the dataset through ``step(params, data)``.

    Records are sliced (and pinned) on a background thread. Up to ``window``
    batches are launched before the oldest is fetched with ``.cpu()``, so the
    device works on batch i while the host slices and uploads batch i + 1.

    With a ``mesh`` of more than one rank, every rank walks the same global
    batch list and slices its rows ``[lo, lo + per)`` on the host before
    any upload; the step's outputs are all-gathered, so every rank feeds the
    whole batch to the metrics.
    """
    pre = _preprocess_fn(dataset)
    lo, per = 0, batch_size
    sharded = mesh is not None and mesh_lib.batch_shard_count(mesh) > 1
    if sharded:
        nproc = mesh_lib.batch_shard_count(mesh)
        assert batch_size % nproc == 0, (
            f"eval batch_size {batch_size} must divide over {nproc} "
            "processes")
        lo, per = mesh_lib.shard_rows(mesh, batch_size)
    batches = list(eval_batches(len(dataset), batch_size))
    if max_batches is not None:
        batches = batches[:max_batches]
    q = queue.Queue(maxsize=2)

    def producer():
        try:
            for idx, valid in batches:
                raw = dataset.raw_batch(idx[lo:lo + per])
                q.put((host_tensors(raw, device), valid))
        except Exception as e:
            # the consumer would otherwise block in q.get() forever
            q.put((_ProducerError(e), 0))

    threading.Thread(target=producer, daemon=True).start()
    pending = collections.deque()

    def drain_one(bi):
        out, valid = pending.popleft()
        if sharded:
            out = mesh_lib.gather_rows(out, mesh)
        util_feed({k: v[:valid].cpu().numpy() for k, v in out.items()})
        if progress:
            progress(bi, valid)

    drained = 0
    for _ in batches:
        host, valid = q.get()
        if isinstance(host, _ProducerError):
            raise RuntimeError("eval IO producer thread failed") from host.exc
        pending.append((run_step(step, pre, cfg, params, host, device), valid))
        if len(pending) >= window:
            drain_one(drained)
            drained += 1
    while pending:
        drain_one(drained)
        drained += 1


def _device_params(params, device, mesh=None):
    """``params`` on ``device``, TF32 off there first. A TF-layout numpy tree
    is converted; a torch tree already on ``device`` (a training run's, for
    an in-training eval) is used as it is, with no copy: the harnesses run
    under ``torch.inference_mode``, so no gradient reaches it. On a mesh
    with a "model" axis the params take its tensor-parallel layout
    (``parallel.shard_params``; a tree already sharded is kept)."""
    device = precision.exact_f32(device)
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(v for v in leaf.values() if not mesh_lib.is_shard(v))
    if not isinstance(leaf, torch.Tensor):
        params = params_from_jax(params, device)
    else:
        index = device.index if device.index is not None else (
            torch.cuda.current_device() if device.type == "cuda" else None)
        if leaf.device.type != device.type or leaf.device.index != index:
            raise ValueError(f"params lie on {leaf.device}, not on {device}")
    if mesh is not None:
        params = mesh_lib.shard_params(mesh, params)
    return params, device


def _root_relative_dists(pred_normed, data):
    """3D distances (m) of the scaled prediction to the root-centered GT
    (eval3d.py:88-96, eval_full.py:80-86)."""
    pred = pred_normed * data["keypoint_scale"][:, None, None]
    gt = data["keypoint_xyz21"] - data["keypoint_xyz21"][:, :1]
    return torch.linalg.vector_norm(gt - pred, dim=-1)


def step_gt_cropped(posenet_params, data):
    scoremap = posenet.apply(posenet_params, data["image_crop"])[-1]
    coord_uv = decode_upsampled(scoremap,
                                CROP_SIZE // scoremap.shape[1]).flip(-1)
    scale = data["crop_scale"][:, None, None]
    dists = torch.linalg.vector_norm(
        data["keypoint_uv21"] / scale - coord_uv / scale, dim=-1)
    return {"dists": dists, "vis": data["keypoint_vis21"]}


def step_full_image(params, data):
    image = data["image"]
    h, w = image.shape[1:3]
    out = ColorHandPose3D().inference2d(
        params, resize_bilinear(image, NET_INPUT_HW), keypoints_scoremap=False)
    # back to the dataset frame (eval2d.py:98-99)
    factor = torch.tensor([w / NET_INPUT_HW[1], h / NET_INPUT_HW[0]],
                          dtype=torch.float32, device=image.device)
    dists = torch.linalg.vector_norm(
        data["keypoint_uv21"] - out.keypoint_uv21 * factor, dim=-1)
    return {"dists": dists, "vis": data["keypoint_vis21"]}


def step_lifting(variant, params, data):
    out = PosePriorNetwork(variant).apply(params, data["scoremap"],
                                          data["hand_side"])
    return {"dists": _root_relative_dists(out.coord_xyz_rel_normed, data)}


def step_from_posenet(variant, params, data):
    scoremap = posenet.apply(params[posenet.SCOPE], data["image_crop"])[-1]
    if scoremap.shape[1] != SCOREMAP_SIZE:
        scoremap = resize_bilinear(scoremap, (SCOREMAP_SIZE, SCOREMAP_SIZE))
    out = PosePriorNetwork(variant).apply(params, scoremap, data["hand_side"])
    return {"dists": _root_relative_dists(out.coord_xyz_rel_normed, data)}


def step_full_pipeline(params, data):
    out = ColorHandPose3D().inference(
        params, resize_bilinear(data["image"], NET_INPUT_HW),
        data["hand_side"], keypoints_scoremap=False)
    return {"dists": _root_relative_dists(out.keypoint_coord3d, data),
            "vis": data["keypoint_vis21"]}


def _px_metrics(util):
    mean, median, auc, curve, thr = util.get_measures(0.0, 30.0, 20)
    return {"epe_mean_px": mean, "epe_median_px": median, "auc_0_30px": auc,
            "pck_curve": curve, "thresholds_px": thr}


def _mm_metrics(util):
    mean, median, auc, curve, thr = util.get_measures(0.0, 0.050, 20)
    return {"epe_mean_mm": mean * 1000, "epe_median_mm": median * 1000,
            "auc_0_50mm": auc, "pck_curve": curve, "thresholds_m": thr}


def _feed_visible(util):
    return lambda o: util.feed_batch(o["dists"], o["vis"])


def _feed_all(util):
    # eval3d.py:98 counts every keypoint visible
    return lambda o: util.feed_batch(o["dists"], np.ones_like(o["dists"]))


def eval2d_gt_cropped(posenet_params, dataset, batch_size=32, progress=None,
                      max_batches=None, mesh=None, *, device):
    """PoseNet alone on ground-truth crops; 2D EPE in source-image pixels.

    Reference: eval2d_gt_cropped.py (reader settings :38, EPE / crop_scale
    :82, thresholds 0-30 px in 20 steps :87). ``max_batches`` bounds the
    pass.
    """
    params, device = _device_params(posenet_params, device, mesh)
    util = EvalUtil()
    _run(dataset, GT_CROP_CONFIG, batch_size, step_gt_cropped, params,
         _feed_visible(util), device, progress, max_batches=max_batches,
         mesh=mesh)
    return _px_metrics(util)


def eval2d_full_image(params, dataset, batch_size=16, use_wrist_coord=True,
                      scale_to_size=True, progress=None, max_batches=None,
                      mesh=None, *, device):
    """HandSegNet + PoseNet on full frames; 2D EPE in dataset pixels.

    Reference: eval2d.py. With scale_to_size both GT and predictions live in
    the 240x320 frame (the paper setting, BASELINE.md rows 3-4); without it
    the network still sees 240x320 but coords are mapped back to the
    320x320 RHD frame (row 5). ``max_batches`` bounds the pass.
    """
    params, device = _device_params(params, device, mesh)
    util = EvalUtil()
    _run(dataset, full_image_config(use_wrist_coord, scale_to_size),
         batch_size, step_full_image, params, _feed_visible(util), device,
         progress, max_batches=max_batches, mesh=mesh)
    return _px_metrics(util)


def eval3d_lifting(variant, lifting_params, dataset, batch_size=32,
                   progress=None, max_batches=None, mesh=None, *, device):
    """A lifting variant from GT scoremaps; 3D EPE in meters.

    Reference: eval3d.py (reader :50, pred * keypoint_scale against the
    root-centered GT :88-96, thresholds 0-50 mm :101, every keypoint counted
    visible :98).
    """
    params, device = _device_params(lifting_params, device, mesh)
    util = EvalUtil()
    _run(dataset, GT_CROP_CONFIG, batch_size,
         functools.partial(step_lifting, variant), params, _feed_all(util),
         device, progress, max_batches=max_batches, mesh=mesh)
    return _mm_metrics(util)


def eval3d_from_posenet(variant, params, dataset, batch_size=32,
                        progress=None, max_batches=None, mesh=None, *,
                        device):
    """Lifting from PoseNet's predicted scoremaps on GT crops; 3D EPE (m).

    No reference script: it isolates the 2D -> 3D hand-off. The metric math
    is eval3d.py:88-101. ``params`` holds the PoseNet2D and PosePrior (and,
    for 'proposed', ViewpointNet) scopes.
    """
    params, device = _device_params(params, device, mesh)
    util = EvalUtil()
    _run(dataset, FROM_POSENET_CONFIG, batch_size,
         functools.partial(step_from_posenet, variant), params,
         _feed_all(util), device, progress, max_batches=max_batches,
         mesh=mesh)
    return _mm_metrics(util)


def eval_full_pipeline(params, dataset, batch_size=16, progress=None,
                       max_batches=None, mesh=None, *, device):
    """Full cascade image -> 3D; EPE in mm, AUC 0-50 mm and the 20-50 mm
    subset.

    Reference: eval_full.py (240x320 input :50, pred * keypoint_scale against
    the root-centered GT :80-86, thresholds 0-50 mm :92, subset curve[8:]
    :99-101). Works on the STB (paper Figure 9) and RHD evaluation sets.
    ``max_batches`` bounds the pass.
    """
    params, device = _device_params(params, device, mesh)
    util = EvalUtil()
    _run(dataset, FULL_PIPELINE_CONFIG, batch_size, step_full_pipeline,
         params, _feed_visible(util), device, progress,
         max_batches=max_batches, mesh=mesh)
    metrics = _mm_metrics(util)
    metrics["auc_20_50mm"] = calc_auc(metrics["thresholds_m"][8:] * 1000.0,
                                      metrics["pck_curve"][8:])
    return metrics
