"""Serving API (counterpart of hand3d_tpu/serving.py: float, bf16 and int8).

``HandPoseEstimator`` runs the cascade behind one fixed (batch, height,
width) shape on one device, padding partial batches, numpy in and numpy
out. ``SnapEstimator`` and ``AutoBucketEstimator`` take any input
resolution (resized to a bucket on the estimator's device, uv and center
mapped back); ``DynamicBatcher`` coalesces concurrent requests into one
device batch.

uint8 frames reach ``HandPoseEstimator`` as uint8 and each chunk is
normalized on the device (``batching.to_device_normalized``); float frames,
frames that ``SnapEstimator`` or ``AutoBucketEstimator`` resize, and
``DynamicBatcher``'s requests are normalized on the host
(``normalize_images``).

On one CUDA device without a mesh, ``HandPoseEstimator`` replays each
chunk's cascade as a CUDA graph (``_CascadeGraph``), captured at the first
chunk of each frame dtype; on the CPU and on a mesh it launches the cascade
op by op.

Spans (``utils.profiling``): ``serving.h2d`` (a chunk's copy in, and on the
eager path a uint8 chunk's normalize on the device) and ``serving.launch``
(the eager path: the cascade's launches, the served outputs' selection and
a mesh's gather; the graph path: the replay, which holds the normalize,
and the outputs' clones) in ``HandPoseEstimator``, with ``batching``'s
``serving.normalize`` and ``serving.fetch``; the counters
``serving.graph.captures`` and ``serving.graph.replays``;
``batcher.queue_wait`` (a request's wait from its put to its collection)
and the counters ``batcher.batches`` and ``batcher.images`` in
``DynamicBatcher``.

Example:
    est = HandPoseEstimator.from_npz("weights.npz", batch_size=32,
                                     device="cuda")
    out = est.predict(images)          # [N, H, W, 3] uint8 or float
    out["keypoint_uv21"], out["keypoint_coord3d"], out["hand_scoremap"]
"""

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch
import torch.nn.functional as F

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.batching import (check_input, chunked_predict,
                                       normalize_images, normalized_on_device,
                                       predict_input, select_serving_outputs,
                                       to_device_normalized, uint8_levels)
from hand3d_tpu_torch.models.cascade import ColorHandPose3D
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.utils import profiling
from hand3d_tpu_torch.weights import load_npz, params_from_jax

__all__ = ["AutoBucketEstimator", "DeviceParams", "DynamicBatcher",
           "HandPoseEstimator", "SnapEstimator", "chunked_predict",
           "normalize_images", "prepare_params", "quantized_device_params",
           "select_serving_outputs"]


QUANTIZE_MODES = (None, "int8", "int8_static")
GRAPH_WARMUP_CALLS = 2  # eager chunks on a side stream before a capture


def prepare_params(params, quantize=None, phase_pack=False,
                   quantize_scope=None, calibration_batches=None,
                   calibrate_fn=None):
    """The inference-time param transforms of the JAX package, on a torch
    tree (``weights.params_from_jax``), shared by the live estimator and
    the exporter.

    ``quantize``: None, "int8" (``ops.quant.quantize_params_int8``: dynamic
    per-sample activation scales) or "int8_static" (static per-input-channel
    scales, calibrated by ``calibrate_fn(params, batch)`` running the float
    model over ``calibration_batches``). ``quantize_scope``: stage names
    (case-insensitive, e.g. {"handsegnet"}) that alone are quantized.
    ``phase_pack``: conv1_2 of HandSegNet and PoseNet in the phase-packed
    layout (``ops.phasepack.phase_pack_params``), after any quantization.
    """
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"quantize must be one of {QUANTIZE_MODES}, got "
                         f"{quantize!r}")
    if quantize is None and quantize_scope:
        raise ValueError("quantize_scope requires quantize='int8'")
    if quantize is not None:
        from hand3d_tpu_torch.ops.quant import (calibrate_act_scales,
                                                quantize_params_int8)

        act = None
        if quantize == "int8_static":
            if calibration_batches is None or calibrate_fn is None:
                raise ValueError("quantize='int8_static' needs "
                                 "calibration_batches and calibrate_fn")
            act = calibrate_act_scales(calibrate_fn, params,
                                       calibration_batches)
        params = quantize_params_int8(
            params, scopes=set(quantize_scope) if quantize_scope else None,
            act_scales=act)
    if phase_pack:
        from hand3d_tpu_torch.ops.phasepack import phase_pack_params

        params = phase_pack_params(params)
    return params


class DeviceParams(dict):
    """A param tree converted by ``weights.params_from_jax`` to ``device``,
    so estimators on that device share it instead of converting again;
    ``quantize`` names the transform applied to it (None: float)."""

    def __init__(self, tree, device, quantize=None):
        super().__init__(tree)
        self.device = device
        self.quantize = quantize


def device_params(params, device):
    """``params`` (a TF-layout numpy tree, or DeviceParams on ``device``) as
    DeviceParams on ``device``."""
    if isinstance(params, DeviceParams):
        if params.device != device:
            raise ValueError(f"params live on {params.device}, not {device}")
        return params
    return DeviceParams(params_from_jax(params, device), device)


def quantized_device_params(params, device, quantize=None,
                            quantize_scope=None, calibration_images=None,
                            left_hand=True, seg_scale=1.0, phase_pack=False):
    """``params`` on ``device`` with ``prepare_params``' transform applied
    once there. For "int8_static" the float cascade runs eagerly on the
    device over ``calibration_images`` ([N, H, W, 3], any dtype
    ``normalize_images`` takes), as one batch. DeviceParams that already
    carry a transform are returned as they are when no other is asked for.
    """
    params = device_params(params, device)
    if quantize is None and not quantize_scope and not phase_pack:
        return params
    if params.quantize is not None:
        raise ValueError(f"params are already quantized ({params.quantize})")
    batches, run = None, None
    if quantize == "int8_static":
        if calibration_images is None:
            raise ValueError("quantize='int8_static' needs calibration_images")
        images = normalize_images(np.asarray(calibration_images))
        side = hand_side_tensor(left_hand, len(images), device)
        net = ColorHandPose3D(seg_scale=seg_scale)
        batches = [torch.from_numpy(images).to(device)]

        def run(p, batch):
            return net.inference(p, batch, side, keypoints_scoremap=False)
    tree = prepare_params(params, quantize, phase_pack, quantize_scope,
                          calibration_batches=batches, calibrate_fn=run)
    mode = quantize if not quantize_scope else (
        f"{quantize} {sorted(quantize_scope)}")
    return DeviceParams(tree, device, mode)


def hand_side_tensor(left_hand, batch_size, device):
    """[batch_size, 2] one-hot hand side: (1, 0) left, (0, 1) right."""
    side = [1.0, 0.0] if left_hand else [0.0, 1.0]
    return torch.tensor([side] * batch_size, device=device)


class HandPoseEstimator:
    """The cascade behind a fixed (batch, height, width) shape on one device.

    Args:
      params: TF-layout param tree (``weights.load_npz`` or
        ``weights.random_params``), or DeviceParams already on ``device``.
      batch_size: images per device batch; the last chunk is zero-padded.
      input_hw: the (H, W) every request must have.
      compute_dtype: None (f32) or "bfloat16", the JAX package's bf16 mode
        (``models.cascade.ColorHandPose3D``).
      left_hand: hand side fed to the lifting nets.
      seg_scale: localization resolution factor in (0, 1].
      device: torch device to run on, e.g. "cuda" or "cpu". On a CUDA device
        the two hand-written kernels run; on the CPU their plain twins.
      quantize: None, "int8" or "int8_static" (``prepare_params``): the
        int8 layers take ``ops.quant``'s path on the device.
      quantize_scope: stage names that alone are quantized, e.g.
        {"handsegnet"}.
      calibration_images: [N, H, W, 3] representative images, required by
        "int8_static": the float cascade runs on them on the device and its
        activation ranges set the static scales.
      mesh: a mesh of any layout (``parallel.make_mesh``,
        ``make_multislice_mesh``): every rank builds the estimator and
        calls ``predict`` with the same images; each computes its rows of
        every padded batch (the ranks of a "model" group the same rows) and
        the outputs are all-gathered, so every rank returns the whole
        answer. The params take the mesh's tensor-parallel layout after any
        ``quantize``. batch_size must divide over the mesh's batch shards.
      phase_pack: conv1_2 phase-packed (``prepare_params``), fused with its
        pool; equal to the plain cascade to float reassociation. The input
        width must be even.

    On CUDA the estimator turns TF32 off first (``precision.exact_f32``):
    the cascade's parity contract is f32. The bf16 mode allows TF32 for its
    rounded convolutions only (``precision.tf32_convs``).

    On a CUDA device without a mesh, whatever the other arguments, the
    first chunk of each frame dtype (uint8; float32 normalized on the host)
    captures the chunk's cascade as a CUDA graph (``_CascadeGraph``), which
    every later chunk of that dtype replays: equal to the cascade launched
    op by op, bit for bit. The graphs share one memory pool and one lock
    (``_GraphPool``): each chunk's copy in, replay and output clones hold
    the lock, so threads calling one estimator take turns there, and the
    pool, as large as one eager chunk's activations and cuDNN workspace at
    their peak, is held as long as the estimator. The buckets of an
    ``AutoBucketEstimator`` share one ``_GraphPool``. On the CPU and on a
    mesh the cascade runs op by op.
    """

    def __init__(self, params, batch_size=16, input_hw=(240, 320),
                 compute_dtype=None, left_hand=True, seg_scale=1.0, *,
                 device, mesh=None, quantize=None, phase_pack=False,
                 quantize_scope=None, calibration_images=None):
        self.mesh = mesh
        self.rows = (0, batch_size)  # this rank's rows of a padded batch
        if mesh is not None:
            n_shards = mesh_lib.batch_shard_count(mesh)
            assert batch_size % n_shards == 0, (
                f"batch_size {batch_size} not divisible by the mesh's "
                f"{n_shards} batch shards (slice x data)")
            self.rows = mesh_lib.shard_rows(mesh, batch_size)
            device = mesh_lib.rank_device(device)
        self.device = precision.exact_f32(device)
        self.net = ColorHandPose3D(compute_dtype=compute_dtype,
                                   seg_scale=seg_scale)
        self.params = quantized_device_params(
            params, self.device, quantize, quantize_scope,
            calibration_images, left_hand, seg_scale, phase_pack)
        if mesh is not None:
            self.params = DeviceParams(
                mesh_lib.shard_params(mesh, self.params), self.device,
                self.params.quantize)
        self.batch_size = batch_size
        self.input_hw = tuple(input_hw)
        self.hand_side = hand_side_tensor(left_hand, self.rows[1],
                                          self.device)
        self.levels = uint8_levels(self.device)
        # {frame dtype: _CascadeGraph} and their pool on a single CUDA
        # device, else None
        self._graphs = self._pool = None
        if self.device.type == "cuda" and mesh is None:
            self._graphs = {}
            self._pool = _GraphPool()

    @classmethod
    def from_npz(cls, path, **kwargs):
        return cls(load_npz(path), **kwargs)

    def _run(self, chunk):
        if self._graphs is not None:
            return self._replay(chunk)
        lo, per = self.rows
        with profiling.span("serving.h2d"):
            image = to_device_normalized(chunk[lo:lo + per], self.levels)
        with profiling.span("serving.launch"), torch.inference_mode():
            out = select_serving_outputs(self.net.inference(
                self.params, image, self.hand_side, keypoints_scoremap=False))
            if self.mesh is not None:
                out = mesh_lib.gather_rows(out, self.mesh)
        return out

    def _replay(self, chunk):
        """``_run`` on a single CUDA device: the chunk copied into the
        static input of its dtype's graph (captured at the first chunk of
        that dtype), the graph replayed and its outputs cloned, all on the
        current stream and under the pool's lock, so that neither the
        next replay nor another thread's chunk overwrites them."""
        pool = self._pool
        with pool.lock:
            graph = self._graphs.get(chunk.dtype)
            if graph is None:
                graph = self._graphs[chunk.dtype] = _CascadeGraph(
                    self, chunk, pool.handle)
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(pool.replayed)
            with profiling.span("serving.h2d"):
                graph.input.copy_(torch.from_numpy(chunk))
            with profiling.span("serving.launch"), torch.inference_mode():
                graph.replay()
                out = {k: v.clone() for k, v in graph.out.items()}
                pool.replayed.record(stream)
        return out

    def warmup(self):
        """Run one batch of uint8 frames ahead of traffic (kernel build,
        cuDNN set-up, the normalize on the device; on one CUDA device the
        capture of the uint8 graph)."""
        self.predict(np.zeros((self.batch_size, *self.input_hw, 3),
                              np.uint8))
        return self

    def predict(self, images, *, normalized=False):
        """images: [N, H, W, 3], uint8 in [0,255] or float in [0,1] or
        mean-subtracted float. Returns a dict of numpy arrays with leading N.
        uint8 frames travel to the device as uint8 and are normalized there,
        chunk by chunk; float frames are normalized on the host first.
        ``normalized=True`` says the caller already ran normalize_images (the
        [0, 1]-range rule must run only once)."""
        images = predict_input(images, normalized)
        check_input(images, self.input_hw)
        return chunked_predict(self._run, images, self.batch_size)


class _GraphPool:
    """What the cascade graphs of one or more single-device estimators
    share: one memory pool (``handle``), the lock that each chunk's copy
    in, replay and output clones hold, and the event after the latest
    clones. Sharing is safe because two of the graphs never replay at once
    and each replay's outputs are cloned before the next replay, whichever
    graph that is."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.replayed = torch.cuda.Event()


class _CascadeGraph:
    """One chunk of a single-device CUDA ``HandPoseEstimator`` captured as a
    CUDA graph over a static input of one dtype: uint8 frames, looked up in
    the estimator's ``levels`` inside the graph, or float32 frames.

    ``GRAPH_WARMUP_CALLS`` eager chunks on a side stream come first (cuDNN's
    plans, the kernels' build, the cascade's device constants); entering
    ``torch.cuda.graph`` synchronizes and releases their cached blocks, so
    the graph's pool does not sit beside a second copy of the activations
    and cuDNN's workspace. The capture holds only this thread to its rules:
    the server's and the input pipeline's threads may call CUDA meanwhile.
    ``pool`` is the handle of the ``_GraphPool`` that the graph shares.

    The two kernels' bindings count a launch (``kernels.*.launches``) where
    the capture records it, once; a replay runs the recorded kernels
    without entering them, and counts ``serving.graph.replays``."""

    def __init__(self, est, chunk, pool):
        dev = est.device
        host = torch.from_numpy(chunk)
        self.input = torch.zeros(host.shape, dtype=host.dtype, device=dev)

        def body():
            with torch.inference_mode():
                return select_serving_outputs(est.net.inference(
                    est.params, normalized_on_device(self.input, est.levels),
                    est.hand_side, keypoints_scoremap=False))

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP_CALLS):
                body()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            self.out = body()
        profiling.count("serving.graph.captures")

    def replay(self):
        self.graph.replay()
        profiling.count("serving.graph.replays")


def _resize_to(images, target_hw, device="cpu"):
    """Bilinear resize of [N, H, W, 3] float32 ``images`` into
    ``target_hw`` on ``device``; numpy out.

    Half-pixel centers, antialiased where it shrinks: what
    ``jax.image.resize(..., "bilinear")`` computes, to ~1e-7. Without
    ``antialias`` a 480x640 -> 240x320 shrink differs from it by ~0.3.
    """
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    x = x.to(device).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(target_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def _map_back(out, hw, target_hw):
    """Map pixel-space outputs from the bucket frame ``target_hw`` back to
    the caller's frame ``hw``: keypoint_uv21 is (u, v), center is (row,
    col). hand_scoremap and scale_crop stay in the bucket frame (a scalar
    crop scale cannot survive an anisotropic resize); the ``snap_hw``
    output records that frame."""
    scale_uv = np.asarray([hw[1] / target_hw[1], hw[0] / target_hw[0]],
                          np.float32)
    out["keypoint_uv21"] = out["keypoint_uv21"] * scale_uv
    out["center"] = out["center"] * scale_uv[::-1]
    return out


def _snapped_predict(est, target, images, normalized, device):
    """``est.predict`` on ``images`` resized to ``target``, with uv and
    center mapped back and ``snap_hw`` added. Frames already at ``target``
    go to ``est.predict`` as they came (uint8 is normalized on the device);
    frames to resize are normalized on the host first, and resized in
    float."""
    hw = tuple(images.shape[1:3])
    if target == hw:
        out = est.predict(images, normalized=normalized)
    else:
        if not normalized:
            images = normalize_images(images)
        out = _map_back(est.predict(_resize_to(images, target, device),
                                    normalized=True), hw, target)
    out["snap_hw"] = np.asarray(target, np.int32)
    return out


class SnapEstimator:
    """Wrap a single fixed-resolution estimator (e.g. an
    ``export.ExportedEstimator``, whose program is baked at one (H, W)):
    any-resolution inputs are resized to its bucket on its device and
    keypoint_uv21/center mapped back to the caller's frame — the same
    contract AutoBucketEstimator provides for live weights. Frames it
    resizes are normalized on the host first; frames already at the bucket
    go to the estimator as they came."""

    def __init__(self, estimator):
        self.est = estimator
        self.batch_size = estimator.batch_size
        self.input_hw = tuple(estimator.input_hw)
        self.device = getattr(estimator, "device", torch.device("cpu"))

    def predict(self, images, *, normalized=False):
        return _snapped_predict(self.est, self.input_hw, np.asarray(images),
                                normalized, self.device)


class AutoBucketEstimator:
    """Serving across mixed input resolutions: one estimator per observed
    (height, width), built lazily and cached; all share one copy of the
    params on the device.

    ``max_buckets`` bounds the buckets (each holds its cuDNN plans and
    warm-up; on one CUDA card each its graphs, all in one shared pool).
    With ``snap_hws`` the input is first bilinearly resized on the
    device to the nearest configured bucket — keypoint_uv21 and center are
    then mapped back to the caller's frame. hand_scoremap and scale_crop
    remain in the bucket's frame (a scalar crop scale cannot survive an
    anisotropic resize); the ``snap_hw`` output records that frame. Frames
    it resizes are normalized on the host first; frames already at their
    bucket go to it as they came.

    All other constructor kwargs pass through to HandPoseEstimator (``mesh``
    among them: every bucket then spreads its batches over the ranks); the
    param transforms (``quantize``, ``quantize_scope``,
    ``calibration_images``, ``phase_pack``) are applied here, once, to the
    params the buckets share.
    """

    def __init__(self, params, batch_size=16, snap_hws=None, max_buckets=8,
                 *, device, quantize=None, quantize_scope=None,
                 calibration_images=None, phase_pack=False, **kwargs):
        mesh = kwargs.get("mesh")
        if mesh is not None:
            device = mesh_lib.rank_device(device)
        self.device = precision.exact_f32(device)
        self.params = quantized_device_params(
            params, self.device, quantize, quantize_scope,
            calibration_images, kwargs.get("left_hand", True),
            kwargs.get("seg_scale", 1.0), phase_pack)
        if mesh is not None:  # sharded once, for every bucket
            self.params = DeviceParams(
                mesh_lib.shard_params(mesh, self.params), self.device,
                self.params.quantize)
        self.batch_size = batch_size
        self.kwargs = kwargs
        self.snap_hws = [tuple(hw) for hw in snap_hws] if snap_hws else None
        self.max_buckets = max_buckets
        self._buckets = {}
        self._pool = None  # the buckets' graphs' _GraphPool, on one card

    def _bucket(self, hw):
        est = self._buckets.get(hw)
        if est is None:
            if len(self._buckets) >= self.max_buckets:
                raise RuntimeError(
                    f"over {self.max_buckets} resolution buckets "
                    f"(adding {hw}); pass snap_hws to pool resolutions or "
                    "raise max_buckets")
            est = HandPoseEstimator(self.params, batch_size=self.batch_size,
                                    input_hw=hw, device=self.device,
                                    **self.kwargs)
            if est._pool is not None:
                self._pool = est._pool = self._pool or est._pool
            self._buckets[hw] = est
        return est

    def _snap(self, hw):
        if self.snap_hws is None or hw in self.snap_hws:
            return hw
        # nearest by log-area + aspect distance; exact matches win
        h, w = hw

        def dist(b):
            bh, bw = b
            return abs(np.log(bh * bw / (h * w))) + abs(
                np.log((bh / bw) / (h / w)))

        return min(self.snap_hws, key=dist)

    def predict(self, images, *, normalized=False):
        """Same contract as HandPoseEstimator.predict, any resolution."""
        images = np.asarray(images)
        target = self._snap(tuple(images.shape[1:3]))
        return _snapped_predict(self._bucket(target), target, images,
                                normalized, self.device)


class DynamicBatcher:
    """Aggregate CONCURRENT predict() calls into one device batch.

    Callers from many threads each submit a few images; a single batcher
    thread drains the queue, coalesces up to ``max_batch`` images — waiting
    at most ``max_wait_ms`` for stragglers after the first arrival — runs
    ONE predict on the wrapped estimator, and scatters the results back.
    Under load the device sees full batches; an isolated request pays at
    most max_wait_ms extra latency. Only the batcher thread touches the
    card.

    Wraps any estimator with the predict() contract (HandPoseEstimator,
    AutoBucketEstimator, SnapEstimator, ExportedEstimator). Requests whose
    (H, W) differ are batched separately (shapes must agree within one
    device batch).
    """

    def __init__(self, estimator, max_batch=None, max_wait_ms=5.0):
        self.est = estimator
        self.max_batch = max_batch or getattr(estimator, "batch_size", 8)
        self.max_wait = max_wait_ms / 1000.0
        self._q = queue.Queue()
        self._stop = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dynamic-batcher")
        self._thread.start()

    def close(self):
        """Stop accepting new requests, finish everything already queued,
        then stop the batcher thread. Idempotent."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
        self._q.put(None)  # shutdown token: drained strictly after all
        # requests enqueued before close() (predict holds _lock, so no
        # request can slip in after _stop is set)
        self._thread.join(timeout=30)

    def predict(self, images):
        """Same contract as the wrapped estimator; thread-safe. Raises
        RuntimeError after close(). Each request is normalized on the host,
        here, before the batcher thread coalesces it."""
        images = normalize_images(images)
        fut = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("DynamicBatcher is closed")
            put = time.perf_counter_ns()
            self._q.put((images, fut))
        out = fut.result()
        profiling.record("batcher.queue_wait", put, fut.collected_ns)
        return out

    def _collect(self, first):
        """Coalesce requests: same-(H,W) items totalling at most max_batch
        images, waiting at most max_wait for more after the first arrival.
        Items that don't fit this batch (other resolution, or would
        overflow max_batch) are re-queued for the next round."""
        items = [first]
        hw = first[0].shape[1:3]
        total = first[0].shape[0]
        deadline = time.monotonic() + self.max_wait
        put_back = []
        saw_stop = False
        while total < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                saw_stop = True
                break
            n = item[0].shape[0]
            if item[0].shape[1:3] != hw:
                put_back.append(item)  # different bucket: next round
                continue
            if total + n > self.max_batch:
                put_back.append(item)  # would overflow: next round
                break  # this batch is as full as it gets
            items.append(item)
            total += n
        for item in put_back:
            self._q.put(item)
        if saw_stop:
            # re-queue the shutdown token BEHIND the put-back items so the
            # loop still processes them before exiting
            self._q.put(None)
        return items

    def _loop(self):
        draining = False
        try:
            while True:
                if draining:
                    # shutdown token seen: finish whatever is still queued
                    # (e.g. put-back items re-queued behind the token),
                    # then exit
                    try:
                        first = self._q.get_nowait()
                    except queue.Empty:
                        return
                else:
                    first = self._q.get()
                if first is None:
                    draining = True
                    continue
                items = self._collect(first)
                collected = time.perf_counter_ns()
                for _, fut in items:
                    fut.collected_ns = collected
                profiling.count("batcher.batches")
                profiling.count("batcher.images",
                                sum(im.shape[0] for im, _ in items))
                try:
                    batch = np.concatenate([im for im, _ in items])
                    out = self.est.predict(batch, normalized=True)
                    start = 0
                    for im, fut in items:
                        n = im.shape[0]
                        fut.set_result(
                            {k: v[start:start + n] for k, v in out.items()
                             if k != "snap_hw"}
                            | ({"snap_hw": out["snap_hw"]}
                               if "snap_hw" in out else {}))
                        start += n
                except Exception as e:
                    for _, fut in items:
                        if not fut.done():
                            fut.set_exception(e)
        finally:
            # fail anything still queued so no caller blocks forever
            # (normally empty: close() guarantees the token drains last)
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None and not item[1].done():
                    item[1].set_exception(
                        RuntimeError("DynamicBatcher closed"))
