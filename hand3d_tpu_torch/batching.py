"""The predict() contract shared by the live estimators (``serving``) and a
loaded export artifact (``export.ExportedEstimator``): input normalization,
the served outputs and fixed-size chunking. It imports no model code, so an
artifact is served without it. Its spans: ``serving.normalize`` and
``serving.fetch`` (``utils.profiling``).

Where frames are normalized: ``predict`` keeps uint8 frames uint8 through
the chunking, and each chunk is copied to the device as uint8 and
normalized there (``to_device_normalized``), bit-equal to
``normalize_images``. Float frames are normalized on the host, since the
[0, 1]-range rule needs the whole call's min and max. ``SnapEstimator`` and
``AutoBucketEstimator`` normalize on the host the frames they resize, and
``DynamicBatcher`` every request before it coalesces them.
"""

import numpy as np
import torch

from hand3d_tpu_torch.utils import profiling


def _normalized(images):
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0 - 0.5
    elif images.min() >= 0.0 and images.max() <= 1.0:
        images = images.astype(np.float32) - 0.5
    return images.astype(np.float32, copy=False)


def normalize_images(images):
    """[N,H,W,3] uint8 in [0,255] / float in [0,1] / mean-subtracted float
    -> mean-subtracted float32 (the cascade's input convention), on the
    host."""
    with profiling.span("serving.normalize"):
        return _normalized(np.asarray(images))


def predict_input(images, normalized=False):
    """``images`` as ``predict`` chunks them: uint8 stays uint8, each chunk
    to be normalized on the device (``to_device_normalized``); float goes
    through ``normalize_images``' rule on the host, unless ``normalized``
    says the caller ran it already. The span ``serving.normalize`` holds the
    host's part: the dtype check, and the float path's numpy work."""
    images = np.asarray(images)
    if normalized:
        return images.astype(np.float32, copy=False)
    with profiling.span("serving.normalize"):
        return images if images.dtype == np.uint8 else _normalized(images)


def uint8_levels(device):
    """``normalize_images``' float32 for each of the 256 uint8 values, on
    ``device``: the table ``to_device_normalized`` looks uint8 frames up
    in."""
    return torch.from_numpy(
        _normalized(np.arange(256, dtype=np.uint8))).to(device)


def to_device_normalized(chunk, levels):
    """A chunk of ``predict_input`` on ``levels.device`` as the cascade's
    float32 input. Float is copied as it is. uint8 is copied as uint8, a
    quarter of the bytes, and looked up in ``levels`` (``uint8_levels``)
    there, so it is bit-equal to ``normalize_images``: a CUDA ``x / 255.0``
    multiplies by the reciprocal, which differs from the quotient in 111 of
    the 256 values."""
    return normalized_on_device(torch.from_numpy(chunk).to(levels.device),
                                levels)


def normalized_on_device(x, levels):
    """``to_device_normalized``'s part on the device: ``x``, a chunk already
    on ``levels.device``, as the cascade's float32 input (uint8 looked up in
    ``levels``, float as it is)."""
    return levels[x.long()] if x.dtype == torch.uint8 else x


def select_serving_outputs(out):
    """The served subset of a CascadeOutput: one definition for the live
    estimator and the exported program."""
    return {
        "keypoint_coord3d": out.keypoint_coord3d,
        "keypoint_uv21": out.keypoint_uv21,
        "hand_scoremap": out.hand_scoremap,
        "scale_crop": out.scale_crop,
        "center": out.center,
    }


def chunked_predict(run_chunk, images, batch_size):
    """Chunk ``images`` into fixed-size batches (zero-padding the last, in
    the images' dtype: each row's answer depends on its own image only and
    padded rows are trimmed), launch EVERY chunk before fetching any result,
    then trim and concatenate (the span ``serving.fetch``: the wait for the
    device, the copies out and the concatenation).

    CUDA launches are asynchronous, so chunk i's device work overlaps chunk
    i+1's host-side padding and copy; the first device -> host copy waits.
    ``run_chunk(padded_chunk) -> dict of tensors``.
    """
    n = images.shape[0]
    if n == 0:
        raise ValueError("predict() needs at least one image")
    pending = []
    for start in range(0, n, batch_size):
        chunk = images[start:start + batch_size]
        valid = chunk.shape[0]
        if valid < batch_size:
            pad = np.zeros((batch_size - valid, *chunk.shape[1:]), chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        pending.append((run_chunk(chunk), valid))
    with profiling.span("serving.fetch"):
        outs = [{k: v[:valid].cpu().numpy() for k, v in out.items()}
                for out, valid in pending]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def check_input(images, input_hw):
    """Raise unless ``images`` is [N, H, W, 3] at ``input_hw``."""
    if images.ndim != 4 or images.shape[1:] != (*input_hw, 3):
        raise ValueError(f"expected [N, {input_hw[0]}, {input_hw[1]}, 3] "
                         f"images, got {images.shape}; resize on the client "
                         "or serve through SnapEstimator / "
                         "AutoBucketEstimator")
