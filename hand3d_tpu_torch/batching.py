"""The predict() contract shared by the live estimators (``serving``) and a
loaded export artifact (``export.ExportedEstimator``): input normalization,
the served outputs and fixed-size chunking. It imports no model code, so an
artifact is served without it.
"""

import numpy as np


def normalize_images(images):
    """[N,H,W,3] uint8 in [0,255] / float in [0,1] / mean-subtracted float
    -> mean-subtracted float32 (the cascade's input convention)."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0 - 0.5
    elif images.min() >= 0.0 and images.max() <= 1.0:
        images = images.astype(np.float32) - 0.5
    return images.astype(np.float32, copy=False)


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
    """Chunk ``images`` into fixed-size batches (zero-padding the last),
    launch EVERY chunk before fetching any result, then trim and concatenate.

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
