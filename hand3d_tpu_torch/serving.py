"""Serving API: a padded-batch, fixed-shape hand-pose estimator (counterpart
of hand3d_tpu/serving.py, float path).

Example:
    est = HandPoseEstimator.from_npz("weights.npz", batch_size=32,
                                     device="cuda")
    out = est.predict(images)          # [N, H, W, 3] uint8 or float
    out["keypoint_uv21"], out["keypoint_coord3d"], out["hand_scoremap"]
"""

import numpy as np
import torch

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.models.cascade import ColorHandPose3D
from hand3d_tpu_torch.weights import load_npz, params_from_jax


def select_serving_outputs(out):
    """The served subset of a CascadeOutput."""
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


def normalize_images(images):
    """[N,H,W,3] uint8 in [0,255] / float in [0,1] / mean-subtracted float
    -> mean-subtracted float32 (the cascade's input convention)."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0 - 0.5
    elif images.min() >= 0.0 and images.max() <= 1.0:
        images = images.astype(np.float32) - 0.5
    return images.astype(np.float32, copy=False)


class HandPoseEstimator:
    """The cascade behind a fixed (batch, height, width) shape on one device.

    Args:
      params: TF-layout param tree (``weights.load_npz`` or
        ``weights.random_params``).
      batch_size: images per device batch; the last chunk is zero-padded.
      input_hw: the (H, W) every request must have.
      left_hand: hand side fed to the lifting nets.
      device: torch device to run on, e.g. "cuda" or "cpu". On a CUDA device
        the two hand-written kernels run; on the CPU their plain twins.

    On CUDA the estimator turns TF32 off first (``precision.exact_f32``):
    the cascade's parity contract is f32.
    """

    def __init__(self, params, batch_size=16, input_hw=(240, 320),
                 left_hand=True, *, device):
        self.device = precision.exact_f32(device)
        self.net = ColorHandPose3D()
        self.params = params_from_jax(params, self.device)
        self.batch_size = batch_size
        self.input_hw = tuple(input_hw)
        side = [1.0, 0.0] if left_hand else [0.0, 1.0]
        self.hand_side = torch.tensor([side] * batch_size, device=self.device)

    @classmethod
    def from_npz(cls, path, **kwargs):
        return cls(load_npz(path), **kwargs)

    def _run(self, chunk):
        image = torch.from_numpy(chunk).to(self.device)
        with torch.inference_mode():
            out = self.net.inference(self.params, image, self.hand_side,
                                     keypoints_scoremap=False)
        return select_serving_outputs(out)

    def warmup(self):
        """Run one batch ahead of traffic (kernel build, cuDNN set-up)."""
        self.predict(np.zeros((self.batch_size, *self.input_hw, 3),
                              np.float32), normalized=True)
        return self

    def predict(self, images, *, normalized=False):
        """images: [N, H, W, 3], uint8 in [0,255] or float in [0,1] or
        mean-subtracted float. Returns a dict of numpy arrays with leading N.
        ``normalized=True`` says the caller already ran normalize_images."""
        images = np.asarray(images) if normalized else normalize_images(images)
        if images.ndim != 4 or images.shape[1:] != (*self.input_hw, 3):
            raise ValueError(f"expected [N, {self.input_hw[0]}, "
                             f"{self.input_hw[1]}, 3] images, got "
                             f"{images.shape}")
        return chunked_predict(self._run, images.astype(np.float32, copy=False),
                               self.batch_size)
