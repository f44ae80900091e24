"""hand3d_tpu_torch — the PyTorch / CUDA port of hand3d_tpu for one NVIDIA H100.

The cascade of ColorHandPose3D (HandSegNet -> single-blob mask -> bbox ->
256x256 crop -> PoseNet -> PosePrior/ViewpointNet lifting -> keypoint
decode), its serving front and its evaluation path, in eager PyTorch.
Module names follow ``hand3d_tpu`` so each counterpart is easy to find;
public functions keep its layouts (NHWC images, [B, K, 2] (row, col)
keypoints) while convolutions run NCHW inside.

The two Pallas kernels of the JAX package are hand-written CUDA C++ here
(``csrc/floodfill.cu``, ``csrc/decode.cu``), built with nvcc for sm_90a at
first use (``ops/kernels``) and registered as the ops
``torch.ops.hand3d.flood_fill`` and ``torch.ops.hand3d.decode_upsampled``.
A CUDA tensor goes through the kernel; a CPU tensor goes through its plain
PyTorch twin. The package never imports jax.

Package layout:
  precision.py exact f32 on the card (TF32 off), called by every entry point
  weights.py   npz reader, TF-layout -> torch conversion, seeded random init
  ops/         nn, image, segmentation, keypoints, numerics, rotations,
               canonical, kinematics
  ops/kernels  nvcc build + ctypes bindings of the CUDA kernels
  models/      HandSegNet, PoseNet, PosePrior/ViewpointNet and the five
               lifting variants, the cascade (seg_scale, soft-argmax,
               inference2d)
  data/        RHD / STB record codecs and readers, on-device preprocessing
  eval/        EPE / PCK / AUC metrics and the five eval harnesses
  train/       losses, Adam on the reference schedule, snapshots, fit loop
  utils/       metrics logging, hand skeleton plots (viz)
  cli/         eval2d_gt_cropped, eval2d, eval3d, eval_full, the four
               train_* trainers, serve (HTTP), export_model, demo
  batching.py  the predict() contract: normalize, chunk and pad
  serving.py   HandPoseEstimator (f32 / bf16), SnapEstimator,
               AutoBucketEstimator, DynamicBatcher
  export.py    torch.export artifacts (H3DX container), ExportedEstimator
  parity.py    flip-aware cascade comparison shared by tests and chip_smoke
"""

__version__ = "0.1.0"
