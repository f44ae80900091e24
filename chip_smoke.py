"""Drive the PyTorch port (hand3d_tpu_torch) once on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --mesh-cards N`` runs the device, build, mesh,
parallel and scaling phases alone, with one NCCL rank on each of N cards
instead of gloo ranks on one.

Phases, in order; any failure raises and exits non-zero before the result
line is printed:

1. device: nvidia-smi's name and power limit, torch and CUDA versions,
   which of the modules an Orbax reader and the tools could use import;
   a CUDA device is required;
2. build: both CUDA kernels compiled from csrc/ with nvcc (sm_90a);
3. kernel parity: each kernel against its plain PyTorch twin, bit for bit,
   on synthetic masks and scoremaps at the cascade's shapes, at batches 1,
   8, 32 and 128 (the flood fill spreads an image over a thread-block
   cluster at small batch and runs one CTA an image at 128): blobs across
   band boundaries, seeds on the first and last rows and off the image, a
   serpentine that stops at num_passes, NaN, -0.0 / +0.0 ties and ties
   between far rows in the decode;
4. slice: HandPoseEstimator at full width (random weights from a seed) on
   240x320 images answers three requests; both kernels must have run on
   the card (its device trace: the estimator replays a CUDA graph, which
   the bindings' launch counters do not see);
   the kernels must equal their twins on the slice's own tensors; the card's
   outputs are held to the port's CPU run (plain twins) by the flip-aware
   comparison of hand3d_tpu_torch.parity;
5. times: CUDA-event times of the served slice and of each kernel beside its
   twin and its bound at batches 1, 32 and 128, and of the flood fill on two
   fixed masks (a hand-sized blob, a serpentine that runs every pass); at
   batch 1 the host time of each registered op (torch.ops.hand3d.*) beside
   its binding called directly, and batch-1 predicts through the ops and
   through the bindings, alternating: what the op dispatch costs;
6. serve: AutoBucketEstimator with one 240x320 bucket on 480x640 and 300x500
   uint8 frames, resized on the card (held to the CPU's resize within
   RESIZE_ATOL), each answer equal to the bucket's cascade mapped back to
   the caller's frame, that cascade held flip-aware to the port's CPU run;
   DynamicBatcher over a batch-8 estimator, 32 one-image requests from 16
   threads in fewer device batches, each answer equal to its row of a direct
   predict of its batch; both kernels run on the card in a request of each
   (its device trace); cli.serve's HTTP server in front of the batcher
   (.npy POSTs from 4 threads, a 500, /healthz, /metrics) and the one-image
   round trip through it and through a batch-1 server (median of 20; with
   predict on the server's device thread and on each request's own handler
   thread);
7. export: export_estimator at batch 8 on the card, loaded in a child
   process that imports only hand3d_tpu_torch.export: both kernels launch
   there, no model module is imported, the answers equal the live
   estimator's bit for bit;
8. bf16: HandPoseEstimator(compute_dtype="bfloat16") at batches 1, 32 and
   128 beside f32's frames/s, its cascade held flip-aware to the port's bf16
   CPU run (BF16_* bounds), each of its 59 convs to the CPU's f32 conv of the
   same bf16-rounded operands (TF32 multiplies them exactly), TF32 off
   afterwards;
9. eval: synthetic RHD (320x320) and STB (480x640) files in the reference's
   record layouts go through the five eval harnesses at their CLI batch
   sizes (eval2d_full_image with both scale_to_size settings, eval3d_lifting
   for all five variants). Each harness is called once to warm up, then
   once more, timed by CUDA events, with its kernel launches counted and its
   per-sample dists recorded; metrics must be finite, the kernels must have
   launched where the harness runs them, and TF32 must stay off. The dists
   of the first batch's first 4 records are held to the port's CPU run of
   the same records, flip-aware for the cascade harnesses. One harness call
   per harness (one lifting variant) is also timed over a longer file: 10
   or 20 batches,
   and its steady-state pace read from the drains of batches inside the
   streaming loop (each right after a launch). The cascade with seg_scale=0.5 and with the soft-argmax decoder is
   held to the CPU run, and the flood-fill kernel to its twin, bit for bit,
   on the 120x160 maps that seg_scale=0.5 makes;
10. train: the four trainers' CLIs (train_posenet, train_handsegnet,
   train_lifting proposed, train_joint proposed) each run 20 steps on a
   synthetic 64-record RHD file at full width (batch 8, 256x256 crops, the
   reference LR defaults, seeded random weights) with a metrics log and a
   snapshot directory, every step timed by CUDA events; train_posenet also
   evaluates in training (eval2d_gt_cropped, twice, 2 batches), which must
   launch the decode kernel, bit-equal to its twin on those scoremaps. Step
   0 of each stage is held to the port's CPU run of the same params, batch
   and noise (kink-aware bounds, see TRAIN_FLIP_RTOL_OF_MAX), and the
   card's gradients to the same step in float64 on the CPU that takes the
   card's choice at every leaky ReLU and max pool, with the choices float64
   would have made otherwise counted and required near their kink; the
   card's Adam, over 3 steps with a new LR at each, is held to Adam
   written out in float64 and fed the card's gradients; 20 steps on one
   repeated batch must lower the PoseNet and lifting losses; 3 steps +
   --resume 3 must equal 6 straight train_posenet steps bit for bit under
   deterministic algorithms, in a child process with
   CUBLAS_WORKSPACE_CONFIG set (the other phases run without it); a
   torch.profiler window of 3 PoseNet steps gives the conv and idle shares.
   TF32 must stay off;
11. train_resident: train_posenet's device-resident path on phase 10's file
   (re-made from its seed): 20 steps at --steps-per-call 7 (windows 7, 7, 6
   of replays of one captured CUDA graph; in-training evals at the window
   boundaries 14 and 20), 20 replays, step 0's loss equal to phase 10's
   per-step run bit for bit, the final params held to its within
   RESIDENT_SPREAD times a second per-step run's distance from it (at
   least RESIDENT_PARAM_REL_L2); 8 steps at --steps-per-call 4 across the
   LR boundary at 5, the LR the device took at each step equal to the
   schedule, the params held to the per-step run of the same flags; 3 + --resume 3 == 6 straight steps
   at --steps-per-call 2, bit for bit, in the deterministic child process;
   ms a step by window (CUDA events) beside phase 10's median; a
   torch.profiler window of one resident window (idle share, host waits)
   beside phase 10's; --remat none / True / dots_saveable /
   dots_with_no_batch_dims_saveable: peak memory and ms a step over 3
   steps, step 0's gradients within REMAT_GRAD_RTOL_OF_MAX of no remat's,
   and the same four on the resident path (ms a step over a window, peak
   memory with the capture);
   the file through the C++ streamer (InputPipeline(use_native=True)), each
   batch equal to the memmap's records at the streamer's indices, and the
   records/s of the native and the threaded pipeline;
12. weights: the slice's tree written in the reference's formats,
   handsegnet-rhd.pickle and posenet3d-rhd-stb.pickle (names with ':0') and
   a CPM-MPII-shaped TF checkpoint (Adam slots, beta powers, global_step),
   each loaded through cli._common.load_weight_trees: every array equal to
   its source bit for bit, the warm-start rules taking exactly the layers
   they should, every seeded layer outside the file keeping its value;
   cli.eval2d on the pickles over a synthetic RHD file, both kernels
   launched, its decoded keypoints and distances equal to the run on the
   .npz of the same tree, each decode equal to its twin; 3 steps of
   train_posenet warm-started from the checkpoint, step 0 holding the
   checkpoint's PoseNet2D layers and the trainer's seeded others, its
   in-training eval launching the decode kernel;
13. quant: the int8, int8_static (scales calibrated on the card by
   HandPoseEstimator's own path on 8 other frames) and int8_seg trees
   quantized on the card equal to the CPU's bit for bit; every int8 conv of
   the int8 cascade on 8 frames: its accumulator (TF32 tensor cores over
   integer operands) equal to F.conv2d in float64 of the same operands at
   every element below 2**24; each mode's cascade held flip-aware to the
   port's CPU run of the same tree (INT8_* bounds), both kernels held to
   their twins on its inputs; HandPoseEstimator(quantize="int8") equal to
   the cascade and an exported int8 artifact, loaded in a child process,
   equal to the estimator bit for bit, its bytes beside f32's; frames/s of
   each mode at batches 1, 32 and 128 beside f32's and bf16's;
   train_posenet --qat on phase 10's file: step 0 held to the CPU
   kink-aware (the fake quantizers' grid steps that differ counted), 8
   steps per step twice and at --steps-per-call 4, the resident run's step
   0 loss equal to the per-step run's and its params within RESIDENT_SPREAD
   times the card's own per-step spread;
14. mesh: data parallelism over torch.distributed ranks, in child processes
   of this script. Two gloo ranks share the card (NCCL refuses two ranks on
   one GPU): 3 data-parallel train_posenet steps at full width, global
   batch 8 (4 a rank, fed by the CLI's sharded pipeline), the ranks
   bit-equal after every step, each step held to one process's step on the
   gathered global batch at the same params and draws (loss within
   MESH_LOSS_RTOL, gradients within the TRAIN_* kink-aware bounds), with
   ms a step and the all-reduce bytes counted; cli.eval_full --mesh 2x1 on
   a synthetic RHD file, the ranks' metrics equal and held to one
   process's (equal, or within parity.check_cascade's flip rules where the
   card's algorithms at 4 rows differ from 8); HandPoseEstimator(mesh=) at
   batch 8, each rank's answers held to one process's by check_cascade and
   both kernels held to their twins on each rank's rows. One NCCL rank
   (torchrun's variables set here): train_posenet --mesh 1x1
   --deterministic equal to the run without a mesh bit for bit, and ms a
   mesh step against a plain one;
15. parallel: the JAX package's multichip dry run (__graft_entry__.py
   dryrun_multichip) on ranks, in child processes of this script: two gloo
   ranks share the card (on N cards one NCCL rank each). (a) 3 DP x TP
   train steps (1x2; 2x2 and the multislice 2x1x2 on four cards) of the
   whole cascade under the reference's three losses combined, at full
   width on 128x128 images and crops, batch 8: the ranks bit-equal after
   every step, the wide layers split over "model" on every rank, step 0
   held to one process's step on the global batch at the same params and
   draws (MESH_LOSS_RTOL, the TRAIN_* kink-aware bounds), ms a step beside
   one process's plain step and the bytes each collective moved; (b) an SP
   grad step of HandSegNet at 240x320 (1x2; 1x4 at 256x320 on four cards),
   held to one process the same way, with the plain tree and with conv1_2
   phase-packed; (c) a GPipe train step of PoseNet at
   256x256 (data x stage 2, 2 microbatches), loss and gradients held to the
   sequential loss's, the forward ticks timed beside the bubble fraction;
   (d) an EP grad step of the MoE layer (4 experts, 64 -> 32), held to the
   reference on each rank's tokens; (e) HandPoseEstimator(mesh=) at 240x320,
   batch 8, f32 and int8, each rank's answers held to one process by
   check_cascade, both kernels launched on every rank and equal to their
   twins on that rank's tensors; (f) train_posenet through loop.fit at full
   width with --mesh Dx2 for 2 steps (rank 0's params broadcast to every
   rank, the state sharded, each snapshot gathered whole), rank 0's
   snapshot equal to the gathered state bit for bit, then --resume from it
   on (2D)x1 for one more step, the ranks bit-equal after each run;
16. phase_pack: conv1_2 of HandSegNet and PoseNet phase-packed
   (ops.phasepack) at 240x320: the tree packed on the card equal to the
   CPU's packing of the TF-layout tree; the fused conv + ReLU + pool held
   to the plain layer (PACK_LAYER_*) and timed at batches 1 and 32; the
   packed f32 and int8_seg_pp (HandSegNet int8, then packed) cascades held
   flip-aware to the plain f32 and int8_seg ones on the card, both kernels
   to their twins on the packed cascades' inputs;
   HandPoseEstimator(phase_pack=True) equal to the packed cascade and an
   export with phase_pack=True (its header saying so), loaded in a child
   process, equal to it bit for bit; frames/s of f32, f32 packed, int8_seg
   and int8_seg_pp at batches 1 and 32, timed in alternating rounds, with
   the card's name and power limit;
17. tools: hand3d_tpu_torch.tools.create_binary_db on PNG fixtures of the
   RHD layout (PIL), read back by the port's RHD reader equal to the PNGs
   and annotations; run_baseline_parity's drill, all 13 BASELINE rows
   judged over synthetic RHD and STB files, reference-format pickles and
   retrained snapshots through the four harnesses on the card; bench_input
   (the C++ streamer and memmap, records/s beside the resident PoseNet
   step); release_check with its preset step alone, its record stamped with
   nvidia-smi's line;
18. orbax: (a) train_posenet at full width (batch 8, 256x256 crops) for 2
   steps on the card, save_orbax, restore_orbax into a fresh template on
   the card: every param, Adam moment and count bit-equal, and one more
   step from the original and from the restored state bit-equal, under
   deterministic algorithms in a child process (CUBLAS_WORKSPACE_CONFIG),
   with the checkpoint's bytes and the save and restore seconds; (b) the
   JAX-made checkpoint of tests/torch_fixtures/orbax_jax (OCDBT, zstd,
   Huffman-coded blocks) restored into a template on the card, every leaf
   equal to its .npz bit for bit, the zstd decoder's MB/s over its chunks
   and the restore time that rate implies for (a)'s bytes (derived);
19. measure: the three measuring tools through their entry points
   (hand3d_tpu_torch.tools.profile_stages, memory_report, roofline) at full
   width on the card: profile_stages at 240x320 for f32 at batches 1, 32
   and 128, bf16 at 32 and 128 and int8 (f32 otherwise) at 1, every stage's
   time finite and positive, the flood-fill kernel launched in the three
   mask stages and the FULL cascade and nowhere else, the decode kernel in
   decode_upsampled and the FULL cascade and nowhere else, the FULL
   cascade's frames/s beside phase 5's; memory_report's default rows, each
   peak split into the tensors live at it and the scratch of the op it
   falls in, the batch-8 PoseNet step's temp and its tensors' peak falling
   from accum 1 to 2 to 4; roofline with the card's measured effective
   rates (the device kernels of each reference shape named), f32 at
   batches 1, 32 and 128 with --glue-ms from
   profile_stages' crop_from_scoremap (flood fill, box and crop) and
   decode_upsampled stages, its ms a frame at most the measured FULL
   cascade's at the same batch (bf16 and int8 printed beside it); each
   kernel's launches in one ColorHandPose3D.inference at batches 1 and 32;
20. scaling: the scaling record (hand3d_tpu_torch.tools.scaling_record),
   data-parallel weak scaling of the full-width PoseNet train step at
   per-device batch 2: its measure() at 32x32 crops on n = 1, 2 gloo ranks
   sharing the card and at the 256x256 training crop on one rank, 5 steps
   each (under --mesh-cards N, its CLI at its defaults on the first N
   cards, one NCCL rank a card, n = 1, 2, 4 up to N, and measure() at the
   training crop on the same ranks, 10 steps). Every row's step times
   finite and positive, its gradient bytes PoseNet's 70,075,388, and the
   bytes each rank all-reduces a step those plus the scalars the row names.

Standard output ends with one JSON line per timed batch, per serving check,
per eval harness and per training stage, the seconds of each phase, the
kernels line, nvidia-smi's line, and {"ok": true, "device": {...}}.
"""

import contextlib
import hashlib
import http.client
import importlib.util
import io
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from hand3d_tpu_torch import parity, precision, weights
from hand3d_tpu_torch.cli import (_common, eval2d, eval_full,
                                  train_handsegnet, train_joint,
                                  train_lifting, train_posenet)
from hand3d_tpu_torch.data import augment, codec, native
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import (InputPipeline, epoch_indices,
                                            resident_data)
from hand3d_tpu_torch.data.preprocess import preprocess_rhd, preprocess_stb
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.stb import STBDataset
from hand3d_tpu_torch.eval import harnesses
from hand3d_tpu_torch.models import cascade, handsegnet, posenet
from hand3d_tpu_torch.models.cascade import ColorHandPose3D
from hand3d_tpu_torch.models.poseprior import VARIANTS, PosePriorNetwork
from hand3d_tpu_torch.ops import (keypoints, nn, phasepack, quant,
                                  segmentation)
from hand3d_tpu_torch.ops.image import resize_bilinear
from hand3d_tpu_torch.ops.kernels import (build, decode, floodfill,
                                         kernel_counts, kernel_runs)
from hand3d_tpu_torch.parallel import collectives, expert, pipeline
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.cli import serve
from hand3d_tpu_torch.export import export_estimator
from hand3d_tpu_torch.batching import select_serving_outputs
from hand3d_tpu_torch.serving import (AutoBucketEstimator, DeviceParams,
                                      DynamicBatcher, HandPoseEstimator,
                                      _map_back, _resize_to, normalize_images)
from hand3d_tpu_torch.tools import (bench_input, create_binary_db,
                                    memory_report, profile_stages, roofline,
                                    run_baseline_parity, scaling_record)
from hand3d_tpu_torch.tools.card import nvidia_smi
from hand3d_tpu_torch.tools.scaling_record import (counted_collectives,
                                                   run_processes)
from hand3d_tpu_torch.train import checkpoints, losses, loop, trainer
from hand3d_tpu_torch.utils import profiling
from hand3d_tpu_torch.weights import ocdbt, tf_ckpt, zstd

CPU = torch.device("cpu")
H, W = 240, 320  # the serving bucket of the JAX package's bench and demo
NUM_PASSES = max(H, W) // 10
FACTOR = 8  # 32x32 PoseNet scoremap -> 256x256 crop
SLICE_BATCH = 8
REQUESTS = (5, 8, 17)  # a partial, a full and a ragged multi-chunk request
PARITY_FLOOD_BATCHES = (1, 8, 32, 128)
PARITY_DECODE_BATCHES = (1, 8, 32, 128)
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
# the first batch's first 4 images are held to the CPU run: the CPU side of a
# cascade harness took 16-21 s at its full first batch
EVAL_CPU_IMAGES = 4
# steady-state files: 10 batches of 32 or 20 of 16 RHD, 10 of 16 STB
STEADY_RHD_RECORDS = 320
STEADY_STB_RECORDS = 160
WINDOW = 3  # the harnesses' launch window (harnesses._run)
MODE_PARITY_IMAGES = 2  # card vs CPU for seg_scale=0.5 and soft-argmax
# soft-argmax uv is an expectation over 256^2 crop pixels, summed by cuBLAS
# in another order than on the CPU: ~1e-5 of a 256 px coordinate, times 4
# at the smallest crop scale (0.25)
SOFT_ARGMAX_UV_ATOL = 2e-2  # px

# training: each trainer's CLI at full width (batch 8, 256^2 GT crops, 256^2
# random crops of 320^2 frames, the reference LR defaults, seeded weights)
TRAIN_STAGES = {
    "posenet": (train_posenet, []),
    "handsegnet": (train_handsegnet, []),
    "lifting proposed": (train_lifting, ["--variant", "proposed"]),
    "joint proposed": (train_joint, ["--variant", "proposed"]),
}
TRAIN_RECORDS = 64
TRAIN_BATCH = 8  # the trainers' default
TRAIN_STEPS = 20
# step 0, card vs CPU, same params, batch and noise. Leaky ReLU and max pool
# have kinks: a pre-activation within float32 rounding of one takes the other
# branch on one side, and every gradient before it moves. With random weights
# the card takes another branch than float64 at ~1,000 leaky ReLU inputs of
# PoseNet's step 0, the CPU at ~20 (measured on this batch: card vs CPU up
# to 1.4e-2 of a tensor's max |g|, median over a stage's tensors up to
# 6.1e-4; the last layers, after every kink, 4e-6). So card vs CPU holds the
# last layers to TRAIN_GRAD_RTOL_OF_MAX, every tensor to
# TRAIN_FLIP_RTOL_OF_MAX and the stage's median to
# TRAIN_FLIP_MEDIAN_RTOL_OF_MAX; a wrong backward on the card is off by O(1).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL_OF_MAX = 1e-4
TRAIN_FLIP_RTOL_OF_MAX = 5e-2
TRAIN_FLIP_MEDIAN_RTOL_OF_MAX = 5e-3
TRAIN_LAST_LAYERS = {  # param paths that no kink follows
    "posenet": ("PoseNet2D/conv7_7/",),
    "handsegnet": ("HandSegNet/conv6_2/",),
    "lifting proposed": ("PosePrior/fc_xyz/", "ViewpointNet/fc_vp_u"),
    "joint proposed": ("PosePrior/fc_xyz/", "ViewpointNet/fc_vp_u"),
    "cascade": ("HandSegNet/conv6_2/", "PoseNet2D/conv7_7/",
                "PosePrior/fc_xyz/", "ViewpointNet/fc_vp_u"),
}
# the same step on the CPU in float64 (params and preprocessed features cast
# up; the same batch and draws), taking the card's branch at every leaky ReLU
# and the card's element at every max pool, is the exact gradient of the
# card's own choices: the card is held to it within TRAIN_GRAD_RTOL_OF_MAX.
# (measured: 2e-5). Where float64 alone would have chosen otherwise, the
# input must lie within TRAIN_KINK_MARGIN of the call's largest |input| of
# its kink: a float32 sum of PoseNet's widest convolution (3x3x512 = 4,608
# terms) may be off by 4,608 * 2^-24 = 2.7e-4 of its largest term
# (measured: 3.6e-5).
TRAIN_KINK_MARGIN = 1e-3
# Adam on the card (torch's foreach path) against Adam written out in float64
# on the CPU and fed the card's own gradients, ADAM_STEPS steps on one batch
# with a new LR at every step (the stage's reference LR values, their
# boundaries moved to steps 1 and 2). Per step, the moments may differ by a
# few float32 roundings (ADAM_RTOL of |m| + max |g|, of v + max g^2, plus a
# subnormal), the params by 4 ulps plus ADAM_UPDATE_ATOL * lr; a wrong LR,
# bias correction or moment update is off by O(1) of lr.
ADAM_STEPS = 3
ADAM_LR_ITER = {"posenet": ("1", "2"), "handsegnet": ("1", "2"),
                "lifting proposed": ("1",), "joint proposed": ("1",)}
ADAM_RTOL = 1e-6
ADAM_UPDATE_ATOL = 1e-5
F32_SUBNORMAL = 2.0 ** -149

RESUME_CHILD = "--train-resume-child"  # phase_train_resume's own process

# train_resident: train_posenet's device-resident path on phase 10's file
RESIDENT_K = 7  # 20 steps: windows 7 + 7 + 6
RESIDENT_LR = ("--lr", "1e-4", "1e-5", "--lr-iter", "5")
RESIDENT_LR_K, RESIDENT_LR_STEPS = 4, 8  # the boundary inside window 4..8
# resident vs phase 10's per-step params after the same steps, per tensor:
# |p_res - p_step| over |p_step - p_0| (L2). The two take the same batches,
# draws and kernels, but cuDNN's backward sums with atomics in no fixed
# order, and a last-bit change grows through leaky-ReLU / max-pool kinks
# (TRAIN_FLIP_RTOL_OF_MAX) from step to step: 0.106 after 20 steps, 0.0098
# after 8 (NVIDIA H100 80GB HBM3, 700 W), where a second per-step run of the
# same seed lay 0.077 away. So the bound is the card's own run-to-run spread:
# RESIDENT_SPREAD times the distance of a second per-step run of the same
# seed from phase 10's, and at least RESIDENT_PARAM_REL_L2
RESIDENT_PARAM_REL_L2 = 5e-2
RESIDENT_SPREAD = 3.0
REMAT_SETTINGS = (False, True, "dots_saveable",
                  "dots_with_no_batch_dims_saveable")
REMAT_STEPS = 3
# step 0's gradients under remat vs without: the recompute runs the
# forward's kernels on the same inputs (the same kink choices); only the
# backward's sums move, by rounding
REMAT_GRAD_RTOL_OF_MAX = 1e-4
NATIVE_EPOCHS = 4
PER_STEP_POSENET = {}  # phase 10's train_posenet run, for train_resident

# weights: the reference's pickles and a CPM-MPII-shaped TF checkpoint of the
# slice's tree through --weights; eval2d and train_posenet on a small file
WEIGHTS_RECORDS = 16
WEIGHTS_BATCH = 8
WEIGHTS_TRAIN_STEPS = 3

# serving: AutoBucketEstimator snapping other frames to the 240x320 bucket,
# DynamicBatcher, the HTTP server, an exported program, the bf16 mode
SERVE_BATCH = 8
SERVE_FRAMES = ((480, 640), (300, 500))  # resized to (H, W) on the card
SERVE_PARITY_IMAGES = 2  # per frame size, card vs CPU
RESIZE_ATOL = 1e-5  # the card's antialiased resize vs the CPU's
BATCHER_REQUESTS = 32
BATCHER_CLIENTS = 16
BATCHER_WAIT_MS = 5.0
HTTP_CLIENTS = 4
HTTP_POSTS_PER_CLIENT = 4
HTTP_ROUND_TRIPS = 20
DISPATCH_CALLS = 200  # op-dispatch cost: calls timed on the host
# bf16 mode, card vs the port's bf16 CPU run: a bf16-rounded activation one
# bf16 ulp (2^-8) apart on the two sides moves everything after it, so the
# bounds are wider than f32's (measured values are printed)
BF16_BATCHES = (1, 32, 128)
BF16_SCOREMAP_ATOL = 2e-4  # measured 2.3e-5 (hand), 9.2e-6 (PoseNet)
BF16_FLIP_BOUND = 4e-4
BF16_COORD3D_ATOL = 2e-4  # measured 2.5e-5
# each bf16 conv on the card (TF32 on rounded operands) vs the CPU's f32 conv
# of the same rounded operands: products exact, sums in another order (the
# tensor cores' included) of up to 7*7*149 terms: measured 1.4e-5 of the
# layer's largest |output| (4e-6 for cuDNN's f32 path). TF32 on unrounded
# operands, the witness that the check sees inexact products, is far above.
BF16_CONV_RTOL_OF_MAX = 5e-5
BF16_FPS = {}  # phase 8's frames/s, for the int8 lines
EXPORT_BYTES = {}  # phase 7's f32 artifact, for the int8 artifact's line
# int8 (phase quant): the int8 (dynamic activation scales), int8_static
# (static scales calibrated on the card by HandPoseEstimator's own path on
# QUANT_CALIB_FRAMES other frames) and int8_seg (HandSegNet alone) trees,
# made on the card and on the CPU from the same float tree and scales
QUANT_MODES = ("int8", "int8_static", "int8_seg")
QUANT_CALIB_FRAMES = 8
QUANT_PARITY_IMAGES = 2
QUANT_ITERS = {1: 20, 32: 5, 128: 3}
# each int8 conv's accumulator is a conv of integers |q| <= 127: below
# 2**24 every order of the f32 sum is exact, so the card's (TF32 tensor
# cores) must equal float64's there element for element
ACC_EXACT = 2.0 ** 24
# int8 cascade, card vs the port's CPU run of the same int8 tree: each int8
# layer's sum is exact on both, but a float layer one ulp apart (the first
# convs and the heads stay float) puts an activation on the other side of a
# rounding boundary of the next grid now and then, and that step moves
# everything after it
# (measured on NVIDIA H100 80GB HBM3, 700 W, int8 / int8_static / int8_seg:
# hand_scoremap 1.0e-4 / 5.4e-5 / 1.0e-4, PoseNet's scoremap 3.7e-5 /
# 2.0e-5 / 3.4e-8, coord3d 3.7e-9 / 7.0e-6 / 3.4e-8)
INT8_SCOREMAP_ATOL = 5e-4
INT8_FLIP_BOUND = 1e-3
INT8_COORD3D_ATOL = 1e-4
# QAT: train_posenet --qat on phase 10's file, per step and resident; step
# 0 held to the CPU run that takes the card's round(), leaky ReLU and max
# pool choices (qat_first_step_vs_cpu; measured on NVIDIA H100 80GB HBM3,
# 700 W: 5,085 of 79 million round() choices overridden, within 4.6e-5 of
# the largest |input| of the boundary, gradients within 2.4e-5)
QAT_BATCH = 8
QAT_STEPS = 8
QAT_K = 4  # windows 4 + 4
# mesh: data parallelism over torch.distributed ranks on the one card. Two
# gloo ranks share cuda:0 (NCCL refuses two ranks on one GPU; gloo runs its
# collectives on CUDA tensors through the host); one NCCL rank trains
# through --mesh 1x1. The DP step is held to one process's step on the
# concatenated global batch (same params, same global draws): the loss
# within MESH_LOSS_RTOL, the gradients within the TRAIN_* kink-aware bounds
MESH_CHILD = "--mesh-child"  # one gloo rank
MESH_NCCL_CHILD = "--mesh-nccl-child"  # the one NCCL rank
MESH_DEVICE = "cuda:0"  # every rank's device
MESH_WORLD = 2
MESH_TRAIN_BATCH = 8  # global: 4 a rank
MESH_TRAIN_STEPS = 3
MESH_LOSS_RTOL = 1e-6
MESH_EVAL_RECORDS = 32
MESH_EVAL_BATCH = 8  # global: 4 a rank
MESH_SERVE_BATCH = 8
MESH_TIMED_STEPS = 5
MESH_TIMEOUT_S = 300
# parallel: the JAX package's multichip dry run on ranks (TP, multislice,
# SP, PP, EP, the estimator). On one card PARALLEL_WORLD gloo ranks share
# it, as in the mesh phase. The TP step is the dry run's whole-cascade loss
# at full width on PARALLEL_HW images and crops; its step 0, the SP step and
# the PP step are held to one process on the global batch by the mesh
# phase's bounds (MESH_LOSS_RTOL, the TRAIN_* kink-aware gradient bounds:
# a column-parallel input gradient sums M partials in another order, and
# the ranks' convs run other shapes than one process's); EP to
# moe_dense_reference on each token slice within PARALLEL_EP_ATOL and
# TRAIN_GRAD_RTOL_OF_MAX; the estimators by check_cascade (f32 bounds, the
# INT8_* bounds for int8).
PARALLEL_CHILD = "--parallel-child"
PARALLEL_WORLD = 2
PARALLEL_BATCH = 8  # global, as the dry run's at 4 devices and fewer
PARALLEL_HW = 128
PARALLEL_STEPS = 3
PARALLEL_SHARD_PATHS = {  # path -> (the sharded dim, its whole length)
    "HandSegNet/conv4_1/weights": (0, 512),
    "PoseNet2D/conv6_1/weights": (0, 128),
    "PosePrior/fc_rel0/weights": (1, 512),
}
PARALLEL_SP_BATCH = 2
# the rows of a rank must stay even down to HandSegNet's third pool:
# 240 / 2 = 120 -> 60 -> 30 do; 240 / 4 = 60 -> 30 -> 15 do not, so four
# ranks take 256 rows (64 -> 32 -> 16)
PARALLEL_SP_HW = {2: (240, 320), 4: (256, 320)}
PARALLEL_PP_BATCH = 8
PARALLEL_PP_HW = 256  # the reference's crop
PARALLEL_PP_MICRO = 2
PARALLEL_EP = (4, 64, 32)  # experts, in, out: the dry run's
PARALLEL_EP_TOKENS = 32
PARALLEL_EP_ATOL = 1e-5
PARALLEL_SERVE_BATCH = 8
PARALLEL_FIT_RECORDS = 16
PARALLEL_FIT_STEPS = 2  # on DxM, then one more resumed on (D*M)x1
# phase packing: conv1_2 of HandSegNet and PoseNet phase-packed
# (ops.phasepack) and fused with the pool after it. The packed layer sums
# the plain layer's products and exact zeros in another order, so the
# packed cascades are held flip-aware to the plain ones on the card, f32 at
# the f32 bounds, int8_seg_pp (int8 HandSegNet, then packed) at the INT8_*
# bounds (int8 rounds its inputs: a float step moves a grid choice now and
# then); the fused layer alone to the plain conv + ReLU + pool at
# PACK_LAYER_ATOL + PACK_LAYER_RTOL * |plain|, the JAX package's test bounds
PACK_BATCHES = (1, 32)
PACK_ITERS = {1: 20, 32: 5}  # predicts a mode and round, two rounds
PACK_PARITY_IMAGES = 2
PACK_LAYER_ATOL = 2e-5
PACK_LAYER_RTOL = 1e-5
PACK_LAYER_ITERS = 10
# tools: create_binary_db on PNG fixtures of the RHD layout, the
# run_baseline_parity drill (all 13 rows) over synthetic files at its eval
# batch, bench_input, and release_check restricted to its preset step
TOOLS_PNG_SAMPLES = 4
TOOLS_RECORDS = 16  # RHD and STB records of the drill
TOOLS_BATCH = 8
TOOLS_BENCH_RECORDS = 256
TOOLS_RELEASE_TIMEOUT_S = 600
# orbax: save_orbax / restore_orbax of train_posenet's full-width state, and
# the JAX package's checkpoint of tests/torch_fixtures/orbax_jax on the card
ORBAX_CHILD = "--orbax-child"
ORBAX_STEPS = 2
ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "torch_fixtures", "orbax_jax")
ORBAX_DECODE_ROUNDS = 20
# measure: profile_stages configurations (dtype, quantize, batch, iters),
# the stages that must launch each kernel, and the stages whose ms a frame
# are the roofline's glue: the crop stage runs the flood fill, the box and
# the crop, so the flood-fill stage is not added to it a second time
MEASURE_PROFILES = (("f32", None, 1, 20), ("f32", None, 32, 5),
                    ("f32", None, 128, 3), ("bf16", None, 32, 5),
                    ("bf16", None, 128, 3), ("f32", "int8", 1, 20))
MEASURE_LAUNCHING = {
    "flood_fill": ("single_obj_scoremap", "calc_center_bb",
                   "crop_from_scoremap", "FULL cascade"),
    "decode_upsampled": ("decode_upsampled", "FULL cascade")}
MEASURE_GLUE = ("crop_from_scoremap", "decode_upsampled")
MEASURE_CONV_STAGES = ("handsegnet", "posenet", "poseprior+viewpoint")
MEASURE_ROOFLINE_BATCHES = (1, 32, 128)
MEASURE_ACCUMS = (1, 2, 4)  # memory_report's default --accum
MEASURE_CALL_BATCHES = (1, 32)  # launches in one cascade call
# scaling: measure() at 32x32 on SCALING_RANKS ranks (gloo, sharing the one
# card) and at the training crop on one, SCALING_STEPS timed steps; under
# --mesh-cards N the record's CLI at its defaults and measure() at the
# training crop, one NCCL rank a card, n = 1, 2, 4 up to N
SCALING_RANKS = (1, 2)
SCALING_STEPS = 5
SCALING_CROP = 256
SCALING_GRADIENT_BYTES = 70_075_388  # PoseNet's 17,518,847 f32 params
SCALING_TIMEOUT_S = 600
EXPORT_CHILD_CODE = """
import json, sys, time
import numpy as np
t0 = time.perf_counter()
from hand3d_tpu_torch.export import ExportedEstimator
est = ExportedEstimator.load(sys.argv[1])
load_s = time.perf_counter() - t0
kernels = sys.modules["hand3d_tpu_torch.ops.kernels"]
images = np.load(sys.argv[2])
est.warmup()
before = kernels.kernel_counts()
t0 = time.perf_counter()
out = est.predict(images)
predict_s = time.perf_counter() - t0
np.savez(sys.argv[3], **out)
print(json.dumps({"load_s": load_s, "predict_s": predict_s,
                  "meta": est.meta,
                  "launches": {k: n - before[k] for k, n in
                               kernels.kernel_counts().items()},
                  "model_modules": sorted(
                      m for m in sys.modules
                      if m.startswith("hand3d_tpu_torch.models")),
                  "jax_modules": sorted(m for m in sys.modules
                                        if m.split(".")[0] == "jax")}))
"""

KERNELS = {
    "flood_fill": ("hand3d_tpu_torch/csrc/floodfill.cu",
                   "hand3d_tpu/ops/pallas/floodfill.py:58"),
    "decode_upsampled": ("hand3d_tpu_torch/csrc/decode.cu",
                         "hand3d_tpu/ops/pallas/decode.py:36"),
}
# why no single PyTorch call computes the kernel's function (library_ms null)
LIBRARY = {
    "flood_fill": "none: max_pool2d is one pass of one axis; the fill repeats "
                  "two of them and a mask to a fixed point",
    "decode_upsampled": "none: F.interpolate's bilinear grid is not TF1's "
                        "asymmetric one, and the argmax is a second call",
}
# the bounds: NVIDIA's data sheet of the H100 SXM, float32 outside the tensor
# cores and HBM3. The decode's count is its Pallas kernel's CostEstimate
# (decode.py:105). The flood fill works on binary maps as 32-pixel words:
# per word and pass 43.125 integer operations (the 21-row OR tree 89 per 8
# rows, the two +-10 column reach trees 14 each, combine and mask 2, change
# test 2; csrc/floodfill.cu), plus a compare a pixel to pack and a select to
# unpack, at the INT32 rate: 64 operations per SM and clock against 128 f32
# lanes, whose FMAs count twice in the f32 rate, so a quarter of it
PEAK_F32_OPS = 67e12
PEAK_INT32_OPS = PEAK_F32_OPS / 4
PEAK_BYTES = 3.35e12
FLOOD_OPS_PER_WORD_PASS = 89 / 8 + 14 + 14 + 2 + 2
FLOOD_OPS_PER_PX = 2  # pack and unpack
DECODE_OPS_PER_VALUE = 6  # per source value and (a, b) offset


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
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    # what the tools read PNGs with, and that the storage packages of Orbax
    # checkpoints are absent (the port reads them with weights/zstd.py,
    # ocdbt.py and orbax.py)
    log("modules: " + json.dumps({
        m: importlib.util.find_spec(m) is not None
        for m in ("zstandard", "tensorstore", "zarr", "numcodecs", "PIL",
                  "matplotlib", "scipy")}))
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


def serpentine(h, w):
    """Lanes of 2 rows, 23 rows apart (more than the 21-row window), joined
    at alternating ends: one corridor; at 240x320 it needs about 380 passes,
    so the fill runs all of its max(H, W) // 10."""
    det = np.zeros((h, w), np.float32)
    for i, r in enumerate(range(0, h, 23)):
        det[r:r + 2, :] = 1.0
        c = w - 2 if i % 2 == 0 else 0
        det[r:r + 25, c:c + 2] = 1.0
    return det


def flood_cases(b, rng):
    """[b, H, W] masks and seeds: two blobs, bridged, empty, a seed on
    background 5 px from a blob, random noise, blobs across band boundaries
    with seeds on the first, last and boundary rows, seeds off the image, a
    serpentine."""
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
    bands = (rng.random((b, H, W)) > 0.7).astype(np.float32)
    rows = [0, H - 1] + [q * H // c for c in (2, 4, 8) for q in range(1, c)]
    for r in rows[2:]:  # a blob across every band boundary
        bands[:, max(r - 4, 0):r + 4, (r * 7) % W:(r * 7) % W + 30] = 1.0
    cases["band_edges"] = (bands, np.stack(
        [np.array(rows)[np.arange(b) % len(rows)], rng.integers(0, W, b)],
        1).astype(np.int32))
    off = np.array([[-1, 5], [H, 5], [5, -1], [5, W]], np.int32)
    cases["seed_off_image"] = (noise, off[np.arange(b) % 4])
    cases["serpentine"] = (np.repeat(serpentine(H, W)[None], b, 0),
                           np.zeros((b, 2), np.int32))
    return cases


def decode_cases(b, rng):
    """[b, 32, 32, 21] scoremaps with exact ties (far apart rows too), edge
    peaks, the cascade's ~1e-3 value scale, NaN, infinities and -0.0 /
    +0.0 ties."""
    sm = rng.standard_normal((b, 32, 32, 21)).astype(np.float32)
    sm[0, :, :, 0] = 0.0
    sm[0, 5, 5, 3] = sm[0, 20, 20, 3] = sm[0].max() + 1.0
    sm[-1, 31, 31, 4] = sm[-1, 0, 31, 5] = sm[-1, 31, 0, 6] = 10.0
    small = (rng.standard_normal((b, 32, 32, 21)) * 1e-3).astype(np.float32)
    special = rng.standard_normal((b, 32, 32, 21)).astype(np.float32)
    special[:, :, :, 0] = -1.0  # -0.0 then +0.0: a tie, the first wins
    special[:, 3, 7, 0] = -0.0
    special[:, 30, 2, 0] = 0.0
    special[:, 9, 9, 1] = np.nan  # the first NaN wins
    special[:, 31, 31, 1] = np.nan
    special[:, :, :, 2] = -np.inf
    special[:, 16, 4, 3] = np.inf  # inf * 0 in the clamped lerp is NaN
    special[:, 1, 0, 7] = special[:, 30, 31, 7] = 50.0  # far rows, one value
    return {"ties_edges": sm, "small_values": small, "special": special}


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
            passes = flood_passes(det_t, seed_t, NUM_PASSES)
            log(f"flood fill == twin: {name:18s} B={b:3d} "
                f"({int(want.sum().item())} px kept, passes up to "
                f"{max(passes)}; cluster, clusters held: "
                f"{floodfill.cluster_plan(b, H, W, dev)})")
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


def flood_passes(det, seed, num_passes):
    """Passes the flood fill runs on each image of these inputs, counted by
    running the twin's pass one at a time: the passes that change the map,
    and the one that finds the fixed point, at most num_passes."""
    b, h, w = det.shape
    rows = torch.arange(h, device=det.device)[None, :, None]
    cols = torch.arange(w, device=det.device)[None, None, :]
    s = seed.long()
    obj = ((rows == s[:, 0, None, None])
           & (cols == s[:, 1, None, None])).to(torch.float32)
    k, half = segmentation.DILATION_FILTER_SIZE, \
        segmentation.DILATION_FILTER_SIZE // 2
    active = torch.ones(b, dtype=torch.bool, device=det.device)
    passes = torch.zeros(b, dtype=torch.int64, device=det.device)
    for _ in range(num_passes):
        passes += active
        grown = F.max_pool2d(obj[:, None], (k, 1), 1, (half, 0))
        new = det * F.max_pool2d(grown, (1, k), 1, (0, half))[:, 0]
        active &= (new != obj).flatten(1).any(1)
        obj = new
        if not active.any():
            break
    return passes.tolist()


def bound(ops, peak_ops, nbytes):
    """The least time the card could take: the larger of the operations over
    their peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def flood_bound(det, seed, num_passes):
    """Bound of one flood fill: each image's passes at 43.125 integer
    operations a 32-pixel word, packing and unpacking at 2 a pixel; det read
    once, the result written once, the seeds read once."""
    b, h, w = det.shape
    passes = flood_passes(det, seed, num_passes)
    words = h * ((w + 31) // 32)
    out = bound(FLOOD_OPS_PER_WORD_PASS * words * sum(passes)
                + FLOOD_OPS_PER_PX * b * h * w, PEAK_INT32_OPS,
                2 * 4 * b * h * w + 8 * b)
    out["ops_counted"] = (f"int32: {FLOOD_OPS_PER_WORD_PASS} a 32-px word "
                          f"and pass, {FLOOD_OPS_PER_PX} a px")
    out["passes"] = passes if b <= SLICE_BATCH else {
        "sum": sum(passes), "min": min(passes), "max": max(passes)}
    return out


def decode_bound(sm, factor):
    """Bound of one decode: 6 operations a source value and (a, b) offset;
    the scoremap read once, the (row, col) pairs written once."""
    b, h, w, k = sm.shape
    out = bound(DECODE_OPS_PER_VALUE * factor * factor * b * h * w * k,
                PEAK_F32_OPS, 4 * b * h * w * k + 4 * b * k * 2)
    out["ops_counted"] = (f"f32: {DECODE_OPS_PER_VALUE} a source value and "
                          "upsampled offset")
    return out


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
    zero_counts()
    outs, runs = kernel_runs(lambda: [est.predict(r) for r in requests])
    counts = launch_counts()
    log(f"served {len(requests)} requests of {REQUESTS} images; "
        f"kernel launches {counts}, runs on the card {runs}")
    for name, n in runs.items():
        require(n > 0, f"the served requests never ran {name}")
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
    bounds = {"flood_fill": flood_bound(det, seed, NUM_PASSES),
              "decode_upsampled": decode_bound(sm, FACTOR)}
    return [{"name": name, "route": "cuda", "source": KERNELS[name][0],
             "replaces": KERNELS[name][1], "launches": counts[name],
             "max_abs_err": err[name], "ms": ms[name][0],
             "plain_ms": ms[name][1], **bounds[name], "library_ms": None,
             "library": LIBRARY[name], "batch": SLICE_BATCH}
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
    """Served f32 frames/s and the kernels' times at TIME_BATCHES (and at
    batch 1 the op-dispatch cost); returns {batch: frames/s}."""
    rng = np.random.default_rng(2)
    fps = {}
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
        fb = flood_bound(det, seed, NUM_PASSES)
        if b == 1:
            phase_dispatch(det, seed, sm, est, images)
        med = float(np.median(per_batch))
        fps[b] = b * 1000.0 / med
        log(json.dumps({
            "batch": b, "input_hw": [H, W], "slice_ms_per_batch_median": med,
            "slice_ms_per_batch": per_batch, "frames_per_s": b * 1000.0 / med,
            "flood_fill_ms": kt["flood_fill"][0],
            "flood_fill_plain_ms": kt["flood_fill"][1],
            "flood_fill_bound_ms": fb["bound_ms"],
            "flood_fill_bound_by": fb["bound_by"],
            "flood_fill_passes": fb["passes"],
            "flood_fill_cluster": floodfill.cluster_plan(b, H, W, dev),
            "decode_ms": kt["decode_upsampled"][0],
            "decode_plain_ms": kt["decode_upsampled"][1],
            "decode_bound_ms": decode_bound(sm, FACTOR)["bound_ms"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}))
        del est
        torch.cuda.empty_cache()
        fixed_mask_times(dev, b)
    return fps


def fixed_mask_times(dev, b, iters=20):
    """The flood fill at [b, 240, 320] on two fixed masks: the hand-sized
    blob of the two_blob case and a serpentine that runs all NUM_PASSES."""
    masks = {"two_blob": flood_cases(1, np.random.default_rng(0))["two_blob"],
             "serpentine": (serpentine(H, W)[None],
                            np.zeros((1, 2), np.int32))}
    for name, (det, seed) in masks.items():
        det_t = torch.from_numpy(np.repeat(det[:1], b, 0)).to(dev)
        seed_t = torch.from_numpy(np.repeat(seed[:1], b, 0)).to(dev)
        got = floodfill.flood_fill_cuda(det_t, seed_t, NUM_PASSES)
        want = segmentation.flood_fill_torch(det_t, seed_t, NUM_PASSES)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"flood fill differs on {name}")
        fb = flood_bound(det_t, seed_t, NUM_PASSES)
        log(json.dumps({
            "flood_fill_mask": name, "batch": b, "input_hw": [H, W],
            "ms": cuda_ms(lambda: floodfill.flood_fill_cuda(
                det_t, seed_t, NUM_PASSES), iters),
            "plain_ms": cuda_ms(lambda: segmentation.flood_fill_torch(
                det_t, seed_t, NUM_PASSES), iters),
            "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
            "passes": fb["passes"]}))


_launch_base = {"flood_fill": 0, "decode_upsampled": 0}


def zero_counts():
    """Count the kernels' launches from nought again: ``launch_counts()``
    below counts from the last call of this."""
    _launch_base.update(kernel_counts())


def launch_counts():
    """{kernel: launches} since the last ``zero_counts()``."""
    return {k: n - _launch_base[k] for k, n in kernel_counts().items()}


def add_counts(total, counts):
    for k in total:
        total[k] += counts[k]


def padded(images, batch):
    """``images`` zero-padded to a whole chunk of ``batch``, as
    chunked_predict pads its last chunk."""
    pad = np.zeros((-len(images) % batch, *images.shape[1:]), images.dtype)
    return np.concatenate([images, pad])


def phase_serve_buckets(dev, params_np):
    """AutoBucketEstimator with one 240x320 bucket on 480x640 and 300x500
    uint8 frames: the card's resize held to the CPU's, the answers to the
    bucket's cascade on the resized frames (uv and center mapped back), and
    that cascade, flip-aware, to the port's CPU run on the same frames."""
    rng = np.random.default_rng(5)
    auto = AutoBucketEstimator(params_np, batch_size=SERVE_BATCH,
                               snap_hws=[(H, W)], device=dev)
    requests = [rng.integers(0, 256, (SERVE_BATCH // 2, h, w, 3), np.uint8)
                for h, w in SERVE_FRAMES]
    auto.predict(requests[0][:1])  # warm-up: cuDNN plans for the bucket
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [auto.predict(r) for r in requests]
    ms = (time.perf_counter() - t0) * 1e3 / len(requests)
    counts = launch_counts()
    _, runs = kernel_runs(lambda: auto.predict(requests[0]))
    for name, n in runs.items():
        require(n > 0, f"AutoBucketEstimator never ran {name}")
    require(list(auto._buckets) == [(H, W)], f"buckets {list(auto._buckets)}")
    cpu_params = weights.params_from_jax(params_np, "cpu")
    summaries = []
    for frames, out in zip(requests, outs):
        hw = frames.shape[1:3]
        norm = normalize_images(frames)
        resized = _resize_to(norm, (H, W), dev)
        resize_err = float(np.abs(resized - _resize_to(norm, (H, W))).max())
        require(resize_err <= RESIZE_ATOL,
                f"{hw}: the card's resize differs from the CPU's by "
                f"{resize_err}")
        require(tuple(out["snap_hw"]) == (H, W), f"snap_hw {out['snap_hw']}")
        batch = torch.from_numpy(padded(resized, SERVE_BATCH)).to(dev)
        hand_side = auto._bucket((H, W)).hand_side
        card = parity.port_fields(auto.params, batch, hand_side)
        mapped = _map_back({k: card[k][:len(frames)] for k in (
            "keypoint_uv21", "center")}, hw, (H, W))
        for k in ("keypoint_uv21", "center"):
            require(np.array_equal(out[k], mapped[k]),
                    f"{hw}: served {k} is not the bucket's, mapped back")
        for k in ("scale_crop", "keypoint_coord3d"):
            require(np.array_equal(out[k], card[k][:len(frames)]),
                    f"{hw}: served {k} differs from the bucket's run")
        k = SERVE_PARITY_IMAGES
        image = torch.from_numpy(resized[:k])
        side = hand_side[:k].cpu()
        ref = parity.port_fields(cpu_params, image, side)
        got = parity.port_fields(auto.params, image.to(dev), side.to(dev))
        summary = parity.check_cascade(
            ref, got, parity.port_rerun(cpu_params, image, side),
            scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
            flip_bound=FLIP_BOUND)
        summaries.append({"frame": list(hw), "resize_max_abs_err": resize_err,
                          "card_vs_cpu": summary})
    log(json.dumps({"serve": "AutoBucketEstimator", "bucket": [H, W],
                    "batch": SERVE_BATCH, "frames": summaries,
                    "ms_per_request": ms, "launches": counts,
                    "runs_in_one_request": runs}))
    return counts


def phase_serve_batcher(dev, params_np):
    """DynamicBatcher over a batch-8 estimator: 32 one-image requests from 16
    threads run as fewer device batches, and each answer equals its row of
    a direct predict of the batch it rode in. Then the HTTP server in front
    of it, and a batch-1 server's round trip."""
    rng = np.random.default_rng(6)
    est = HandPoseEstimator(params_np, batch_size=SERVE_BATCH,
                            input_hw=(H, W), device=dev).warmup()
    batches = []  # (images, outputs) of every device batch
    inner = est.predict

    def recording(images, normalized=False):
        out = inner(images, normalized=normalized)
        batches.append((images.copy(), out))
        return out

    est.predict = recording
    frames = rng.integers(0, 256, (BATCHER_REQUESTS, 1, H, W, 3), np.uint8)
    batcher = DynamicBatcher(est, max_batch=SERVE_BATCH,
                             max_wait_ms=BATCHER_WAIT_MS)
    counts = {"flood_fill": 0, "decode_upsampled": 0}
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(BATCHER_CLIENTS) as pool:
            answers = list(pool.map(batcher.predict, frames))
        wall = time.perf_counter() - t0
        add_counts(counts, launch_counts())
        require(len(batches) < BATCHER_REQUESTS,
                f"{len(batches)} device batches for {BATCHER_REQUESTS} "
                "requests: nothing coalesced")
        norm = normalize_images(frames[:, 0])
        for i, answer in enumerate(answers):
            rows = [(b, r) for b, (images, _) in enumerate(batches)
                    for r in range(len(images))
                    if np.array_equal(images[r], norm[i])]
            require(len(rows) >= 1, f"request {i} rode in no device batch")
            b, r = rows[0]
            direct = inner(batches[b][0], normalized=True)
            for k, v in answer.items():
                require(np.array_equal(v[0], direct[k][r]),
                        f"request {i}: {k} differs from its batch's row")
        sizes = [len(images) for images, _ in batches]
        log(json.dumps({"serve": "DynamicBatcher", "requests":
                        BATCHER_REQUESTS, "clients": BATCHER_CLIENTS,
                        "max_batch": SERVE_BATCH,
                        "max_wait_ms": BATCHER_WAIT_MS,
                        "device_batches": sizes, "wall_s": wall,
                        "images_per_s": BATCHER_REQUESTS / wall}))
        _, runs = kernel_runs(lambda: batcher.predict(frames[0]))
        for name, n in runs.items():
            require(n > 0, f"the batcher never ran {name}")
        round_trip = http_checks(dev, params_np, batcher.predict, counts)
    finally:
        batcher.close()
    log(json.dumps({"serve": "HTTP", **round_trip, "launches": counts}))
    return counts


def post_npy(port, images):
    """POST ``images`` as an .npy body to /predict: (status, JSON)."""
    buf = io.BytesIO()
    np.save(buf, images)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


@contextlib.contextmanager
def serving(predict, meta, serialize):
    """cli.serve's server on a free port, serving in a thread."""
    srv = serve.make_server(predict, meta, port=0, serialize=serialize)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def round_trips(port, image):
    """Milliseconds of HTTP_ROUND_TRIPS one-image POSTs, one at a time."""
    ms = []
    for _ in range(HTTP_ROUND_TRIPS):
        t0 = time.perf_counter()
        status, _ = post_npy(port, image)
        ms.append((time.perf_counter() - t0) * 1e3)
        require(status == 200, f"round trip answered {status}")
    return ms


def http_checks(dev, params_np, predict, counts):
    """.npy POSTs from HTTP_CLIENTS threads to a server in front of the
    batcher, /healthz and /metrics; the one-image round trip through it and
    through a batch-1 server without the batcher (median of 20)."""
    rng = np.random.default_rng(7)
    posts = rng.integers(0, 256, (HTTP_CLIENTS * HTTP_POSTS_PER_CLIENT, H, W,
                                  3), np.uint8)
    with serving(predict, {"source": "chip_smoke"}, serialize=False) as port:
        zero_counts()
        with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            replies = list(pool.map(lambda im: post_npy(port, im), posts))
        for status, body in replies:
            require(status == 200, f"/predict answered {status}: {body}")
            require(np.asarray(body["keypoint_uv21"]).shape == (1, 21, 2)
                    and np.isfinite(body["keypoint_coord3d"]).all(),
                    "bad /predict body")
        status, bad = post_npy(port, np.zeros((1, 8, 8, 3), np.uint8))
        require(status == 500 and "expected" in bad["error"],
                f"a wrong-size image answered {status}: {bad}")
        status, health = get(port, "/healthz")
        require(status == 200 and json.loads(health)["status"] == "ok",
                f"/healthz: {status} {health}")
        status, metrics = get(port, "/metrics")
        want = (f"hand3d_requests_total {len(posts)}",
                f"hand3d_images_total {len(posts)}", "hand3d_errors_total 1")
        require(status == 200 and all(w in metrics for w in want),
                f"/metrics: {metrics}")
        batched_ms = round_trips(port, posts[:1])
        add_counts(counts, launch_counts())
    single = HandPoseEstimator(params_np, batch_size=1, input_hw=(H, W),
                               device=dev).warmup()
    with serving(single.predict, {"source": "chip_smoke"},
                 serialize=True) as port:
        zero_counts()
        single_ms = round_trips(port, posts[:1])
        add_counts(counts, launch_counts())
    # the same server calling predict on each request's own handler thread
    with serving(single.predict, {"source": "chip_smoke"},
                 serialize=False) as port:
        zero_counts()
        handler_ms = round_trips(port, posts[:1])
        add_counts(counts, launch_counts())
    return {"posts": len(posts), "clients": HTTP_CLIENTS,
            "round_trip_ms_median_batcher": float(np.median(batched_ms)),
            "round_trip_ms_median_batch1": float(np.median(single_ms)),
            "round_trip_ms_batch1": single_ms,
            "round_trip_ms_median_batch1_handler_threads": float(
                np.median(handler_ms))}


def exported_answers(params_np, dev, images, live, **kwargs):
    """export_estimator(params_np, **kwargs) at batch SERVE_BATCH on the
    card, loaded by a child process that imports only
    hand3d_tpu_torch.export and run on ``images``: both kernels must launch
    there, no model module be imported, and the answers equal ``live``
    bit for bit. Returns the child's report with the artifact's bytes and
    the seconds of the export and the child."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cascade.h3dx")
        t0 = time.perf_counter()
        blob = export_estimator(params_np, path, batch_size=SERVE_BATCH,
                                input_hw=(H, W), device=dev, **kwargs)
        export_s = time.perf_counter() - t0
        np.save(os.path.join(tmp, "images.npy"), images)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD_CODE, path,
             os.path.join(tmp, "images.npy"), os.path.join(tmp, "out.npz")],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        sys.stderr.write(child.stderr[-4000:])
        require(child.returncode == 0,
                f"the export child exited {child.returncode}")
        report = json.loads(child.stdout.strip().splitlines()[-1])
        with np.load(os.path.join(tmp, "out.npz")) as data:
            exported = {k: data[k] for k in data.files}
    for name, n in report["launches"].items():
        require(n > 0, f"the exported program never launched {name}")
    require(not report["model_modules"] and not report["jax_modules"],
            f"loading the artifact imported {report}")
    require(set(exported) == set(live), f"exported keys {sorted(exported)}")
    for k, v in live.items():
        require(np.array_equal(exported[k], v),
                f"exported {k} differs from the live estimator's")
    return {"artifact_bytes": len(blob), "export_s": export_s,
            "child_s": child_s, **report}


def phase_export(dev, params_np):
    """export_estimator at batch 8 on the card, loaded by a child process
    that imports only hand3d_tpu_torch.export: both kernels launch there and
    its answers equal the live estimator's bit for bit."""
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (SERVE_BATCH + 3, H, W, 3), np.uint8)
    live = HandPoseEstimator(params_np, batch_size=SERVE_BATCH,
                             input_hw=(H, W), device=dev).predict(images)
    report = exported_answers(params_np, dev, images, live)
    require(report["meta"]["phase_pack"] is False,
            f"the f32 artifact's header: {report['meta']}")
    EXPORT_BYTES["f32"] = report["artifact_bytes"]
    log(json.dumps({"export": "torch.export", "batch": SERVE_BATCH,
                    "input_hw": [H, W], **report,
                    "outputs": "bit-equal to the live estimator"}))
    return report["launches"]


@contextlib.contextmanager
def recorded_convs():
    """Record every ops.nn.conv2d call: (x, params, stride, compute dtype,
    output)."""
    calls = []
    base = nn.conv2d

    def conv2d(x, params, stride=1, compute_dtype=None):
        y = base(x, params, stride, compute_dtype)
        calls.append((x, params, stride, compute_dtype, y))
        return y

    nn.conv2d = conv2d
    try:
        yield calls
    finally:
        nn.conv2d = base


def bf16_conv_errs(dev, params_np):
    """Each bf16 conv of a batch-1 forward on the card against the CPU's f32
    conv of the same rounded operands: the worst error over the layer's
    largest |output|, with TF32 (the bf16 path) and without it; and, as the
    witness, TF32 on the layers' unrounded operands against f32 on them."""
    net = ColorHandPose3D(compute_dtype="bfloat16")
    params = weights.params_from_jax(params_np, dev)
    image = torch.from_numpy(normalize_images(np.random.default_rng(9)
                             .integers(0, 256, (1, H, W, 3), np.uint8)))
    with recorded_convs() as calls, torch.inference_mode():
        net.inference(params, image.to(dev), torch.tensor([[1.0, 0.0]],
                                                          device=dev))
    worst = {"tf32": 0.0, "f32": 0.0, "tf32_unrounded_witness": 0.0}

    def err(got, want):
        return ((got.cpu() - want).abs().max() / want.abs().max()).item()

    for x, p, stride, cd, y in calls:
        require(cd == torch.bfloat16, "an f32 conv in the bf16 forward")
        xr, wr = nn.rounded(x, cd), nn.rounded(p["weights"], cd)
        want = nn._conv2d(xr.cpu(), wr.cpu(), p["biases"].cpu(), stride)
        worst["tf32"] = max(worst["tf32"], err(y, want))
        worst["f32"] = max(worst["f32"], err(  # TF32 is off here
            nn._conv2d(xr, wr, p["biases"], stride), want))
        with precision.tf32_convs(dev):
            unrounded = nn._conv2d(x, p["weights"], p["biases"], stride)
        worst["tf32_unrounded_witness"] = max(
            worst["tf32_unrounded_witness"], err(unrounded, nn._conv2d(
                x.cpu(), p["weights"].cpu(), p["biases"].cpu(), stride)))
    require(worst["tf32"] <= BF16_CONV_RTOL_OF_MAX,
            f"a bf16 conv on the card differs from f32 on its rounded "
            f"operands by {worst} of its max")
    require(worst["tf32_unrounded_witness"] > 4 * BF16_CONV_RTOL_OF_MAX,
            f"TF32 looks exact on unrounded operands: {worst}")
    require_exact_f32()
    return len(calls), worst


def phase_bf16(dev, params_np, f32_fps):
    """HandPoseEstimator(compute_dtype="bfloat16") at batches 1 / 32 / 128:
    frames/s beside f32's, its cascade held flip-aware to the port's bf16
    CPU run, each bf16 conv to f32 on its rounded operands; TF32 off
    afterwards."""
    rng = np.random.default_rng(10)
    counts = {"flood_fill": 0, "decode_upsampled": 0}
    rows = []
    for b in BF16_BATCHES:
        est = HandPoseEstimator(params_np, batch_size=b, input_hw=(H, W),
                                compute_dtype="bfloat16", device=dev)
        images = rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)
        est.predict(images)
        zero_counts()
        per_batch = [cuda_ms(lambda: est.predict(images), 1)
                     for _ in range(TIME_ITERS[b])]
        add_counts(counts, launch_counts())
        require_exact_f32()
        med = float(np.median(per_batch))
        BF16_FPS[b] = b * 1000.0 / med
        rows.append({"batch": b, "ms_per_batch_median": med,
                     "frames_per_s": b * 1000.0 / med,
                     "f32_frames_per_s": f32_fps[b]})
        del est
        torch.cuda.empty_cache()
    net = ColorHandPose3D(compute_dtype="bfloat16")
    image = torch.from_numpy(normalize_images(
        rng.integers(0, 256, (2, H, W, 3), np.uint8)))
    side = torch.tensor([[1.0, 0.0]] * 2)
    cpu_params = weights.params_from_jax(params_np, "cpu")
    ref = parity.port_fields(cpu_params, image, side, net=net)
    got = parity.port_fields(weights.params_from_jax(params_np, dev),
                             image.to(dev), side.to(dev), net=net)
    summary = parity.check_cascade(
        ref, got, parity.port_rerun(cpu_params, image, side, net=net),
        scoremap_atol=BF16_SCOREMAP_ATOL, coord3d_atol=BF16_COORD3D_ATOL,
        flip_bound=BF16_FLIP_BOUND)
    n_convs, conv_err = bf16_conv_errs(dev, params_np)
    log(json.dumps({"bf16": rows, "card_vs_cpu_bf16": summary,
                    "tolerances": {"scoremap_atol": BF16_SCOREMAP_ATOL,
                                   "coord3d_atol": BF16_COORD3D_ATOL,
                                   "flip_bound": BF16_FLIP_BOUND},
                    "convs_checked": n_convs,
                    "conv_err_of_max": conv_err, "launches": counts}))
    require_exact_f32()
    return counts


@contextlib.contextmanager
def recorded_accumulators():
    """Record every int8 conv of ops.quant: (x, params, stride, acc)."""
    calls = []
    base = quant.conv2d_accumulator

    def accumulator(x, params, stride=1):
        acc, s_x = base(x, params, stride)
        calls.append((x, params, stride, acc))
        return acc, s_x

    quant.conv2d_accumulator = accumulator
    try:
        yield calls
    finally:
        quant.conv2d_accumulator = base


def int8_accumulators(tree, image, side):
    """Each int8 conv of the cascade on ``tree``: its accumulator on the
    card (torch.ops.hand3d.int8_conv, TF32 on for that call) against
    F.conv2d in float64 of the same integer operands on the card. Returns
    the layers, the largest |acc|, the elements at or above 2**24 and the
    unequal elements below it."""
    with recorded_accumulators() as calls, torch.inference_mode():
        ColorHandPose3D().inference(tree, image, side)
    out = {"layers": len(calls), "largest_abs_acc": 0.0, "beyond_2_24": 0,
           "unequal_below_2_24": 0, "elements": 0}
    with torch.inference_mode():
        for x, params, stride, acc in calls:
            x_q, _ = quant._quantize_input(x, params)
            w_q = params["weights_q"].double()
            x_q, padding = nn.same_padded(x_q.double(), w_q.shape[2],
                                          w_q.shape[3], stride)
            want = F.conv2d(x_q, w_q, stride=stride, padding=padding)
            exact = want.abs() < ACC_EXACT
            out["largest_abs_acc"] = max(out["largest_abs_acc"],
                                         want.abs().max().item())
            out["beyond_2_24"] += int((~exact).sum())
            out["unequal_below_2_24"] += int(
                ((acc.double() != want) & exact).sum())
            out["elements"] += want.numel()
    return out


def trees_equal(a, b):
    """Two torch trees equal leaf for leaf (dtype and bits); the leaves."""
    n = 0
    for path, layer in quant.layer_paths(b).items():
        got = quant.layer_paths(a)[path]
        require(set(got) == set(layer), f"{path}: {sorted(got)}")
        for k, v in layer.items():
            require(got[k].dtype == v.dtype
                    and torch.equal(got[k].cpu(), v.cpu()),
                    f"{path} {k} differs between the card and the CPU")
            n += 1
    return n


def quant_trees(dev, params_np):
    """{mode: (card tree, CPU tree)} quantized on each device from the same
    float tree; int8_static with the scales that HandPoseEstimator's
    calibration made on the card. Also the seconds of that calibration."""
    rng = np.random.default_rng(14)
    calib = rng.integers(0, 256, (QUANT_CALIB_FRAMES, H, W, 3), np.uint8)
    t0 = time.perf_counter()
    static = HandPoseEstimator(params_np, batch_size=1, input_hw=(H, W),
                               quantize="int8_static",
                               calibration_images=calib, device=dev).params
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    scales = {path: layer["act_scale"].cpu().numpy()
              for path, layer in quant.layer_paths(static).items()
              if "act_scale" in layer}
    kwargs = {"int8": {}, "int8_static": {"act_scales": scales},
              "int8_seg": {"scopes": {"handsegnet"}}}
    floats = {d: weights.params_from_jax(params_np, d) for d in (dev, CPU)}
    trees = {mode: tuple(quant.quantize_params_int8(floats[d], **kw)
                         for d in (dev, CPU))
             for mode, kw in kwargs.items()}
    require(trees_equal(trees["int8_static"][0], static) > 0,
            "the estimator's int8_static tree differs from quantizing with "
            "its own scales")
    return trees, calib_s


def quant_throughput(dev, trees, rng):
    """frames/s of each int8 mode at TIME_BATCHES (CUDA events around
    predict, as phase 5 times f32), and the kernel launches of those
    predicts."""
    counts = {"flood_fill": 0, "decode_upsampled": 0}
    rows = {}
    for mode in QUANT_MODES:
        params = DeviceParams(trees[mode][0], dev, mode)
        rows[mode] = {}
        for b in TIME_BATCHES:
            est = HandPoseEstimator(params, batch_size=b, input_hw=(H, W),
                                    device=dev)
            images = rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)
            est.predict(images)
            zero_counts()
            per_batch = [cuda_ms(lambda: est.predict(images), 1)
                         for _ in range(QUANT_ITERS[b])]
            add_counts(counts, launch_counts())
            med = float(np.median(per_batch))
            rows[mode][b] = b * 1000.0 / med
            del est
        torch.cuda.empty_cache()
    require_exact_f32()
    return rows, counts


@contextlib.contextmanager
def recorded_grids():
    """Record the grid index that every fake-quantized input of QAT took
    (ops.quant.fake_quant_act): each element's round() choice."""
    grids = []
    base = quant.fake_quant_act

    def fake_quant_act(x):
        scale = quant._act_scale(x.detach())
        grids.append(torch.clamp(torch.round(x.detach() / scale),
                                 -quant.QMAX, quant.QMAX).to(torch.int8))
        return base(x)

    quant.fake_quant_act = fake_quant_act
    try:
        yield grids
    finally:
        quant.fake_quant_act = base


@contextlib.contextmanager
def pinned_grids(grids):
    """Take another run's grid indices at every fake-quantized input, on
    this run's own scales. Counts where this run's own round() differs and,
    over those, how far its x lay from the boundary between the two grid
    points, over the sample's largest |x| (127 grid steps; half a step,
    3.9e-3, or more is no rounding flip)."""
    stats = {"grid_values": 0, "grid_flipped": 0, "grid_flip_margin": 0.0}
    calls = iter(grids)
    base = quant.fake_quant_act

    def fake_quant_act(x):
        idx = next(calls).to(x.device, x.dtype)
        scale = quant._act_scale(x.detach())
        t = x.detach() / scale
        own = torch.clamp(torch.round(t), -quant.QMAX, quant.QMAX)
        flip = own != idx
        stats["grid_values"] += own.numel()
        if flip.any():
            stats["grid_flipped"] += int(flip.sum())
            stats["grid_flip_margin"] = max(
                stats["grid_flip_margin"],
                (t - (own + idx) / 2)[flip].abs().max().item() / quant.QMAX)
        return quant._ste(x, idx * scale)

    quant.fake_quant_act = fake_quant_act
    try:
        yield stats
    finally:
        quant.fake_quant_act = base
    require(next(calls, None) is None,
            "the pinned run made fewer fake-quant calls than the recorded one")


def qat_first_step_vs_cpu(module, argv):
    """Step 0 of train_posenet --qat on the card against the port's CPU run
    of the same params, batch and noise. A fake quantizer's round() is a
    kink: one ulp in an input can move it a grid step, and that step moves
    every later layer's input, whose grids then move too, so the two runs'
    own gradients part by far more than phase 10's float ones. So the card
    is held to the CPU run that takes the card's choice at every round(),
    leaky ReLU and max pool: within TRAIN_GRAD_RTOL_OF_MAX of each tensor's
    max, every choice it overrode within TRAIN_KINK_MARGIN of the call's
    largest |input| of its kink (the rounding boundary, the ReLU's 0, the
    pool window's maximum). The CPU's unpinned run is reported beside
    it."""
    t0 = time.perf_counter()
    with recorded_grids() as grids:
        card = first_step(module.setup(argv))
    cpu = first_step(module.setup(argv + ["--device", "cpu"]))
    with pinned_grids(grids) as grid_stats:
        pinned = first_step(module.setup(argv + ["--device", "cpu"]),
                            pin=card.kinks)
    for k, v in card.raw.items():
        require(torch.equal(v.cpu(), cpu.raw[k]), f"first batch differs: {k}")
    paths = trainer.tree_paths(card.state.params)
    return {"loss": card.loss.item(), "loss_cpu": cpu.loss.item(),
            "loss_rel_err": abs(card.loss.item() - pinned.loss.item())
            / abs(pinned.loss.item()),
            "grad_err_of_max_vs_cpu_on_card_choices": grad_errs(
                "posenet", paths, card.grads, pinned.grads),
            "cpu_choices_overridden": {**pinned.kinks, **grid_stats},
            "fake_quant_inputs": len(grids),
            "unpinned_cpu": {
                "grad_err_of_max": grad_errs("posenet", paths, card.grads,
                                             cpu.grads),
                "kinks_differ": kinks_differ(card.kinks, cpu.kinks)},
            "seconds": time.perf_counter() - t0}


def phase_qat(dev):
    """train_posenet --qat at full width on phase 10's file: step 0 held to
    the CPU; QAT_STEPS steps per step (twice: the card's own spread) and at
    --steps-per-call QAT_K, the resident run held to the per-step one."""
    rng = np.random.default_rng(4)  # phase 10's file, byte for byte
    module = train_posenet
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "train.bin")
        write_rhd_file(data, TRAIN_RECORDS, rng)
        _, argv = train_argv("posenet", data, tmp, QAT_STEPS, "--qat",
                             "--batch-size", str(QAT_BATCH))
        step0 = qat_first_step_vs_cpu(module, argv)
        init = [p.detach().clone()
                for p in trainer.tree_leaves(module.setup(argv).params)]
        with timed_steps() as events:
            per_step, rows, _, _, _ = resident_run(
                module, argv, os.path.join(tmp, "per_step.jsonl"))
        step_ms = [a.elapsed_time(b) for a, b in events]
        again = resident_run(module, argv, os.path.join(tmp, "again.jsonl"))
        resident, r_rows, windows, replays, _ = resident_run(
            module, argv + ["--steps-per-call", str(QAT_K)],
            os.path.join(tmp, "resident.jsonl"))
    require_exact_f32()
    loss0 = [r["loss"] for r in rows if "loss" in r][0]
    r_loss0 = [r["loss"] for r in r_rows if "loss" in r][0]
    spread = param_rel_l2(trainer.tree_leaves(again[0].params),
                          trainer.tree_leaves(per_step.params), init)
    err = param_rel_l2(trainer.tree_leaves(resident.params),
                       trainer.tree_leaves(per_step.params), init)
    bound = max(RESIDENT_PARAM_REL_L2, RESIDENT_SPREAD * spread)
    out = {"first_step_vs_cpu": step0, "steps": QAT_STEPS,
           "per_step_ms_median": float(np.median(step_ms[2:])),
           "resident_ms_per_step": [a.elapsed_time(b) / k
                                    for a, b, k in windows],
           "replays": replays, "loss0": loss0, "loss0_resident": r_loss0,
           "params_rel_l2_vs_per_step": err, "per_step_rerun_rel_l2": spread,
           "params_bound": bound}
    over = step0["cpu_choices_overridden"]
    require(step0["fake_quant_inputs"] == 25,
            f"QAT step 0 fake-quantized {step0['fake_quant_inputs']} inputs")
    require(step0["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and step0["grad_err_of_max_vs_cpu_on_card_choices"]["worst"]
            <= TRAIN_GRAD_RTOL_OF_MAX
            and over["grid_flip_margin"] <= TRAIN_KINK_MARGIN
            and over["relu_flip_margin"] <= TRAIN_KINK_MARGIN
            and over["pool_flip_margin"] <= TRAIN_KINK_MARGIN,
            f"QAT step 0 differs from the CPU's: {out}")
    require(replays == [QAT_STEPS] and r_loss0 == loss0,
            f"QAT resident run: {out}")
    require(err <= bound, f"QAT resident params {err:.3g} from the per-step "
            f"run's (bound {bound:.3g}): {out}")
    return out


def phase_quant(dev, params_np, f32_fps, err):
    """int8 at 240x320: the trees quantized on the card bit-equal to the
    CPU's; every int8 conv's accumulator exact; the int8, int8_static and
    int8_seg cascades held flip-aware to the port's CPU run of the same
    tree, with both kernels held to their twins on their inputs; the int8
    estimator and an exported int8 artifact equal to the cascade bit for
    bit; frames/s at 1 / 32 / 128 beside f32's and bf16's; QAT (phase_qat).
    Returns the kernel launches."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(13)
    trees, calib_s = quant_trees(dev, params_np)
    leaves = sum(trees_equal(*trees[m]) for m in QUANT_MODES)
    frames = rng.integers(0, 256, (SLICE_BATCH, H, W, 3), np.uint8)
    image = torch.from_numpy(normalize_images(frames))
    side = torch.tensor([[1.0, 0.0]] * SLICE_BATCH)
    acc = int8_accumulators(trees["int8"][0], image.to(dev), side.to(dev))
    log(json.dumps({"int8_accumulators": acc}))
    require(acc["unequal_below_2_24"] == 0 and acc["layers"] == 41,
            f"int8 accumulators on the card are not exact: {acc}")

    counts = {"flood_fill": 0, "decode_upsampled": 0}
    cascades = {}
    n = QUANT_PARITY_IMAGES
    for mode in QUANT_MODES:
        card, cpu = trees[mode]
        zero_counts()
        got = parity.port_fields(card, image[:n].to(dev), side[:n].to(dev))
        add_counts(counts, launch_counts())
        ref = parity.port_fields(cpu, image[:n], side[:n])
        cascades[mode] = parity.check_cascade(
            ref, got, parity.port_rerun(cpu, image[:n], side[:n]),
            scoremap_atol=INT8_SCOREMAP_ATOL, coord3d_atol=INT8_COORD3D_ATOL,
            flip_bound=INT8_FLIP_BOUND)
        det, seed, sm = slice_inputs(card, image.to(dev), side.to(dev))
        pairs = {
            "flood_fill": (floodfill.flood_fill_cuda(det, seed, NUM_PASSES),
                           segmentation.flood_fill_torch(det, seed,
                                                         NUM_PASSES)),
            "decode_upsampled": (decode.decode_upsampled_cuda(sm, FACTOR),
                                 keypoints.decode_upsampled_torch(sm,
                                                                  FACTOR))}
        for name, (a, b) in pairs.items():
            err[name] = max(err[name], (a - b).abs().max().item())
            require(torch.equal(a, b), f"{name} differs from its twin on "
                    f"the {mode} cascade's input")
    for name, k in counts.items():
        require(k > 0, f"the int8 cascades never launched {name}")

    # serving: the estimator and an exported artifact answer as the cascade
    est = HandPoseEstimator(params_np, batch_size=SERVE_BATCH,
                            input_hw=(H, W), quantize="int8", device=dev)
    zero_counts()
    live = est.predict(frames)
    add_counts(counts, launch_counts())
    with torch.inference_mode():
        want = select_serving_outputs(ColorHandPose3D().inference(
            trees["int8"][0], image.to(dev), side.to(dev),
            keypoints_scoremap=False))
    for k, v in want.items():
        require(np.array_equal(live[k], v.cpu().numpy()),
                f"the int8 estimator's {k} differs from the cascade's")
    report = exported_answers(params_np, dev, frames, live, quantize="int8")
    add_counts(counts, report["launches"])
    del est

    fps, timed_counts = quant_throughput(dev, trees, rng)
    add_counts(counts, timed_counts)
    qat = phase_qat(dev)
    log(json.dumps({
        "int8": {mode: {"frames_per_s": {str(b): v for b, v in
                                         fps[mode].items()},
                        "card_vs_cpu": cascades[mode]}
                 for mode in QUANT_MODES},
        "f32_frames_per_s": {str(b): v for b, v in f32_fps.items()},
        "bf16_frames_per_s": {str(b): v for b, v in BF16_FPS.items()},
        "tolerances": {"scoremap_atol": INT8_SCOREMAP_ATOL,
                       "coord3d_atol": INT8_COORD3D_ATOL,
                       "flip_bound": INT8_FLIP_BOUND},
        "leaves_card_equal_cpu": leaves, "calibration_s": calib_s,
        "estimator": "bit-equal to the cascade",
        "export": {"artifact_bytes": report["artifact_bytes"],
                   "f32_artifact_bytes": EXPORT_BYTES.get("f32"),
                   "export_s": report["export_s"],
                   "child_s": report["child_s"],
                   "launches": report["launches"],
                   "outputs": "bit-equal to the live estimator"},
        "qat": qat, "launches": counts,
        "phase_s": time.perf_counter() - t_start}))
    return counts


def phase_dispatch(det, seed, sm, est, images, rounds=4, iters=20):
    """What the registered ops (torch.ops.hand3d.*) add to their bindings:
    host microseconds a call of each, launched back to back (mean of
    DISPATCH_CALLS after a warm-up), and batch-1 predict milliseconds (CUDA
    events, median of ``iters``) through the ops and with the bindings
    called directly, alternating ``rounds`` times in this process."""
    pairs = {
        "flood_fill": (lambda: torch.ops.hand3d.flood_fill(det, seed,
                                                           NUM_PASSES),
                       lambda: floodfill.flood_fill_cuda(det, seed,
                                                         NUM_PASSES)),
        "decode_upsampled": (
            lambda: torch.ops.hand3d.decode_upsampled(sm, FACTOR),
            lambda: decode.decode_upsampled_cuda(sm, FACTOR))}
    out = {}
    for name, (op, binding) in pairs.items():
        require(torch.equal(op(), binding()), f"{name}: op != binding")
        us = {}
        for label, fn in (("op", op), ("binding", binding),
                          ("op_again", op), ("binding_again", binding)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            us[label] = (time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS
            torch.cuda.synchronize()
        us["dispatch_us"] = (us["op"] + us["op_again"] - us["binding"]
                             - us["binding_again"]) / 2
        out[name] = us
    routes = {"op": (floodfill.flood_fill, decode.decode_upsampled),
              "binding": (floodfill.flood_fill_cuda,
                          decode.decode_upsampled_cuda)}
    predict_ms = {"op": [], "binding": []}
    try:
        for _ in range(rounds):
            for label, (fill, dec) in routes.items():
                floodfill.flood_fill, decode.decode_upsampled = fill, dec
                est.predict(images)
                predict_ms[label].append(float(np.median(
                    [cuda_ms(lambda: est.predict(images), 1)
                     for _ in range(iters)])))
    finally:
        floodfill.flood_fill, decode.decode_upsampled = routes["op"]
    log(json.dumps({"op_dispatch_host_us_per_call": out,
                    "batch1_predict_ms": predict_ms,
                    "batch1_predict_ms_median": {
                        k: float(np.median(v))
                        for k, v in predict_ms.items()}}))


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
    zero_counts()
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
    counts = launch_counts()
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
    n = min(batch, EVAL_CPU_IMAGES)
    with recorded_dists() as cpu_rows:
        run.call(dataset, n, CPU, max_batches=1)
    held, tol, note = run.held(dataset.raw_batch(np.arange(n)))
    require(card_rows[0].shape == (batch, 21)
            and cpu_rows[0].shape == (n, 21),
            f"{run.label}: first batch {card_rows[0].shape}")
    err = np.abs(card_rows[0][:n] - cpu_rows[0])
    beyond = (err > tol) & held
    require(not beyond.any(), f"{run.label}: card dists differ from the "
            f"CPU's beyond the bound at {np.argwhere(beyond).tolist()}; {note}")
    log(f"{run.label}: first {n} of a batch of {batch}: card dists == CPU at "
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


@contextlib.contextmanager
def timed_steps():
    """CUDA events around every train step that ``train.loop.fit`` runs."""
    events = []
    base = loop.make_train_step

    def make(*args, **kw):
        step = base(*args, **kw)

        def timed(state, batch, key):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch, key)
            end.record()
            events.append((start, end))
            return out
        return timed

    loop.make_train_step = make
    try:
        yield events
    finally:
        loop.make_train_step = base


@contextlib.contextmanager
def recorded_decodes(module=harnesses):
    """Record the scoremaps that ``module`` (the eval harnesses, or the
    cascade) decodes, with what the decode returned for them."""
    calls = []
    base = module.decode_upsampled

    def recording(scoremap, factor):
        out = base(scoremap, factor)
        calls.append((scoremap.clone(), factor, out.clone()))
        return out

    module.decode_upsampled = recording
    try:
        yield calls
    finally:
        module.decode_upsampled = base


class Kinks(NamedTuple):
    """What a run chose at its kinks, in call order: the branch (input > 0)
    of every leaky ReLU call, the window element every 2x2 max pool took."""
    relu: list
    pool: list


@contextlib.contextmanager
def recorded_kinks():
    """Record the run's Kinks; the ops themselves run as they are."""
    kinks = Kinks([], [])
    relu, pool = nn.leaky_relu, nn.max_pool_2x2

    def leaky_relu(x):
        kinks.relu.append(x.detach() > 0)
        return relu(x)

    def max_pool_2x2(x):
        kinks.pool.append(F.max_pool2d(x.detach(), 2, 2,
                                       return_indices=True)[1])
        return pool(x)

    nn.leaky_relu, nn.max_pool_2x2 = leaky_relu, max_pool_2x2
    try:
        yield kinks
    finally:
        nn.leaky_relu, nn.max_pool_2x2 = relu, pool


@contextlib.contextmanager
def pinned_kinks(kinks):
    """Take another run's ``kinks`` at every kink instead of this run's own
    choices. Counts where this run's own choice differs and, over those, how
    near the kink it lay: the largest |input| among the flipped leaky ReLU
    inputs, and the largest gap between a window's own maximum and the
    element taken, each over the call's largest |input|."""
    stats = {"relu_flipped": 0, "relu_flip_margin": 0.0,
             "pool_flipped": 0, "pool_flip_margin": 0.0}
    relu_calls, pool_calls = iter(kinks.relu), iter(kinks.pool)
    relu, pool = nn.leaky_relu, nn.max_pool_2x2

    def leaky_relu(x):
        branch = next(relu_calls).to(x.device)
        a = x.detach().abs()
        flip = (x.detach() > 0) != branch
        if flip.any():
            stats["relu_flipped"] += int(flip.sum())
            stats["relu_flip_margin"] = max(
                stats["relu_flip_margin"], (a[flip].max() / a.max()).item())
        return torch.where(branch, x, nn.NEG_SLOPE_OF_RELU * x)

    def max_pool_2x2(x):
        taken = next(pool_calls).to(x.device)
        own, own_idx = F.max_pool2d(x.detach(), 2, 2, return_indices=True)
        out = x.flatten(2).gather(2, taken.flatten(2)).view(taken.shape)
        flip = own_idx != taken
        if flip.any():
            stats["pool_flipped"] += int(flip.sum())
            gap = (own - out.detach())[flip].max() / x.detach().abs().max()
            stats["pool_flip_margin"] = max(stats["pool_flip_margin"],
                                            gap.item())
        return out

    nn.leaky_relu, nn.max_pool_2x2 = leaky_relu, max_pool_2x2
    try:
        yield stats
    finally:
        nn.leaky_relu, nn.max_pool_2x2 = relu, pool
    require(next(relu_calls, None) is None and next(pool_calls, None) is None,
            "the pinned run made fewer kink calls than the recorded one")


def train_argv(stage, data, tmp, steps, *extra):
    module, args = TRAIN_STAGES[stage]
    name = stage.split()[0]
    return module, [*args, "--data", data, "--max-iter", str(steps),
                    "--show-loss-freq", str(max(steps - 1, 1)),
                    "--snapshot-dir", os.path.join(tmp, f"snaps_{name}"),
                    *extra]


def first_batch(job):
    """The raw batch of the job's first step, as its pipeline yields it."""
    it = job.pipeline.iterate(epochs=1)
    try:
        return next(it)
    finally:
        it.close()


class FirstStep(NamedTuple):
    state: trainer.TrainState
    loss: torch.Tensor
    grads: list  # in trainer.tree_leaves order
    raw: dict
    kinks: object  # Kinks recorded, or pinned_kinks' counts


def first_step(job, pin=None):
    """Step 0 of ``job`` on its device up to its gradients: its params, its
    first batch, the step's generator. It records the kinks it chose, or
    with ``pin`` (another run's Kinks) takes those."""
    state = trainer.init_state(job.params, job.optimizer)
    raw = first_batch(job)
    with (recorded_kinks() if pin is None else pinned_kinks(pin)) as kinks:
        loss, grads = trainer.value_and_grad(
            job.loss, state.params, raw,
            augment.generator(trainer.STEP_STREAM, job.options["seed"], 0))
    return FirstStep(state, loss, grads, raw, kinks)


def float64_job(module, argv):
    """The stage's job on the CPU in float64: its params and preprocessed
    features cast up, the same batch and draws."""
    base = module.fuse_preprocess

    def fused(loss_fn, preprocess_fn, cfg):
        def preprocess(cfg, raw, noise):
            return {k: v.double() if v.is_floating_point() else v
                    for k, v in preprocess_fn(cfg, raw, noise).items()}
        return base(loss_fn, preprocess, cfg)

    module.fuse_preprocess = fused
    try:
        job = module.setup(argv + ["--device", "cpu"])
    finally:
        module.fuse_preprocess = base
    return job._replace(params=trainer.tree_map(torch.Tensor.double,
                                                job.params))


def grad_errs(stage, paths, grads, want):
    """max |grads - want| / max |want| over each tensor, summarized: the
    last layers' worst, the worst tensor, the median over tensors."""
    errs = {}
    for path, g, w in zip(paths, grads, want):
        w = w.cpu().double()
        scale = w.abs().max().item()
        require(scale > 0, f"{stage}: no gradient reaches {path}")
        errs[path] = (g.cpu().double() - w).abs().max().item() / scale
    last = [e for p, e in errs.items()
            if p.startswith(TRAIN_LAST_LAYERS[stage])]
    require(last, f"{stage}: no last layer among {list(errs)}")
    worst = max(errs, key=errs.get)
    return {"last_layers": max(last), "worst": errs[worst],
            "worst_tensor": worst,
            "median": float(np.median(list(errs.values())))}


def kinks_differ(a, b):
    """Leaky ReLU inputs and max-pool outputs whose choice differs between
    two runs' Kinks."""
    return {"relu": sum(int((x.cpu() != y.cpu()).sum())
                        for x, y in zip(a.relu, b.relu)),
            "pool": sum(int((x.cpu() != y.cpu()).sum())
                        for x, y in zip(a.pool, b.pool))}


def ulp(x):
    """The float32 spacing at |x|."""
    a = x.float().abs()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()


def adam_direction(g):
    """Adam's first update over -lr: the bias-corrected m / (sqrt(v) + eps)
    of step 1 is g / (|g| + eps)."""
    g = g.cpu().double()
    return g / (g.abs() + 1e-8)


def first_update_err(card, card_job, cpu, cpu_job):
    """Step 0's update, each side from its own gradients (torch's foreach
    Adam on the card, the single-tensor one on the CPU). Adam's first update
    is -lr * u(g), so the card's params must differ from the CPU's by
    -lr * (u(g_card) - u(g_cpu)), within 4 float32 ulps + 1e-3 lr. Returns
    the worst error over that bound."""
    lr = card_job.optimizer.schedule(0)
    for side, job in ((card, card_job), (cpu, cpu_job)):
        job.optimizer.apply(side.state.opt_state, side.state.params,
                            side.grads, 0)
    worst = 0.0
    for p, q, g, h in zip(trainer.tree_leaves(card.state.params),
                          trainer.tree_leaves(cpu.state.params),
                          card.grads, cpu.grads):
        q = q.detach().double()
        err = (p.detach().cpu().double() - q
               + lr * (adam_direction(g) - adam_direction(h))).abs()
        worst = max(worst, (err / (4 * ulp(q) + 1e-3 * lr)).max().item())
    return worst


def first_step_vs_cpu(stage, module, argv):
    """Step 0 of the stage on the card held to the port's CPU run of the
    same params, batch of 8 and noise: the loss, the last layers' gradients,
    through kink flips every other gradient, and the update each side makes
    from its own gradients. The card's gradients are also held to the same
    step in float64 on the CPU that takes the card's choice at every leaky
    ReLU and max pool, with the inputs where float64 would have chosen
    otherwise counted, and how near their kink they lay."""
    t0 = time.perf_counter()
    card_job = module.setup(argv)
    cpu_job = module.setup(argv + ["--device", "cpu"])
    card, cpu = first_step(card_job), first_step(cpu_job)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = first_step(float64_job(module, argv), pin=card.kinks)
    float64_s = time.perf_counter() - t0
    for k, v in card.raw.items():
        require(torch.equal(v.cpu(), cpu.raw[k]), f"first batch differs: {k}")
    paths = trainer.tree_paths(card.state.params)
    return {"loss": card.loss.item(), "loss_cpu": cpu.loss.item(),
            "loss_float64": exact.loss.item(),
            "loss_rel_err": abs(card.loss.item() - cpu.loss.item())
            / abs(cpu.loss.item()),
            "grad_err_of_max": grad_errs(stage, paths, card.grads, cpu.grads),
            "grad_err_of_max_vs_float64_on_card_kinks": grad_errs(
                stage, paths, card.grads, exact.grads),
            "leaky_relu_inputs": sum(b.numel() for b in card.kinks.relu),
            "max_pool_outputs": sum(i.numel() for i in card.kinks.pool),
            "card_kinks_vs_float64": exact.kinks,
            "card_kinks_vs_cpu": kinks_differ(card.kinks, cpu.kinks),
            "first_update_err_over_bound": first_update_err(
                card, card_job, cpu, cpu_job),
            "cpu_side_s": cpu_s, "float64_s": float64_s}


def require_first_step(stage, s):
    vs_cpu = s["grad_err_of_max"]
    kinks = s["card_kinks_vs_float64"]
    require(s["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and vs_cpu["last_layers"] <= TRAIN_GRAD_RTOL_OF_MAX
            and vs_cpu["worst"] <= TRAIN_FLIP_RTOL_OF_MAX
            and vs_cpu["median"] <= TRAIN_FLIP_MEDIAN_RTOL_OF_MAX
            and s["grad_err_of_max_vs_float64_on_card_kinks"]["worst"]
            <= TRAIN_GRAD_RTOL_OF_MAX
            and kinks["relu_flip_margin"] <= TRAIN_KINK_MARGIN
            and kinks["pool_flip_margin"] <= TRAIN_KINK_MARGIN
            and s["first_update_err_over_bound"] <= 1.0,
            f"{stage}: first step differs from the CPU's or from float64: "
            f"{s}")


def adam_vs_float64(stage, module, argv):
    """ADAM_STEPS train steps on the card on one batch, with a new LR (the
    stage's reference values) at every step, each update held to Adam
    written out in float64 on the CPU from the same params and the card's
    own gradients: params, first and second moments. Returns the LRs and,
    per tensor kind, the worst error over its bound."""
    job = module.setup(argv + ["--lr-iter", *ADAM_LR_ITER[stage]])
    state = trainer.init_state(job.params, job.optimizer)
    raw = first_batch(job)
    ref = [{"params": p.detach().cpu().double()}
           for p in trainer.tree_leaves(state.params)]
    for r in ref:
        r["exp_avg"] = torch.zeros_like(r["params"])
        r["exp_avg_sq"] = torch.zeros_like(r["params"])
        r["g_max"] = torch.zeros_like(r["params"])
    worst = dict.fromkeys(("params", "exp_avg", "exp_avg_sq"), 0.0)
    lrs = []
    for t in range(1, ADAM_STEPS + 1):
        _, grads = trainer.value_and_grad(
            job.loss, state.params, raw,
            augment.generator(trainer.STEP_STREAM, job.options["seed"],
                              t - 1))
        lrs.append(job.optimizer.schedule(state.step))
        job.optimizer.apply(state.opt_state, state.params, grads, state.step)
        state = state._replace(step=state.step + 1)
        moments = state.opt_state.state_dict()["state"]
        rel = ADAM_RTOL * t
        for i, (p, g, r) in enumerate(zip(trainer.tree_leaves(state.params),
                                          grads, ref)):
            g = g.cpu().double()
            r["g_max"] = torch.maximum(r["g_max"], g.abs())
            r["exp_avg"] = 0.9 * r["exp_avg"] + 0.1 * g
            r["exp_avg_sq"] = 0.999 * r["exp_avg_sq"] + 0.001 * g * g
            r["params"] = r["params"] - lrs[-1] * (
                r["exp_avg"] / (1 - 0.9 ** t)) / (
                (r["exp_avg_sq"] / (1 - 0.999 ** t)).sqrt() + 1e-8)
            bounds = {
                "params": 4 * t * ulp(r["params"])
                + ADAM_UPDATE_ATOL * sum(lrs),
                "exp_avg": rel * (r["exp_avg"].abs() + r["g_max"])
                + t * F32_SUBNORMAL,
                "exp_avg_sq": rel * (r["exp_avg_sq"] + r["g_max"] ** 2)
                + t * F32_SUBNORMAL}
            got = {"params": p.detach(), **moments[i]}
            for k, bound in bounds.items():
                err = (got[k].cpu().double() - r[k]).abs() / bound
                worst[k] = max(worst[k], err.max().item())
    return {"lr": lrs, "err_over_bound": worst}


def repeated_batch(module, argv, steps):
    """Losses of ``steps`` train steps on the card on one batch with one
    noise draw (step 0's), each step taking the last one's params."""
    job = module.setup(argv)
    state = trainer.init_state(job.params, job.optimizer)
    step = trainer.make_train_step(job.loss, job.optimizer)
    raw = first_batch(job)
    losses = []
    for _ in range(steps):
        state, m = step(state, raw, (job.options["seed"], 0))
        losses.append(m["loss"])
    return [float(v) for v in losses], state


def profile_posenet_step(module, argv, steps=3):
    """torch.profiler over ``steps`` PoseNet train steps after two warm-up
    steps: shares of the window spent in conv forward and backward kernels,
    and idle; the host ops that took longest, and the host's waits on the
    device (scalar reads, synchronizations)."""
    job = module.setup(argv)
    state = trainer.init_state(job.params, job.optimizer)
    step = trainer.make_train_step(job.loss, job.optimizer)
    raw = first_batch(job)
    for i in range(2):
        state, _ = step(state, raw, (0, i))
    torch.cuda.synchronize()

    def window():
        nonlocal state
        for i in range(steps):
            state, _ = step(state, raw, (0, 2 + i))

    return profiled(window, steps)


def profiled(window, steps, require_busy=True):
    """Run ``window()`` (``steps`` train steps) under torch.profiler with
    CUDA events around it: the shares of the window in conv forward and
    backward kernels and idle, the longest device and host ops, and the
    host's waits on the device, each per step."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        window()
        end.record()
        torch.cuda.synchronize()
    window_us = start.elapsed_time(end) * 1e3

    def device_us(evt, total):
        name = ("" if total else "self_") + "device_time_total"
        old = ("" if total else "self_") + "cuda_time_total"
        return getattr(evt, name, None) or getattr(evt, old, 0.0)

    averages = prof.key_averages()
    by_op = {e.key: device_us(e, True) for e in averages}
    busy = sum(device_us(e, False) for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA)
    top = sorted(averages, key=lambda e: -device_us(e, False))[:8]
    host = sorted(averages, key=lambda e: -e.self_cpu_time_total)[:8]
    waits = {e.key: e.count for e in averages if e.key in (
        "aten::_local_scalar_dense", "cudaStreamSynchronize",
        "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaEventSynchronize",
        "cudaGraphLaunch")}
    require(busy > 0 or not require_busy, "the profiler saw no device time")
    return {"steps": steps, "window_ms": window_us / 1e3,
            "busy_share": busy / window_us,
            "idle_share": 1.0 - busy / window_us,
            "conv_forward_share": by_op.get("aten::convolution", 0.0)
            / window_us,
            "conv_backward_share": by_op.get("aten::convolution_backward",
                                             0.0) / window_us,
            "top_device_ms": {e.key[:60]: device_us(e, False) / 1e3 / steps
                              for e in top},
            "top_host_ms": {e.key[:60]: e.self_cpu_time_total / 1e3 / steps
                            for e in host},
            "host_waits": {k: n / steps for k, n in waits.items()}}


def states_equal(a, b):
    """Params, Adam state and step counter equal bit for bit."""
    if a.step != b.step:
        return False
    if not all(torch.equal(x, y) for x, y in zip(
            trainer.tree_leaves(a.params), trainer.tree_leaves(b.params))):
        return False
    sa, sb = a.opt_state.state_dict(), b.opt_state.state_dict()
    return all(torch.equal(v, sb["state"][i][k])
               for i, s in sa["state"].items() for k, v in s.items())


def phase_train(dev):
    """The four trainers' CLIs on the card at full width (phase 7); returns
    the kernel launches of their runs (train_posenet's in-training eval)."""
    rng = np.random.default_rng(4)
    launches = {"flood_fill": 0, "decode_upsampled": 0}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "train.bin")
        eval_data = os.path.join(tmp, "eval.bin")
        write_rhd_file(data, TRAIN_RECORDS, rng)
        write_rhd_file(eval_data, TRAIN_RECORDS, rng)
        for stage in TRAIN_STAGES:
            module, argv = train_argv(stage, data, tmp, TRAIN_STEPS)
            extra = ["--eval-data", eval_data,
                     "--eval-freq", str(TRAIN_STEPS // 2),
                     "--eval-batches", "2"] if stage == "posenet" else []
            log_path = os.path.join(tmp, stage.split()[0] + ".jsonl")
            zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            with timed_steps() as events, recorded_decodes() as decodes:
                state = module.main(argv + extra + ["--metrics-log",
                                                    log_path])
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated(dev)
            require_exact_f32()
            require(state.step == TRAIN_STEPS, f"{stage}: step {state.step}")
            ms = [s.elapsed_time(e) for s, e in events]
            require(len(ms) == TRAIN_STEPS, f"{stage}: {len(ms)} steps timed")
            rows = [json.loads(line) for line in open(log_path)]
            losses = [r["loss"] for r in rows if "loss" in r]
            if stage == "posenet":
                PER_STEP_POSENET.update(
                    params=[p.detach().clone()
                            for p in trainer.tree_leaves(state.params)],
                    loss0=losses[0], ms_median=float(np.median(ms[3:])))
            require(len(losses) == 2 and all(np.isfinite(losses)),
                    f"{stage}: losses {losses}")
            if stage == "posenet":
                require(counts["decode_upsampled"] > 0,
                        "train_posenet's in-training eval never launched "
                        "the decode kernel")
                with torch.inference_mode():
                    for sm, factor, got in decodes:
                        require(torch.equal(
                            got, keypoints.decode_upsampled_torch(sm, factor)),
                            "decode differs from its twin on train_posenet's "
                            "eval scoremaps")
                        require(torch.equal(
                            decode.decode_upsampled_cuda(sm, factor), got),
                            "decode kernel not reproducible")
                evals = [r for r in rows if "eval_epe_mean_px" in r]
                require([r["step"] for r in evals]
                        == [TRAIN_STEPS // 2, TRAIN_STEPS],
                        f"in-training evals at {evals}")
            for k in launches:
                launches[k] += counts[k]

            # step 0 on the card against the CPU; the repeated-batch descent
            vs_cpu = first_step_vs_cpu(stage, module, argv)
            adam = adam_vs_float64(stage, module, argv)
            repeated, _ = repeated_batch(module, argv, TRAIN_STEPS)
            med = float(np.median(ms[3:]))
            line = {"train": stage, "batch": TRAIN_BATCH,
                    "steps": TRAIN_STEPS, "ms_per_step_median": med,
                    "ms_per_step": ms, "images_per_s": TRAIN_BATCH * 1e3 / med,
                    "peak_mem_bytes": peak, "loss_first": losses[0],
                    "loss_last": losses[-1], "main_s": host_s,
                    "launches": counts, "first_step_vs_cpu": vs_cpu,
                    "adam_vs_float64": adam,
                    "repeated_batch_loss": [repeated[0], repeated[-1]]}
            if stage == "posenet":
                line["eval_decodes_checked"] = len(decodes)
                line["profile"] = profile_posenet_step(module, argv)
                PER_STEP_POSENET["profile"] = line["profile"]
            log(json.dumps(line))
            require_first_step(stage, vs_cpu)
            require(max(adam["err_over_bound"].values()) <= 1.0,
                    f"{stage}: the card's Adam differs from float64's: {adam}")
            if stage in ("posenet", "lifting proposed"):
                require(repeated[-1] < repeated[0], f"{stage}: loss did not "
                        f"fall on a repeated batch: {repeated}")
        phase_train_resume(tmp, data)
    require_exact_f32()
    return launches


def phase_train_resume(tmp, data, *extra):
    """train_posenet: 3 steps + --resume 3 steps equals 6 straight steps bit
    for bit, under deterministic algorithms, with the trainer flags
    ``extra``. It runs in a child process: deterministic cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG before cuBLAS starts, and the other phases keep
    cuBLAS's default workspace."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), RESUME_CHILD, tmp, data,
         *extra], env=env, capture_output=True, text=True, timeout=600)
    sys.stdout.write(child.stdout)
    sys.stderr.write(child.stderr)
    require(child.returncode == 0,
            f"the resume check's child process exited {child.returncode}")


def train_resume_child(tmp, data, *extra):
    require(torch.cuda.is_available(), "no CUDA device")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    runs = {}
    for label, argv in (
            ("straight", train_argv("posenet", data, tmp, 6, *extra)[1]),
            ("first", train_argv("posenet", data, os.path.join(tmp, "r"),
                                 3, *extra)[1]),
            ("resumed", train_argv("posenet", data, os.path.join(tmp, "r"),
                                   6, "--resume", *extra)[1])):
        runs[label] = train_posenet.main(argv)
    require(runs["first"].step == 3, "the first run did not stop at 3")
    require(states_equal(runs["straight"], runs["resumed"]),
            f"train_posenet {' '.join(extra)}: 3 + --resume 3 steps differ "
            "from 6 straight steps")
    require_exact_f32()
    log(f"train_posenet {' '.join(extra)}: 3 steps + --resume 3 == 6 "
        "straight steps, bit for bit (params and Adam state; deterministic "
        "cuDNN, cuBLAS and torch algorithms, in a child process)")


def resident_replays():
    """The counter ``train.resident_step.replays`` since the process
    began: replays of every resident step's CUDA graph."""
    return profiling.counters().get("train.resident_step.replays", 0)


@contextlib.contextmanager
def timed_windows():
    """CUDA events around every window that ``train.loop.fit``'s resident
    step runs (start, end, steps), and the replays of each step it made
    (the counter's growth over that step's windows)."""
    windows, replays = [], []
    base = loop.make_resident_train_step

    def make(*args, **kw):
        step = base(*args, **kw)
        made = len(replays)
        replays.append(0)

        def timed(state, data, idx, *rest):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = resident_replays()
            start.record()
            out = step(state, data, idx, *rest)
            end.record()
            replays[made] += resident_replays() - before
            windows.append((start, end, len(idx)))
            return out
        return timed

    loop.make_resident_train_step = make
    try:
        yield windows, replays
    finally:
        loop.make_resident_train_step = base


def param_rel_l2(params, want, init):
    """max over tensors of |params - want| / |want - init| (L2)."""
    worst = 0.0
    for p, w, p0 in zip(params, want, init):
        w, p0 = w.double(), p0.double()
        moved = (w - p0).norm().item()
        require(moved > 0, "a tensor did not move in training")
        worst = max(worst, (p.double() - w).norm().item() / moved)
    return worst


def resident_run(module, argv, log_path):
    """``module.main`` with ``argv``: its final state, the metrics log's
    rows, the windows, the replays of each resident step it made (the steps
    themselves, and their graphs, are let go), its launches."""
    zero_counts()
    with timed_windows() as (windows, replays):
        state = module.main(argv + ["--metrics-log", log_path])
    torch.cuda.synchronize()
    rows = [json.loads(line) for line in open(log_path)]
    counts = launch_counts()
    return state, rows, windows, replays, counts


def warm_resident(module, argv, dev, remat=False):
    """A resident PoseNet step over the job's file, RESIDENT_K steps a
    window, captured and run for two windows: (step, state, data, idx)."""
    job = module.setup(argv)
    state = trainer.init_state(job.params, job.optimizer)
    step = trainer.make_resident_train_step(job.loss, job.optimizer,
                                            remat=remat)
    data = resident_data(job.pipeline.dataset, dev)
    rows = epoch_indices(len(job.pipeline.dataset), TRAIN_BATCH, True,
                         job.pipeline.seed)
    idx = np.stack([rows[i % len(rows)] for i in range(RESIDENT_K)])
    for w in range(2):
        state, metrics = step(state, data, idx, 0, w * RESIDENT_K)
    metrics.cpu()
    return step, state, data, idx


def profile_resident_window(module, argv, dev):
    """torch.profiler over one resident window of RESIDENT_K PoseNet steps,
    after the capture and one more window."""
    before = resident_replays()
    step, state, data, idx = warm_resident(module, argv, dev)
    out = profiled(lambda: step(state, data, idx, 0, 2 * RESIDENT_K)[1]
                   .cpu(), RESIDENT_K, require_busy=False)
    out["replays"] = resident_replays() - before
    return out


def resident_remat_runs(module, argv, dev):
    """The resident step under each of REMAT_SETTINGS: ms a step over a
    third window (CUDA events, the loss read included) and the peak memory
    from the step's build on (its capture included)."""
    out = {}
    for remat in REMAT_SETTINGS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = resident_replays()
        step, state, data, idx = warm_resident(module, argv, dev, remat)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, data, idx, 0, 2 * RESIDENT_K)[1].cpu()
        end.record()
        torch.cuda.synchronize()
        replays = resident_replays() - before
        out[str(remat)] = {
            "ms_per_step": start.elapsed_time(end) / RESIDENT_K,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "replays": replays}
        require(replays == 3 * RESIDENT_K,
                f"--remat {remat}: {replays} replays")
        del step, state, data
    return out


def remat_runs(module, argv, dev):
    """PoseNet at batch 8 under each of REMAT_SETTINGS: peak memory and ms a
    step over REMAT_STEPS per-step steps, and step 0's gradients held to
    no remat's."""
    job = module.setup(argv)
    raw = first_batch(job)
    seed = job.options["seed"]
    out, plain = {}, None
    for remat in REMAT_SETTINGS:
        state = trainer.init_state(job.params, job.optimizer)
        _, grads = trainer.value_and_grad(
            job.loss, state.params, raw,
            augment.generator(trainer.STEP_STREAM, seed, 0), remat)
        grads = [g.cpu() for g in grads]
        if plain is None:
            plain = grads
        err = max(((g - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(grads, plain))
        del grads
        step = trainer.make_train_step(job.loss, job.optimizer, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        events = []
        for i in range(REMAT_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step(state, raw, (seed, i))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in events]
        out[str(remat)] = {"peak_mem_bytes": torch.cuda.max_memory_allocated(
            dev), "ms_per_step": ms, "ms_median": float(np.median(ms)),
            "grad0_err_of_max": err}
        require(err <= REMAT_GRAD_RTOL_OF_MAX,
                f"--remat {remat}: step 0's gradients {err:.3g} of the max "
                "from no remat's")
    return out


def native_reads(data, dev):
    """The 64-record file through the C++ streamer: its batches equal the
    memmap's records at the indices it returns, and
    ``InputPipeline(use_native=True)`` yields those batches; records/s of
    the native and the threaded pipeline (raw batches on the card)."""
    ds = RHDDataset("training", data)
    golden = np.memmap(data, dtype=codec.RHD_RECORD_DTYPE, mode="r")
    reader = native.NativeRecordReader(data, codec.RHD_RECORD_DTYPE,
                                       TRAIN_BATCH, seed=0)
    reader.reset(1)
    pipe = InputPipeline(ds, PreprocessConfig(), TRAIN_BATCH, seed=0,
                         yield_raw=True, use_native=True, device=dev)
    batches = 0
    for raw in pipe.iterate(epochs=1):
        recs, idx = reader.next_batch()
        require(recs.tobytes() == golden[idx].tobytes(),
                "the streamer's records differ from the memmap's")
        for k, v in raw.items():
            require(np.array_equal(v.cpu().numpy(), recs[k]),
                    f"the native pipeline's {k} differs from the streamer's")
        batches += 1
    require(reader.next_batch() is None and batches == len(ds) // TRAIN_BATCH,
            f"the native pipeline gave {batches} batches")
    reader.close()
    rates = {}
    for use_native in (True, False):
        pipe = InputPipeline(ds, PreprocessConfig(), TRAIN_BATCH, seed=0,
                             yield_raw=True, use_native=use_native,
                             device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(raw["image"].shape[0]
                for raw in pipe.iterate(epochs=NATIVE_EPOCHS))
        torch.cuda.synchronize()
        rates["native" if use_native else "threaded"] = n / (
            time.perf_counter() - t0)
    return {"batches_checked": batches, "records_per_s": rates}


def phase_train_resident(dev):
    """train_posenet's device-resident path (--steps-per-call) at full
    width on phase 10's file, held to phase 10's per-step run; the LR
    boundary inside a window; exact resume; the profile of a window; the
    remat policies; the C++ streamer. Returns the kernel launches (the
    in-training evals' decodes)."""
    require(PER_STEP_POSENET, "phase 10's per-step PoseNet run is missing")
    rng = np.random.default_rng(4)  # phase 10's two files, byte for byte
    module = train_posenet
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "train.bin")
        eval_data = os.path.join(tmp, "eval.bin")
        write_rhd_file(data, TRAIN_RECORDS, rng)
        write_rhd_file(eval_data, TRAIN_RECORDS, rng)
        _, argv = train_argv("posenet", data, tmp, TRAIN_STEPS)
        init = [p.detach().clone()
                for p in trainer.tree_leaves(module.setup(argv).params)]

        # 20 steps in windows of 7, evals at 10 and 20 as in phase 10
        state, rows, windows, replays, counts = resident_run(
            module, argv + ["--steps-per-call", str(RESIDENT_K),
                            "--eval-data", eval_data,
                            "--eval-freq", str(TRAIN_STEPS // 2),
                            "--eval-batches", "2"],
            os.path.join(tmp, "resident.jsonl"))
        require_exact_f32()
        require(state.step == TRAIN_STEPS, f"resident: step {state.step}")
        require(replays == [TRAIN_STEPS],
                f"resident: {replays} replays, {TRAIN_STEPS} steps")
        require([k for *_, k in windows] == [7, 7, 6],
                f"windows {[k for *_, k in windows]}")
        losses = [r for r in rows if "loss" in r]
        require(losses[0]["step"] == 0
                and losses[0]["loss"] == PER_STEP_POSENET["loss0"],
                f"step 0's loss {losses[0]} differs from the per-step "
                f"run's {PER_STEP_POSENET['loss0']}")
        evals = [r["step"] for r in rows if "eval_epe_mean_px" in r]
        require(evals == [14, TRAIN_STEPS], f"resident evals at {evals}")
        require(counts["decode_upsampled"] > 0,
                "the resident run's evals never launched the decode kernel")
        params_err = param_rel_l2(trainer.tree_leaves(state.params),
                                  PER_STEP_POSENET["params"], init)
        window_ms = [a.elapsed_time(b) / k for a, b, k in windows]
        # the spread: a second per-step run of phase 10's flags
        again = resident_run(module, argv, os.path.join(tmp, "again.jsonl"))
        spread = param_rel_l2(trainer.tree_leaves(again[0].params),
                              PER_STEP_POSENET["params"], init)
        params_bound = max(RESIDENT_PARAM_REL_L2, RESIDENT_SPREAD * spread)
        del again

        # the LR boundary at 5 inside the window 4..8, held to the per-step
        # run of the same flags
        lr_runs = {}
        for k in (RESIDENT_LR_K, 1):
            lr_runs[k] = resident_run(
                module, train_argv("posenet", data, os.path.join(tmp, str(k)),
                                   RESIDENT_LR_STEPS, *RESIDENT_LR,
                                   "--steps-per-call", str(k),
                                   "--show-loss-freq", "1")[1],
                os.path.join(tmp, f"lr{k}.jsonl"))
        lrs = [r["lr"] for r in lr_runs[RESIDENT_LR_K][1] if "loss" in r]
        want = [1e-4] * 5 + [1e-5] * (RESIDENT_LR_STEPS - 5)
        require(lrs == want, f"the device's LRs {lrs}, the schedule {want}")
        lr_err = param_rel_l2(
            trainer.tree_leaves(lr_runs[RESIDENT_LR_K][0].params),
            trainer.tree_leaves(lr_runs[1][0].params), init)

        phase_train_resume(tmp, data, "--steps-per-call", "2")
        profile = profile_resident_window(module, argv, dev)
        remat = remat_runs(module, argv, dev)
        remat_resident = resident_remat_runs(module, argv, dev)
        reads = native_reads(data, dev)
    per_step = PER_STEP_POSENET["profile"]
    line = {"train_resident": "posenet", "batch": TRAIN_BATCH,
            "steps": TRAIN_STEPS, "steps_per_call": RESIDENT_K,
            "replays": replays[0],
            "windows": [k for *_, k in windows],
            "ms_per_step_by_window": window_ms,
            "ms_per_step": float(np.mean(window_ms[1:])),
            "per_step_ms_median": PER_STEP_POSENET["ms_median"],
            "loss0": losses[0]["loss"],
            "loss0_per_step": PER_STEP_POSENET["loss0"],
            "params_rel_l2_vs_per_step": params_err,
            "per_step_rerun_rel_l2": spread, "params_bound": params_bound,
            "evals_at": evals,
            "launches": counts,
            "lr_window": {"steps_per_call": RESIDENT_LR_K, "lr": lrs,
                          "params_rel_l2_vs_per_step": lr_err},
            "profile": profile,
            "per_step_profile": {k: per_step[k] for k in (
                "window_ms", "idle_share", "host_waits")},
            "remat": remat, "remat_resident": remat_resident,
            "native": reads}
    log(json.dumps(line))
    require(params_err <= params_bound and lr_err <= params_bound,
            f"resident params {params_err:.3g} / {lr_err:.3g} from the "
            f"per-step run's (bound {params_bound:.3g}; a second per-step "
            f"run: {spread:.3g})")
    require_exact_f32()
    return counts


def write_reference_pickles(tmp, params_np):
    """handsegnet-rhd.pickle and posenet3d-rhd-stb.pickle as the reference
    ships them, {variable name + ':0': ndarray}, from ``params_np``."""
    paths = []
    for name, scopes in (("handsegnet-rhd.pickle", ("HandSegNet",)),
                         ("posenet3d-rhd-stb.pickle",
                          ("PoseNet2D", "PosePrior", "ViewpointNet"))):
        flat = weights.tree_to_flat({s: params_np[s] for s in scopes})
        paths.append(os.path.join(tmp, name))
        with open(paths[-1], "wb") as f:
            pickle.dump({k + ":0": v for k, v in flat.items()}, f,
                        protocol=2)
    return paths


def write_cpm_checkpoint(prefix, params_np):
    """A TF checkpoint in the CPM-MPII warm start's layout, from the same
    HandSegNet and PoseNet arrays: HandSegNet's layers under
    CPM/PersonNet/<layer>_CPM, PoseNet's trunk under CPM/PoseNet/<layer>_CPM
    (its refiners are Mconv layers in the real model: one decoy stands for
    them), with Adam's two slots of every variable, the beta powers and
    global_step. Returns {scope: layers} that the warm-start rules must
    take: all but HandSegNet's conv6_* and PoseNet's conv5_2."""
    ckpt = {}
    for scope, net in (("HandSegNet", "PersonNet"), ("PoseNet2D", "PoseNet")):
        for name, value in weights.tree_to_flat(params_np[scope]).items():
            layer, leaf = name.split("/")
            if scope == "PoseNet2D" and layer.startswith(("conv6", "conv7")):
                continue
            var = f"CPM/{net}/{layer}_CPM/{leaf}"
            ckpt[var] = ckpt[var + "/Adam"] = ckpt[var + "/Adam_1"] = value
    ckpt["CPM/PoseNet/Mconv1_stage2/weights"] = \
        params_np["PoseNet2D"]["conv6_1"]["weights"]
    ckpt["beta1_power"] = np.asarray(0.9, np.float32)
    ckpt["beta2_power"] = np.asarray(0.999, np.float32)
    ckpt["global_step"] = np.asarray(300000, np.int64)
    tf_ckpt.write_checkpoint(prefix, ckpt)
    return {"HandSegNet": {k for k in params_np["HandSegNet"]
                           if not k.startswith("conv6")},
            "PoseNet2D": {k for k in params_np["PoseNet2D"]
                          if not k.startswith(("conv5_2", "conv6", "conv7"))}}


def require_layers(tree, source, label):
    """Every array of ``tree`` equals its ``source`` array bit for bit."""
    flat, src = weights.tree_to_flat(tree), weights.tree_to_flat(source)
    for k, v in flat.items():
        require(k in src and v.dtype == src[k].dtype
                and np.array_equal(v, src[k]), f"{label}: {k} differs from "
                "the array it was written from")


def phase_weights(dev, params_np):
    """Phase 11: the reference's weight formats through --weights. Returns
    the kernel launches of the eval2d run on the pickles and of the
    warm-started training run."""
    t_phase = time.perf_counter()
    line = {"phase": "weights", "load_s": {}}
    launches = {"flood_fill": 0, "decode_upsampled": 0}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pickles = write_reference_pickles(tmp, params_np)
        cpm = os.path.join(tmp, "cpm-model-mpii")
        taken = write_cpm_checkpoint(cpm, params_np)
        npz = os.path.join(tmp, "w.npz")
        weights.save_npz(npz, params_np)
        rhd = os.path.join(tmp, "rhd.bin")
        write_rhd_file(rhd, WEIGHTS_RECORDS, np.random.default_rng(5))
        line["write_s"] = time.perf_counter() - t0
        line["bytes"] = {os.path.basename(p): os.path.getsize(p)
                         for p in (*pickles, cpm + ".data-00000-of-00001")}

        # each file alone: its arrays bit for bit, its scopes only
        for path, scopes in zip(pickles, (["HandSegNet"], [
                "PoseNet2D", "PosePrior", "ViewpointNet"])):
            t0 = time.perf_counter()
            tree = _common.load_weight_trees([path])
            line["load_s"][os.path.basename(path)] = time.perf_counter() - t0
            require(sorted(tree) == scopes and all(
                tree[s].keys() == params_np[s].keys() for s in scopes),
                f"{path}: scopes or layers differ")
            require_layers(tree, params_np, os.path.basename(path))
        t0 = time.perf_counter()
        tree = _common.load_weight_trees([cpm])
        line["load_s"]["cpm-model-mpii"] = time.perf_counter() - t0
        require({s: set(v) for s, v in tree.items()} == taken,
                f"the CPM checkpoint gave {sorted(tree)}: "
                f"{ {s: sorted(v) for s, v in tree.items()} }")
        require_layers(tree, params_np, "cpm-model-mpii")
        # layers the checkpoint does not name keep their seeded values
        seeded = weights.random_params(1)
        kept = {k: v.copy() for k, v in weights.tree_to_flat(seeded).items()}
        merged = weights.tree_to_flat(_common.init_or_load(seeded, [cpm]))
        from_file = weights.tree_to_flat(tree)
        require(merged.keys() == kept.keys(), "init_or_load changed names")
        for k, v in merged.items():
            require(np.array_equal(v, from_file.get(k, kept[k])),
                    f"init_or_load: {k} is neither the file's nor the seed's")
        line["cpm_layers_taken"] = {s: len(v) for s, v in taken.items()}

        # eval2d on the pickles and on the .npz of the same tree: the same
        # decoded keypoints and distances, exactly
        runs = {}
        for label, files in (("pickles", pickles), ("npz", [npz])):
            zero_counts()
            with recorded_dists() as dists, \
                    recorded_decodes(cascade) as decodes:
                eval2d.main(["--data", rhd, "--batch-size",
                             str(WEIGHTS_BATCH), "--no-wrist", "--weights",
                             *files])
            torch.cuda.synchronize()
            runs[label] = (dists, decodes, launch_counts())
        (p_dists, p_decodes, counts), (n_dists, n_decodes, _) = \
            runs["pickles"], runs["npz"]
        for name, n in counts.items():
            require(n > 0, f"eval2d on the pickles never launched {name}")
        add_counts(launches, counts)
        require(len(p_decodes) == len(n_decodes) == len(p_dists) > 0,
                "eval2d ran other batches on the two files")
        with torch.inference_mode():
            for (sm, factor, got), (_, _, want) in zip(p_decodes, n_decodes):
                require(torch.equal(got, want), "eval2d's keypoints on the "
                        "pickles differ from those on the .npz")
                require(torch.equal(
                    got, keypoints.decode_upsampled_torch(sm, factor)),
                    "decode differs from its twin on eval2d's scoremaps")
        require(all(np.array_equal(a, b) for a, b in zip(p_dists, n_dists)),
                "eval2d's distances on the pickles differ from the .npz's")
        line["eval2d_launches"] = counts

        # train_posenet warm-started from the checkpoint: step 0 holds its
        # PoseNet2D layers, and the trainer's own seeded ones elsewhere
        job = train_posenet.setup([
            "--data", rhd, "--max-iter", str(WEIGHTS_TRAIN_STEPS),
            "--show-loss-freq", "1",
            "--snapshot-dir", os.path.join(tmp, "snaps"), "--weights", cpm,
            "--eval-data", rhd, "--eval-batches", "1",
            "--eval-freq", str(WEIGHTS_TRAIN_STEPS)])
        step0 = weights.params_to_jax(job.params)
        require(list(step0) == [posenet.SCOPE], f"scopes {list(step0)}")
        own = posenet.init(np.random.default_rng(0))
        for layer, leaves in step0[posenet.SCOPE].items():
            src = params_np[posenet.SCOPE] if layer in taken[posenet.SCOPE] \
                else own
            require(all(np.array_equal(v, src[layer][k])
                        for k, v in leaves.items()),
                    f"train_posenet's step-0 {layer} is not the "
                    f"{'checkpoint' if src is not own else 'seeded'} one")
        zero_counts()
        state = _common.run(job)
        torch.cuda.synchronize()
        counts = launch_counts()
        require(state.step == WEIGHTS_TRAIN_STEPS, f"step {state.step}")
        require(counts["decode_upsampled"] > 0, "the warm-started "
                "train_posenet's eval never launched the decode kernel")
        add_counts(launches, counts)
        line["train_launches"] = counts
    require_exact_f32()
    line["s"] = time.perf_counter() - t_phase
    log(json.dumps(line))
    return launches

# --- mesh: data parallelism over ranks ---------------------------------------


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def digest(tensors):
    """sha256 of the tensors' bytes, in order: what ranks compare to show
    that they are bit-equal."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_dp_steps(mesh, rank, data, tmp, dev):
    """MESH_TRAIN_STEPS data-parallel steps of train_posenet at full width,
    this rank fed its rows of each global batch by the CLI's sharded
    pipeline. Rank 0 also takes one process's gradients of the gathered
    global batch at the same params and draws, and holds the DP step to
    them. Per step: the loss, ms, the all-reduce calls and bytes, a digest
    of the params after it, the visible keypoints of this rank's rows."""
    world = mesh_lib.batch_shard_count(mesh)
    job = train_posenet.setup([
        "--data", data, "--batch-size", str(MESH_TRAIN_BATCH // world),
        "--max-iter", str(MESH_TRAIN_STEPS), "--mesh", f"{world}x1",
        "--device", str(dev), "--snapshot-dir", os.path.join(tmp, f"dp{rank}")])
    state = trainer.init_state(job.params, job.optimizer)
    mesh_lib.broadcast_(trainer.tree_leaves(state.params))
    grads_of = trainer.DataParallelGrads(job.loss, mesh)
    paths = trainer.tree_paths(state.params)
    seed = job.options["seed"]
    it = job.pipeline.iterate(epochs=None)
    steps = []
    try:
        for i in range(MESH_TRAIN_STEPS):
            raw = next(it)
            sync(dev)
            t0 = time.perf_counter()
            with counted_collectives() as sent:
                loss, grads = grads_of(state.params, raw, (seed, i))
            sync(dev)
            grad_s = time.perf_counter() - t0
            whole = mesh_lib.gather_rows(raw, mesh)
            reduced = sent.get("all_reduce", {"calls": 0, "bytes": 0})
            step = {"loss": loss.item(), "vis": int(raw["kp_vis"].sum()),
                    "allreduce_calls": reduced["calls"],
                    "allreduce_bytes": reduced["bytes"]}
            if rank == 0:
                ref_loss, ref_grads = trainer.value_and_grad(
                    job.loss, state.params, whole,
                    augment.generator(trainer.STEP_STREAM, seed, i))
                step["single_loss"] = ref_loss.item()
                step["grad_err_of_max"] = grad_errs(
                    "posenet", paths, grads, [g.cpu() for g in ref_grads])
            t0 = time.perf_counter()
            job.optimizer.apply(state.opt_state, state.params, grads,
                                state.step)
            state = state._replace(step=state.step + 1)
            sync(dev)
            step["ms"] = (grad_s + time.perf_counter() - t0) * 1e3
            step["params"] = digest(trainer.tree_leaves(state.params))
            steps.append(step)
    finally:
        it.close()
    return steps


def mesh_eval(mesh, evalfile, dev):
    """cli.eval_full over the synthetic RHD eval file, with --mesh on a
    mesh: its printed metrics, its dists and its kernel launches on this
    rank."""
    argv = ["--dataset", "rhd", "--data", evalfile, "--batch-size",
            str(MESH_EVAL_BATCH), "--device", str(dev)]
    if mesh is not None:
        argv += ["--mesh", f"{mesh_lib.batch_shard_count(mesh)}x1"]
    buf = io.StringIO()
    with recorded_dists() as rows, contextlib.redirect_stdout(buf):
        zero_counts()
        eval_full.main(argv)
        counts = launch_counts()
    lines = [l for l in buf.getvalue().splitlines()
             if l.startswith(("Average", "Area"))]
    return {"lines": lines, "dists": np.concatenate(rows).tolist(),
            "launches": counts}


def mesh_serve_images():
    return np.random.default_rng(9).integers(
        0, 256, (MESH_SERVE_BATCH, H, W, 3), dtype=np.uint8)


def mesh_serve(mesh, tmp, rank, dev):
    """HandPoseEstimator(mesh=) at batch MESH_SERVE_BATCH, H x W: its answers
    on this rank, the cascade's fields of this rank's rows gathered over the
    ranks, both kernels held to their twins on those rows."""
    est = HandPoseEstimator(weights.random_params(0),
                            batch_size=MESH_SERVE_BATCH, input_hw=(H, W),
                            mesh=mesh, device=dev)
    images = mesh_serve_images()
    zero_counts()
    served = est.predict(images)
    sync(dev)
    counts = launch_counts()
    lo, per = est.rows
    image = torch.from_numpy(normalize_images(images)[lo:lo + per]).to(dev)
    fields = parity.port_fields(est.params, image, est.hand_side)
    fields = mesh_lib.gather_rows(
        {k: torch.from_numpy(v).to(dev) for k, v in fields.items()}, mesh)
    det, seed, sm = slice_inputs(est.params, image, est.hand_side)
    err = {}
    for name, (got, want) in {
            "flood_fill": (floodfill.flood_fill_cuda(det, seed, NUM_PASSES),
                           segmentation.flood_fill_torch(det, seed,
                                                         NUM_PASSES)),
            "decode_upsampled": (decode.decode_upsampled_cuda(sm, FACTOR),
                                 keypoints.decode_upsampled_torch(sm, FACTOR))
            }.items():
        require(torch.equal(got, want),
                f"rank {rank}: {name} differs from its twin on its rows")
        err[name] = (got - want).abs().max().item()
    np.savez(os.path.join(tmp, f"serve{rank}.npz"),
             **{f"served_{k}": v for k, v in served.items()},
             **{f"fields_{k}": v.cpu().numpy() for k, v in fields.items()})
    return {"launches": counts, "max_abs_err": err}


def mesh_child(rank, world, port, tmp, data, evalfile, device, backend):
    """One rank of phase_mesh (gloo on a shared card, or NCCL on its own):
    the DP steps, eval_full and the estimator, each on the mesh; the
    results as the last stdout line."""
    rank, world = int(rank), int(world)
    dev = torch.device(device)
    if dev.type == "cuda":
        require(torch.cuda.is_available(), "no CUDA device")
        torch.cuda.set_device(dev)
    precision.exact_f32(dev)
    mesh_lib.init_distributed(f"127.0.0.1:{port}", world, rank,
                              backend=backend, timeout=MESH_TIMEOUT_S)
    mesh = mesh_lib.make_mesh(world, 1)
    t0 = time.perf_counter()
    out = {"dp": mesh_dp_steps(mesh, rank, data, tmp, dev)}
    out["dp_s"] = time.perf_counter() - t0
    out["eval"] = mesh_eval(mesh, evalfile, dev)
    out["serve"] = mesh_serve(mesh, tmp, rank, dev)
    require_exact_f32()
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def mesh_nccl_child(tmp, data):
    """The one NCCL rank (the launcher's environment set by phase_mesh):
    train_posenet --deterministic for MESH_TRAIN_STEPS steps without a mesh,
    then with --mesh 1x1 over NCCL, the two final states compared bit for
    bit; then ms a step of the mesh step against the plain one on one
    batch, in turns (plain, mesh, mesh, plain)."""
    require(torch.cuda.is_available(), "no CUDA device")
    module, argv = train_argv("posenet", data, tmp, MESH_TRAIN_STEPS,
                              "--deterministic")
    states = {}
    for label, extra in (("plain", []), ("mesh", ["--mesh", "1x1"])):
        states[label] = module.main(argv + extra + [
            "--snapshot-dir", os.path.join(tmp, f"nccl_{label}")])
    backend = torch.distributed.get_backend()
    require(backend == "nccl", f"--mesh 1x1 ran over {backend}")
    equal = states_equal(states["plain"], states["mesh"])
    require(equal, "train_posenet --mesh 1x1 over NCCL differs from the run "
            "without a mesh (--deterministic)")
    job = module.setup(argv + ["--mesh", "1x1"])
    mesh = job.options["mesh"]
    state = trainer.init_state(job.params, job.optimizer)
    raw = first_batch(job)
    steps = {"plain": trainer.make_train_step(job.loss, job.optimizer),
             "mesh": trainer.make_train_step(job.loss, job.optimizer,
                                             mesh=mesh)}
    for fn in steps.values():
        for i in range(2):
            state, _ = fn(state, raw, (0, i))
    ms = {k: [] for k in steps}
    for k in ("plain", "mesh", "mesh", "plain"):
        def one():
            nonlocal state
            state, _ = steps[k](state, raw, (0, 0))
        ms[k].append(cuda_ms(one, MESH_TIMED_STEPS))
    require_exact_f32()
    torch.distributed.destroy_process_group()
    print(json.dumps({"bit_equal": equal, "backend": backend,
                      "ms": {k: float(np.mean(v)) for k, v in ms.items()},
                      "ms_turns": ms}), flush=True)


def mesh_eval_held(params_np, evalfile, dev, world):
    """Where the ranks' dists differ from one process's: per batch, the
    cascade on each rank's rows (the card's algorithms at that batch) held
    flip-aware to the cascade on the whole batch; returns the images whose
    masks differ (rerun), by global index."""
    dataset = RHDDataset("evaluation", evalfile)
    params = weights.params_from_jax(params_np, dev)
    rerun = []
    for bi, (idx, _) in enumerate(harnesses.eval_batches(
            len(dataset), MESH_EVAL_BATCH)):
        data = preprocessed(preprocess_rhd, harnesses.FULL_PIPELINE_CONFIG,
                            dataset.raw_batch(idx), dev)
        image = resize_bilinear(data["image"], harnesses.NET_INPUT_HW)
        side = hand_side_of(data)
        ref = parity.port_fields(params, image, side)
        per = MESH_EVAL_BATCH // world
        parts = [parity.port_fields(params, image[r * per:(r + 1) * per],
                                    side[r * per:(r + 1) * per])
                 for r in range(world)]
        got = {k: np.concatenate([p[k] for p in parts]) for k in ref}
        summary = parity.check_cascade(
            ref, got, parity.port_rerun(params, image, side),
            scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
            flip_bound=FLIP_BOUND)
        rerun += [bi * MESH_EVAL_BATCH + i for i in summary["images_rerun"]]
    return rerun


def phase_mesh(dev, params_np, smi, cards=1):
    """(a) DP train steps of train_posenet held to one process's step and
    the ranks to each other; (b) one NCCL rank: train_posenet --mesh 1x1
    equal to the run without a mesh; (c) eval_full --mesh on every rank
    against one process; (d) HandPoseEstimator(mesh=) on every rank against
    one process. On one card (``cards=1``) MESH_WORLD gloo ranks share it;
    on ``cards`` > 1 one NCCL rank runs on each card, and (b) is left out."""
    t_phase = time.perf_counter()
    world = MESH_WORLD if cards == 1 else cards
    backend = "gloo" if cards == 1 else "nccl"
    devices = ([MESH_DEVICE] * world if cards == 1
               else [f"cuda:{r}" for r in range(cards)])
    line = {"phase": "mesh", "card": smi, "world": world,
            "backend": backend, "devices": devices}
    launches = dict.fromkeys(KERNELS, 0)
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(23)
        data = os.path.join(tmp, "train.bin")
        evalfile = os.path.join(tmp, "eval.bin")
        write_rhd_file(data, TRAIN_RECORDS, rng)
        write_rhd_file(evalfile, MESH_EVAL_RECORDS, rng)
        port = free_port()
        t0 = time.perf_counter()
        ranks = run_processes([
            [sys.executable, me, MESH_CHILD, str(r), str(world), str(port),
             tmp, data, evalfile, devices[r], backend]
            for r in range(world)])
        line["children_s"] = time.perf_counter() - t0

        # (a) the DP steps: ranks in lockstep, held to one process
        dp = [r["dp"] for r in ranks]
        for i, steps in enumerate(zip(*dp)):
            require(len({(s["loss"], s["params"]) for s in steps}) == 1,
                    f"DP step {i}: the ranks differ")
            s = steps[0]
            rel = abs(s["loss"] - s["single_loss"]) / abs(s["single_loss"])
            e = s["grad_err_of_max"]
            require(rel <= MESH_LOSS_RTOL
                    and e["last_layers"] <= TRAIN_GRAD_RTOL_OF_MAX
                    and e["worst"] <= TRAIN_FLIP_RTOL_OF_MAX
                    and e["median"] <= TRAIN_FLIP_MEDIAN_RTOL_OF_MAX,
                    f"DP step {i} differs from one process's step on the "
                    f"global batch: loss rel {rel}, gradients {e}")
            s["loss_rel_err"] = rel
        require(any(len({s["vis"] for s in steps}) > 1
                    for steps in zip(*dp)),
                "the ranks' rows never differed in visible keypoints")
        line["dp_steps"] = dp[0]
        line["dp_vis_by_rank"] = [[s["vis"] for s in d] for d in dp]
        line["dp_ms_per_step_after_first"] = float(np.mean(
            [s["ms"] for s in dp[0][1:]]))
        line["dp_allreduce_bytes_per_step"] = dp[0][0]["allreduce_bytes"]
        line["dp_s"] = ranks[0]["dp_s"]

        # (c) eval_full --mesh 2x1 against one process
        ev = [r["eval"] for r in ranks]
        require(all(e["lines"] == ev[0]["lines"]
                    and e["dists"] == ev[0]["dists"] for e in ev),
                "the ranks' eval_full metrics differ")
        for counts in (e["launches"] for e in ev):
            for name in KERNELS:
                require(counts[name] > 0, f"a rank's eval never launched "
                        f"{name}")
                launches[name] += counts[name]
        single = mesh_eval(None, evalfile, dev)
        got, want = np.asarray(ev[0]["dists"]), np.asarray(single["dists"])
        exact = bool(np.array_equal(got, want))
        rerun = [] if exact else mesh_eval_held(weights.random_params(0),
                                                evalfile, dev, world)
        held = np.ones(len(want), bool)
        held[rerun] = False
        err = float(np.abs(got - want)[held].max())
        require(err <= EVAL_DIST_ATOL, f"eval_full --mesh dists differ from "
                f"one process's by {err}")
        require(exact or ev[0]["lines"] == single["lines"] or rerun,
                "eval_full --mesh metrics differ from one process's with "
                "no mask flip")
        line["eval"] = {"lines": ev[0]["lines"], "single": single["lines"],
                        "exact": exact, "images_rerun": rerun,
                        "dist_err": err, "launches_by_rank": [
                            e["launches"] for e in ev]}

        # (d) the estimator on both ranks against one process
        images = mesh_serve_images()
        est = HandPoseEstimator(params_np, batch_size=MESH_SERVE_BATCH,
                                input_hw=(H, W), device=dev)
        image = torch.from_numpy(normalize_images(images)).to(dev)
        ref = parity.port_fields(est.params, image, est.hand_side)
        rerun_fn = parity.port_rerun(est.params, image, est.hand_side)
        answers = []
        for r in range(world):
            z = np.load(os.path.join(tmp, f"serve{r}.npz"))
            fields = {k[7:]: z[k] for k in z.files if k.startswith("fields_")}
            served = {k[7:]: z[k] for k in z.files if k.startswith("served_")}
            summary = parity.check_cascade(
                ref, fields, rerun_fn, scoremap_atol=SCOREMAP_ATOL,
                coord3d_atol=COORD3D_ATOL, flip_bound=FLIP_BOUND)
            for k in ("keypoint_uv21", "keypoint_coord3d", "center",
                      "scale_crop"):
                require(np.array_equal(served[k], fields[k]),
                        f"rank {r}: served {k} differs from its cascade")
            answers.append(served)
            counts = ranks[r]["serve"]["launches"]
            for name in KERNELS:
                require(counts[name] > 0, f"rank {r}'s estimator never "
                        f"launched {name}")
                launches[name] += counts[name]
            line.setdefault("serve", []).append(summary)
        for k, v in answers[0].items():
            require(all(np.array_equal(v, a[k]) for a in answers),
                    f"the ranks' served {k} differ")
        line["kernel_vs_twin_by_rank"] = [r["serve"]["max_abs_err"]
                                          for r in ranks]

        # (b) one NCCL rank: --mesh 1x1 == no mesh, and its step time
        if cards == 1:
            env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                       CUBLAS_WORKSPACE_CONFIG=":4096:8")
            t0 = time.perf_counter()
            (nccl,) = run_processes(
                [[sys.executable, me, MESH_NCCL_CHILD, tmp, data]], [env])
            line["nccl"] = nccl
            line["nccl_child_s"] = time.perf_counter() - t0
    require_exact_f32()
    line["launches"] = launches
    line["s"] = time.perf_counter() - t_phase
    log(json.dumps(line))
    return launches


# --- parallel: TP, multislice, SP, PP and EP over ranks ----------------------


def cascade_batch(b, hw, rng):
    """The JAX package's multichip dry run's batch (__graft_entry__.py
    ``dryrun_multichip``): images and crops of ``hw``, the 32x32 scoremaps
    the lifting nets take."""
    mask = rng.random((b, hw, hw)) < 0.2
    return {
        "image": (rng.normal(size=(b, hw, hw, 3)) * 0.1).astype(np.float32),
        "hand_mask": np.stack([~mask, mask], -1).astype(np.float32),
        "image_crop": (rng.normal(size=(b, hw, hw, 3)) * 0.1)
        .astype(np.float32),
        "scoremap_gt": rng.random((b, hw, hw, 21)).astype(np.float32),
        "keypoint_vis21": np.ones((b, 21), np.float32),
        "lifting_scoremap": rng.random((b, 32, 32, 21)).astype(np.float32),
        "hand_side": np.tile(np.float32([[1.0, 0.0]]), (b, 1)),
        "keypoint_xyz21_can": rng.normal(size=(b, 21, 3)).astype(np.float32),
        "rot_mat": np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1)),
    }


def cascade_loss(params, data, generator):
    """The dry run's loss: every param of the cascade trained by the
    reference's three losses combined."""
    seg = handsegnet.apply(params[handsegnet.SCOPE], data["image"])
    l_seg = losses.handsegnet_loss(seg, data["hand_mask"])
    preds = posenet.apply(params[posenet.SCOPE], data["image_crop"])
    l_pose = losses.posenet_scoremap_loss(preds, data["scoremap_gt"],
                                          data["keypoint_vis21"])
    lift = PosePriorNetwork("proposed").apply(
        params, data["lifting_scoremap"], data["hand_side"], train=True,
        generator=generator)
    return l_seg + l_pose + losses.lifting_loss("proposed", lift, data)


def local_shapes(tree, paths):
    got = dict(zip(trainer.tree_paths(tree),
                   (tuple(t.shape) for t in trainer.tree_leaves(tree))))
    return {p: got[p] for p in paths}


def timed_ms(fn, dev):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def parallel_tp(mesh, rank, dev, label):
    """PARALLEL_STEPS train steps of the whole cascade under DP x TP on
    ``mesh``, from seeded random params, on the dry run's batch (this rank's
    rows): per step the loss, ms, the collectives' calls and bytes and a
    digest of the whole params after it. Step 0's gradients, gathered
    whole, are held on rank 0 to one process's on the global batch at the
    same params and draws; rank 0 then times that process's plain step."""
    data = cascade_batch(PARALLEL_BATCH, PARALLEL_HW,
                         np.random.default_rng(29))
    opt = trainer.make_optimizer([1e-4], [])
    whole = trainer.init_state(weights.params_from_jax(
        weights.random_params(0), dev), opt)
    state = trainer.shard_state(mesh, whole)
    lo, per = mesh_lib.shard_rows(mesh, PARALLEL_BATCH)
    local = {k: torch.from_numpy(v[lo:lo + per]).to(dev)
             for k, v in data.items()}
    grads_of = trainer.DataParallelGrads(cascade_loss, mesh)
    out = {"mesh": label, "shapes": local_shapes(state.params,
                                                 PARALLEL_SHARD_PATHS),
           "steps": []}
    for i in range(PARALLEL_STEPS):
        with counted_collectives() as sent:
            (loss, grads), ms = timed_ms(
                lambda: grads_of(state.params, local, (0, i)), dev)
        _, ms_adam = timed_ms(lambda: opt.apply(
            state.opt_state, state.params, grads, state.step), dev)
        state = state._replace(step=state.step + 1)
        step = {"loss": loss.item(), "ms": ms + ms_adam, "collectives": sent,
                "params": digest(trainer.tree_leaves(mesh_lib.gather_params(
                    mesh, state.params)))}
        if i == 0:
            g = mesh_lib.gather_params(
                mesh, trainer.tree_unflatten(state.params, grads))
            if rank == 0:
                ref_loss, ref_grads = trainer.value_and_grad(
                    cascade_loss, whole.params,
                    {k: torch.from_numpy(v).to(dev) for k, v in data.items()},
                    augment.generator(trainer.STEP_STREAM, 0, 0))
                step["loss_rel_err"] = abs(loss.item() - ref_loss.item()) / (
                    abs(ref_loss.item()))
                step["grad_err_of_max"] = grad_errs(
                    "cascade", trainer.tree_paths(whole.params),
                    trainer.tree_leaves(g), ref_grads)
        out["steps"].append(step)
    if rank == 0:  # one process's plain step on the global batch
        plain = trainer.make_train_step(cascade_loss, opt)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        s = whole
        ms = []
        for i in range(PARALLEL_STEPS):
            (s, _), t = timed_ms(lambda: plain(s, batch, (0, i)), dev)
            ms.append(t)
        out["plain_ms"] = ms
    mesh_lib.barrier()
    return out


def parallel_fit(rank, world, tmp, dev):
    """train_posenet through ``loop.fit`` at full width with ``--mesh
    Dx2`` for PARALLEL_FIT_STEPS steps (rank 0's params broadcast to every
    rank, the state sharded, the snapshot gathered whole), then
    ``--resume`` from that snapshot on ``(2D)x1`` for one more step, at
    the same global batch. Per run: this rank's local shapes, a digest of
    the whole params, the loss lines (rank 0 logs them); on rank 0 whether the snapshot equals the gathered
    state, params and Adam moments, bit for bit."""
    rows = world // 2
    snaps = os.path.join(tmp, "fit")

    def run(mesh, per_rank, max_iter, *extra):
        job = train_posenet.setup([
            "--data", os.path.join(tmp, "train.bin"), "--device", str(dev),
            "--batch-size", str(per_rank), "--max-iter", str(max_iter),
            "--mesh", mesh, "--show-loss-freq", "1", "--snapshot-dir", snaps,
            "--snapshot-freq", "100", *extra])
        lines = []
        state, secs = timed_ms(lambda: loop.fit(
            job.loss, job.params, job.optimizer, job.pipeline, job.max_iter,
            log=lines.append, **job.options), dev)
        whole = trainer.gather_state(job.options["mesh"], state)
        out = {"mesh": mesh, "step": state.step, "lines": lines, "ms": secs,
               "shapes": local_shapes(state.params, [
                   "PoseNet2D/conv6_1/weights"]),
               "params": digest(trainer.tree_leaves(whole.params))}
        return whole, out

    whole, first = run(f"{rows}x2", MESH_TRAIN_BATCH // rows,
                       PARALLEL_FIT_STEPS)
    if rank == 0:
        snap = torch.load(os.path.join(
            snaps, f"snapshot-{PARALLEL_FIT_STEPS}.pt"), weights_only=True)
        moments = whole.opt_state.state_dict()["state"]
        first["snapshot_equal"] = (
            trainer.tree_paths(snap["params"])
            == trainer.tree_paths(whole.params)
            and all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
                trainer.tree_leaves(snap["params"]),
                trainer.tree_leaves(whole.params)))
            and all(torch.equal(moments[i][k].cpu(),
                                snap["opt_state"]["state"][i][k].cpu())
                    for i in moments for k in ("exp_avg", "exp_avg_sq")))
    mesh_lib.barrier()
    _, resumed = run(f"{world}x1", MESH_TRAIN_BATCH // world,
                     PARALLEL_FIT_STEPS + 1, "--resume")
    mesh_lib.barrier()
    return {"first": first, "resumed": resumed}


def parallel_sp(mesh, rank, dev, packed=False):
    """A grad step of HandSegNet with its rows split over "model" at
    PARALLEL_SP_HW; on rank 0 held to one process's step. ``packed``: with
    conv1_2 phase-packed (its one-row halo, its fused pool's row rule)."""
    hs, ws = PARALLEL_SP_HW[mesh_lib.model_size(mesh)]
    rng = np.random.default_rng(31)
    mask = rng.random((PARALLEL_SP_BATCH, hs, ws)) < 0.2
    data = {"image": torch.from_numpy((rng.normal(size=(
        PARALLEL_SP_BATCH, hs, ws, 3)) * 0.1).astype(np.float32)).to(dev),
            "hand_mask": torch.from_numpy(np.stack([~mask, mask], -1)
                                          .astype(np.float32)).to(dev)}
    tree = weights.params_from_jax(weights.random_params(0)[handsegnet.SCOPE],
                                   dev)
    if packed:
        tree = phasepack.phase_pack_params(tree)
    params = trainer.init_state(tree, trainer.make_optimizer([1.0],
                                                             [])).params
    constrain = mesh_lib.spatial_constrainer(mesh)

    def sp_loss(p, batch, generator):
        return losses.handsegnet_loss(
            handsegnet.apply(p, batch["image"], constrain=constrain),
            batch["hand_mask"])

    grads_of = trainer.DataParallelGrads(sp_loss, mesh)
    lo, per = mesh_lib.shard_rows(mesh, PARALLEL_SP_BATCH)
    mine = {k: v[lo:lo + per] for k, v in data.items()}
    grads_of(params, mine, (0, 0))  # warm-up
    with counted_collectives() as sent:
        (loss, grads), ms = timed_ms(lambda: grads_of(params, mine, (0, 0)),
                                     dev)
    out = {"hw": [hs, ws], "rows_a_rank": hs // mesh_lib.model_size(mesh),
           "loss": loss.item(), "ms": ms, "collectives": sent,
           "grads": digest(grads)}
    if rank == 0:
        ref_loss, ref_grads = trainer.value_and_grad(
            lambda p, b, g: losses.handsegnet_loss(
                handsegnet.apply(p, b["image"]), b["hand_mask"]),
            params, data, None)
        out["loss_rel_err"] = abs(loss.item() - ref_loss.item()) / abs(
            ref_loss.item())
        out["grad_err_of_max"] = grad_errs(
            "handsegnet", [f"HandSegNet/{p}" for p in
                           trainer.tree_paths(params)], grads, ref_grads)
    return out


def parallel_pp(mesh, rank, dev):
    """A GPipe train step of PoseNet (trunk split over every rank, the two
    refinement units over "stage", PARALLEL_PP_MICRO microbatches) at
    PARALLEL_PP_HW crops; the forward ticks timed (the device synchronized
    at each hand-off); on rank 0 the loss and gradients held to the
    sequential loss's on the global batch."""
    rng = np.random.default_rng(37)
    b = PARALLEL_PP_BATCH
    hw = PARALLEL_PP_HW
    data = [torch.from_numpy(a).to(dev) for a in (
        (rng.normal(size=(b, hw, hw, 3)) * 0.1).astype(np.float32),
        rng.random((b, hw, hw, 21)).astype(np.float32),
        (rng.random((b, 21)) > 0.3).astype(np.float32))]
    whole = weights.params_from_jax(weights.random_params(0)[posenet.SCOPE],
                                    dev)
    trunk, stacked = pipeline.stack_refinement_params(whole)
    params = {"trunk": trainer.tree_map(lambda t: t.clone().requires_grad_(
        True), trunk),
              "refine": trainer.tree_map(lambda t: t.requires_grad_(True),
                                         pipeline.shard_refinement_params(
                                             mesh, stacked))}
    per = b // mesh_lib.process_count()
    lo = mesh_lib.process_index() * per
    mine = [t[lo:lo + per] for t in data]
    loss_fn = pipeline.posenet_pipeline_loss(mesh, PARALLEL_PP_MICRO)
    opt = trainer.make_optimizer([1e-4], [])
    adam = opt.init(params)
    # tree order: "refine" (this stage's unit), then "trunk"
    n_stage = len(trainer.tree_leaves(params["refine"]))
    marks = []
    base_shift = collectives.shift

    def marked_shift(*args, **kwargs):
        sync(dev)
        marks.append(time.perf_counter())
        return base_shift(*args, **kwargs)

    def step():
        loss = loss_fn(params["trunk"], params["refine"], *mine)
        grads = torch.autograd.grad(loss, trainer.tree_leaves(params))
        g_trunk, g_stage = pipeline.reduce_pipeline_grads(
            mesh, grads[n_stage:], grads[:n_stage])
        return loss, list(g_stage) + list(g_trunk)

    step()  # warm-up
    collectives.shift = marked_shift
    try:
        with counted_collectives() as sent:
            (loss, grads), ms = timed_ms(step, dev)
    finally:
        collectives.shift = base_shift
    ticks = [(b2 - a2) * 1e3 for a2, b2 in zip(marks, marks[1:])]
    g_stage = [collectives.all_gather(g, mesh.get_group(pipeline.STAGE_AXIS),
                                      0) for g in grads[:n_stage]]
    g_whole = pipeline.unstack_refinement_params(
        trainer.tree_unflatten(params["trunk"], grads[n_stage:]),
        trainer.tree_unflatten(params["refine"], g_stage))
    opt.apply(adam, params, grads, 0)
    s = mesh_lib.axis_size(mesh, pipeline.STAGE_AXIS)
    out = {"n_micro": PARALLEL_PP_MICRO, "stages": s, "ms": ms,
           "loss": loss.item(), "collectives": sent,
           "bubble_fraction": (s - 1) / (PARALLEL_PP_MICRO + s - 1),
           "tick_ms_between_handoffs": ticks,
           "stage_shape": tuple(params["refine"]["conv_1"]["weights"].shape)}
    if rank == 0:
        ref = trainer.tree_map(lambda t: t.clone().requires_grad_(True),
                               whole)
        ref_loss = losses.posenet_scoremap_loss(posenet.apply(ref, data[0]),
                                                data[1], data[2])
        ref_grads = torch.autograd.grad(ref_loss, trainer.tree_leaves(ref))
        out["sequential_loss"] = ref_loss.item()
        out["loss_rel_err"] = abs(loss.item() - ref_loss.item()) / abs(
            ref_loss.item())
        out["grad_err_of_max"] = grad_errs(
            "posenet", [f"PoseNet2D/{p}" for p in trainer.tree_paths(ref)],
            trainer.tree_leaves(g_whole), ref_grads)
    return out


def parallel_ep(mesh, rank, dev):
    """An EP grad step of the MoE layer (PARALLEL_EP experts and widths, the
    dry run's 32 tokens): on rank 0 the gathered outputs and the gradients
    held to moe_dense_reference applied to each rank's token slice (the
    capacity is a slice's budget)."""
    n_exp, d_in, d_out = PARALLEL_EP
    rng = np.random.default_rng(41)
    whole = trainer.tree_map(
        lambda t: t.requires_grad_(True), weights.params_from_jax(
            expert.moe_dense_init(rng, n_exp, d_in, d_out), dev))
    x = torch.from_numpy(rng.normal(size=(PARALLEL_EP_TOKENS, d_in))
                         .astype(np.float32)).to(dev)
    params = expert.shard_expert_params(mesh, whole)
    params["experts"] = trainer.tree_map(lambda t: t.requires_grad_(True),
                                         params["experts"])
    world = mesh_lib.process_count()
    per = PARALLEL_EP_TOKENS // world
    mine = x[mesh_lib.process_index() * per:][:per]
    gate, experts = (trainer.tree_leaves(params[k])
                     for k in ("gate", "experts"))

    def step():
        y, aux = expert.moe_dense_apply(mesh, params, mine)
        loss = y.square().sum() / (PARALLEL_EP_TOKENS * d_out) + 0.01 * aux
        g = torch.autograd.grad(loss, gate + experts)
        return y, loss, expert.reduce_expert_grads(mesh, g[:len(gate)],
                                                   g[len(gate):])

    step()
    with counted_collectives() as sent:
        (y, loss, (g_gate, g_exp)), ms = timed_ms(step, dev)
    group = mesh.get_group(expert.EXPERT_AXIS)
    y_all = collectives.all_gather(y, None, 0)
    # the global loss (each rank's is its tokens' share plus the aux mean)
    loss = y_all.square().mean() + (
        loss - y.square().sum() / (PARALLEL_EP_TOKENS * d_out))
    g_exp = [collectives.all_gather(g, group, 0) for g in g_exp]
    out = {"ms": ms, "loss": loss.item(), "collectives": sent,
           "slab": tuple(params["experts"]["weights"].shape)}
    if rank == 0:
        parts = [expert.moe_dense_reference(whole, x[r * per:(r + 1) * per])
                 for r in range(world)]
        ref_y = torch.cat([p[0] for p in parts])
        ref_aux = torch.stack([p[1] for p in parts]).mean()
        ref_loss = ref_y.square().mean() + 0.01 * ref_aux
        ref_g = torch.autograd.grad(
            ref_loss, trainer.tree_leaves(whole["gate"])
            + trainer.tree_leaves(whole["experts"]))
        out["out_err"] = (y_all - ref_y).abs().max().item()
        out["loss_rel_err"] = abs(loss.item() - ref_loss.item()) / abs(
            ref_loss.item())
        out["grad_err_of_max"] = max(
            ((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(list(g_gate) + g_exp, ref_g))
        out["dropped"] = int((ref_y.abs().sum(dim=1) == 0).sum())
    return out


def parallel_serve(mesh, tmp, rank, dev, quantize):
    """HandPoseEstimator(mesh=) at batch PARALLEL_SERVE_BATCH, H x W, with
    ``quantize``: the answers on this rank, the cascade's fields of this
    rank's rows gathered over the batch axes, both kernels launched and held
    to their twins on this rank's tensors."""
    est = HandPoseEstimator(weights.random_params(0),
                            batch_size=PARALLEL_SERVE_BATCH,
                            input_hw=(H, W), mesh=mesh, device=dev,
                            quantize=quantize)
    images = mesh_serve_images()
    zero_counts()
    (served, ms) = timed_ms(lambda: est.predict(images), dev)
    counts = launch_counts()
    _, ms = timed_ms(lambda: est.predict(images), dev)
    lo, per = est.rows
    image = torch.from_numpy(normalize_images(images)[lo:lo + per]).to(dev)
    fields = mesh_lib.gather_rows(
        {k: torch.from_numpy(v).to(dev) for k, v in parity.port_fields(
            est.params, image, est.hand_side).items()}, mesh)
    det, seed, sm = slice_inputs(est.params, image, est.hand_side)
    err = {}
    for name, (got, want) in {
            "flood_fill": (floodfill.flood_fill_cuda(det, seed, NUM_PASSES),
                           segmentation.flood_fill_torch(det, seed,
                                                         NUM_PASSES)),
            "decode_upsampled": (decode.decode_upsampled_cuda(sm, FACTOR),
                                 keypoints.decode_upsampled_torch(sm, FACTOR))
            }.items():
        require(torch.equal(got, want), f"rank {rank}: {name} differs from "
                f"its twin on its rows ({quantize})")
        err[name] = (got - want).abs().max().item()
    label = quantize or "f32"
    np.savez(os.path.join(tmp, f"par_{label}_{rank}.npz"),
             **{f"served_{k}": v for k, v in served.items()},
             **{f"fields_{k}": v.cpu().numpy() for k, v in fields.items()})
    return {"launches": counts, "max_abs_err": err, "ms": ms,
            "sharded": mesh_lib.is_sharded(est.params)}


def parallel_child(rank, world, port, tmp, device, backend):
    """One rank of phase_parallel: TP (and, on four ranks, multislice),
    SP, PP, EP and the estimator, each on its mesh; the results as the last
    stdout line."""
    rank, world = int(rank), int(world)
    dev = torch.device(device)
    require(torch.cuda.is_available(), "no CUDA device")
    torch.cuda.set_device(dev)
    precision.exact_f32(dev)
    mesh_lib.init_distributed(f"127.0.0.1:{port}", world, rank,
                              backend=backend, timeout=MESH_TIMEOUT_S)
    rows = world // 2
    out, secs = {}, {}
    for name, run in (
            ("tp", lambda: parallel_tp(mesh_lib.make_mesh(rows, 2), rank,
                                       dev, f"{rows}x2")),
            ("multislice", lambda: parallel_tp(
                mesh_lib.make_multislice_mesh(2, rows // 2, 2), rank, dev,
                f"2x{rows // 2}x2") if world >= 4 else None),
            ("sp", lambda: parallel_sp(mesh_lib.make_mesh(1, world), rank,
                                       dev)),
            ("sp_packed", lambda: parallel_sp(mesh_lib.make_mesh(1, world),
                                              rank, dev, packed=True)),
            ("pp", lambda: parallel_pp(pipeline.make_pipeline_mesh(rows, 2),
                                       rank, dev)),
            ("ep", lambda: parallel_ep(expert.make_expert_mesh(rows, 2),
                                       rank, dev)),
            ("fit", lambda: parallel_fit(rank, world, tmp, dev)),
            ("serve", lambda: {q or "f32": parallel_serve(
                mesh_lib.make_mesh(rows, 2), tmp, rank, dev, q)
                for q in (None, "int8")})):
        t0 = time.perf_counter()
        result = run()
        if result is not None:
            out[name] = result
            secs[name] = time.perf_counter() - t0
    out["s"] = secs
    require_exact_f32()
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def phase_parallel(dev, params_np, smi, cards=1):
    """The port's counterpart of the JAX package's multichip dry run
    (__graft_entry__.py ``dryrun_multichip``), in child processes: on one
    card PARALLEL_WORLD gloo ranks share it; on ``cards`` > 1 one NCCL rank
    runs on each card. (a) DP x TP train steps of the whole cascade (1x2;
    2x2 on four cards, and the multislice 2x1x2) held to one process's step
    and the ranks to each other; (b) an SP grad step of HandSegNet (1x2 at
    240x320; 1x4 at 256x320); (c) a GPipe PoseNet step (data x stage 2);
    (d) an EP grad step of the MoE layer; (e) HandPoseEstimator(mesh=) f32
    and int8 held to one process by parity.check_cascade, both kernels
    launched on every rank and equal to their twins there; (f) fit with
    --mesh Dx2, its snapshot, and the resume on (2D)x1."""
    t_phase = time.perf_counter()
    world = PARALLEL_WORLD if cards == 1 else cards
    backend = "gloo" if cards == 1 else "nccl"
    devices = ([MESH_DEVICE] * world if cards == 1
               else [f"cuda:{r}" for r in range(cards)])
    line = {"phase": "parallel", "card": smi, "world": world,
            "backend": backend, "devices": devices}
    launches = dict.fromkeys(KERNELS, 0)
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        write_rhd_file(os.path.join(tmp, "train.bin"), PARALLEL_FIT_RECORDS,
                       np.random.default_rng(37))
        port = free_port()
        t0 = time.perf_counter()
        ranks = run_processes([
            [sys.executable, me, PARALLEL_CHILD, str(r), str(world),
             str(port), tmp, devices[r], backend] for r in range(world)])
        line["children_s"] = time.perf_counter() - t0
        line["child_s"] = ranks[0]["s"]

        for key in ("tp", "multislice"):
            if key not in ranks[0]:
                continue
            runs = [r[key] for r in ranks]
            for i, steps in enumerate(zip(*(r["steps"] for r in runs))):
                require(len({(s["loss"], s["params"]) for s in steps}) == 1,
                        f"{key} step {i}: the ranks differ: losses "
                        f"{[s['loss'] for s in steps]}")
            s = runs[0]["steps"][0]
            e = s["grad_err_of_max"]
            require(s["loss_rel_err"] <= MESH_LOSS_RTOL
                    and e["last_layers"] <= TRAIN_GRAD_RTOL_OF_MAX
                    and e["worst"] <= TRAIN_FLIP_RTOL_OF_MAX
                    and e["median"] <= TRAIN_FLIP_MEDIAN_RTOL_OF_MAX,
                    f"{key} step 0 differs from one process's step: loss "
                    f"rel {s['loss_rel_err']}, gradients {e}")
            for r in runs:
                for path, shape in r["shapes"].items():
                    dim, full = PARALLEL_SHARD_PATHS[path]
                    require(shape[dim] == full // 2,
                            f"{key}: {path} is not split over 'model': "
                            f"{shape}")
            line[key] = {
                "mesh": runs[0]["mesh"], "shapes": runs[0]["shapes"],
                "loss_rel_err": s["loss_rel_err"], "grad_err_of_max": e,
                "ms_per_step": [st["ms"] for st in runs[0]["steps"]],
                "plain_ms_per_step": runs[0]["plain_ms"],
                "collectives_per_step": runs[0]["steps"][-1]["collectives"]}

        for key in ("sp", "sp_packed"):
            sp = [r[key] for r in ranks]
            require(len({(s["loss"], s["grads"]) for s in sp}) == 1,
                    f"{key}: the ranks differ")
            e = sp[0]["grad_err_of_max"]
            require(sp[0]["loss_rel_err"] <= MESH_LOSS_RTOL
                    and e["last_layers"] <= TRAIN_GRAD_RTOL_OF_MAX
                    and e["worst"] <= TRAIN_FLIP_RTOL_OF_MAX
                    and e["median"] <= TRAIN_FLIP_MEDIAN_RTOL_OF_MAX,
                    f"{key} differs from one process: loss rel "
                    f"{sp[0]['loss_rel_err']}, gradients {e}")
            line[key] = sp[0]

        pp = [r["pp"] for r in ranks]
        require(len({p["loss"] for p in pp}) == 1, "PP: the ranks' losses "
                "differ")
        e = pp[0]["grad_err_of_max"]
        require(pp[0]["loss_rel_err"] <= MESH_LOSS_RTOL
                and e["last_layers"] <= TRAIN_GRAD_RTOL_OF_MAX
                and e["worst"] <= TRAIN_FLIP_RTOL_OF_MAX
                and e["median"] <= TRAIN_FLIP_MEDIAN_RTOL_OF_MAX,
                f"PP differs from the sequential loss: rel "
                f"{pp[0]['loss_rel_err']}, gradients {e}")
        line["pp"] = pp[0]
        line["pp_tick_ms_by_rank"] = [p["tick_ms_between_handoffs"]
                                      for p in pp]

        ep = [r["ep"] for r in ranks]
        require(len({p["loss"] for p in ep}) == 1, "EP: the ranks' losses "
                "differ")
        require(ep[0]["out_err"] <= PARALLEL_EP_ATOL
                and ep[0]["loss_rel_err"] <= MESH_LOSS_RTOL
                and ep[0]["grad_err_of_max"] <= TRAIN_GRAD_RTOL_OF_MAX,
                f"EP differs from the per-slice reference: {ep[0]}")
        line["ep"] = ep[0]

        fits = [r["fit"] for r in ranks]
        for key, steps in (("first", PARALLEL_FIT_STEPS),
                           ("resumed", PARALLEL_FIT_STEPS + 1)):
            runs = [f[key] for f in fits]
            require(all(r["step"] == steps for r in runs),
                    f"fit {key}: steps {[r['step'] for r in runs]}")
            require(len({r["params"] for r in runs}) == 1,
                    f"fit {key} on {runs[0]['mesh']}: the ranks' gathered "
                    "params differ")
        for r in fits:
            shape = r["first"]["shapes"]["PoseNet2D/conv6_1/weights"]
            require(shape[0] == PARALLEL_SHARD_PATHS[
                "PoseNet2D/conv6_1/weights"][1] // 2,
                    f"fit: conv6_1 is not split over 'model': {shape}")
        require(fits[0]["first"]["snapshot_equal"], "fit: rank 0's snapshot "
                "differs from the gathered state")
        resumed = fits[0]["resumed"]["lines"]
        require(resumed and resumed[0].endswith(
            f"snapshot-{PARALLEL_FIT_STEPS}.pt at step {PARALLEL_FIT_STEPS}"),
                f"fit: the run on {fits[0]['resumed']['mesh']} did not "
                f"resume from the {fits[0]['first']['mesh']} snapshot: "
                f"{resumed[:1]}")
        line["fit"] = {k: {f: fits[0][k][f] for f in
                           ("mesh", "step", "lines", "ms")}
                       for k in ("first", "resumed")}

        images = mesh_serve_images()
        for q, bounds in ((None, (SCOREMAP_ATOL, COORD3D_ATOL, FLIP_BOUND)),
                          ("int8", (INT8_SCOREMAP_ATOL, INT8_COORD3D_ATOL,
                                    INT8_FLIP_BOUND))):
            label = q or "f32"
            est = HandPoseEstimator(params_np, batch_size=PARALLEL_SERVE_BATCH,
                                    input_hw=(H, W), device=dev, quantize=q)
            image = torch.from_numpy(normalize_images(images)).to(dev)
            ref = parity.port_fields(est.params, image, est.hand_side)
            rerun_fn = parity.port_rerun(est.params, image, est.hand_side)
            answers, summaries = [], []
            for r in range(world):
                z = np.load(os.path.join(tmp, f"par_{label}_{r}.npz"))
                fields = {k[7:]: z[k] for k in z.files
                          if k.startswith("fields_")}
                served = {k[7:]: z[k] for k in z.files
                          if k.startswith("served_")}
                summaries.append(parity.check_cascade(
                    ref, fields, rerun_fn, scoremap_atol=bounds[0],
                    coord3d_atol=bounds[1], flip_bound=bounds[2]))
                for k in ("keypoint_uv21", "keypoint_coord3d", "center",
                          "scale_crop"):
                    require(np.array_equal(served[k], fields[k]),
                            f"rank {r}: served {k} differs from its cascade "
                            f"({label})")
                answers.append(served)
                s = ranks[r]["serve"][label]
                require(s["sharded"], f"rank {r}: the {label} estimator's "
                        "params are not split over 'model'")
                for name in KERNELS:
                    require(s["launches"][name] > 0, f"rank {r}'s {label} "
                            f"estimator never launched {name}")
                    launches[name] += s["launches"][name]
            for k, v in answers[0].items():
                require(all(np.array_equal(v, a[k]) for a in answers),
                        f"the ranks' served {k} differ ({label})")
            line[f"serve_{label}"] = {
                "check_cascade": summaries,
                "ms_per_predict": [r["serve"][label]["ms"] for r in ranks],
                "kernel_vs_twin_by_rank": [r["serve"][label]["max_abs_err"]
                                           for r in ranks]}
    require_exact_f32()
    line["launches"] = launches
    line["s"] = time.perf_counter() - t_phase
    log(json.dumps(line))
    return launches


def pack_layer_times(dev, plain, packed):
    """HandSegNet's conv1_2 + leaky ReLU + 2x2 pool at each PACK_BATCHES
    batch on its [B, 64, H, W] input: the fused packed layer held to the
    plain one, and both timed by CUDA events (plain, packed, packed,
    plain)."""
    gen = torch.Generator(device=dev).manual_seed(43)
    out = {}
    for b in PACK_BATCHES:
        x = torch.randn(b, 64, H, W, device=dev, generator=gen)

        def run_plain():
            return nn.max_pool_2x2(nn.leaky_relu(nn.conv2d(x, plain)))

        def run_packed():
            return phasepack.conv_relu_pool_packed(x, packed)

        with torch.inference_mode():
            want, got = run_plain(), run_packed()
            err = (got - want).abs()
            require(bool((err <= PACK_LAYER_ATOL
                          + PACK_LAYER_RTOL * want.abs()).all()),
                    f"the packed conv1_2 differs from the plain one at batch "
                    f"{b}: {err.max().item()}")
            ms = {"plain": [], "packed": []}
            for name in ("plain", "packed", "packed", "plain"):
                fn = run_plain if name == "plain" else run_packed
                fn()
                ms[name].append(cuda_ms(fn, PACK_LAYER_ITERS))
        out[b] = {"max_abs_err": err.max().item(),
                  "err_of_max": err.max().item() / want.abs().max().item(),
                  "plain_ms": ms["plain"], "packed_ms": ms["packed"]}
        del x, want, got, err
    torch.cuda.empty_cache()
    return out


def pack_throughput(dev, params_np, rng, counts):
    """frames/s at PACK_BATCHES of HandPoseEstimator f32 and int8_seg, each
    plain and with phase_pack=True, timed in two rounds of alternating
    order; the launches of the timed predicts go into ``counts``."""
    modes = {"f32": {}, "f32_packed": {"phase_pack": True},
             "int8_seg": {"quantize": "int8",
                          "quantize_scope": {"handsegnet"}},
             "int8_seg_pp": {"quantize": "int8",
                             "quantize_scope": {"handsegnet"},
                             "phase_pack": True}}
    fps = {mode: {} for mode in modes}
    for b in PACK_BATCHES:
        images = rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)
        ests = {mode: HandPoseEstimator(params_np, batch_size=b,
                                        input_hw=(H, W), device=dev, **kw)
                for mode, kw in modes.items()}
        for est in ests.values():
            est.predict(images)
        per_batch = {mode: [] for mode in modes}
        for order in (list(modes), list(modes)[::-1]):
            for mode in order:
                zero_counts()
                per_batch[mode] += [cuda_ms(lambda: ests[mode].predict(images),
                                            1) for _ in range(PACK_ITERS[b])]
                add_counts(counts, launch_counts())
        for mode, ms in per_batch.items():
            fps[mode][b] = b * 1000.0 / float(np.median(ms))
        del ests
        torch.cuda.empty_cache()
    return fps


def phase_pack(dev, params_np, smi, err):
    """Phase-packed conv1_2 at 240x320: the packed tree made on the card
    equal to the CPU's made from the TF-layout tree; the fused layer held to
    the plain one and timed; the packed f32 and int8_seg_pp cascades held
    flip-aware to the plain f32 and int8_seg ones on the card, both kernels
    held to their twins on the packed cascades' inputs; frames/s of the
    four estimators at PACK_BATCHES with the card's name and power limit;
    an export with phase_pack=True loaded in a child process, its header
    saying so, its answers equal to the live packed estimator's. Returns the
    kernel launches."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(41)
    plain = weights.params_from_jax(params_np, dev)
    seg = quant.quantize_params_int8(plain, scopes={"handsegnet"})
    trees = {"f32": (plain, phasepack.phase_pack_params(plain)),
             "int8_seg": (seg, phasepack.phase_pack_params(seg))}
    leaves = trees_equal(trees["f32"][1], weights.params_from_jax(
        phasepack.phase_pack_params(params_np), CPU))
    for tree in trees["f32"][1], trees["int8_seg"][1]:
        require({p for p, layer in quant.layer_paths(tree).items()
                 if "weights_p2" in layer} == {("HandSegNet", "conv1_2"),
                                               ("PoseNet2D", "conv1_2")},
                "phase_pack_params did not pack conv1_2 alone")
    layer = pack_layer_times(dev, plain["HandSegNet"]["conv1_2"],
                             trees["f32"][1]["HandSegNet"]["conv1_2"])

    counts = {"flood_fill": 0, "decode_upsampled": 0}
    n = PACK_PARITY_IMAGES
    frames = rng.integers(0, 256, (SERVE_BATCH, H, W, 3), np.uint8)
    image = torch.from_numpy(normalize_images(frames)).to(dev)
    side = torch.tensor([[1.0, 0.0]] * SERVE_BATCH, device=dev)
    cascades = {}
    for mode, (atol, c3d, flip) in (
            ("f32", (SCOREMAP_ATOL, COORD3D_ATOL, FLIP_BOUND)),
            ("int8_seg", (INT8_SCOREMAP_ATOL, INT8_COORD3D_ATOL,
                          INT8_FLIP_BOUND))):
        base, packed = trees[mode]
        zero_counts()
        got = parity.port_fields(packed, image[:n], side[:n])
        add_counts(counts, launch_counts())
        cascades[mode] = parity.check_cascade(
            parity.port_fields(base, image[:n], side[:n]), got,
            parity.port_rerun(base, image[:n], side[:n]),
            scoremap_atol=atol, coord3d_atol=c3d, flip_bound=flip)
        det, seed, sm = slice_inputs(packed, image, side)
        pairs = {
            "flood_fill": (floodfill.flood_fill_cuda(det, seed, NUM_PASSES),
                           segmentation.flood_fill_torch(det, seed,
                                                         NUM_PASSES)),
            "decode_upsampled": (decode.decode_upsampled_cuda(sm, FACTOR),
                                 keypoints.decode_upsampled_torch(sm,
                                                                  FACTOR))}
        for name, (a, b) in pairs.items():
            err[name] = max(err[name], (a - b).abs().max().item())
            require(torch.equal(a, b), f"{name} differs from its twin on "
                    f"the packed {mode} cascade's input")

    # the user's path: the estimator packs, serves the packed cascade, and
    # an export of it answers the same
    est = HandPoseEstimator(params_np, batch_size=SERVE_BATCH,
                            input_hw=(H, W), phase_pack=True, device=dev)
    trees_equal(est.params, trees["f32"][1])
    zero_counts()
    live = est.predict(frames)
    add_counts(counts, launch_counts())
    with torch.inference_mode():
        want = select_serving_outputs(ColorHandPose3D().inference(
            trees["f32"][1], image, side, keypoints_scoremap=False))
    for k, v in want.items():
        require(np.array_equal(live[k], v.cpu().numpy()),
                f"the packed estimator's {k} differs from the cascade's")
    del est
    report = exported_answers(params_np, dev, frames, live, phase_pack=True)
    require(report["meta"]["phase_pack"] is True,
            f"the packed artifact's header: {report['meta']}")
    add_counts(counts, report["launches"])

    fps = pack_throughput(dev, params_np, rng, counts)
    for name, k in counts.items():
        require(k > 0, f"the packed cascades never launched {name}")
    require_exact_f32()
    log(json.dumps({
        "phase_pack": {mode: {str(b): v for b, v in fps[mode].items()}
                       for mode in fps},
        "unit": "frames/s at 240x320", "card": smi,
        "packed_vs_plain_f32": {str(b): fps["f32_packed"][b] / fps["f32"][b]
                                for b in PACK_BATCHES},
        "conv1_2_layer": {str(b): v for b, v in layer.items()},
        "packed_vs_plain_cascade": cascades,
        "leaves_card_equal_cpu": leaves,
        "export": {"artifact_bytes": report["artifact_bytes"],
                   "export_s": report["export_s"],
                   "child_s": report["child_s"],
                   "launches": report["launches"],
                   "phase_pack": report["meta"]["phase_pack"],
                   "outputs": "bit-equal to the live estimator"},
        "launches": counts, "phase_s": time.perf_counter() - t_start}))
    return counts


def rhd_png_tree(root, rng, n):
    """An RHD_published_v2-shaped evaluation set of ``n`` samples: RGB
    color PNGs, grey part-mask PNGs and the annotation pickle (protocol 2,
    as the published one); returns the arrays written."""
    from PIL import Image

    for sub in ("color", "mask"):
        os.makedirs(os.path.join(root, "evaluation", sub))
    anno, truth = {}, {}
    for sid in range(n):
        uv_vis = np.concatenate([rng.random((42, 2)) * 320,
                                 rng.integers(0, 2, (42, 1))], 1)
        anno[sid] = {"xyz": rng.standard_normal((42, 3)).astype(np.float32),
                     "uv_vis": uv_vis.astype(np.float32),
                     "K": (np.eye(3) * 283 + rng.random((3, 3))).astype(
                         np.float32)}
        truth[sid] = (rng.integers(0, 256, (*codec.RHD_IMAGE_SIZE, 3),
                                   np.uint8),
                      rng.integers(0, 34, codec.RHD_IMAGE_SIZE, np.uint8))
        for sub, arr in zip(("color", "mask"), truth[sid]):
            Image.fromarray(arr).save(os.path.join(
                root, "evaluation", sub, "%.5d.png" % sid))
    with open(os.path.join(root, "evaluation", "anno_evaluation.pickle"),
              "wb") as f:
        pickle.dump(anno, f, protocol=2)
    return anno, truth


def baseline_drill_inputs(tmp, params_np):
    """data/, weights/ and retrained/ for all 13 rows of
    run_baseline_parity: synthetic RHD and STB files, the reference's
    pickles of seeded trees, and the port's snap_pose / snap_seg
    snapshots."""
    data, wdir, retrained = (os.path.join(tmp, d) for d in
                             ("data", "weights", "retrained"))
    for d in (data, wdir):
        os.makedirs(d)
    rng = np.random.default_rng(47)
    write_rhd_file(os.path.join(data, "rhd_evaluation.bin"), TOOLS_RECORDS,
                   rng)
    write_stb_file(os.path.join(data, "stb_evaluation.bin"), TOOLS_RECORDS,
                   rng)
    trees = {"handsegnet-rhd.pickle": ("HandSegNet",),
             "posenet-rhd-stb.pickle": ("PoseNet2D",),
             "posenet3d-rhd-stb.pickle": ("PoseNet2D", "PosePrior",
                                          "ViewpointNet")}
    for name, scopes in trees.items():
        flat = weights.tree_to_flat({sc: params_np[sc] for sc in scopes})
        with open(os.path.join(wdir, name), "wb") as f:
            pickle.dump({k + ":0": v for k, v in flat.items()}, f,
                        protocol=2)
    for i, v in enumerate(run_baseline_parity.VARIANT_BY_ROW.values()):
        flat = weights.tree_to_flat(weights.random_lifting_params(v, i + 1))
        with open(os.path.join(wdir, f"lifting-{v}.pickle"), "wb") as f:
            pickle.dump(flat, f, protocol=2)
    for snap, scope in (("snap_pose", "PoseNet2D"), ("snap_seg",
                                                     "HandSegNet")):
        checkpoints.save_snapshot(
            os.path.join(retrained, snap), trainer.init_state(
                weights.params_from_jax({scope: params_np[scope]}, CPU),
                trainer.make_optimizer([1e-4], [])), step=1)
    return data, wdir, retrained


def phase_tools(dev, params_np, smi):
    """The dataset and host tools on the card's machine: create_binary_db
    on PNG fixtures (PIL there, no matplotlib), read back by the port's RHD
    reader; run_baseline_parity's drill, all 13 rows judged on synthetic
    files through the four harnesses on the card; bench_input's records/s
    beside the resident PoseNet step; release_check with its preset step
    alone, on an overfit dir of a seeded lifting snapshot. Returns the
    kernel launches of the drill."""
    t_start = time.perf_counter()
    line = {"phase": "tools", "card": smi}
    counts = {"flood_fill": 0, "decode_upsampled": 0}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "RHD_published_v2")
        anno, truth = rhd_png_tree(root, np.random.default_rng(45),
                                   TOOLS_PNG_SAMPLES)
        out = os.path.join(tmp, "rhd_png.bin")
        t0 = time.perf_counter()
        create_binary_db.main(["--rhd-path", root, "--out", out])
        line["create_binary_db_s"] = time.perf_counter() - t0
        raw = RHDDataset("evaluation", path=out).raw_batch(
            np.arange(TOOLS_PNG_SAMPLES))
        for sid, (image, mask) in truth.items():
            a = anno[sid]
            require(np.array_equal(raw["image"][sid], image)
                    and np.array_equal(raw["hand_parts"][sid], mask)
                    and np.array_equal(raw["kp_xyz"][sid], a["xyz"])
                    and np.array_equal(raw["kp_uv"][sid], a["uv_vis"][:, :2])
                    and np.array_equal(raw["cam_mat"][sid], a["K"])
                    and np.array_equal(raw["kp_vis"][sid],
                                       a["uv_vis"][:, 2] == 1),
                    f"create_binary_db: record {sid} differs from its PNGs "
                    "and annotation")

        data, wdir, retrained = baseline_drill_inputs(tmp, params_np)
        zero_counts()
        t0 = time.perf_counter()
        results = run_baseline_parity.run_rows(
            data, wdir, retrained_dir=retrained, batch_size=TOOLS_BATCH,
            progress=False, device=dev)
        line["baseline_drill_s"] = time.perf_counter() - t0
        add_counts(counts, launch_counts())
        require(sorted(results) == list(range(1, 14)), f"rows {results}")
        for row, r in results.items():
            require(not r["skipped"] and set(r["measured"]) == set(
                run_baseline_parity.ROWS[row]["expect"]) and all(
                    np.isfinite(v) for v in r["measured"].values()),
                    f"baseline row {row}: {r}")
        line["baseline_rows"] = {row: {"seconds": r["seconds"],
                                       "measured": r["measured"]}
                                 for row, r in results.items()}
        for name, k in counts.items():
            require(k > 0, f"the baseline drill never launched {name}")

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench_input.main(["--records", str(TOOLS_BENCH_RECORDS),
                              "--batch", str(TRAIN_BATCH)])
        bench = json.loads(buf.getvalue().splitlines()[-1])
        require("native_error" not in bench and bench["native_rec_s"] > 0
                and bench["memmap_rec_s"] > 0, f"bench_input: {bench}")
        line["bench_input"] = bench

        overfit = os.path.join(tmp, "overfit")
        checkpoints.save_snapshot(
            os.path.join(overfit, "snap_lifting"), trainer.init_state(
                weights.params_from_jax(weights.random_lifting_params(
                    "proposed", 3), CPU), trainer.make_optimizer([1e-4], [])),
            step=1)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "hand3d_tpu_torch.tools.release_check",
             "--round", "0", "--steps", "preset", "--overfit-dir", overfit,
             "--out-dir", tmp],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=TOOLS_RELEASE_TIMEOUT_S)
        sys.stderr.write(proc.stderr[-2000:])
        with open(os.path.join(tmp, "RESULTS_torch_r00.json")) as f:
            record = json.load(f)
        step = record["steps"]["preset"]
        require(proc.returncode == 0 and step["ok"]
                and record["card"] == smi and record["partial"]
                and step["summary"]["gate"] == "preset_accuracy"
                and all(record["steps"][k].get("skipped") for k in
                        ("chip_smoke", "overfit", "generalization")),
                f"release_check exited {proc.returncode}: {record}")
        line["release_check"] = {
            "s": time.perf_counter() - t0, "card": record["card"],
            "preset_s": step["seconds"],
            "presets": sorted(step["summary"]["presets"])}
    line["launches"] = counts
    line["s"] = time.perf_counter() - t_start
    log(json.dumps(line))
    return counts


def directory_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_orbax(dev, smi):
    """(a) in a child process (deterministic algorithms), (b) here."""
    t_start = time.perf_counter()
    zero_counts()
    line = {"phase": "orbax", "card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "train.bin")
        write_rhd_file(data, TRAIN_RECORDS, np.random.default_rng(46))
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), ORBAX_CHILD, tmp,
             data], env=env, capture_output=True, text=True, timeout=600)
        sys.stderr.write(child.stderr[-4000:])
        require(child.returncode == 0,
                f"the orbax child process exited {child.returncode}")
        line["full_width"] = json.loads(child.stdout.splitlines()[-1])

    # (b) the JAX package's checkpoint: OCDBT nodes and zarr chunks in zstd
    path = os.path.join(ORBAX_FIXTURE, "checkpoint", "2")
    with np.load(os.path.join(ORBAX_FIXTURE, "expected.npz")) as f:
        want = {k: f[k] for k in f.files}
    tree = weights.flat_to_tree({k[len("params/"):]: v for k, v in
                                 want.items() if k.startswith("params/")})
    template = trainer.init_state(weights.params_from_jax(tree, dev),
                                  trainer.make_optimizer([1e-4, 1e-5], [1]))
    t0 = time.perf_counter()
    restored = checkpoints.restore_orbax(path, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    leaves = trainer.tree_leaves(restored.params)
    require(all(p.device == dev for p in leaves), "restored off the card")
    got = {f"params/{k}": v for k, v in weights.tree_to_flat(
        weights.params_to_jax(restored.params)).items()}
    for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        moments = trainer.tree_unflatten(restored.params, [
            restored.opt_state.state[p][key] for p in leaves])
        got.update({f"opt_state/0/{name}/{k}": v for k, v in
                    weights.tree_to_flat(weights.params_to_jax(
                        moments)).items()})
    counts = {float(restored.opt_state.state[p]["step"]) for p in leaves}
    require(counts == {2.0} and restored.step == 2,
            f"fixture: counts {counts}, step {restored.step}")
    moments_and_params = {k: v for k, v in want.items()
                          if "/count" not in k and k != "step"}
    require(sorted(got) == sorted(moments_and_params) and all(
        got[k].dtype == v.dtype and np.array_equal(got[k], v)
        for k, v in moments_and_params.items()),
        "the JAX-made checkpoint restored on the card differs from its .npz")
    reader = ocdbt.OcdbtReader(path)
    frames = [reader.read(k) for k in reader.list()
              if not k.endswith(".zarray")]
    decoded = sum(len(zstd.decompress(f)) for f in frames)
    rounds = []
    for _ in range(ORBAX_DECODE_ROUNDS):
        t0 = time.perf_counter()
        for f in frames:
            zstd.decompress(f)
        rounds.append(time.perf_counter() - t0)
    rate = decoded / float(np.median(rounds))
    full_bytes = line["full_width"]["checkpoint_bytes"]
    line["jax_fixture"] = {
        "leaves": len(want), "restore_s": restore_s,
        "zstd_frames": len(frames),
        "zstd_bytes_in": sum(len(f) for f in frames),
        "zstd_bytes_out": decoded, "decoder_mb_per_s": rate / 1e6,
        "derived_restore_s_of_full_width_at_decoder_rate":
            full_bytes / rate}
    line["launches"] = launch_counts()  # none: no kernel on this path
    line["s"] = time.perf_counter() - t_start
    log(json.dumps(line))
    return line["launches"]


def orbax_child(tmp, data):
    """Phase 18 (a): train_posenet's state after 2 steps through
    save_orbax and restore_orbax on the card, then one more step from
    each; prints one JSON line."""
    require(torch.cuda.is_available(), "no CUDA device")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    module, argv = train_argv("posenet", data, tmp, ORBAX_STEPS)
    state = module.main(argv)
    require(state.step == ORBAX_STEPS, f"stopped at {state.step}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoints.save_orbax(os.path.join(tmp, "orbax"), state)
    save_s = time.perf_counter() - t0
    job = module.setup(argv)
    template = trainer.init_state(job.params, job.optimizer)
    require(not all(torch.equal(x, y) for x, y in zip(
        trainer.tree_leaves(state.params),
        trainer.tree_leaves(template.params))),
        "the fresh template already holds the trained params")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = checkpoints.restore_orbax(path, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(states_equal(state, restored), "save_orbax + restore_orbax on "
            "the card changed a param, an Adam moment or a count")
    step = trainer.make_train_step(job.loss, job.optimizer)
    raw = first_batch(job)
    key = (job.options["seed"], ORBAX_STEPS)
    a, _ = step(state, raw, key)
    b, _ = step(restored, raw, key)
    torch.cuda.synchronize()
    require(states_equal(a, b), "one step from the restored state differs "
            "from one step from the original")
    require_exact_f32()
    log(json.dumps({
        "steps": ORBAX_STEPS, "batch": TRAIN_BATCH,
        "leaves": len(trainer.tree_leaves(state.params)),
        "checkpoint_bytes": directory_bytes(path), "save_s": save_s,
        "restore_s": restore_s, "round_trip_bit_equal": True,
        "next_step_bit_equal": True}))


def measure_profiles(f32_fps):
    """profile_stages at MEASURE_PROFILES: {(dtype, quantize, batch):
    {stage: ms a batch}}, each stage's time and launches checked."""
    out = {}
    for dtype, quantize, b, iters in MEASURE_PROFILES:
        argv = ["--batch", str(b), "--hw", str(H), str(W), "--dtype", dtype,
                "--iters", str(iters)]
        if quantize:
            argv += ["--quantize", quantize]
        rows = profile_stages.main(argv)
        for r in rows:
            require(np.isfinite(r["ms"]) and r["ms"] > 0,
                    f"profile_stages {argv}: {r['stage']} took {r['ms']} ms")
            for kernel, stages in MEASURE_LAUNCHING.items():
                launched = r["launches"][kernel] > 0
                require(launched == (r["stage"] in stages),
                        f"profile_stages {argv}: {r['stage']} launched "
                        f"{kernel} {r['launches'][kernel]} times")
        ms = {r["stage"]: r["ms"] for r in rows}
        out[(dtype, quantize, b)] = ms
        conv = sum(ms[s] for s in MEASURE_CONV_STAGES)
        log(json.dumps({
            "measure": "profile_stages", "dtype": dtype,
            "quantize": quantize, "batch": b,
            "full_cascade_frames_per_s": b * 1e3 / ms["FULL cascade"],
            "times_phase_f32_frames_per_s": (
                f32_fps.get(b) if (dtype, quantize) == ("f32", None)
                else None),
            "conv_stages_share_of_full": conv / ms["FULL cascade"],
            "glue_ms_per_frame": sum(ms[s] for s in MEASURE_GLUE) / b}))
    return out


def roofline_cli(argv):
    """``python -m hand3d_tpu_torch.tools.roofline`` in a process of its
    own: its summary line, every reference shape's device kernels required.
    In this script's process, after the earlier phases, torch.profiler
    returned no device kernel, so the rates are measured where a user
    measures them, in a fresh process."""
    child = subprocess.run(
        [sys.executable, "-m", "hand3d_tpu_torch.tools.roofline", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=300)
    sys.stdout.write(child.stdout)
    sys.stderr.write(child.stderr[-4000:])
    require(child.returncode == 0, f"roofline {argv} exited "
            f"{child.returncode}")
    out = json.loads(child.stdout.strip().splitlines()[-1])
    for path, m in out["measured"].items():
        for shape, names in m["kernels"].items():
            require(names, f"roofline named no device kernel of {path} "
                    f"{shape}")
    return out


def measure_roofline(profiles):
    """roofline at f32 (required to bound the FULL cascade), bf16 and int8
    at the profiled batches: the CLI's first run measures the card's rates,
    and ``roofline.roofline`` takes them for the rest."""
    first = None
    layers = roofline.stage_layers((H, W))
    for dtype, quantize, b in [("f32", None, b)
                               for b in MEASURE_ROOFLINE_BATCHES] + [
            k for k in profiles if k[0] == "bf16" or k[1]]:
        ms = profiles[(dtype, quantize, b)]
        glue = sum(ms[s] for s in MEASURE_GLUE) / b
        if first is None:
            require(not quantize, "the rates are measured at f32 or bf16")
            out = first = roofline_cli([
                "--batch", str(b), "--image-hw", f"{H}x{W}", "--dtype", dtype,
                "--glue-ms", repr(glue)])
        else:
            out = roofline.roofline(layers, first["rates"], first["hbm"], b,
                                    dtype, bool(quantize), glue_ms=glue)
        measured = ms["FULL cascade"] / b
        log(json.dumps({
            "measure": "roofline", "dtype": dtype, "int8": bool(quantize),
            "batch": b, "predicted_ms_per_frame": out["ms_per_frame"],
            "measured_ms_per_frame": measured,
            "share_of_roofline": out["ms_per_frame"] / measured,
            "rates_tflops": {p: r / 1e12
                             for p, r in first["rates"].items()},
            "hbm_gbps": first["hbm"] / 1e9}))
        if dtype == "f32":
            require(out["ms_per_frame"] <= measured,
                    f"roofline at batch {b}: {out['ms_per_frame']} ms a "
                    f"frame predicted, {measured} measured: no bound")


def measure_memory():
    """memory_report's default rows; the batch-8 PoseNet step's peak, and
    its tensors' peak without the ops' scratch, required to fall from
    accum 1 to 2 to 4."""
    rows = {r["config"]: r for r in memory_report.main(["--hw", str(H),
                                                         str(W)])}
    steps = {acc: rows[f"posenet train step batch 8 accum={acc}"]
             for acc in MEASURE_ACCUMS}
    temp = {acc: r["temp"] for acc, r in steps.items()}
    tensors = {acc: r["split"]["tensor_peak"] for acc, r in steps.items()}
    log(json.dumps({"measure": "memory_report", "posenet_step_temp": temp,
                    "posenet_step_split": {acc: r["split"]
                                           for acc, r in steps.items()},
                    "accum2_over_accum1": temp[2] / temp[1]}))
    for few, many in zip(MEASURE_ACCUMS, MEASURE_ACCUMS[1:]):
        require(temp[many] < temp[few] and tensors[many] < tensors[few],
                f"accum {many} does not lower the batch-8 PoseNet step's "
                f"peak below accum {few}'s: temp {temp}, tensors {tensors}")


def launches_per_cascade_call(dev):
    """Each kernel's launches in one ``ColorHandPose3D.inference`` at each
    of MEASURE_CALL_BATCHES (240x320, random weights): what a main-path
    call costs in launches, whatever the script runs around it."""
    net = ColorHandPose3D()
    params = weights.params_from_jax(weights.random_params(0), dev)
    per_call = {}
    for b in MEASURE_CALL_BATCHES:
        image = torch.rand((b, H, W, 3), generator=torch.Generator()
                           .manual_seed(b)).to(dev) - 0.5
        hand_side = torch.tensor([[1.0, 0.0]], device=dev).repeat(b, 1)
        with torch.inference_mode():
            before = launch_counts()
            net.inference(params, image, hand_side)
            sync(dev)
        per_call[b] = {k: n - before[k] for k, n in launch_counts().items()}
        for name, n in per_call[b].items():
            require(n > 0, f"one cascade call at batch {b} never launched "
                    f"{name}")
    log(json.dumps({"measure": "launches_per_cascade_call",
                    "by_batch": per_call}))


def phase_measure(dev, f32_fps):
    """profile_stages, memory_report and roofline on the card, and each
    kernel's launches in one cascade call."""
    zero_counts()
    profiles = measure_profiles(f32_fps)
    measure_memory()
    measure_roofline(profiles)
    launches_per_cascade_call(dev)
    return launch_counts()


# --- scaling: the scaling record's rows --------------------------------------


def scaling_cli(cards):
    """``python -m hand3d_tpu_torch.tools.scaling_record`` at its defaults
    on the first ``cards`` cards, in a process group of its own, as a user
    runs it: its summary line. Past SCALING_TIMEOUT_S the whole group, its
    ranks included, is killed and the phase fails."""
    env = dict(os.environ,
               CUDA_VISIBLE_DEVICES=",".join(map(str, range(cards))))
    child = subprocess.Popen(
        [sys.executable, "-m", "hand3d_tpu_torch.tools.scaling_record"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = child.communicate(timeout=SCALING_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(child.pid, signal.SIGKILL)
        child.communicate()
        raise RuntimeError(f"scaling_record ran past {SCALING_TIMEOUT_S} s; "
                           "its process group was killed")
    sys.stderr.write(err[-4000:])
    require(child.returncode == 0, f"scaling_record exited "
            f"{child.returncode}:\n{out[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def require_scaling_rows(rows, backend):
    """Each row's backend, finite positive times, PoseNet's gradient bytes,
    and the bytes all-reduced a step equal to those plus the named
    scalars (a group of one at n_data 1 reduces them too)."""
    for r in rows:
        at = f"scaling row n_data {r['n_data']} at {r['size']}^2"
        require(r["backend"] == backend, f"{at}: backend {r['backend']}")
        for k in ("step_ms_median", "step_ms_min", "first_step_s"):
            require(np.isfinite(r[k]) and r[k] > 0, f"{at}: {k} {r[k]}")
        require(r["gradient_bytes"] == SCALING_GRADIENT_BYTES,
                f"{at}: {r['gradient_bytes']} gradient bytes")
        require(r["collective_bytes_per_step"] == r["gradient_bytes"] + sum(
            r["scalar_bytes"].values()), f"{at}: "
            f"{r['collective_bytes_per_step']} bytes all-reduced, "
            f"{r['gradient_bytes']} of gradients and {r['scalar_bytes']}")


def phase_scaling(smi, cards=1):
    """The scaling record on the card. ``cards=1``: measure() at 32x32 on
    SCALING_RANKS ranks, where the tool places them (gloo ranks sharing a
    one-card host's card), and on one rank at the training crop, each at
    SCALING_STEPS steps. ``cards`` > 1: the CLI at its defaults on the
    first ``cards`` cards (one NCCL rank a card), and measure() at the
    training crop for the same rank counts and steps."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' memory, not this process's cache
    defaults = scaling_record.parse_args([])
    if cards == 1:
        backend, _ = scaling_record.placement(max(SCALING_RANKS), "cuda")
        steps, counts = SCALING_STEPS, (1,)
        rows = scaling_record.against_ideal([
            scaling_record.measure(n, defaults.per_device_batch, steps)
            for n in SCALING_RANKS])
    else:
        backend, steps = "nccl", defaults.steps
        counts = tuple(n for n in scaling_record.RANKS if n <= cards)
        rows = scaling_cli(cards)["rows"]
        require([r["n_data"] for r in rows] == list(counts),
                f"scaling_record ran n_data {[r['n_data'] for r in rows]}")
    t0 = time.perf_counter()
    crop_rows = scaling_record.against_ideal([
        scaling_record.measure(n, defaults.per_device_batch, steps,
                               size=SCALING_CROP)
        for n in counts])
    crop_s = time.perf_counter() - t0
    require_scaling_rows(rows + crop_rows, backend)
    log(json.dumps({"phase": "scaling", "card": smi, "backend": backend,
                    "steps": steps, "rows": rows, "crop_rows": crop_rows,
                    "crop_s": crop_s, "s": time.perf_counter() - t_phase}))
    return dict.fromkeys(KERNELS, 0)


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    precision.exact_f32(dev)
    phase_s = {}
    t0 = time.perf_counter()
    phase_build()
    err = phase_kernel_parity(dev)
    params_np = weights.random_params(0)
    kernels = phase_slice(dev, params_np, err)
    phase_s["build_parity_slice"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f32_fps = phase_times(dev, params_np)
    phase_s["times"] = time.perf_counter() - t0
    launches = []
    for name, phase in (
            ("serve_buckets", lambda: phase_serve_buckets(dev, params_np)),
            ("serve_batcher_http", lambda: phase_serve_batcher(dev,
                                                               params_np)),
            ("export", lambda: phase_export(dev, params_np)),
            ("bf16", lambda: phase_bf16(dev, params_np, f32_fps)),
            ("eval", lambda: phase_eval(dev, params_np, err)),
            ("train", lambda: phase_train(dev)),
            ("train_resident", lambda: phase_train_resident(dev)),
            ("weights", lambda: phase_weights(dev, params_np)),
            ("quant", lambda: phase_quant(dev, params_np, f32_fps, err)),
            ("mesh", lambda: phase_mesh(dev, params_np, smi)),
            ("parallel", lambda: phase_parallel(dev, params_np, smi)),
            ("phase_pack", lambda: phase_pack(dev, params_np, smi, err)),
            ("tools", lambda: phase_tools(dev, params_np, smi)),
            ("orbax", lambda: phase_orbax(dev, smi)),
            ("measure", lambda: phase_measure(dev, f32_fps)),
            ("scaling", lambda: phase_scaling(smi))):
        t0 = time.perf_counter()
        launches.append(phase())
        phase_s[name] = time.perf_counter() - t0
    require_exact_f32()
    log(json.dumps({"phase_s": phase_s,
                    "total_s": time.perf_counter() - t_start}))
    for k in kernels:
        k["launches"] += sum(counts[k["name"]] for counts in launches)
        k["max_abs_err"] = err[k["name"]]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main_cards(cards):
    """``chip_smoke.py --mesh-cards N``: the mesh, parallel and scaling
    phases alone with one NCCL rank on each of N cards; the rest of the
    script is the one-card run's."""
    cards = int(cards)
    smi = phase_device()
    require(torch.cuda.device_count() >= cards,
            f"{torch.cuda.device_count()} cards, {cards} asked for")
    dev = torch.device("cuda", 0)
    precision.exact_f32(dev)
    phase_build()
    phase_mesh(dev, weights.random_params(0), smi, cards)
    phase_parallel(dev, weights.random_params(0), smi, cards)
    phase_scaling(smi, cards)
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-cards"]:
        main_cards(*sys.argv[2:])
    elif sys.argv[1:2] == [RESUME_CHILD]:
        train_resume_child(*sys.argv[2:])
    elif sys.argv[1:2] == [MESH_CHILD]:
        mesh_child(*sys.argv[2:])
    elif sys.argv[1:2] == [MESH_NCCL_CHILD]:
        mesh_nccl_child(*sys.argv[2:])
    elif sys.argv[1:2] == [PARALLEL_CHILD]:
        parallel_child(*sys.argv[2:])
    elif sys.argv[1:2] == [ORBAX_CHILD]:
        orbax_child(*sys.argv[2:])
    else:
        main()
