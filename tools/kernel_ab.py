"""Time the port's CUDA kernels against another version of their sources, on
one card, in one process.

    python tools/kernel_ab.py --old-csrc DIR

DIR holds an older ``decode.cu`` and ``floodfill.cu`` (for example those of
an earlier commit, written out with ``git show <commit>:<path>``). Both are
built with the same nvcc flags as the current ones, into
``hand3d_tpu_torch/_build/ab/``. Each kernel runs, old and new in turns (old,
new, new, old), on the tensors that chip_smoke.py's timing phase gives it:
the served slice's flood-fill masks and PoseNet scoremaps at batches 1, 32
and 128 (random weights from seed 0, images from seed 2), and the flood fill
on chip_smoke's two fixed masks. Every pair of outputs must be equal. One
JSON line per case: the mean ms of 20 launches by CUDA events, per turn;
and, at batch 1, the host time of a call of each current wrapper.
The older decode entry takes no scratch argument
(``h3d_decode_upsampled(sm, out, B, h, w, K, factor, stream)``); pass
``--old-decode-scratch`` if DIR's does.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from hand3d_tpu_torch import precision, weights  # noqa: E402
from hand3d_tpu_torch.ops.kernels import build, decode, floodfill  # noqa: E402
from hand3d_tpu_torch.serving import (HandPoseEstimator,  # noqa: E402
                                      normalize_images)

AB_DIR = build.BUILD_DIR / "ab"
ITERS = 20


def build_old(src, name):
    """Compile ``src`` with the port's flags; return the ctypes library."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    out = AB_DIR / f"lib{name}_old.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def old_kernels(old_dir, decode_scratch):
    """Callables (det, seed, passes) and (sm, factor) of the old sources."""
    ff = build_old(Path(old_dir) / "floodfill.cu", "floodfill")
    ff.h3d_flood_fill.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    dc = build_old(Path(old_dir) / "decode.cu", "decode")
    n_ptr = 3 if decode_scratch else 2
    dc.h3d_decode_upsampled.argtypes = [ctypes.c_void_p] * n_ptr \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]

    def flood(det, seed, passes):
        out = torch.empty_like(det)
        b, h, w = det.shape
        err = ff.h3d_flood_fill(det.data_ptr(), seed.data_ptr(),
                                out.data_ptr(), b, h, w, passes,
                                build.current_stream(det.device))
        assert err == 0, err
        return out

    def dec(sm, factor):
        b, h, w, k = sm.shape
        out = torch.empty((b, k, 2), dtype=torch.float32, device=sm.device)
        ptrs = [sm.data_ptr(), out.data_ptr()]
        if decode_scratch:
            ptrs.append(torch.zeros(b * k + b, dtype=torch.int64,
                                    device=sm.device).data_ptr())
        err = dc.h3d_decode_upsampled(*ptrs, b, h, w, k, factor,
                                      build.current_stream(sm.device))
        assert err == 0, err
        return out

    return flood, dec


def turns(old, new):
    """ms of old and new, launched in the order old, new, new, old."""
    for fn in (old, new):
        fn()  # warm-up
    times = {"old": [], "new": []}
    for label in ("old", "new", "new", "old"):
        times[label].append(chip_smoke.cuda_ms(old if label == "old" else new,
                                               ITERS))
    return times


def host_us(fn, calls=200):
    """Host microseconds a call of ``fn`` takes to return, the card drained
    after all of them: a launch rate, not a kernel time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", required=True,
                    help="directory with the older decode.cu, floodfill.cu")
    ap.add_argument("--old-decode-scratch", action="store_true",
                    help="the older decode entry takes a scratch pointer")
    args = ap.parse_args(argv)
    smi = chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    precision.exact_f32(dev)
    old_flood, old_decode = old_kernels(args.old_csrc,
                                        args.old_decode_scratch)
    params_np = weights.random_params(0)
    rng = np.random.default_rng(2)  # chip_smoke.phase_times' images
    passes = chip_smoke.NUM_PASSES
    for b in chip_smoke.TIME_BATCHES:
        est = HandPoseEstimator(params_np, batch_size=b,
                                input_hw=(chip_smoke.H, chip_smoke.W),
                                device=dev)
        images = rng.integers(0, 256, (b, chip_smoke.H, chip_smoke.W, 3),
                              dtype=np.uint8)
        det, seed, sm = chip_smoke.slice_inputs(
            est.params, torch.from_numpy(normalize_images(images)).to(dev),
            est.hand_side)
        masks = {"slice": (det, seed)}
        for name in ("two_blob", "serpentine"):
            d, s = (chip_smoke.flood_cases(1, np.random.default_rng(0))
                    ["two_blob"] if name == "two_blob" else
                    (chip_smoke.serpentine(chip_smoke.H, chip_smoke.W)[None],
                     np.zeros((1, 2), np.int32)))
            masks[name] = (torch.from_numpy(np.repeat(d[:1], b, 0)).to(dev),
                           torch.from_numpy(np.repeat(s[:1], b, 0)).to(dev))
        for name, (d, s) in masks.items():
            same = torch.equal(old_flood(d, s, passes),
                               floodfill.flood_fill_cuda(d, s, passes))
            t = turns(lambda: old_flood(d, s, passes),
                      lambda: floodfill.flood_fill_cuda(d, s, passes))
            print(json.dumps({"kernel": "flood_fill", "input": name,
                              "batch": b, "equal": same,
                              "passes": chip_smoke.flood_bound(
                                  d, s, passes)["passes"], **t}), flush=True)
            chip_smoke.require(same, f"old and new flood fill differ: {name}")
        same = torch.equal(old_decode(sm, chip_smoke.FACTOR),
                           decode.decode_upsampled_cuda(sm, chip_smoke.FACTOR))
        t = turns(lambda: old_decode(sm, chip_smoke.FACTOR),
                  lambda: decode.decode_upsampled_cuda(sm, chip_smoke.FACTOR))
        print(json.dumps({"kernel": "decode_upsampled", "input": "slice",
                          "batch": b, "equal": same, **t}), flush=True)
        chip_smoke.require(same, "old and new decode differ")
        if b == 1:
            host = {"flood_fill": host_us(
                        lambda: floodfill.flood_fill_cuda(det, seed, passes)),
                    "decode_upsampled": host_us(
                        lambda: decode.decode_upsampled_cuda(
                            sm, chip_smoke.FACTOR))}
            print(json.dumps({"host_us_per_call": host}), flush=True)
        del est
        torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
