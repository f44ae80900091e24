"""Input-pipeline throughput (counterpart of tools/bench_input.py).

Writes a synthetic RHD .bin in the reference's record layout
(``data.codec.RHD_RECORD_DTYPE``, 410,520 bytes a record), then measures the
host's record throughput of

  1. the C++ streamer (``data.native``: pread, shuffle and batch assembly on
     worker threads), and
  2. the numpy memmap gather (``data.codec.FixedLenRecordFile``),

beside what training consumes: --batch records every --step-ms. The default
step is the port's device-resident PoseNet step at batch 8, 77.1 ms on an
NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6, training-resident runs).

The file is read right after it is written, so this measures the page-cache
hot path (epoch 2 and later) and the pipeline's own overhead; a cold first
epoch is bound by the disk. The last line of standard output is one JSON
object.

Usage: python -m hand3d_tpu_torch.tools.bench_input [--records 256]
       [--batch 8] [--step-ms 77.1]
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

from hand3d_tpu_torch.data.codec import RHD_RECORD_DTYPE, FixedLenRecordFile

POSENET_RESIDENT_STEP_MS = 77.1


def make_bin(path, num_records, seed=0):
    """Random-byte images in the reference layout (the read cost does not
    depend on the content); returns the file's size."""
    rng = np.random.RandomState(seed)
    rec = np.zeros(num_records, dtype=RHD_RECORD_DTYPE)
    rec["image"] = rng.randint(0, 255, rec["image"].shape, dtype=np.uint8)
    rec.tofile(path)
    return os.path.getsize(path)


def bench_native(path, batch, epochs=3):
    """Records/s of the C++ streamer over ``epochs`` shuffled epochs, after
    one warm-up epoch."""
    from hand3d_tpu_torch.data.native import NativeRecordReader

    reader = NativeRecordReader(path, RHD_RECORD_DTYPE, batch, shuffle=True,
                                seed=1)
    try:
        reader.reset(epochs=1)
        while reader.next_batch() is not None:
            pass
        reader.reset(epochs=epochs)
        n = 0
        t0 = time.perf_counter()
        while (out := reader.next_batch()) is not None:
            n += len(out[0])
        dt = time.perf_counter() - t0
    finally:
        reader.close()
    return n / dt


def bench_memmap(path, batch, epochs=3):
    """Records/s of shuffled memmap gathers over ``epochs`` epochs."""
    f = FixedLenRecordFile(path, RHD_RECORD_DTYPE)
    rng = np.random.RandomState(1)
    f.gather(rng.permutation(len(f))[:batch])  # warm-up
    n = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        order = rng.permutation(len(f))
        for i in range(0, len(f) - batch + 1, batch):
            n += len(f.gather(order[i:i + batch]))
    return n / (time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--step-ms", type=float, default=POSENET_RESIDENT_STEP_MS,
                    help="training step time at --batch (ms)")
    ap.add_argument("--keep", help="write the .bin here and keep it")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="hand3d_inbench_") as tmp:
        path = args.keep or os.path.join(tmp, "rhd_big.bin")
        size = make_bin(path, args.records)
        demand = args.batch / (args.step_ms / 1e3)
        results = {
            "records": args.records,
            "record_kb": RHD_RECORD_DTYPE.itemsize / 1024,
            "file_mb": size / 1e6,
            "batch": args.batch,
            "step_ms": args.step_ms,
            "train_demand_rec_s": demand,
        }
        try:
            rs = bench_native(path, args.batch)
            results["native_rec_s"] = rs
            results["native_gb_s"] = rs * RHD_RECORD_DTYPE.itemsize / 1e9
            results["native_headroom_x"] = rs / demand
        except (OSError, RuntimeError) as e:  # NativeUnavailable: no g++
            results["native_error"] = f"{type(e).__name__}: {e}"
        rs = bench_memmap(path, args.batch)
        results["memmap_rec_s"] = rs
        results["memmap_gb_s"] = rs * RHD_RECORD_DTYPE.itemsize / 1e9
        results["memmap_headroom_x"] = rs / demand
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
