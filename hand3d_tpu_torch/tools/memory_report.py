"""Device memory of the main programs (counterpart of
tools/memory_report.py).

Prints, per configuration, what a call holds on the card:

* ``args``: the bytes of its arguments, the params or the train state
  (params, Adam's two moments and its step counters) plus the inputs;
* ``out``: the bytes of what it returns;
* ``temp``: ``torch.cuda.max_memory_allocated`` over the call, after
  ``reset_peak_memory_stats``, less what was allocated before it: the
  activations, the gradients and every cuDNN and cuBLAS workspace the call
  took from the caching allocator (the outputs' own bytes included). Taken
  on the second call, after a warm-up call has made Adam's state and picked
  the convolution algorithms;
* on a card, what the peak is made of, from a third call under a dispatch
  mode that reads the allocator around every aten op (:class:`PeakSplit`):
  the op during which the peak falls, with its operands' shapes, the
  ``tensors`` live when that op began or returned, and the op's
  ``scratch``, the rest of the peak: what the op allocated and freed inside
  itself, a cuDNN or cuBLAS workspace or a copy. ``tensor_peak`` is the
  most the tensors held between ops, scratch left out;
* ``code``: printed as "—". The JAX tool reads the size of the compiled XLA
  program; eager PyTorch compiles no program a configuration. Its kernels
  are the libraries' (cuDNN, cuBLAS, aten) and the port's two, loaded once
  a process whatever the batch.

JAX's ``memory_analysis()`` reports a compiled program without running it;
torch has no such report, so each configuration runs. On the CPU (``--device
cpu``) ``args`` and ``out`` are exact and ``temp`` prints "n/a".

Configurations, the JAX tool's: cascade inference (``keypoint_coord3d``)
per batch, and the PoseNet train step (``posenet_scoremap_loss``, Adam
1e-4, ``train.trainer.make_train_step``) at ``--train-batch`` on 256x256
crops at each ``--accum``, plus the same step with remat
at the largest accum. It shows whether accumulation and remat cut the
step's memory before a long run is committed to.

Usage:
  python -m hand3d_tpu_torch.tools.memory_report [--batches 1 32]
      [--hw 240 320] [--train-batch 8] [--accum 1 2 4] [--skip-train]
      [--device cuda]
"""

import argparse
import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hand3d_tpu_torch import precision, weights
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.models.cascade import CROP_SIZE, ColorHandPose3D
from hand3d_tpu_torch.tools import card
from hand3d_tpu_torch.train import losses, trainer


def _fmt(n):
    if n is None:
        return f"{'n/a':>12}"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:8.1f} {unit}"
        n /= 1024
    return f"{n} B"


def nbytes(obj):
    """Bytes of the distinct tensors in ``obj``: tensors, dicts, lists,
    tuples (named too), a ``torch.optim.Optimizer``'s state."""
    seen = {}

    def walk(o):
        if isinstance(o, torch.Tensor):
            seen[id(o)] = o.numel() * o.element_size()
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif isinstance(o, torch.optim.Optimizer):
            for v in o.state.values():
                walk(v)

    walk(obj)
    return sum(seen.values())


class PeakSplit(TorchDispatchMode):
    """Reads the card's allocator around every aten op run under it,
    backward and optimizer ops included: the op during which the allocated
    bytes peak, what was live when it began and when it returned, and the
    peak's rest, allocated and freed inside that op."""

    def __init__(self, device):
        super().__init__()
        self.device = device
        self.base = torch.cuda.memory_allocated(device)
        self.top = None
        self.tensor_peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        out = func(*args, **(kwargs or {}))
        peak = torch.cuda.max_memory_allocated(self.device)
        after = torch.cuda.memory_allocated(self.device)
        self.tensor_peak = max(self.tensor_peak, before, after)
        if self.top is None or peak > self.top["peak"]:
            shapes = [list(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]
            self.top = {"peak": peak, "op": str(func), "shapes": shapes,
                        "before": before, "after": after}
        return out

    def result(self):
        """{"peak", "op", "shapes", "tensors", "scratch", "tensor_peak"},
        bytes over what was allocated when the mode was made."""
        t = self.top
        held = max(t["before"], t["after"])
        return {"peak": t["peak"] - self.base, "op": t["op"],
                "shapes": t["shapes"], "tensors": held - self.base,
                "scratch": t["peak"] - held,
                "tensor_peak": self.tensor_peak - self.base}


def measure(fn, args, device):
    """{"args", "out", "temp"} bytes of ``fn(*args)``: on a card the second
    call's peak over what was allocated before it (``temp``) and a third
    call's :class:`PeakSplit` (``split``); on the CPU one call and ``temp``
    None. ``args`` is counted after the first call, which makes a train
    state's Adam moments."""
    device = torch.device(device)
    out = fn(*args)
    if device.type != "cuda":
        return {"args": nbytes(args), "out": nbytes(out), "temp": None}
    del out
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    torch.cuda.synchronize(device)
    stats = {"args": nbytes(args), "out": nbytes(out),
             "temp": torch.cuda.max_memory_allocated(device) - before}
    del out
    with PeakSplit(device) as split:
        fn(*args)
    torch.cuda.synchronize(device)
    stats["split"] = split.result()
    return stats


def report(tag, stats, info):
    print(f"{tag:44s} args {_fmt(stats['args'])}  out {_fmt(stats['out'])}  "
          f"temp {_fmt(stats['temp'])}  code {'—':>10}", flush=True)
    split = stats.get("split")
    if split:
        print(f"  peak {_fmt(split['peak'])} during {split['op']} "
              f"{split['shapes']}: tensors {_fmt(split['tensors'])} + "
              f"scratch {_fmt(split['scratch'])}; tensor peak "
              f"{_fmt(split['tensor_peak'])}", flush=True)
    row = {"config": tag, **stats, "code": None, "card": info["name"],
           "power_limit": info["power_limit"]}
    print(json.dumps(row), flush=True)
    return row


def inference_reports(batches, hw, device, info):
    """One row per batch: the f32 cascade's ``keypoint_coord3d``."""
    net = ColorHandPose3D()
    params = weights.params_from_jax(weights.random_params(0), device)

    def run(p, im, hs):
        with torch.inference_mode():
            return net.inference(p, im, hs,
                                 keypoints_scoremap=False).keypoint_coord3d

    rows = []
    generator = torch.Generator().manual_seed(1)
    for b in batches:
        image = (torch.rand((b, *hw, 3), generator=generator) - 0.5).to(device)
        hand_side = torch.tensor([[1.0, 0.0]], device=device).repeat(b, 1)
        rows.append(report(f"cascade inference batch {b} {hw[0]}x{hw[1]}",
                           measure(run, (params, image, hand_side), device),
                           info))
        del image, hand_side
    return rows


def posenet_loss(params, data, generator):
    preds = posenet.apply(params[posenet.SCOPE], data["image_crop"])
    return losses.posenet_scoremap_loss(preds, data["scoremap"],
                                        data["keypoint_vis21"])


def train_batch(batch, crop, device, generator):
    """A random PoseNet batch: crops, scoremaps and visibilities."""
    def rand(*shape):
        return torch.rand(shape, generator=generator).to(device)
    return {"image_crop": rand(batch, crop, crop, 3) - 0.5,
            "scoremap": rand(batch, crop, crop, posenet.NUM_KP),
            "keypoint_vis21": (rand(batch, posenet.NUM_KP) > 0.2).float()}


def train_reports(batch, accums, device, info, crop=CROP_SIZE):
    """One row per accum, and one with remat at the largest."""
    rows = []
    opt = trainer.make_optimizer([1e-4], [])
    data = train_batch(batch, crop, device, torch.Generator().manual_seed(2))
    params = {posenet.SCOPE: weights.params_from_jax(
        posenet.init(np.random.default_rng(0)), device)}
    for acc in accums:
        for remat in ((False, True) if acc == max(accums) else (False,)):
            state = trainer.init_state(params, opt)  # a copy of params
            step = trainer.make_train_step(posenet_loss, opt, remat=remat,
                                           accum_steps=acc)
            # a step updates the state in place and returns it; its
            # arguments are that state (with Adam's moments, made by the
            # warm-up call) and the batch
            stats = measure(lambda s, d: step(s, d, (0, 0)), (state, data),
                            device)
            tag = f"posenet train step batch {batch} accum={acc}" + (
                " remat" if remat else "")
            rows.append(report(tag, stats, info))
            del state, step
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=[1, 32])
    p.add_argument("--hw", type=int, nargs=2, default=[240, 320])
    p.add_argument("--train-batch", type=int, default=8)
    p.add_argument("--accum", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--skip-train", action="store_true")
    card.add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    """Print the report; returns its rows."""
    args = parse_args(argv)
    device = precision.exact_f32(args.device)
    info = card.card(device)
    print(f"backend: {device.type} ({card.label(info)})", flush=True)
    rows = inference_reports(args.batches, tuple(args.hw), device, info)
    if not args.skip_train:
        rows += train_reports(args.train_batch, args.accum, device, info)
    return rows


if __name__ == "__main__":
    main()
