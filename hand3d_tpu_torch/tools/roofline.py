"""Analytic roofline of the cascade on one card (counterpart of
tools/roofline.py).

Walks the port's own layer tables (``models.handsegnet.LAYERS``, PoseNet's
``ENCODER``, its 1x1 head and ``refinement_layers``, and the PosePrior and
ViewpointNet towers of ``models.poseprior``) and charges each convolution

    t = max(FLOPs / R, bytes / BW)

per frame, where

* R is the effective conv rate of the compute path the layer runs,
  measured on this card at start: the direct convolution's FLOPs
  (2 h w k^2 cin cout a frame) over the time of ``ops.nn.conv2d``, the op
  the model calls, on the three reference shapes (3x3x256 @ 60x80,
  3x3x512 @ 30x40, 7x7x128 @ 32x32, batch 32), the best of them, for each
  path the port runs: "f32" (cuDNN with TF32 off, as parity runs), "bf16"
  (the bf16 mode: operands rounded to bf16, TF32 convs) and "int8"
  (``ops.quant``'s int8 layers today: TF32 convs of integer-valued f32,
  with their quantize and dequantize). cuDNN picks the algorithm: an FFT
  or Winograd one does fewer multiplies than the direct conv, so its
  effective rate can pass the card's peak for the type. On a card the
  tool names the device kernels each reference shape ran, which tell the
  algorithm. The best shape's rate is the layers' rate, the highest and
  so the loosest bound of the three;
* bytes are the layer's activations in and out at its output resolution
  plus its weights amortized over ``--batch``, at the path's operand size:
  4 bytes on every path today, since the bf16 mode and the int8 layers keep
  their rounded operands in f32 tensors;
* BW is the card's HBM rate, measured by a 1 GiB device-to-device copy
  (read and write counted).

``--int8`` charges the int8 rate to the layers that ``ops.quant``'s gate
quantizes (``min_in_chan`` 128, ``min_out_chan`` 32); the others keep the
``--dtype`` rate. The glue between the networks (flood fill, bbox, crop,
resizes, decode) is charged at ``--glue-ms`` a frame, measured by
``profile_stages``; the FCs of the lifting nets are left out (< 20 MFLOP).
Each term is a lower bound of the layer's time, so the total bounds the
cascade from below: a measured frame faster than it means a wrong tool.

Two things of the JAX tool are not carried over. Its rates are a TPU's
(v5e) with an MXU lane-fill factor ``min(cin, 128) / 128``; here every rate
is this card's. Its int8 rate goes to every layer with ``cin >= 128``, the
four float heads (PoseNet ``conv5_2``, ``conv6_7``, ``conv7_7`` and
HandSegNet ``conv6_2``) included; and it walks refinement units 1 and 2,
printing ``conv7_*`` and ``conv8_*``, where the model's are ``conv6_*`` and
``conv7_*``. Its comment amortizes the weights over the batch, which its
code never reads; here ``--batch`` does.

``--rate`` (the ``--dtype`` path's) and ``--hbm`` override the measured
numbers; given both and no ``--int8``, the tool measures nothing and
touches no device.

Usage:
  python -m hand3d_tpu_torch.tools.roofline --batch 128
      [--image-hw 240x320] [--seg-scale 1.0] [--dtype f32|bf16]
      [--int8 [--int8-scope handsegnet]] [--glue-ms MS] [--per-layer]
      [--rate TFLOPS] [--hbm GBPS] [--device cuda]
"""

import argparse
import inspect
import json

import torch

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.models import handsegnet, posenet, poseprior
from hand3d_tpu_torch.models.cascade import CROP_SIZE
from hand3d_tpu_torch.ops import nn, quant
from hand3d_tpu_torch.tools import card

# (kernel, channels in = out, height, width) of the reference conv shapes
REFERENCE_SHAPES = ((3, 256, 60, 80), (3, 512, 30, 40), (7, 128, 32, 32))
RATE_BATCH = 32
PATHS = ("f32", "bf16", "int8")
OPERAND_BYTES = {"f32": 4, "bf16": 4, "int8": 4}
HBM_COPY_BYTES = 1 << 30
_GATE = inspect.signature(quant.quantize_params_int8).parameters
MIN_IN_CHAN = _GATE["min_in_chan"].default
MIN_OUT_CHAN = _GATE["min_out_chan"].default


def conv_cost(h, w, k, cin, cout, rate, hbm, batch=1, dtype_bytes=4):
    """(FLOPs, bytes, seconds, HBM-bound) of one frame through a k x k conv
    with an h x w output."""
    flops = 2.0 * h * w * k * k * cin * cout
    nbytes = dtype_bytes * (h * w * cin + h * w * cout
                            + k * k * cin * cout / batch)
    t_rate, t_hbm = flops / rate, nbytes / hbm
    return flops, nbytes, max(t_rate, t_hbm), t_hbm > t_rate


def handsegnet_layers(h, w):
    """(name, h, w, k, cin, cout) of HandSegNet's convs on an h x w input."""
    cin = 3
    for entry in handsegnet.LAYERS:
        if entry == "pool":
            h, w = h // 2, w // 2
            continue
        name, k, cout, _ = entry
        yield name, h, w, k, cin, cout
        cin = cout


def posenet_layers(crop=CROP_SIZE):
    """PoseNet's encoder, its 1x1 head and the refinement units."""
    h = w = crop
    cin = 3
    for entry in posenet.ENCODER:
        if entry == "pool":
            h, w = h // 2, w // 2
            continue
        name, k, cout = entry
        yield name, h, w, k, cin, cout
        cin = cout
    yield "conv5_1", h, w, 1, posenet.ENC_CHAN, 512
    yield "conv5_2", h, w, 1, 512, posenet.NUM_KP
    for unit in range(posenet.NUM_REFINEMENT_UNITS):
        cin = posenet.NUM_KP + posenet.ENC_CHAN
        for name, k, cout in posenet.refinement_layers(unit):
            yield name, h, w, k, cin, cout
            cin = cout


def prior_layers():
    """The PosePrior and ViewpointNet towers: per width a stride-1 conv and
    a stride-2 conv, from the 32x32x21 scoremap."""
    for chans in (poseprior.POSE_CHANS, poseprior.VP_CHANS):
        prefix = poseprior._prefix(chans)
        h = w = poseprior.SCOREMAP_SIZE
        cin = poseprior.NUM_KP
        for i, cout in enumerate(chans):
            yield f"{prefix}_{i}_1", h, w, 3, cin, cout
            yield f"{prefix}_{i}_2", h // 2, w // 2, 3, cout, cout
            h, w, cin = h // 2, w // 2, cout


def stage_layers(image_hw, seg_scale=1.0):
    """{stage: [(name, h, w, k, cin, cout)]} of the cascade."""
    ih, iw = image_hw
    sh, sw = max(1, round(ih * seg_scale)), max(1, round(iw * seg_scale))
    return {"HandSegNet": list(handsegnet_layers(sh, sw)),
            "PoseNet": list(posenet_layers()),
            "Prior+Viewpoint": list(prior_layers())}


def int8_layer(k, cin, cout):
    """Whether ``ops.quant``'s gate quantizes a k x k conv cin -> cout."""
    w = torch.empty((cout, cin, k, k), device="meta")
    return quant._eligible(w, MIN_IN_CHAN, MIN_OUT_CHAN)


def _conv_fn(path, k, c, device, generator):
    layer = {"weights": torch.randn((c, c, k, k), generator=generator)
             .mul_(0.02).to(device),
             "biases": torch.zeros(c, device=device)}
    if path == "int8":
        layer = quant.quantize_params_int8({"conv": layer})["conv"]
    dtype = torch.bfloat16 if path == "bf16" else None
    return lambda x: nn.conv2d(x, layer, compute_dtype=dtype)


def device_kernels(fn, args):
    """Names of the device kernels one call of ``fn(*args)`` runs on the
    card, the longest first."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), \
            torch.profiler.profile(activities=acts) as prof:
        fn(*args)
        torch.cuda.synchronize()

    def device_us(evt):
        return (getattr(evt, "self_device_time_total", None)
                or getattr(evt, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.key for e in sorted(kernels, key=lambda e: -device_us(e))]


def measure_rates(device, paths=PATHS, shapes=REFERENCE_SHAPES,
                  batch=RATE_BATCH, iters=10):
    """{path: {"rate": FLOP/s, "shape": its best shape, "by_shape": {...},
    "kernels": {shape: device kernel names} (on a card)}} of
    ``ops.nn.conv2d`` on ``device``; a rate counts the direct conv's
    FLOPs."""
    generator = torch.Generator().manual_seed(0)
    on_card = torch.device(device).type == "cuda"
    out = {}
    for path in paths:
        by_shape, kernels = {}, {}
        for k, c, h, w in shapes:
            x = torch.randn((batch, c, h, w), generator=generator).to(device)
            fn = _conv_fn(path, k, c, device, generator)
            ms = card.time_ms(fn, (x,), iters, device)
            shape = f"{k}x{k}x{c}@{h}x{w}"
            by_shape[shape] = 2.0 * batch * h * w * k * k * c * c / (ms / 1e3)
            if on_card:
                kernels[shape] = device_kernels(fn, (x,))
            del x, fn
        best = max(by_shape, key=by_shape.get)
        out[path] = {"rate": by_shape[best], "shape": best,
                     "by_shape": by_shape, "kernels": kernels}
    return out


def measure_hbm(device, nbytes=HBM_COPY_BYTES, iters=10):
    """Bytes/s of a device-to-device copy of ``nbytes`` (read + write)."""
    src = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    ms = card.time_ms(dst.copy_, (src,), iters, device)
    return 2.0 * nbytes / (ms / 1e3)


def roofline(layers, rates, hbm, batch, dtype="f32", int8=False,
             int8_scope=None, glue_ms=0.0):
    """The prediction: per stage its layers' (name, h, w, k, cin, cout,
    path, FLOPs, bytes, seconds, HBM-bound), and the totals."""
    stages = {}
    total_t = total_f = 0.0
    for stage, specs in layers.items():
        stage_int8 = int8 and (int8_scope is None or
                               stage.lower() == int8_scope.lower())
        rows = []
        for name, h, w, k, cin, cout in specs:
            path = "int8" if stage_int8 and int8_layer(k, cin, cout) \
                else dtype
            f, nbytes, t, bw = conv_cost(h, w, k, cin, cout, rates[path], hbm,
                                         batch, OPERAND_BYTES[path])
            rows.append({"name": name, "h": h, "w": w, "k": k, "cin": cin,
                         "cout": cout, "path": path, "flops": f,
                         "bytes": nbytes, "s": t, "hbm_bound": bw})
        st = sum(r["s"] for r in rows)
        sf = sum(r["flops"] for r in rows)
        stages[stage] = {"gflop": sf / 1e9, "ms": st * 1e3,
                         "hbm_bound": sum(r["hbm_bound"] for r in rows),
                         "layers": rows}
        total_t += st
        total_f += sf
    total = total_t + glue_ms / 1e3
    return {"stages": stages, "glue_ms": glue_ms,
            "total_gflop": total_f / 1e9, "ms_per_frame": total * 1e3,
            "frames_per_s": 1.0 / total,
            "eff_tflops": total_f / total / 1e12}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image-hw", default="240x320")
    ap.add_argument("--seg-scale", type=float, default=1.0)
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                    help="the compute path of the float layers")
    ap.add_argument("--int8", action="store_true",
                    help="int8 rate for the layers ops.quant's gate "
                         "quantizes (min_in_chan 128, min_out_chan 32)")
    ap.add_argument("--int8-scope", default=None, choices=["handsegnet"],
                    help="with --int8: apply the int8 rate only to this "
                         "stage (the drift-free quantize_scope preset)")
    ap.add_argument("--glue-ms", type=float, default=0.0,
                    help="measured non-conv glue ms/frame (flood fill + box "
                         "+ crop + decode) from profile_stages; default 0 = "
                         "conv-only bound")
    ap.add_argument("--per-layer", action="store_true")
    ap.add_argument("--rate", type=float, default=None,
                    help="TFLOP/s of the --dtype path instead of measuring")
    ap.add_argument("--hbm", type=float, default=None,
                    help="GB/s of HBM instead of measuring")
    card.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Print the roofline; returns :func:`roofline`'s dict with the rates,
    their source and the arguments."""
    args = parse_args(argv)
    ih, iw = (int(v) for v in args.image_hw.split("x"))
    rates = {}
    if args.rate is not None:
        rates[args.dtype] = args.rate * 1e12
    hbm = None if args.hbm is None else args.hbm * 1e9
    need = {args.dtype, "int8"} if args.int8 else {args.dtype}
    measured = {}
    if not need <= set(rates) or hbm is None:
        device = precision.exact_f32(args.device)
        info = card.card(device)
        measured = measure_rates(device)
        for path, m in measured.items():
            rates.setdefault(path, m["rate"])
            print(f"measured {path} effective conv rate (direct-conv FLOPs): "
                  f"{m['rate'] / 1e12:.3f} TFLOP/s (best {m['shape']}, batch "
                  f"{RATE_BATCH}; "
                  + ", ".join(f"{s} {r / 1e12:.3f}"
                              for s, r in m["by_shape"].items())
                  + f") on {card.label(info)}", flush=True)
            for shape, names in m["kernels"].items():
                print(f"  {path} {shape} kernels: "
                      + ("; ".join(n[:90] for n in names[:3])
                         or "none read (the profiler saw no device kernel)"),
                      flush=True)
        if hbm is None:
            hbm = measure_hbm(device)
            print(f"measured HBM: {hbm / 1e9:.1f} GB/s (device-to-device copy "
                  f"of {HBM_COPY_BYTES} bytes) on {card.label(info)}",
                  flush=True)
        source = card.label(info)
    else:
        source = "given (--rate/--hbm)"
    layers = stage_layers((ih, iw), args.seg_scale)
    out = roofline(layers, rates, hbm, args.batch, args.dtype, args.int8,
                   args.int8_scope, args.glue_ms)
    rate_txt = " ".join(f"rate_{p}={rates[p] / 1e12:.2f}TF/s"
                        for p in sorted(need))
    print(f"batch={args.batch} image={ih}x{iw} seg_scale={args.seg_scale} "
          f"dtype={args.dtype} {rate_txt} hbm={hbm / 1e9:.0f}GB/s "
          f"int8={args.int8} rates: {source}")
    print(f"{'stage':<16} {'GFLOP/frame':>12} {'ms/frame':>9} {'bound':>12}")
    for stage, s in out["stages"].items():
        if args.per_layer:
            for r in s["layers"]:
                print(f"  {r['name']:<14} {r['flops'] / 1e9:10.2f}G "
                      f"{r['s'] * 1e3:8.4f}ms "
                      f"{'HBM' if r['hbm_bound'] else r['path']} "
                      f"({r['h']}x{r['w']} k{r['k']} {r['cin']}->{r['cout']})")
        print(f"{stage:<16} {s['gflop']:12.2f} {s['ms']:9.3f} "
              f"{s['hbm_bound']:>3}/{len(s['layers'])} HBM-bound")
    print(f"{'glue (measured)':<16} {'—':>12} {args.glue_ms:9.3f}")
    print(f"{'TOTAL':<16} {out['total_gflop']:12.2f} "
          f"{out['ms_per_frame']:9.3f}")
    flat = rates[args.dtype]
    print(f"upper-bound throughput: {out['frames_per_s']:,.0f} frames/s "
          f"({out['eff_tflops']:.1f} eff TFLOP/s aggregate; a flat "
          f"{flat / 1e12:.0f} TF/s would give "
          f"{flat / (out['total_gflop'] * 1e9):,.0f} fps)")
    out.update(batch=args.batch, image_hw=[ih, iw], seg_scale=args.seg_scale,
               dtype=args.dtype, int8=args.int8, int8_scope=args.int8_scope,
               rates=rates, hbm=hbm, rates_source=source,
               measured=measured)
    summary = {k: v for k, v in out.items() if k != "stages"}
    summary["stages"] = {k: {kk: vv for kk, vv in s.items() if kk != "layers"}
                         for k, s in out["stages"].items()}
    print(json.dumps(summary), flush=True)
    return out


if __name__ == "__main__":
    main()
