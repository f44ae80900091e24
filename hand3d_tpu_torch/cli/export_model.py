"""Export the cascade as a self-contained AOT serving artifact
(counterpart of tools/export_model.py).

Example:
    python -m hand3d_tpu_torch.cli.export_model --weights weights.npz \
        --out cascade.h3dx --batch-size 32 --input-hw 240x320

The artifact bakes the weights into a torch.export program; a serving host
loads it with hand3d_tpu_torch.export.ExportedEstimator.load (or
``python -m hand3d_tpu_torch.cli.serve --artifact``): no model code or
weight files needed. It runs on the --device it was exported for.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", required=True, help="npz param tree")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--input-hw", default="240x320", help="HxW, e.g. 240x320")
    p.add_argument("--right-hand", action="store_true",
                   help="bake right-hand side (default: left)")
    p.add_argument("--compute-dtype", default=None,
                   choices=[None, "bfloat16"], help="conv compute dtype")
    p.add_argument("--seg-scale", type=float, default=1.0,
                   help="fast localization preset (models.cascade)")
    p.add_argument("--quantize", default=None, choices=[None, "int8"],
                   help="bake in the int8 weights and scales (ops.quant, "
                        "dynamic activation scales)")
    p.add_argument("--phase-pack", action="store_true",
                   help="out of scope for the port, raises")
    p.add_argument("--device", default="cuda",
                   help="device the program runs on (default cuda: the CUDA "
                        "kernels; cpu: their plain twins)")
    args = p.parse_args(argv)

    from hand3d_tpu_torch.export import export_estimator
    from hand3d_tpu_torch.weights import load_npz

    h, w = (int(x) for x in args.input_hw.lower().split("x"))
    blob = export_estimator(
        load_npz(args.weights),
        args.out,
        batch_size=args.batch_size,
        input_hw=(h, w),
        left_hand=not args.right_hand,
        compute_dtype=args.compute_dtype,
        seg_scale=args.seg_scale,
        quantize=args.quantize,
        phase_pack=args.phase_pack,
        device=args.device,
    )
    print(f"wrote {args.out}: {len(blob)} bytes, "
          f"batch={args.batch_size}, input={h}x{w}, device={args.device}, "
          f"quantize={args.quantize}")


if __name__ == "__main__":
    main()
