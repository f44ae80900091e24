"""Convert the Rendered Handpose Dataset (RHD) into fixed-length binary
records (counterpart of tools/create_binary_db.py; byte layout in
``data.codec``, the reference's create_binary_db.py:44-90).

Usage:
  python -m hand3d_tpu_torch.tools.create_binary_db \
      --rhd-path ./RHD_published_v2 --set evaluation \
      --out ./data/bin/rhd_evaluation.bin

The .bin equals the JAX tool's byte for byte. PNGs are read with PIL
(:func:`load_png`), as uint8 arrays equal to what the JAX tool's
``matplotlib.image.imread`` and ``round(x * 255)`` give for 8-bit PNGs.
"""

import argparse
import os
import pickle

import numpy as np

from hand3d_tpu_torch.data.codec import write_rhd_record

# PNG raw modes of 8 bits a channel (PIL's ``im.png.im_rawmode``); "1" is
# 1-bit grey, which matplotlib scales to 0 / 1 and PIL to 0 / 255 as well
_GREY_RAWMODES = ("L", "1")


def load_png(path):
    """An 8-bit PNG as uint8 [H, W] (grey) or [H, W, C] (RGB, RGBA; palette
    and grey + alpha as RGBA, as matplotlib converts them). Another bit
    depth raises: ``imread`` would rescale it."""
    from PIL import Image

    with Image.open(path) as im:
        if im.format != "PNG":
            raise ValueError(f"{path}: not a PNG ({im.format})")
        rawmode = im.png.im_rawmode
        if im.mode in ("P", "LA"):
            im = im.convert("RGBA")
        elif im.mode == "1":
            im = im.convert("L")
        elif not (im.mode in ("RGB", "RGBA")
                  or (im.mode == "L" and rawmode in _GREY_RAWMODES)):
            raise ValueError(f"{path}: {im.mode} PNG of raw mode {rawmode}; "
                             "the datasets' PNGs have 8 bits a channel")
        return np.array(im, np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rhd-path", required=True, help="RHD_published_v2 root")
    p.add_argument("--set", choices=["training", "evaluation"],
                   default="evaluation")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    out = args.out or f"./data/bin/rhd_{args.set}.bin"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    anno_path = os.path.join(args.rhd_path, args.set,
                             f"anno_{args.set}.pickle")
    with open(anno_path, "rb") as f:
        # the published annotations are a Python 2 pickle of numpy arrays
        anno_all = pickle.load(f, encoding="latin1")

    n = len(anno_all)
    root = os.path.join(args.rhd_path, args.set)
    with open(out, "wb") as f:
        for sample_id in sorted(anno_all):
            anno = anno_all[sample_id]
            image = load_png(os.path.join(root, "color",
                                          "%.5d.png" % sample_id))
            mask = load_png(os.path.join(root, "mask",
                                         "%.5d.png" % sample_id))
            kp_uv = anno["uv_vis"][:, :2]
            kp_vis = (anno["uv_vis"][:, 2] == 1).astype(np.uint8)
            write_rhd_record(f, anno["xyz"], kp_uv, anno["K"], image, mask,
                             kp_vis)
            if sample_id % 100 == 0:
                print(f"{sample_id} / {n} images done: "
                      f"{sample_id * 100.0 / n:.3f} percent")
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
