"""Visual consistency check of a converted .bin dataset (counterpart of
tools/inspect_db.py; the reference's manual smoke test,
data/BinaryDbReaderSTB.py:413-451).

For the first --num samples, after the port's preprocessing
(``data.preprocess``), the stored 2D keypoints (green dots) and the 3D
keypoints projected through the stored intrinsics (red crosses) are drawn on
the image, the samples side by side in one PNG. A wrong record layout,
keypoint order or intrinsics shows as two point sets that disagree. Drawn
with PIL, which the card's machine has (it has no matplotlib).

Usage:
  python -m hand3d_tpu_torch.tools.inspect_db --dataset rhd \
      --data ./data/bin/rhd_evaluation.bin --num 4 --out inspect.png
"""

import argparse

import numpy as np
import torch

from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.preprocess import preprocess_rhd, preprocess_stb
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.stb import STBDataset

GREEN, RED = (0, 200, 0), (230, 0, 0)


def panel(data, i):
    """Sample ``i`` of preprocessed ``data`` as a PIL image with its stored
    uv (dots) and its projected xyz (crosses) drawn on."""
    from PIL import Image, ImageDraw

    image = (data["image"][i].numpy() + 0.5).clip(0, 1)
    uv = data["keypoint_uv21"][i].numpy()
    vis = data["keypoint_vis21"][i].numpy().astype(bool).ravel()
    xyz = data["keypoint_xyz21"][i].numpy()
    proj = xyz @ data["cam_mat"][i].numpy().T
    proj = proj[:, :2] / proj[:, 2:3]
    img = Image.fromarray(np.round(image * 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for u, v in uv[vis]:
        draw.ellipse((u - 2, v - 2, u + 2, v + 2), fill=GREEN)
    for u, v in proj[vis]:
        draw.line((u - 4, v, u + 4, v), fill=RED)
        draw.line((u, v - 4, u, v + 4), fill=RED)
    return img


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", choices=["rhd", "stb"], required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--num", type=int, default=4)
    p.add_argument("--out", default="inspect.png")
    args = p.parse_args(argv)

    from PIL import Image

    if args.dataset == "rhd":
        ds, pre = RHDDataset("evaluation", path=args.data), preprocess_rhd
    else:
        ds, pre = STBDataset("evaluation", path=args.data), preprocess_stb
    idx = np.arange(min(args.num, len(ds)))
    raw = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in ds.raw_batch(idx).items()}
    with torch.no_grad():
        data = pre(PreprocessConfig(render_scoremap=False), raw)
    panels = [panel(data, i) for i in range(len(idx))]
    w, h = panels[0].size
    fig = Image.new("RGB", (w * len(panels), h), "white")
    for i, im in enumerate(panels):
        fig.paste(im, (i * w, 0))
    fig.save(args.out)
    print(f"Wrote {args.out} — green dots and red crosses must coincide")


if __name__ == "__main__":
    main()
