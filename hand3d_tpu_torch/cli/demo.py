"""Single-image demo: image file(s) -> mask + 2D keypoints + 3D pose
(<- run.py; counterpart of hand3d_tpu/cli/demo.py). Renders the
reference's 4-panel figure (input with skeleton, crop with skeleton,
segmentation argmax, 3D skeleton) per image into <name>_pose.png.

    python -m hand3d_tpu_torch.cli.demo hand.png --weights weights.npz \
        --out-dir figures

``--quantize int8`` runs the cascade on the int8 tree (ops.quant). Needs
matplotlib, imported at run time.
"""

import argparse
import os

import numpy as np
import torch

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.cli._common import (add_quantize_arg, init_or_load,
                                          maybe_quantize)
from hand3d_tpu_torch.models.cascade import ColorHandPose3D
from hand3d_tpu_torch.ops.image import resize_bilinear
from hand3d_tpu_torch.utils.viz import plot_hand, plot_hand_3d
from hand3d_tpu_torch.weights import params_from_jax, random_params

DEMO_HW = (240, 320)  # run.py's network input


def load_image(path):
    """An image file as float RGB in [0, 1], [H, W, 3]."""
    import matplotlib.image as mpimg

    img = mpimg.imread(path)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return np.asarray(img[..., :3], np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("images", nargs="+", help="Input image files")
    p.add_argument("--weights", nargs="+", default=None,
                   help="Weight files: .npz or the port's snapshot-<step>.pt "
                        "(layers no file names keep seeded random values)")
    p.add_argument("--out-dir", default=".", help="Where to write figures")
    p.add_argument("--left", dest="left", action="store_true", default=True,
                   help="Treat the hand as a left hand (default, as run.py)")
    p.add_argument("--right", dest="left", action="store_false",
                   help="Treat the hand as a right hand")
    p.add_argument("--seg-scale", type=float, default=1.0,
                   help="<1 = fast localization preset (models.cascade)")
    add_quantize_arg(p)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain twins)")
    args = p.parse_args(argv)

    device = precision.exact_f32(args.device)
    net = ColorHandPose3D(seg_scale=args.seg_scale)
    params = maybe_quantize(init_or_load(random_params(0), args.weights),
                            args)
    if args.quantize is None:
        params = params_from_jax(params, device)
    hand_side = torch.tensor([[1.0, 0.0]] if args.left else [[0.0, 1.0]],
                             device=device)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for path in args.images:
        raw = torch.from_numpy(load_image(path))[None].to(device)
        image = resize_bilinear(raw, DEMO_HW) - 0.5
        with torch.inference_mode():
            out = net.inference(params, image, hand_side)

        crop = (out.image_crop[0].cpu().numpy() + 0.5).clip(0, 1)
        seg = np.argmax(out.hand_scoremap[0].cpu().numpy(), -1)
        coord_hw = out.keypoint_uv21[0].cpu().numpy()[:, ::-1]
        sm = out.keypoints_scoremap[0].cpu().numpy()
        crop_hw = np.stack(
            np.unravel_index(sm.reshape(-1, 21).argmax(0), sm.shape[:2]), -1)

        fig = plt.figure(figsize=(10, 8))
        ax1 = fig.add_subplot(221)
        ax2 = fig.add_subplot(222)
        ax3 = fig.add_subplot(223)
        ax4 = fig.add_subplot(224, projection="3d")
        ax1.imshow((image[0].cpu().numpy() + 0.5).clip(0, 1))
        plot_hand(coord_hw, ax1)
        ax2.imshow(crop)
        plot_hand(crop_hw, ax2)
        ax3.imshow(seg)
        plot_hand_3d(out.keypoint_coord3d[0].cpu().numpy(), ax4)
        ax4.view_init(azim=-90.0, elev=-90.0)
        ax4.set_xlim([-3, 3])
        ax4.set_ylim([-3, 1])
        ax4.set_zlim([-3, 3])

        out_path = os.path.join(
            args.out_dir,
            os.path.splitext(os.path.basename(path))[0] + "_pose.png")
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        print(f"Wrote {out_path}")


if __name__ == "__main__":
    main()
