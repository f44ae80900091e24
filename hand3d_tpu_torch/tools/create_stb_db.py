"""Convert the STB (Stereo Hand Tracking Benchmark) dataset into binary
records (counterpart of tools/create_stb_db.py: the reference's MATLAB
pipeline data/stb/create_db.m + write_binary_record.m in Python).

Projection per create_db.m:13-39: annotations are 3D points in the BB
camera frame; the left frame projects through K directly, the right frame
through K after the stereo baseline shift (x - 120.054 mm). Each sample id
writes the left then the right frame (:84-85). The .bin equals the JAX
tool's byte for byte.

Usage:
  python -m hand3d_tpu_torch.tools.create_stb_db \
      --stb-path /path/to/StereoHandTracking --out ./data/stb/stb_eval.bin
"""

import argparse
import os

import numpy as np

from hand3d_tpu_torch.data.codec import write_stb_record
from hand3d_tpu_torch.tools.create_binary_db import load_png

SEQUENCES = ["B1Counting", "B1Random"]
FRAMES_PER_SEQ = 1500

# BB-camera intrinsics + stereo baseline (create_db.m:13-27)
FX = FY = 822.79041
TX, TY = 318.47345, 250.31296
BASELINE_MM = 120.054
K = np.array([[FX, 0.0, TX], [0.0, FY, TY], [0.0, 0.0, 1.0]])


def load_hand_para(labels_dir, seq_name):
    """handPara [3, 21, 1500] of the sequence's .mat annotation file."""
    from scipy.io import loadmat

    return loadmat(os.path.join(labels_dir, f"{seq_name}_BB.mat"))["handPara"]


def project(xyz_mm):
    """[21, 3] camera-frame mm -> [21, 2] pixel uv."""
    uvw = xyz_mm @ K.T
    return uvw[:, :2] / uvw[:, 2:3]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stb-path", required=True, help="StereoHandTracking root")
    p.add_argument("--out", default="./data/stb/stb_eval.bin")
    args = p.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        for seq in SEQUENCES:
            print(f"Working on {seq}")
            hand_para = load_hand_para(os.path.join(args.stb_path, "labels"),
                                       seq)
            for im_id in range(FRAMES_PER_SEQ):
                xyz_l = hand_para[:, :, im_id].T  # [21, 3] mm, left/BB frame
                xyz_r = xyz_l - np.array([BASELINE_MM, 0.0, 0.0])
                vis = np.ones(21, np.float32)
                for side, xyz in (("left", xyz_l), ("right", xyz_r)):
                    img = load_png(os.path.join(args.stb_path, seq,
                                                f"BB_{side}_{im_id}.png"))
                    write_stb_record(f, xyz, project(xyz), vis, img[..., :3])
    print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
