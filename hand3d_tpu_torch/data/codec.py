"""Fixed-length binary record codecs for the RHD and STB datasets (a numpy
copy of hand3d_tpu/data/codec.py: that package's ``__init__`` imports jax).

Byte layouts are the reference converters', so the official .bin files read
unchanged:
  * RHD (create_binary_db.py:44-90, data/BinaryDbReader.py:101-210): 42-kp
    xyz f32, uv f32, 3x3 K f32, 2 pad bytes, 320x320x3 image u8, 320x320
    part mask u8, 42 visibility u8 = 410,520 bytes a record.
  * STB (data/stb/write_binary_record.m, BinaryDbReaderSTB.py:96-190): 21-kp
    xyz f32 in mm, 21 x (u, v, vis) f32, 480x640x3 image u8 = 922,104 bytes.

Records are a numpy structured-array memmap, sliced per batch on the host.
"""

import numpy as np

RHD_IMAGE_SIZE = (320, 320)
STB_IMAGE_SIZE = (480, 640)

RHD_RECORD_DTYPE = np.dtype([
    ("kp_xyz", "<f4", (42, 3)),
    ("kp_uv", "<f4", (42, 2)),
    ("cam_mat", "<f4", (3, 3)),
    ("pad", "u1", (2,)),
    ("image", "u1", (*RHD_IMAGE_SIZE, 3)),
    ("hand_parts", "u1", RHD_IMAGE_SIZE),
    ("kp_vis", "u1", (42,)),
])
assert RHD_RECORD_DTYPE.itemsize == 410520

STB_RECORD_DTYPE = np.dtype([
    ("kp_xyz", "<f4", (21, 3)),
    ("kp_uv_vis", "<f4", (21, 3)),
    ("image", "u1", (*STB_IMAGE_SIZE, 3)),
])
assert STB_RECORD_DTYPE.itemsize == 922104


class FixedLenRecordFile:
    """Memory-mapped fixed-length record file."""

    def __init__(self, path, record_dtype):
        self.path = str(path)
        self.dtype = record_dtype
        self.records = np.memmap(self.path, dtype=record_dtype, mode="r")

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx):
        return self.records[idx]

    def gather(self, indices):
        """The given records as a contiguous structured array."""
        return np.ascontiguousarray(self.records[np.asarray(indices)])


def write_rhd_record(f, kp_xyz, kp_uv, cam_mat, image, hand_parts, kp_vis):
    """Append one RHD record (layout of create_binary_db.py:44-90)."""
    rec = np.zeros((), RHD_RECORD_DTYPE)
    rec["kp_xyz"] = np.asarray(kp_xyz, np.float32)
    rec["kp_uv"] = np.asarray(kp_uv, np.float32)
    rec["cam_mat"] = np.asarray(cam_mat, np.float32)
    rec["pad"] = 255
    rec["image"] = np.asarray(image, np.uint8)
    rec["hand_parts"] = np.asarray(hand_parts, np.uint8)
    rec["kp_vis"] = np.asarray(kp_vis, np.uint8)
    f.write(rec.tobytes())


def write_stb_record(f, kp_xyz_mm, kp_uv, kp_vis, image):
    """Append one STB record (layout of data/stb/write_binary_record.m)."""
    rec = np.zeros((), STB_RECORD_DTYPE)
    rec["kp_xyz"] = np.asarray(kp_xyz_mm, np.float32)
    rec["kp_uv_vis"] = np.concatenate(
        [np.asarray(kp_uv, np.float32),
         np.asarray(kp_vis, np.float32)[:, None]], 1)
    rec["image"] = np.asarray(image, np.uint8)
    f.write(rec.tobytes())
