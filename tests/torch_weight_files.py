"""Weight files in the reference's formats, written by the port's tests
(tests/test_torch_weights.py, tests/test_torch_convert_cli.py): Python 2
style pickles and the flat variable dicts of TF checkpoints. The arrays are
small; the readers never look at shapes.
"""

import pickle
import struct

import numpy as np


class Py2Pickler(pickle._Pickler):
    """Writes bytes as Python 2 ``str`` (SHORT_BINSTRING / BINSTRING), as
    the reference's pickles hold their names and numpy arrays' data. Python
    3 reads those back only with ``encoding="latin1"``."""

    dispatch = dict(pickle._Pickler.dispatch)

    def save_py2_str(self, obj):
        n = len(obj)
        if n < 256:
            self.write(pickle.SHORT_BINSTRING + bytes([n]) + obj)
        else:
            self.write(pickle.BINSTRING + struct.pack("<i", n) + obj)
        self.memoize(obj)

    dispatch[bytes] = save_py2_str


def write_reference_pickle(path, flat):
    """{name: ndarray} as the reference wrote it: str names with ':0'."""
    with open(path, "wb") as f:
        Py2Pickler(f, protocol=2).dump(
            {(k + ":0").encode(): v for k, v in flat.items()})


def small(rng, *shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def layer(rng, scope, name, fortran=False, dtype=np.float32):
    w = small(rng, 3, 2, 4, dtype=dtype)
    return {f"{scope}/{name}/weights": np.asfortranarray(w) if fortran else w,
            f"{scope}/{name}/biases": small(rng, 4, dtype=dtype)}


def seg_pickle_flat(rng):
    flat = {}
    for name in ("conv1_1", "conv4_3", "conv5_1", "conv6_2"):
        flat.update(layer(rng, "HandSegNet", name, fortran=name == "conv4_3"))
    return flat


def pose_pickle_flat(rng):
    """PoseNet, PosePrior and ViewpointNet layers (some float64, some
    Fortran-ordered) and one HandSegNet layer, which overrides the first
    pickle's."""
    flat = {}
    for name in ("conv1_1", "conv5_2", "conv7_7"):
        flat.update(layer(rng, "PoseNet2D", name, dtype=np.float64))
    for scope, name in (("PosePrior", "conv_pose_0_1"), ("PosePrior", "fc_xyz"),
                        ("ViewpointNet", "fc_vp_ux")):
        flat.update(layer(rng, scope, name, fortran=True))
    flat.update(layer(rng, "HandSegNet", "conv1_1"))
    return flat


def cpm_flat(rng):
    """The CPM-MPII checkpoint's layout: trunks under CPM/PersonNet and
    CPM/PoseNet with _CPM suffixes, the heads the warm start drops, Adam
    slots, beta powers and global_step."""
    flat = {}
    for net, names in (("PersonNet", ("conv1_1_CPM", "conv4_3_CPM",
                                      "conv5_1_CPM", "conv6_1")),
                       ("PoseNet", ("conv1_1_CPM", "conv4_3_CPM",
                                    "conv4_4_CPM", "conv5_2_CPM",
                                    "Mconv1_stage2"))):
        for name in names:
            flat.update(layer(rng, f"CPM/{net}", name))
    flat["CPM/PoseNet/conv1_1_CPM/weights/Adam"] = small(rng, 3, 2, 4)
    flat["CPM/PoseNet/conv1_1_CPM/weights/Adam_1"] = small(rng, 3, 2, 4)
    flat["beta1_power"] = np.asarray(0.9, np.float32)
    flat["beta2_power"] = np.asarray(0.999, np.float32)
    flat["global_step"] = np.asarray(30000, np.int64)
    return flat


def snapshot_ckpt_flat(rng):
    """A reference training snapshot: PoseNet2D with its Adam slots."""
    flat = {}
    for name in ("conv1_1", "conv3_4", "conv7_7"):
        flat.update(layer(rng, "PoseNet2D", name))
        flat[f"PoseNet2D/{name}/weights/Adam"] = small(rng, 3, 2, 4)
    flat["beta1_power"] = np.asarray(0.9, np.float32)
    flat["global_step"] = np.asarray(30000, np.int64)
    return flat
