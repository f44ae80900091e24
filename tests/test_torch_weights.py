"""The port's weight readers against the JAX package's, on the same files.

Every file is written here, in the reference's formats: Python 2 style
pickles, TF V2 checkpoints (the CPM-MPII warm start with Adam slots, a
training snapshot) and the JAX package's flax msgpack snapshots. The trees
that ``hand3d_tpu_torch.cli._common.load_weight_trees`` returns must equal
those of ``hand3d_tpu.cli._common.load_weight_trees`` bit for bit, dtype
included. The arrays are small: the readers never look at shapes.
"""

import pickle
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
from flax import serialization

from hand3d_tpu.cli._common import load_weight_trees as jax_load
from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.models.poseprior import PosePriorNetwork
from hand3d_tpu.train import checkpoints as jax_checkpoints
from hand3d_tpu.train.trainer import TrainState
from hand3d_tpu.train.trainer import init_state as jax_init_state
from hand3d_tpu.train.trainer import make_optimizer as jax_optimizer
from hand3d_tpu.weights import convert as jax_convert
from hand3d_tpu.weights import tf_ckpt as jax_tf_ckpt
from hand3d_tpu_torch.cli import _common, eval2d, eval2d_gt_cropped
from hand3d_tpu_torch.cli import train_handsegnet, train_posenet
from hand3d_tpu_torch.data.synthetic import make_rhd_bin
from hand3d_tpu_torch.models import handsegnet, posenet
from hand3d_tpu_torch.weights import convert, flax_msgpack, tf_ckpt

from torch_tmp import module_dir, tmp_path  # noqa: F401
from torch_weight_files import (cpm_flat, layer, pose_pickle_flat,
                                seg_pickle_flat, small, snapshot_ckpt_flat,
                                write_reference_pickle)

EVAL2D_EXCLUDE = ["PosePrior", "ViewpointNet"]  # hand3d_tpu/cli/eval2d.py:42
GT_CROPPED_EXCLUDE = ["PosePrior", "ViewpointNet", "HandSegNet"]  # :40


def jax_snapshot(directory, rng):
    """snapshot-7.msgpack written by the JAX package's save_snapshot: a
    TrainState with Adam's nested state and an int32 step."""
    params = jax_convert.flat_to_tree(
        {**layer(rng, "PoseNet2D", "conv1_1"),
         **layer(rng, "PosePrior", "fc_xyz"),
         **layer(rng, "HandSegNet", "conv6_2")})
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_init_state(params, jax_optimizer([1e-4, 1e-5], [10]))
    state = TrainState(state.params, state.opt_state, jnp.int32(7))
    return jax_checkpoints.save_snapshot(str(directory), state, step=7)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(0)
    with module_dir(tmp_path_factory, "weights") as d:
        seg, pose = d / "handsegnet-rhd.pickle", d / "posenet3d-rhd-stb.pickle"
        write_reference_pickle(seg, seg_pickle_flat(rng))
        write_reference_pickle(pose, pose_pickle_flat(rng))
        jax_tf_ckpt.write_checkpoint(str(d / "cpm-model-mpii"), cpm_flat(rng))
        jax_tf_ckpt.write_checkpoint(str(d / "model-300"),
                                     snapshot_ckpt_flat(rng))
        npz = d / "w.npz"
        jax_convert.save_npz(str(npz), jax_convert.flat_to_tree(
            layer(rng, "PoseNet2D", "conv1_1")))
        yield {"seg": str(seg), "pose": str(pose),
               "cpm": str(d / "cpm-model-mpii"),
               "cpm_index": str(d / "cpm-model-mpii.index"),
               "snapshot": str(d / "model-300"),
               "msgpack": jax_snapshot(d / "snaps", rng), "npz": str(npz)}


def assert_trees_equal(got, want):
    got, want = convert.tree_to_flat(got), jax_convert.tree_to_flat(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


LOADS = {
    "pickles": (["seg", "pose"], None),
    "pickles_eval2d": (["seg", "pose"], EVAL2D_EXCLUDE),
    "pickles_eval2d_gt_cropped": (["seg", "pose"], GT_CROPPED_EXCLUDE),
    "cpm_prefix": (["cpm"], None),
    "cpm_index": (["cpm_index"], None),
    "snapshot_checkpoint": (["snapshot"], None),
    "msgpack": (["msgpack"], None),
    "every_format": (["npz", "seg", "msgpack", "cpm", "snapshot"],
                     EVAL2D_EXCLUDE),
}


@pytest.mark.parametrize("case", list(LOADS))
def test_load_weight_trees_equals_jax(files, case):
    names, exclude = LOADS[case]
    paths = [files[n] for n in names]
    assert_trees_equal(_common.load_weight_trees(paths, exclude),
                       jax_load(paths, exclude))


def test_pickles_merge_in_order_and_drop_excluded_scopes(files):
    tree = _common.load_weight_trees([files["seg"], files["pose"]],
                                     GT_CROPPED_EXCLUDE)
    assert set(tree) == {"PoseNet2D"}
    tree = _common.load_weight_trees([files["seg"], files["pose"]],
                                     EVAL2D_EXCLUDE)
    assert set(tree) == {"HandSegNet", "PoseNet2D"}
    # the later file's conv1_1 overrides the earlier one's
    with open(files["pose"], "rb") as f:
        later = pickle.load(f, encoding="latin1")
    np.testing.assert_array_equal(tree["HandSegNet"]["conv1_1"]["weights"],
                                  later["HandSegNet/conv1_1/weights:0"])
    assert tree["PoseNet2D"]["conv1_1"]["weights"].dtype == np.float64


def test_reference_pickles_need_latin1(files):
    """The fixture pickles hold their arrays as Python 2 strs, as the
    reference's do: the default ASCII decoding refuses them."""
    with open(files["seg"], "rb") as f, pytest.raises(UnicodeDecodeError):
        pickle.load(f)
    flat = convert.load_pickle_flat(files["seg"], ["conv4"])
    assert "HandSegNet/conv1_1/weights" in flat
    assert not any("conv4" in k or k.endswith(":0") for k in flat)
    assert flat.keys() == jax_convert.load_pickle_flat(
        files["seg"], ["conv4"]).keys()


def test_cpm_checkpoint_splits_into_both_scopes(files):
    """The warm-start rules: renames in order on the renamed name, the
    heads and optimizer state dropped."""
    raw = tf_ckpt.load_tf_checkpoint(files["cpm"])
    tree = _common.load_weight_trees([files["cpm"]])
    assert set(tree) == {"HandSegNet", "PoseNet2D"}
    assert set(tree["HandSegNet"]) == {"conv1_1", "conv4_3", "conv5_1"}
    assert set(tree["PoseNet2D"]) == {"conv1_1", "conv4_3", "conv4_4"}
    np.testing.assert_array_equal(tree["PoseNet2D"]["conv4_3"]["weights"],
                                  raw["CPM/PoseNet/conv4_3_CPM/weights"])
    np.testing.assert_array_equal(tree["HandSegNet"]["conv1_1"]["biases"],
                                  raw["CPM/PersonNet/conv1_1_CPM/biases"])
    assert set(tree["PoseNet2D"]["conv1_1"]) == {"weights", "biases"}


@pytest.mark.parametrize("target", ["posenet", "handsegnet"])
def test_convert_cpm_warmstart_equals_jax(files, target):
    raw = convert.load_tf_checkpoint_flat(files["cpm"],
                                          convert.SNAPSHOT_DISCARD)
    assert raw.keys() == jax_convert.load_tf_checkpoint_flat(
        files["cpm"], convert.SNAPSHOT_DISCARD).keys()
    assert_trees_equal(convert.convert_cpm_warmstart(raw, target),
                       jax_convert.convert_cpm_warmstart(raw, target))
    with pytest.raises(ValueError, match="Unknown warm-start target"):
        convert.convert_cpm_warmstart(raw, "lifting")


RENAMES = [
    ({"CPM/PoseNet/conv4_3_CPM/weights": 1}, convert.CPM_POSENET_DISCARD,
     convert.CPM_POSENET_RENAME, {"PoseNet2D/conv4_3/weights": 1}),
    ({"CPM/PoseNet/Mconv1_stage2/weights": 1, "CPM/PoseNet/conv5_2_CPM/b": 2,
      "CPM/PersonNet/conv1_1_CPM/w": 3}, convert.CPM_POSENET_DISCARD,
     convert.CPM_POSENET_RENAME, {}),
    ({"CPM/PersonNet/conv5_2_CPM/w": 1, "CPM/PersonNet/conv6_1/w": 2,
      "CPM/PoseNet/conv1_1_CPM/w": 3}, convert.CPM_HANDSEGNET_DISCARD,
     convert.CPM_HANDSEGNET_RENAME, {"HandSegNet/conv5_2/w": 1}),
    ({"a_CPM_CPM/x": 1, "PoseNet2D/conv1/weights/Adam": 2, "beta2_power": 3,
      "global_step": 4}, convert.SNAPSHOT_DISCARD, {"_CPM": "", "a": "b"},
     {"b/x": 1}),
]


@pytest.mark.parametrize("flat,discard,rename,want", RENAMES)
def test_apply_discard_rename_equals_jax(flat, discard, rename, want):
    got = convert.apply_discard_rename(flat, discard, rename)
    assert got == want == jax_convert.apply_discard_rename(flat, discard,
                                                           rename)


def real_layer_names():
    """Every param path of the cascade and of the five lifting variants."""
    names = set(jax_convert.tree_to_flat(jax.eval_shape(
        JaxCascade().init, jax.random.PRNGKey(0))))
    for v in ("direct", "bottleneck", "local", "local_w_xyz_loss",
              "proposed"):
        names |= set(jax_convert.tree_to_flat(jax.eval_shape(
            PosePriorNetwork(v).init, jax.random.PRNGKey(0))))
    return names


def test_no_real_layer_name_holds_a_discard_substring():
    """A snapshot's discard list must drop optimizer state only; the CPM
    rules drop only the heads the warm start replaces."""
    names = real_layer_names()
    assert len(names) > 100
    for name in names:
        assert not any(d in name for d in convert.SNAPSHOT_DISCARD), name
    seg = [n for n in names if n.startswith("HandSegNet/")]
    pose = [n for n in names if n.startswith("PoseNet2D/")]
    cpm_seg = {n.replace("HandSegNet/", "CPM/PersonNet/"): n for n in seg}
    dropped = set(seg) - {cpm_seg[k] for k in convert.apply_discard_rename(
        dict.fromkeys(cpm_seg), convert.CPM_HANDSEGNET_DISCARD)}
    assert {n.split("/")[1] for n in dropped} == {"conv6_1", "conv6_2"}
    dropped = [n for n in pose if any(
        d in n.replace("PoseNet2D/", "CPM/PoseNet/")
        for d in convert.CPM_POSENET_DISCARD)]
    assert dropped == []  # conv5_2 is dropped by its _CPM name only


def test_py2_pickle_names_and_arrays(tmp_path):
    """float64 and Fortran-ordered arrays come through with their values;
    params_from_jax then casts to float32."""
    rng = np.random.default_rng(3)
    flat = {"PosePrior/fc_xyz/weights": np.asfortranarray(
        small(rng, 4, 6, dtype=np.float64))}
    path = tmp_path / "lifting-proposed.pickle"
    write_reference_pickle(path, flat)
    tree = _common.load_weight_trees([str(path)])
    w = tree["PosePrior"]["fc_xyz"]["weights"]
    assert w.dtype == np.float64
    np.testing.assert_array_equal(w, flat["PosePrior/fc_xyz/weights"])


# --- TF checkpoints ------------------------------------------------------------


def test_bfloat16_through_both_readers(tmp_path):
    rng = np.random.default_rng(1)
    values = rng.standard_normal((4, 5)).astype(ml_dtypes.bfloat16)
    jax_tf_ckpt.write_checkpoint(str(tmp_path / "j"), {"x": values})
    got = tf_ckpt.load_tf_checkpoint(str(tmp_path / "j"))["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, values.astype(np.float32))

    bits = values.view(np.uint16)
    tf_ckpt.write_checkpoint(str(tmp_path / "p"), {"x": bits},
                             bfloat16=("x",))
    back = jax_tf_ckpt.load_tf_checkpoint(str(tmp_path / "p"))["x"]
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.view(np.uint16), bits)
    with pytest.raises(ValueError, match="uint16 bits"):
        tf_ckpt.write_checkpoint(str(tmp_path / "q"), {"x": got},
                                 bfloat16=("x",))


def test_checkpoint_dtypes_round_trip_through_both(tmp_path):
    rng = np.random.default_rng(2)
    flat = {
        "HandSegNet/conv1_1/weights": small(rng, 3, 3, 3, 8),
        "scalar_step": np.asarray(12345, np.int64),
        "mask": np.asarray([[True, False], [False, True]]),
        "halfs": small(rng, 5, 7, dtype=np.float16),
        "doubles": small(rng, 2, 2, dtype=np.float64),
        "bytes": rng.integers(0, 255, (6,), dtype=np.uint8),
        "int32": rng.integers(-9, 9, (2, 3), dtype=np.int32),
        "empty_shape": np.asarray(2.5, np.float32),
    }
    tf_ckpt.write_checkpoint(str(tmp_path / "model-5000"), flat)
    for reader in (tf_ckpt.load_tf_checkpoint, jax_tf_ckpt.load_tf_checkpoint):
        got = reader(str(tmp_path / "model-5000"))
        assert sorted(got) == sorted(flat)
        for name, want in flat.items():
            assert got[name].dtype == want.dtype, name
            np.testing.assert_array_equal(got[name], want)
    # both writers write the same files
    jax_tf_ckpt.write_checkpoint(str(tmp_path / "j"), flat)
    for suffix in (".index", ".data-00000-of-00001"):
        assert (tmp_path / ("model-5000" + suffix)).read_bytes() == \
            (tmp_path / ("j" + suffix)).read_bytes()


def prefix_block(entries, restart_interval):
    """A leveldb block as TF writes one: keys share their prefix with the
    previous key, except at a restart point every ``restart_interval``
    entries."""
    out, restarts, prev = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        if i % restart_interval == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while (shared < min(len(key), len(prev))
                   and key[shared] == prev[shared]):
                shared += 1
        out += (tf_ckpt._write_varint(shared)
                + tf_ckpt._write_varint(len(key) - shared)
                + tf_ckpt._write_varint(len(value)))
        out += key[shared:] + value
        prev = key
    for r in restarts or [0]:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts or [0]))
    return bytes(out)


def test_prefix_compressed_block():
    """The hand-made block of tests/test_tf_ckpt.py, as TF's own .index
    files have them (keys share prefixes between restart points)."""
    k1, v1 = b"net/conv1/biases", b"B1"
    k2, v2 = b"net/conv1/weights", b"W2"
    k3, v3 = b"net/conv2/weights", b"W3"
    out = bytearray()
    out += tf_ckpt._write_varint(0) + tf_ckpt._write_varint(len(k1))
    out += tf_ckpt._write_varint(len(v1)) + k1 + v1
    for key, value, shared in ((k2, v2, 10), (k3, v3, 8)):
        out += tf_ckpt._write_varint(shared)
        out += tf_ckpt._write_varint(len(key) - shared)
        out += tf_ckpt._write_varint(len(value)) + key[shared:] + value
    out += struct.pack("<I", 0) + struct.pack("<I", 1)
    want = [(k1, v1), (k2, v2), (k3, v3)]
    assert tf_ckpt._parse_block(bytes(out)) == want
    assert jax_tf_ckpt._parse_block(bytes(out)) == want
    entries = [(f"PoseNet2D/conv{i}_{j}/{w}".encode(), bytes([i, j]))
               for i in range(1, 4) for j in range(1, 3)
               for w in ("biases", "weights")]
    block = prefix_block(entries, restart_interval=5)
    assert tf_ckpt._parse_block(block) == entries == \
        jax_tf_ckpt._parse_block(block)


def test_prefix_compressed_index_file(tmp_path, monkeypatch):
    """A whole checkpoint whose index blocks use restart interval 16, TF's
    default, read by both readers."""
    rng = np.random.default_rng(4)
    flat = {}
    for i in range(1, 6):
        flat.update(layer(rng, "PoseNet2D", f"conv{i}_1"))
        flat.update(layer(rng, "PoseNet2D", f"conv{i}_2"))
    monkeypatch.setattr(tf_ckpt, "_block_bytes",
                        lambda entries: prefix_block(entries, 16))
    tf_ckpt.write_checkpoint(str(tmp_path / "m"), flat)
    monkeypatch.undo()
    index = (tmp_path / "m.index").read_bytes()
    # keys between restart points are stored as suffixes only
    assert b"PoseNet2D/conv3_1/weights" not in index
    for reader in (tf_ckpt.load_tf_checkpoint, jax_tf_ckpt.load_tf_checkpoint):
        got = reader(str(tmp_path / "m"))
        assert sorted(got) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], v)


def test_reader_rejects_non_table(tmp_path):
    (tmp_path / "junk.index").write_bytes(b"\x00" * 100)
    with pytest.raises(ValueError, match="bad magic"):
        tf_ckpt.load_tf_checkpoint(str(tmp_path / "junk"))


# --- flax msgpack snapshots ----------------------------------------------------


def test_msgpack_snapshot_params_equal_jax(files):
    got = flax_msgpack.load_snapshot_params(files["msgpack"])
    assert_trees_equal(got, jax_checkpoints.load_snapshot_params(
        files["msgpack"]))
    with open(files["msgpack"], "rb") as f:
        full = flax_msgpack.msgpack_restore(f.read())
    assert set(full) == {"params", "opt_state", "step"}
    assert full["step"].dtype == np.int32 and full["step"].shape == ()
    assert full["step"] == 7


def msgpack_cases():
    rng = np.random.default_rng(5)
    return {
        "scalars": {"int": 3, "neg": -1, "neg_byte": -100, "neg_big": -2 ** 40,
                    "big": 2 ** 40, "u16": 60000, "u32": 2 ** 31,
                    "u64": 2 ** 63 + 5, "float": 0.1, "none": None,
                    "yes": True, "no": False, "str": "conv1_1",
                    "long_str": "x" * 300, "bin": b"\x00\xff" * 40},
        "np_scalars": {"f32": np.float32(1.5), "i64": np.int64(-7),
                       "u8": np.uint8(200), "bool": np.bool_(True),
                       "f64": np.float64(2.25)},
        "arrays": {"f32": small(rng, 3, 4), "f16": small(rng, 2, 2,
                                                         dtype=np.float16),
                   "i8": rng.integers(-9, 9, (5,), dtype=np.int8),
                   "u64": rng.integers(0, 9, (2, 2), dtype=np.uint64),
                   "bool": rng.random((3,)) > 0.5, "zero_d": np.asarray(4.0),
                   "empty": np.zeros((0, 3), np.float32),
                   "big": small(rng, 40, 50)},
        "nested": {"a": {"b": {"c": [1, 2, {"d": small(rng, 2)}]}},
                   "list": [1, "two", 3.0],
                   "wide": {f"k{i}": i for i in range(20)}},
        "complex": {"z": complex(1.5, -2.0)},
    }


@pytest.mark.parametrize("case", list(msgpack_cases()))
def test_msgpack_subset_equals_flax(case):
    tree = msgpack_cases()[case]
    data = serialization.msgpack_serialize(tree)
    got = flax_msgpack.msgpack_restore(data)
    want = serialization.msgpack_restore(data)

    def check(g, w):
        if isinstance(w, dict):
            assert isinstance(g, dict) and g.keys() == w.keys()
            for k in w:
                check(g[k], w[k])
        elif isinstance(w, (list, tuple)):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                check(a, b)
        elif isinstance(w, (np.ndarray, np.generic)):
            assert type(g) is type(w) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert type(g) is type(w) and g == w
    check(got, want)


def test_msgpack_bfloat16_widens_exactly():
    values = np.random.default_rng(6).standard_normal((3, 4)).astype(
        ml_dtypes.bfloat16)
    data = serialization.to_bytes({"params": {"w": jnp.asarray(values)}})
    got = flax_msgpack.msgpack_restore(data)["params"]["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, values.astype(np.float32))


def test_msgpack_refuses_chunked_arrays_and_junk(monkeypatch, tmp_path):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.to_bytes({"params": {"w": np.zeros(100,
                                                             np.float32)}})
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        flax_msgpack.msgpack_restore(data)
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(serialization.msgpack_serialize(
            {"a": 1})[:-1])
    with pytest.raises(ValueError, match="after the msgpack value"):
        flax_msgpack.msgpack_restore(b"\x01\x02")
    path = tmp_path / "snapshot-1.msgpack"
    path.write_bytes(serialization.msgpack_serialize({"opt_state": 1}))
    with pytest.raises(ValueError, match="not a training snapshot"):
        flax_msgpack.load_snapshot_params(str(path))


# --- the CLIs ------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_bin(tmp_path_factory):
    with module_dir(tmp_path_factory, "train") as d:
        yield str(make_rhd_bin(d / "t.bin", num_records=2))


@pytest.mark.parametrize("module, want", [
    (eval2d, EVAL2D_EXCLUDE), (eval2d_gt_cropped, GT_CROPPED_EXCLUDE)])
def test_eval2d_clis_pass_the_jax_exclude_lists(module, want, monkeypatch,
                                                files, train_bin):
    seen = []

    def stop(params, paths, exclude_var_list=None):
        seen.append((paths, exclude_var_list))
        raise SystemExit(0)

    monkeypatch.setattr(module, "init_or_load", stop)
    monkeypatch.setattr(module, "random_params", lambda seed: {},
                        raising=False)
    with pytest.raises(SystemExit):
        module.main(["--data", train_bin, "--device", "cpu",
                     "--weights", files["seg"]])
    assert seen == [([files["seg"]], want)]


@pytest.mark.parametrize("module, scope", [
    (train_posenet, posenet.SCOPE), (train_handsegnet, handsegnet.SCOPE)])
def test_trainers_take_only_their_scope_of_a_cpm_checkpoint(
        module, scope, files, train_bin):
    """As JAX's train_posenet.py:92-95 and train_handsegnet.py:76-79: the
    stage's own scope, its layers in the checkpoint replaced."""
    job = module.setup(["--data", train_bin, "--device", "cpu",
                        "--weights", files["cpm"], files["pose"]])
    assert set(job.params) == {scope}
    want = jax_load([files["cpm"], files["pose"]])[scope]
    for name, leaves in want.items():
        w = np.asarray(leaves["weights"], np.float32)
        got = job.params[scope][name]["weights"].detach().numpy()
        np.testing.assert_array_equal(
            got, w.transpose(3, 2, 0, 1) if w.ndim == 4 else w)
