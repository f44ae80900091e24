"""Orbax checkpoints in the port: its zstd decoder against the zstandard
package, its OCDBT reader against tensorstore, and ``save_orbax`` /
``restore_orbax`` against the JAX package's, in both directions, bit for
bit after the layout transposes.

The JAX side's states are TrainStates of ``make_optimizer([1e-4, 1e-5],
[1])`` after two optax steps of seeded gradients (tests/torch_orbax_fixture
.py), so the LR boundary is crossed and the Adam moments are nonzero.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from hand3d_tpu.ops.phasepack import phase_pack_params as jax_phase_pack
from hand3d_tpu.train import checkpoints as jax_checkpoints
from hand3d_tpu.train import trainer as jax_trainer
from hand3d_tpu_torch import weights
from hand3d_tpu_torch.cli import train_posenet
from hand3d_tpu_torch.data import native
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import InputPipeline
from hand3d_tpu_torch.data.preprocess import preprocess_rhd
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.ops.phasepack import phase_pack_params
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.train import checkpoints, trainer
from hand3d_tpu_torch.train.loop import fit
from hand3d_tpu_torch.weights import ocdbt, orbax, zstd

import torch_orbax_fixture as fixture
from fixtures import make_rhd_bin
from torch_threads import torch_threads_per_worker  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

MiB = 1 << 20


# ------------------------------------------------------------------ zstd

def _data(kind, size, seed=0):
    rng = np.random.default_rng(seed)
    n = size // 4
    if kind == "weights":  # N(0, 0.05) float32, as real kernels
        return rng.normal(0, 0.05, n).astype(np.float32).tobytes()
    if kind == "adam_nu":  # squared gradients, spread over decades
        g = rng.normal(0, 1e-3, n) * np.exp(rng.normal(0, 2, n))
        return (1e-3 * g * g).astype(np.float32).tobytes()
    if kind == "zeros":
        return bytes(size)
    words = [b"flood", b"fill", b"decode", b"keypoint", b"crop", b"%d"]
    pick = rng.integers(0, len(words), size // 5)
    text = b" ".join(words[i] % i if i == 5 else words[i] for i in pick)
    return text[:size]


def census(frame):
    """What a single zstd frame's blocks use: ("block", type) for each
    block (0 raw, 1 RLE, 2 compressed) and, for a compressed block,
    ("literals", type) (0 raw, 1 RLE, 2 Huffman, 3 treeless) and
    ("tables", (LL, OF, ML)) of its sequence table modes (0 predefined,
    1 RLE, 2 FSE, 3 repeat) where it has sequences."""
    fhd = frame[4]
    pos = 5 + (0 if fhd & 0x20 else 1) + (0, 1, 2, 4)[fhd & 3]
    fcs = fhd >> 6
    pos += (1 if fhd & 0x20 else 0) if fcs == 0 else 1 << fcs
    out = set()
    while True:
        header = int.from_bytes(frame[pos:pos + 3], "little")
        pos += 3
        btype, size = (header >> 1) & 3, header >> 3
        out.add(("block", btype))
        if btype == 2:
            b = frame[pos:pos + size]
            lt, sf = b[0] & 3, (b[0] >> 2) & 3
            if lt < 2:  # raw or RLE: a 1-, 2- or 3-byte header
                h = int.from_bytes(b[:3], "little")
                hl, regen = ((1, h >> 3 & 31), (2, h >> 4 & 0xFFF),
                             (1, h >> 3 & 31), (3, h >> 4 & 0xFFFFF))[sf]
                q = hl + (regen if lt == 0 else 1)
            else:  # Huffman or treeless: sizes of 10, 14 or 18 bits
                hl = (3, 3, 4, 5)[sf]
                h = int.from_bytes(b[:hl], "little")
                q = hl + (h >> (14, 14, 18, 22)[sf] & (0x3FF, 0x3FF, 0x3FFF,
                                                         0x3FFFF)[sf])
            out.add(("literals", lt))
            if b[q]:
                q += 1 if b[q] < 128 else 2 if b[q] < 255 else 3
                out.add(("tables", (b[q] >> 6, b[q] >> 4 & 3, b[q] >> 2 & 3)))
        pos += 1 if btype == 1 else size
        if header & 1:
            return out


SIZES = {"weights": 4 * MiB, "adam_nu": 2 * MiB, "zeros": MiB,
         "text": MiB}


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", list(SIZES))
def test_zstd_matches_zstandard(kind, level):
    size = SIZES[kind] if level < 19 else MiB
    data = _data(kind, size, seed=level)
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(frame) == data
    seen = census(frame)
    if kind in ("weights", "adam_nu"):  # every block Huffman-coded
        assert {k for k in seen if k[0] != "tables"} <= {
            ("block", 2), ("literals", 2), ("literals", 3)}, seen
    if kind == "zeros":
        assert ("block", 1) in seen, seen


def test_the_zstd_inputs_take_every_block_literals_and_table_mode():
    seen = set()
    for kind in SIZES:
        for level in (1, 3, 19):
            data = _data(kind, SIZES[kind] if level < 19 else MiB, level)
            seen |= census(zstandard.ZstdCompressor(level=level).compress(
                data))
    noise = np.random.default_rng(0).bytes(MiB)  # raw blocks
    seen |= census(zstandard.ZstdCompressor(level=1).compress(noise))
    assert {k for k in seen if k[0] == "block"} == {
        ("block", b) for b in (0, 1, 2)}
    assert {k for k in seen if k[0] == "literals"} == {
        ("literals", t) for t in (0, 1, 2, 3)}
    modes = [m for k, m in seen if k == "tables"]
    for field in range(3):  # LL, OF, ML
        assert {0, 2, 3} <= {m[field] for m in modes}, field
    assert 1 in {m[0] for m in modes} and 1 in {m[2] for m in modes}


def test_zstd_streaming_frames_without_a_size_and_with_checksums():
    data = _data("weights", MiB) + _data("text", MiB)
    for checksum in (False, True):
        comp = zstandard.ZstdCompressor(level=3, write_checksum=checksum)
        obj = comp.compressobj()
        frame = b"".join(obj.compress(data[i:i + 100_000])
                         for i in range(0, len(data), 100_000)) + obj.flush()
        assert not frame[4] & 0xC0 and bool(frame[4] & 4) == checksum
        with pytest.raises(zstandard.ZstdError):  # one-shot needs the size
            zstandard.ZstdDecompressor().decompress(frame)
        assert zstd.decompress(frame) == data
    for size_flag in (False, True):
        frame = zstandard.ZstdCompressor(
            level=1, write_content_size=size_flag,
            write_checksum=True).compress(data)
        assert zstd.decompress(frame) == data


def test_zstd_concatenated_and_skippable_frames():
    parts = [_data("text", 300_000, 1), b"", _data("weights", 400_000, 2),
             b"x" * 1000]
    frames = [zstandard.ZstdCompressor(level=lv).compress(p)
              for lv, p in zip((1, 3, 19, -3), parts)]
    skippable = (0x184D2A5A).to_bytes(4, "little") + (7).to_bytes(
        4, "little") + b"ignored"
    blob = frames[0] + skippable + frames[1] + frames[2] + skippable \
        + frames[3]
    assert zstd.decompress(blob) == b"".join(parts)
    assert zstd.decompress(skippable + frames[0]) == parts[0]


@settings(max_examples=60, deadline=None)
@given(pieces=st.lists(st.tuples(st.binary(min_size=1, max_size=40),
                                 st.integers(1, 30)), max_size=40),
       noise=st.binary(max_size=3000), level=st.integers(-5, 19),
       checksum=st.booleans())
def test_zstd_random_inputs(pieces, noise, level, checksum):
    data = b"".join(p * r for p, r in pieces) + noise
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


def _repeat_offset_frame(prefix, literal_length, of_code, of_bits):
    """A frame made by hand: ``prefix`` as a raw block, then a compressed
    block of one sequence per entry of ``of_bits`` (the offset code's extra
    bits), each taking ``literal_length`` raw literals (LL codes 0-15 are
    the length itself) and a 3-byte match. The three tables are RLE mode,
    so the states take no bits and each sequence reads only its offset
    bits: Offset_Value (1 << of_code) + bits, 1-3 naming a repeat offset
    (with a literal length of 0, 3 is repeat offset 1 minus one)."""
    n = len(of_bits)
    literals = bytes(range(65, 65 + literal_length * n))
    acc = 1  # the padding marker; the first bits read sit just below it
    for bits in of_bits:
        acc = (acc << of_code) | bits
    stream = acc.to_bytes((acc.bit_length() + 7) // 8, "little")
    # raw literals (a 1-byte header: fewer than 32), the sequence count,
    # the modes (LL, OF, ML all RLE: 0x54) and the three RLE symbols
    body = bytes([len(literals) << 3]) + literals + bytes(
        [n, 0x54, literal_length, of_code, 0]) + stream
    raw = (len(prefix) << 3).to_bytes(3, "little") + prefix
    last = ((len(body) << 3) | 4 | 1).to_bytes(3, "little") + body
    return b"\x28\xb5\x2f\xfd\x00\x58" + raw + last


@pytest.mark.parametrize("literal_length,of_code,of_bits", [
    (0, 1, [0, 1, 1]),  # repeat offsets 3, then 1 minus one, twice
    (0, 0, [0, 0, 0]),  # repeat offset 2 (a swap) with no literals
    (2, 1, [1, 0, 1]),  # repeat offsets 3 and 2 after literals
    (1, 0, [0, 0]),  # repeat offset 1 after literals
    (0, 3, [5, 2]),  # new offsets 10 and 7
])
def test_zstd_repeat_offsets(literal_length, of_code, of_bits):
    frame = _repeat_offset_frame(b"0123456789abcdefghij", literal_length,
                                 of_code, of_bits)
    want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
    assert len(want) == 20 + len(of_bits) * (literal_length + 3)
    assert zstd.decompress(frame) == want


def test_zstd_refuses_a_bad_checksum_a_dictionary_and_garbage():
    data = _data("text", 50_000)
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(data))
    frame[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    samples = [_data("text", 400, seed) for seed in range(300)]
    dictionary = zstandard.train_dictionary(4096, samples)
    named = zstandard.ZstdCompressor(dict_data=dictionary).compress(data)
    with pytest.raises(zstd.ZstdError, match="dictionar"):
        zstd.decompress(named)
    for bad in (b"", b"\x28\xb5\x2f", b"not a zstd frame", bytes(frame[:-9])):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bad)


def test_a_missing_gxx_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    with pytest.raises(native.NativeUnavailable, match="g\\+\\+ not found"):
        zstd.decompress(zstandard.ZstdCompressor().compress(b"abc"))
    fixture_dir = os.path.join(fixture.CHECKPOINT, str(fixture.STEP))
    with pytest.raises(native.NativeUnavailable):
        orbax.read_pytree(fixture_dir)
    assert not os.path.exists(tmp_path / "_build") or not any(
        p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


# ----------------------------------------------------------------- OCDBT

def _jax_save(path, state, use_ocdbt=True):
    if use_ocdbt:
        return jax_checkpoints.save_orbax(str(path), state)
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=False)
    target = os.path.join(str(path), str(int(state.step)))
    with ocp.Checkpointer(handler) as ckptr:
        ckptr.save(target, state)
    return target


def _tensorstore_kv(directory):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": f"file://{directory}/"}).result()


def _tensorstore_db(directory, compression, max_node_bytes, commits):
    """An OCDBT store of ``commits`` transactions of 12 keys each, values
    inline and not (16 vs 40 bytes), with nodes of at most
    ``max_node_bytes`` so the B-tree grows several levels."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{directory}/",
                          "config": {"max_decoded_node_bytes": max_node_bytes,
                                     "max_inline_value_bytes": 16,
                                     "compression": compression}}).result()
    rng = np.random.default_rng(len(str(compression)))
    for c in range(commits):
        with ts.Transaction() as txn:
            for j in range(12):
                size = int(rng.choice([3, 40]))
                kv.with_transaction(txn)[f"k{c:02d}/{j:03d}".encode()] = \
                    rng.integers(0, 256, size, np.uint8).tobytes()


@pytest.mark.parametrize("store", ["orbax", "deep_zstd", "deep_raw"])
def test_ocdbt_reader_matches_tensorstore(store, tmp_path):
    if store == "orbax":
        state = fixture.jax_state(fixture.numpy_tree(3), 4)
        directory = _jax_save(tmp_path / "ck", state)
    else:
        directory = str(tmp_path / store)
        _tensorstore_db(directory, {"id": "zstd", "level": 5}
                        if store == "deep_zstd" else None, 300, 20)
    kv = _tensorstore_kv(directory)
    keys = [k.decode() for k in kv.list().result()]
    reader = ocdbt.OcdbtReader(directory)
    assert reader.list() == sorted(keys) and len(keys) > 20
    for key in keys:
        assert reader.read(key) == kv.read(key.encode()).result().value, key
    if store != "orbax":  # the newest root lies several levels up
        manifest = ts.ocdbt.dump(ts.KvStore.open(
            f"file://{directory}/").result()).result()
        assert manifest["versions"][-1]["root_height"] >= 2
        assert manifest["version_tree_nodes"]  # older versions left out


def test_ocdbt_refuses_a_bad_file_by_name(tmp_path):
    directory = str(tmp_path / "db")
    _tensorstore_db(directory, {"id": "zstd"}, 1000, 1)
    manifest = os.path.join(directory, "manifest.ocdbt")
    good = open(manifest, "rb").read()
    for offset, match in ((0, "magic"), (13, "compression"),
                          (len(good) - 1, "crc32c"), (12, "version")):
        bad = bytearray(good)
        bad[offset] ^= 0x7F if offset != 13 else 0x05
        if offset in (12, 13):  # fix the checksum to reach the field
            bad[-4:] = ocdbt.crc32c(bytes(bad[:-4])).to_bytes(4, "little")
        open(manifest, "wb").write(bytes(bad))
        with pytest.raises(ocdbt.OcdbtError, match=match) as e:
            ocdbt.OcdbtReader(directory)
        assert "manifest.ocdbt" in str(e.value)
    assert ocdbt.crc32c(b"123456789") == 0xE3069283  # the check value


# ------------------------------------------------- restore and save, JAX

def _port_template(tree):
    return trainer.init_state(weights.params_from_jax(tree, "cpu"),
                              trainer.make_optimizer(fixture.LR_VALUES,
                                                     fixture.LR_STEPS))


def _port_state_as_jax(state):
    """{'/' path: array} of a port TrainState in the JAX layout (the keys
    of ``fixture.flat_leaves``)."""
    def flat(prefix, tree):
        return {f"{prefix}/{k}": v for k, v in
                weights.tree_to_flat(weights.params_to_jax(tree)).items()}

    leaves = trainer.tree_leaves(state.params)
    slots = [state.opt_state.state[p] for p in leaves]
    out = flat("params", state.params)
    for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        out.update(flat(f"opt_state/0/{name}", trainer.tree_unflatten(
            state.params, [s[key] for s in slots])))
    counts = {float(s["step"]) for s in slots}
    assert len(counts) == 1
    out["opt_state/0/count"] = out["opt_state/1/count"] = np.asarray(
        counts.pop(), np.int32)
    out["step"] = np.asarray(state.step, np.int32)
    return out


def _assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _full_posenet(packed):
    tree = {posenet.SCOPE: posenet.init(np.random.default_rng(5))}
    if packed:
        return jax.tree_util.tree_map(np.asarray, jax_phase_pack(tree)), \
            phase_pack_params(weights.params_from_jax(tree, "cpu"))
    return tree, weights.params_from_jax(tree, "cpu")


@pytest.mark.parametrize("packed", [False, True],
                         ids=["plain", "phase_packed"])
def test_jax_checkpoint_restores_in_the_port(packed, tmp_path):
    """Full-width PoseNet2D, OCDBT and zstd as the JAX package writes it."""
    tree, port_params = _full_posenet(packed)
    if packed:
        assert "weights_p2" in tree[posenet.SCOPE]["conv1_2"]
    state = fixture.jax_state(tree, 6)
    path = _jax_save(tmp_path / "ck", state)
    assert os.path.exists(os.path.join(path, "manifest.ocdbt"))
    template = trainer.init_state(port_params, trainer.make_optimizer(
        fixture.LR_VALUES, fixture.LR_STEPS))
    restored = checkpoints.restore_orbax(path, template)
    assert restored.step == 2 and restored.params is template.params
    _assert_leaves_equal(_port_state_as_jax(restored),
                         fixture.flat_leaves(state))


def test_jax_checkpoint_without_ocdbt_restores_in_the_port(tmp_path):
    tree = fixture.numpy_tree(7)
    state = fixture.jax_state(tree, 8)
    path = _jax_save(tmp_path / "ck", state, use_ocdbt=False)
    assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    restored = checkpoints.restore_orbax(path, _port_template(tree))
    _assert_leaves_equal(_port_state_as_jax(restored),
                         fixture.flat_leaves(state))


def test_a_chunked_jax_checkpoint_restores_in_the_port(tmp_path):
    """Arrays split over many zarr chunks (as a sharded save or a chunk size
    limit writes them), and chunks cut at an array's edge, which zarr
    stores padded to the whole chunk."""
    tree = fixture.numpy_tree(15)
    state = fixture.jax_state(tree, 16)
    save_args = jax.tree_util.tree_map(
        lambda _: ocp.SaveArgs(chunk_byte_size=8192), state)
    path = os.path.join(str(tmp_path), "2")
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, state, save_args=save_args)
    reader = ocdbt.OcdbtReader(path)
    assert len([k for k in reader.list() if k.startswith(
        "params.PoseNet2D.conv1_2.weights/0.")]) > 1
    restored = checkpoints.restore_orbax(path, _port_template(tree))
    _assert_leaves_equal(_port_state_as_jax(restored),
                         fixture.flat_leaves(state))
    # a 5x7 array in 2x3 chunks: the last row and column of chunks padded
    edge = str(tmp_path / "edge")
    want = np.arange(35, dtype=np.float32).reshape(5, 7)
    orbax.write_pytree(edge, {("a",): want})
    folder = os.path.join(edge, "a")
    for name in os.listdir(folder):
        os.remove(os.path.join(folder, name))
    with open(os.path.join(folder, ".zarray"), "w") as f:
        json.dump({"chunks": [2, 3], "compressor": {"id": "zstd"},
                   "dimension_separator": ".", "dtype": "<f4",
                   "fill_value": None, "filters": None, "order": "C",
                   "shape": [5, 7], "zarr_format": 2}, f)
    for i in range(3):
        for j in range(3):
            chunk = np.full((2, 3), -1, np.float32)
            part = want[2 * i:2 * i + 2, 3 * j:3 * j + 3]
            chunk[:part.shape[0], :part.shape[1]] = part
            with open(os.path.join(folder, f"{i}.{j}"), "wb") as f:
                f.write(zstandard.ZstdCompressor().compress(chunk.tobytes()))
    np.testing.assert_array_equal(orbax.read_pytree(edge)[("a",)], want)


def _port_state(tree, seed, steps=fixture.STEP):
    """A port TrainState after ``steps`` Adam updates of seeded
    gradients."""
    state = _port_template(tree)
    opt = trainer.make_optimizer(fixture.LR_VALUES, fixture.LR_STEPS)
    gen = torch.Generator().manual_seed(seed)
    for step in range(steps):
        grads = [torch.randn(p.shape, generator=gen) * 1e-2
                 for p in trainer.tree_leaves(state.params)]
        opt.apply(state.opt_state, state.params, grads, step)
    return trainer.TrainState(state.params, state.opt_state, steps)


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree, port_params = _full_posenet(False)
    state = _port_state(tree, 9)
    path = checkpoints.save_orbax(str(tmp_path / "ck"), state)
    assert path == os.path.join(str(tmp_path / "ck"), "2")
    assert sorted(os.listdir(path))[0] == "_METADATA"
    assert not any(n.endswith(".orbax-checkpoint-tmp") or "-tmp-" in n
                   for n in os.listdir(tmp_path / "ck"))
    template = jax_trainer.init_state(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jax_trainer.make_optimizer(fixture.LR_VALUES, fixture.LR_STEPS))
    back = jax_checkpoints.restore_orbax(path, template)
    _assert_leaves_equal(fixture.flat_leaves(back), _port_state_as_jax(state))
    # the port reads its own checkpoint back too
    again = checkpoints.restore_orbax(path, _port_template(tree))
    _assert_leaves_equal(_port_state_as_jax(again), _port_state_as_jax(state))
    with pytest.raises(FileExistsError):
        checkpoints.save_orbax(str(tmp_path / "ck"), state)


def test_a_fresh_state_round_trips_at_step_0(tmp_path):
    tree = fixture.numpy_tree(10)
    fresh = _port_template(tree)
    path = checkpoints.save_orbax(str(tmp_path / "ck"), fresh)
    leaves = orbax.read_pytree(path)
    assert int(leaves[("opt_state", 0, "count")]) == 0
    assert not leaves[("opt_state", 0, "mu", "PoseNet2D", "conv1_2",
                       "weights")].any()
    state = fixture.jax_state(tree, 0)  # a fresh JAX state: count 0
    jax_fresh = jax_trainer.init_state(state.params, jax_trainer.
                                       make_optimizer([1e-4], []))
    path = _jax_save(tmp_path / "jx", jax_fresh)
    restored = checkpoints.restore_orbax(path, _port_template(tree))
    assert restored.step == 0
    got = _port_state_as_jax(restored)
    assert int(got["opt_state/0/count"]) == 0
    assert not any(v.any() for k, v in got.items() if "/mu/" in k
                   or "/nu/" in k)


# ------------------------------------------------------ port -> port

CFG = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                       coord_uv_noise=True, crop_center_noise=True,
                       crop_size=32)
FUSED = trainer.fuse_preprocess(train_posenet.loss_fn, preprocess_rhd, CFG)


def _fit(data, max_iter, snapshot_dir, resume=False):
    pipeline = InputPipeline(RHDDataset("training", data), CFG, 2, seed=4,
                             yield_raw=True, device="cpu")
    params = weights.params_from_jax(
        {posenet.SCOPE: posenet.init(np.random.default_rng(4))}, "cpu")
    return fit(FUSED, params, trainer.make_optimizer([1e-4, 1e-5], [2]),
               pipeline, max_iter, seed=4, snapshot_dir=snapshot_dir,
               snapshot_freq=0, show_loss_freq=0, log=lambda *a: None,
               resume=resume)


def test_port_resume_from_orbax_equals_the_straight_run(tmp_path_factory,
                                                        tmp_path):
    """Two steps, save_orbax, restore into a fresh template, one more step
    (across the LR boundary): the uninterrupted run's state bit for bit."""
    with module_dir(tmp_path_factory, "orbax_data") as d:
        data = str(make_rhd_bin(d / "t.bin", num_records=8, seed=9))
        straight = _fit(data, 3, str(tmp_path / "a"))
        first = _fit(data, 2, str(tmp_path / "b"))
        path = checkpoints.save_orbax(str(tmp_path / "orbax"), first)
        template = trainer.init_state(
            weights.params_from_jax({posenet.SCOPE: posenet.init(
                np.random.default_rng(11))}, "cpu"),
            trainer.make_optimizer([1e-4, 1e-5], [2]))
        restored = checkpoints.restore_orbax(path, template)
        snaps = str(tmp_path / "c")
        checkpoints.save_snapshot(snaps, restored)
        resumed = _fit(data, 3, snaps, resume=True)
    assert resumed.step == straight.step == 3
    for x, y in zip(trainer.tree_leaves(resumed.params),
                    trainer.tree_leaves(straight.params)):
        assert torch.equal(x, y)
    sa, sb = resumed.opt_state.state_dict(), straight.opt_state.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, slot in sa["state"].items():
        for k, v in slot.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


# ------------------------------------------------------------- refusals

def test_restore_refuses_another_tree_shape_or_dtype(tmp_path):
    tree = fixture.numpy_tree(12)
    path = checkpoints.save_orbax(str(tmp_path / "ck"), _port_state(tree, 1))
    fewer = {k: v for k, v in tree.items() if k != "PosePrior"}
    with pytest.raises(ValueError, match="tree differs") as e:
        checkpoints.restore_orbax(path, _port_template(fewer))
    assert "PosePrior/fc_xyz" in str(e.value)
    wider = fixture.numpy_tree(12)
    wider["PosePrior"]["fc_xyz"]["weights"] = np.zeros((512, 64), np.float32)
    with pytest.raises(ValueError, match="params/PosePrior/fc_xyz/weights"):
        checkpoints.restore_orbax(path, _port_template(wider))
    leaves = orbax.read_pytree(path)
    key = ("opt_state", 0, "nu", "PoseNet2D", "conv1_1", "weights")
    leaves[key] = leaves[key].astype(np.float64)
    orbax.write_pytree(str(tmp_path / "f64"), leaves)
    with pytest.raises(ValueError, match="nu/PoseNet2D/conv1_1/weights is "
                       "float64"):
        checkpoints.restore_orbax(str(tmp_path / "f64"), _port_template(tree))
    # a JAX tree that is not a TrainState of Adam on a schedule
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "other"), {"params": tree})
    with pytest.raises(ValueError, match="not a TrainState"):
        checkpoints.restore_orbax(str(tmp_path / "other"),
                                  _port_template(tree))
    with pytest.raises(orbax.OrbaxError, match="_METADATA"):
        checkpoints.restore_orbax(str(tmp_path), _port_template(tree))


def test_save_refuses_a_sharded_state_and_differing_counts(tmp_path):
    tree = fixture.numpy_tree(13)
    state = _port_state(tree, 2)
    layer = state.params["PoseNet2D"]["conv1_2"]
    layer[mesh_lib.SHARD_KEY] = mesh_lib.ModelShard(None, 2, 0, 64,
                                                    (("weights", 0),))
    with pytest.raises(ValueError, match="gather_state"):
        checkpoints.save_orbax(str(tmp_path / "ck"), state)
    with pytest.raises(ValueError, match="gather_state"):
        checkpoints.restore_orbax(str(tmp_path / "ck"), state)
    assert not os.path.exists(tmp_path / "ck")
    del layer[mesh_lib.SHARD_KEY]
    first = trainer.tree_leaves(state.params)[0]
    state.opt_state.state[first]["step"] += 1
    with pytest.raises(ValueError, match="counts differ"):
        checkpoints.save_orbax(str(tmp_path / "ck"), state)
    assert not os.path.exists(tmp_path / "ck")


def test_a_failed_write_leaves_nothing(tmp_path, monkeypatch):
    state = _port_state(fixture.numpy_tree(14), 3)
    calls = []

    def failing(path, data):
        calls.append(path)
        if len(calls) == 5:
            raise OSError("disk full")
        with open(path, "wb") as f:
            f.write(data)

    monkeypatch.setattr(orbax, "_write", failing)
    with pytest.raises(OSError, match="disk full"):
        checkpoints.save_orbax(str(tmp_path / "ck"), state)
    assert os.listdir(tmp_path / "ck") == []


# -------------------------------------------------------------- fixture

def test_the_committed_fixture_restores_in_jax_and_in_the_port():
    path = os.path.join(fixture.CHECKPOINT, str(fixture.STEP))
    with np.load(fixture.EXPECTED) as f:
        want = {k: f[k] for k in f.files}
    tree = weights.flat_to_tree({k[len("params/"):]: v for k, v in
                                 want.items() if k.startswith("params/")})
    template = jax_trainer.init_state(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jax_trainer.make_optimizer(fixture.LR_VALUES, fixture.LR_STEPS))
    _assert_leaves_equal(fixture.flat_leaves(
        jax_checkpoints.restore_orbax(path, template)), want)
    restored = checkpoints.restore_orbax(path, _port_template(tree))
    _assert_leaves_equal(_port_state_as_jax(restored), want)
    # OCDBT and zstd, as the card must read them
    assert os.path.exists(os.path.join(path, "manifest.ocdbt"))
    reader = ocdbt.OcdbtReader(path)
    name = "params.PoseNet2D.conv1_2.weights"
    frame = reader.read(f"{name}/0.0.0.0")
    assert ("literals", 2) in census(frame)
    assert json.loads(reader.read(f"{name}/.zarray"))["compressor"] == {
        "id": "zstd", "level": 1}


def test_the_fixture_generator_is_what_the_fixture_holds():
    """The generator's state today equals the committed .npz (so the
    fixture can be rebuilt), and its checkpoint is the JAX package's."""
    state = fixture.jax_state(fixture.numpy_tree(0), 1)
    with np.load(fixture.EXPECTED) as f:
        want = {k: f[k] for k in f.files}
    _assert_leaves_equal(fixture.flat_leaves(state), want)
