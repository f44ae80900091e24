"""The Orbax PyTree checkpoint layout, read and written without orbax,
tensorstore, zarr or jax.

A checkpoint of one step is a directory:

  * ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's path (the
    ``str`` of a tuple of keys) to its ``key_metadata`` (each key with its
    ``key_type``: 2 a dict key or named-tuple field, 1 a sequence index)
    and ``value_metadata`` (``value_type``, ``write_shape``);
  * one zarr v2 array per leaf, named by the path's keys joined with ".":
    ``<name>/.zarray`` (dtype, shape, chunks, order, fill value, the "."
    chunk-key separator, a ``zstd`` compressor or none) and its chunks
    ``<name>/0.0.0.0`` (``<name>/0`` for a 0-d array).

Orbax keeps the arrays in an OCDBT store (weights/ocdbt.py) where the
directory holds ``manifest.ocdbt``, and as plain files otherwise
(``use_ocdbt=False``). :func:`read_pytree` reads both.

:func:`write_pytree` writes the plain form with uncompressed chunks, one
chunk an array, and of the metadata only ``_METADATA``: the smallest set the
JAX package's ``restore_orbax`` reads. Its leaves are typed ``np.ndarray``,
so Orbax restores them as numpy arrays without asking for a device by name
(a ``jax.Array`` leaf needs a ``_sharding`` file naming the device it was
saved from). The write is atomic: a temporary directory beside the target,
every file fsynced, then one rename, as Orbax itself commits a step.
"""

import json
import math
import os
import shutil

import numpy as np

from hand3d_tpu_torch.weights import ocdbt, zstd

METADATA = "_METADATA"
KEY_SEQUENCE, KEY_DICT = 1, 2
_VALUE_TYPES = ("jax.Array", "np.ndarray", "scalar")
_TMP_SUFFIX = ".orbax-checkpoint-tmp"


class OrbaxError(ValueError):
    """A checkpoint this reader cannot read, or a tree it cannot write."""


class _Files:
    """The keys of a checkpoint kept as plain files."""

    def __init__(self, directory):
        self.directory = directory

    def read(self, key):
        try:
            with open(os.path.join(self.directory, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None


def _store(directory):
    if os.path.exists(os.path.join(directory, "manifest.ocdbt")):
        return ocdbt.OcdbtReader(directory)
    return _Files(directory)


def leaf_paths(directory):
    """{key tuple: value_metadata} of a checkpoint's ``_METADATA``; a
    sequence index is an int, a dict key a str."""
    name = os.path.join(directory, METADATA)
    try:
        with open(name) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise OrbaxError(f"{directory}: no {METADATA}: not an Orbax "
                         "PyTree checkpoint") from None
    out = {}
    for entry in meta["tree_metadata"].values():
        keys = []
        for k in entry["key_metadata"]:
            if k["key_type"] == KEY_SEQUENCE:
                keys.append(int(k["key"]))
            elif k["key_type"] == KEY_DICT:
                keys.append(str(k["key"]))
            else:
                raise OrbaxError(f"{name}: key type {k['key_type']} of "
                                 f"{k['key']!r} is not read here")
        out[tuple(keys)] = entry["value_metadata"]
    return out


def _dtype(zarray, name):
    try:
        dtype = np.dtype(zarray["dtype"])
    except TypeError as e:
        raise OrbaxError(f"{name}: dtype {zarray['dtype']!r}: {e}") from e
    if dtype.kind not in "biuf":
        raise OrbaxError(f"{name}: dtype {dtype} is not read here")
    return dtype


def read_array(store, name):
    """The numpy array of the zarr v2 array ``name`` in ``store``: C-order
    chunks, raw or zstd-compressed, edge chunks stored whole (zarr pads
    them), every chunk present (Orbax writes even those equal to the fill
    value)."""
    zarray = json.loads(store.read(f"{name}/.zarray"))
    if zarray.get("zarr_format") != 2 or zarray.get("filters"):
        raise OrbaxError(f"{name}: zarr format {zarray.get('zarr_format')} "
                         f"with filters {zarray.get('filters')}: only zarr "
                         "v2 without filters is read here")
    dtype = _dtype(zarray, name)
    shape = tuple(zarray["shape"])
    chunks = tuple(zarray["chunks"])
    sep = zarray.get("dimension_separator", ".")
    compressor = zarray.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxError(f"{name}: compressor {compressor.get('id')!r} is "
                         "not read here")
    if len(chunks) != len(shape) or zarray.get("order", "C") != "C":
        raise OrbaxError(f"{name}: chunks {chunks} / order "
                         f"{zarray.get('order')!r} do not fit shape {shape}")
    out = np.empty(shape, dtype)
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        try:
            raw = store.read(key)
        except KeyError:
            raise OrbaxError(f"{key}: missing chunk") from None
        if compressor is not None:
            try:
                raw = zstd.decompress(raw)
            except zstd.ZstdError as e:
                raise OrbaxError(f"{key}: {e}") from e
        if len(raw) != nbytes:
            raise OrbaxError(f"{key}: {len(raw)} bytes, a chunk holds "
                             f"{nbytes}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks)
        where = tuple(slice(i * c, min((i + 1) * c, s))
                      for i, c, s in zip(index, chunks, shape))
        out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    return out


def read_pytree(directory):
    """{key tuple: numpy array} of every leaf of the checkpoint at
    ``directory`` (one step's directory)."""
    directory = os.fspath(directory)
    paths = leaf_paths(directory)
    store = _store(directory)
    out = {}
    for keys, value in paths.items():
        name = ".".join(map(str, keys))
        if value.get("skip_deserialize"):
            continue
        if value.get("value_type") not in _VALUE_TYPES:
            raise OrbaxError(f"{directory}: leaf {name} of type "
                             f"{value.get('value_type')!r} is not read here")
        try:
            out[keys] = read_array(store, name)
        except KeyError as e:
            raise OrbaxError(f"{directory}: leaf {name} has no "
                             f"{e.args[0]}") from None
    return out


def _zarray(arr):
    return {"chunks": list(arr.shape), "compressor": None,
            "dimension_separator": ".", "dtype": arr.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_pytree(directory, leaves):
    """Write ``leaves`` ({key tuple: numpy array}; an int key is a sequence
    index, a str key a dict key) as an Orbax PyTree checkpoint at
    ``directory``, which must not exist yet."""
    directory = os.path.abspath(os.fspath(directory))
    if os.path.exists(directory):
        raise FileExistsError(f"{directory} exists already")
    arrays, tree_meta = {}, {}
    for keys, value in leaves.items():
        arr = np.asarray(value)
        if arr.dtype.kind not in "biuf":
            raise OrbaxError(f"leaf {keys}: dtype {arr.dtype} is not "
                             "written here")
        name = ".".join(map(str, keys))
        if name in arrays or any(not str(k) or "." in str(k) or "/" in str(k)
                                 for k in keys):
            raise OrbaxError(f"leaf {keys}: its name {name!r} is not one "
                             "array's")
        arrays[name] = arr
        tree_meta[str(tuple(map(str, keys)))] = {
            "key_metadata": [
                {"key": str(k),
                 "key_type": KEY_SEQUENCE if isinstance(k, int)
                 else KEY_DICT} for k in keys],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    meta = {"tree_metadata": tree_meta, "use_ocdbt": False,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    parent = os.path.dirname(directory)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{directory}{_TMP_SUFFIX}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        for name, arr in arrays.items():
            folder = os.path.join(tmp, name)
            os.makedirs(folder)
            _write(os.path.join(folder, ".zarray"),
                   json.dumps(_zarray(arr)).encode())
            chunk = ".".join("0" * arr.ndim) if arr.ndim else "0"
            _write(os.path.join(folder, chunk), arr.tobytes())
            _fsync_dir(folder)
        _write(os.path.join(tmp, METADATA), json.dumps(meta).encode())
        _fsync_dir(tmp)
        os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(parent)
    return directory

