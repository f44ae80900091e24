"""Zstandard decompression without the zstandard package: ctypes bindings of
the port's own frame decoder, csrc/zstd_decode.cpp (RFC 8878).

Orbax checkpoints hold every array chunk as zstd frames (weights/orbax.py),
and the OCDBT store that holds them compresses its manifests and B-tree
nodes with zstd too (weights/ocdbt.py). Real weights make every block
Huffman-coded, one symbol at a time, which is why the decoder is C++.

The library is built with g++ at first use into ``hand3d_tpu_torch/_build/``
(keyed by the source's hash, written to a temporary name and renamed into
place: ``data/native.py``'s rules). Where it cannot be built or opened,
``NativeUnavailable`` is raised; nothing gives way to a slower decoder.
"""

import ctypes
import os
import threading

from hand3d_tpu_torch.data.native import (NativeUnavailable,
                                          build_host_library,
                                          keyed_library_path)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "zstd_decode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_ERR_BYTES = 512

_lock = threading.Lock()
_lib = None


class ZstdError(ValueError):
    """Input that is not a well-formed zstd stream (a bad checksum, a frame
    that names a dictionary, corrupt or truncated data)."""


def load_library():
    """The decoder's ctypes library, built first where needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(SOURCE):
            raise NativeUnavailable(f"missing source: {SOURCE}")
        path = keyed_library_path(SOURCE, "zstd_decode", BUILD_DIR)
        if not os.path.exists(path):
            build_host_library(SOURCE, path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeUnavailable(f"cannot open {path}: {e}") from e
        lib.zd_decompress.restype = ctypes.c_void_p
        lib.zd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.c_size_t]
        lib.zd_data.restype = ctypes.c_void_p
        lib.zd_data.argtypes = [ctypes.c_void_p]
        lib.zd_size.restype = ctypes.c_size_t
        lib.zd_size.argtypes = [ctypes.c_void_p]
        lib.zd_free.restype = None
        lib.zd_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def decompress(data):
    """The bytes of every zstd frame in ``data`` (bytes-like), in order;
    skippable frames are skipped. The frames need not state their size."""
    lib = load_library()
    src = bytes(data)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    handle = lib.zd_decompress(src, len(src), err, _ERR_BYTES)
    if not handle:
        raise ZstdError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(lib.zd_data(handle), lib.zd_size(handle))
    finally:
        lib.zd_free(handle)

