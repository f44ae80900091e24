"""ctypes bindings of the C++ record streamer, native/recordio.cpp (the
port's own copy of hand3d_tpu/data/native.py: ctypes and numpy only).

The library is built with g++ on first use into ``hand3d_tpu_torch/_build/``
(never next to the source), compiled to a temporary name and renamed into
place, so concurrent builds never hand a half-written file to dlopen. Where
it cannot be built or opened, ``NativeUnavailable`` is raised: the caller
asked for the streamer and nothing falls back silently.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "recordio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    """A host library of the port (the record streamer, the zstd decoder)
    cannot be built or opened."""


def keyed_library_path(source, stem, build_dir):
    """Where the g++ build of ``source`` lives in ``build_dir``: keyed by
    the source's hash, so an edited source builds anew."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_dir, f"lib{stem}-{digest}.so")


def library_path():
    """Where the library of the current source is built."""
    return keyed_library_path(SOURCE, "recordio", BUILD_DIR)


def build_host_library(source, lib, libs=()):
    """Compile ``source`` with ``g++ -O3`` into ``lib``: to a temporary name
    first, then renamed into place. Raises ``NativeUnavailable`` where g++
    is missing or fails."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", source, "-o", tmp,
           *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeUnavailable(f"g++ not found: {e}") from e
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise NativeUnavailable(f"g++ build failed:\n{proc.stderr}")
    os.replace(tmp, lib)


def load_library():
    """The streamer's ctypes library, built first where needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(SOURCE):
            raise NativeUnavailable(f"missing source: {SOURCE}")
        path = library_path()
        if not os.path.exists(path):
            build_host_library(SOURCE, path, ("-lpthread",))
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeUnavailable(f"cannot open {path}: {e}") from e
        lib.rr_open.restype = ctypes.c_void_p
        lib.rr_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.rr_num_records.restype = ctypes.c_int64
        lib.rr_num_records.argtypes = [ctypes.c_void_p]
        lib.rr_reset.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.rr_next.restype = ctypes.c_int64
        lib.rr_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int64)]
        lib.rr_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeRecordReader:
    """Shuffled record batches assembled by C++ threads (pread, shuffle and
    batch assembly off the Python thread).

    Args mirror the pipeline: record_dtype (the numpy structured dtype of a
    record), batch_size, shuffle, seed, drop_remainder; num_threads and
    queue_capacity size the streamer.
    """

    def __init__(self, path, record_dtype, batch_size, shuffle=True, seed=0,
                 drop_remainder=True, num_threads=2, queue_capacity=4):
        self._lib = load_library()
        self.dtype = record_dtype
        self.batch_size = batch_size
        self._handle = self._lib.rr_open(
            str(path).encode(), record_dtype.itemsize, batch_size,
            int(shuffle), seed, int(drop_remainder), num_threads,
            queue_capacity)
        if not self._handle:
            raise NativeUnavailable(f"rr_open failed for {path}")
        self.num_records = self._lib.rr_num_records(self._handle)
        self._buf = np.empty(batch_size, dtype=record_dtype)
        self._idx = np.empty(batch_size, dtype=np.int64)

    def reset(self, epochs=-1):
        """Arm the producers for ``epochs`` passes (-1: without end)."""
        self._lib.rr_reset(self._handle, epochs)

    def next_batch(self):
        """(records, indices) copies, or None when drained. Batches come in
        the order their indices were claimed: the same seed gives the same
        stream whatever the threads' timing."""
        n = self._lib.rr_next(
            self._handle, self._buf.ctypes.data_as(ctypes.c_char_p),
            self._idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if n < 0:
            raise IOError("native record streamer hit a short read "
                          "(truncated or concurrently modified file?)")
        if n == 0:
            return None
        return self._buf[:n].copy(), self._idx[:n].copy()

    def close(self):
        if self._handle:
            self._lib.rr_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
