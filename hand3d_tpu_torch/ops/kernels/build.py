"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
nvcc compiles it in seconds. The shared library goes to
``hand3d_tpu_torch/_build/`` (git-ignored) under a name keyed by a hash of
the source and the flags, so an edited source is rebuilt at its next use. A
failed build raises; nothing falls back to the plain PyTorch twins.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
MAX_SMEM_BYTES = 232448  # shared memory one block may use on Hopper
# sm_90a: Hopper with its architecture-specific instructions. -Xptxas -v
# makes nvcc report registers and shared memory per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc():
    """Path of nvcc: on PATH, else under the CUDA home PyTorch detects."""
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME  # imports setuptools

        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def compile_kernel(name, nvcc=None):
    """Compile ``csrc/<name>.cu``; return nvcc's report (stdout + stderr).

    Writes to a temporary file and renames it, so a concurrent loader never
    sees a partial library.
    """
    out = library_path(name)
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", tmp,
             str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def load_kernel(name):
    """The ctypes library of ``csrc/<name>.cu``, built first if missing."""
    path = library_path(name)
    if not path.exists():
        compile_kernel(name)
    return ctypes.CDLL(str(path))


def check(err, lib, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.h3d_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def on_device(device):
    """A context in which ``device`` is the current CUDA device, for a
    launch; a no-op when it already is (the common case costs no switch)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_stream(device):
    """Raw handle of ``device``'s current stream, as the C entries take it."""
    return torch._C._cuda_getCurrentRawStream(device.index)
