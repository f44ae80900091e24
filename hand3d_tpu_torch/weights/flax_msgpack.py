"""The JAX package's training snapshots (``snapshot-<step>.msgpack``), read
without msgpack or flax.

``flax.serialization.to_bytes`` writes a TrainState as one msgpack value: a
map of maps whose leaves are arrays, numbers, strings, nil and bools. Two
msgpack extension types carry numpy values:

  * ext 1, an ndarray: a msgpack array (shape, dtype name, C-order bytes);
  * ext 3, a numpy scalar: the same encoding of a 0-d array.

(ext 2 is a Python complex, (real, imag).) This module decodes that subset
by hand, as tf_ckpt.py decodes protobuf. An array over 1 GiB is written by
flax in a chunked form (a map with ``__msgpack_chunked_array__``), which this
reader refuses. bfloat16 arrays come back as float32 of the same values.
"""

import struct

import numpy as np

from hand3d_tpu_torch.weights.tf_ckpt import bfloat16_to_float32

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width msgpack types: first byte -> (struct format, size)
_FIXED = {
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt, n):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, n):
        return self.unpack(_LENGTH[n], n)

    def value(self):
        """The next msgpack value."""
        b = self.unpack(">B", 1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
            return bytes(self.take(self.length(1 << (b - 0xc4))))
        if b in (0xc7, 0xc8, 0xc9):  # ext 8/16/32
            n = self.length(1 << (b - 0xc7))
            return self.ext(self.unpack(">b", 1), n)
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if 0xd4 <= b <= 0xd8:  # fixext 1/2/4/8/16
            code = self.unpack(">b", 1)
            return self.ext(code, 1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):  # str 8/16/32
            return self.str(self.length(1 << (b - 0xd9)))
        if b in (0xdc, 0xdd):  # array 16/32
            return self.array(self.length(2 << (b - 0xdc)))
        if b in (0xde, 0xdf):  # map 16/32
            return self.map(self.length(2 << (b - 0xde)))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError(
                f"flax's chunked-array form ({_CHUNKED}, an array over 1 GiB) "
                "is not read by the port")
        return out

    def ext(self, code, n):
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(data):
    """flax's ndarray payload: (shape, dtype name, C-order bytes)."""
    shape, name, buf = _Reader(data).value()
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").reshape(shape)
        return bfloat16_to_float32(bits)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def msgpack_restore(data):
    """Decode one msgpack value of flax's subset (the counterpart of
    ``flax.serialization.msgpack_restore``)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         "msgpack value")
    return out


def load_snapshot_params(path):
    """The params of a JAX ``snapshot-<step>.msgpack`` as a TF-layout numpy
    tree, optimizer state and step left out (the reference's
    load_weights_from_snapshot semantics, utils/general.py:614-651)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: not a training snapshot (no 'params')")
    return tree["params"]
