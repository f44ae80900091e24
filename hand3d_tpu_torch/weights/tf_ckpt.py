"""TensorFlow V2 checkpoints without TensorFlow: the reader, and a writer for
fixtures (counterpart of hand3d_tpu/weights/tf_ckpt.py, numpy only).

The reference warm-starts HandSegNet and PoseNet from the CPM-MPII TF
checkpoint (training_handsegnet.py:73-75, training_posenet.py:74-76). A
checkpoint is

  * ``<prefix>.index``: a LevelDB table mapping tensor names to serialized
    BundleEntryProto records (dtype, shape, shard, offset, size), plus a ""
    key holding the BundleHeaderProto;
  * ``<prefix>.data-NNNNN-of-MMMMM``: the tensors' little-endian bytes.

The reader parses the table's footer, index block and data blocks (keys
prefix-compressed between restart points), decodes the two protos by hand
and slices the tensors out of the shard files. Blocks must be uncompressed
(type 0), as TF writes bundle index tables.

bfloat16 tensors (DT_BFLOAT16 = 14) have no numpy type without ml_dtypes:
the reader widens their bits to float32 exactly (``bits << 16``), and the
writer takes the uint16 bits of the names it is told are bfloat16.
"""

import os
import struct

import numpy as np

_TABLE_MAGIC = b"\x57\xfb\x80\x8b\x24\x75\x47\xdb"  # leveldb kTableMagicNumber
_FOOTER_LEN = 48
DT_BFLOAT16 = 14

# tensorflow DataType enum -> numpy dtype (bfloat16 is handled on its own)
_DTYPES = {
    1: np.dtype(np.float32),
    2: np.dtype(np.float64),
    3: np.dtype(np.int32),
    4: np.dtype(np.uint8),
    5: np.dtype(np.int16),
    6: np.dtype(np.int8),
    9: np.dtype(np.int64),
    10: np.dtype(np.bool_),
    17: np.dtype(np.uint16),
    19: np.dtype(np.float16),
    22: np.dtype(np.uint32),
    23: np.dtype(np.uint64),
}
_TF_TYPES = {v: k for k, v in _DTYPES.items()}


def bfloat16_to_float32(bits):
    """uint16 bfloat16 bit patterns -> the float32 values they denote."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


# --- varint / protobuf primitives -------------------------------------------


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value):
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _parse_proto(buf):
    """Serialized message -> {field_number: [value, ...]} (varints as ints,
    length-delimited fields as bytes, fixed32/64 as ints)."""
    fields = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val = bytes(buf[pos:pos + n])
            pos += n
        elif wire == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def _field(key, value):
    """One protobuf field: an int as a varint, bytes length-delimited."""
    if isinstance(value, bytes):
        return _write_varint(key << 3 | 2) + _write_varint(len(value)) + value
    return _write_varint(key << 3 | 0) + _write_varint(int(value))


# --- leveldb table reading ---------------------------------------------------


def _parse_block(data):
    """One leveldb block (trailer stripped) -> [(key, value)] as bytes. Each
    entry's key shares its first ``shared`` bytes with the previous key."""
    if len(data) < 4:
        return []
    num_restarts = struct.unpack_from("<I", data, len(data) - 4)[0]
    limit = len(data) - 4 - 4 * num_restarts
    entries = []
    key = b""
    pos = 0
    while pos < limit:
        shared, pos = _read_varint(data, pos)
        non_shared, pos = _read_varint(data, pos)
        value_len, pos = _read_varint(data, pos)
        key = key[:shared] + bytes(data[pos:pos + non_shared])
        pos += non_shared
        entries.append((key, bytes(data[pos:pos + value_len])))
        pos += value_len
    return entries


def _read_block(f, offset, size):
    f.seek(offset)
    raw = f.read(size + 1)  # + the 1-byte compression type (a crc follows)
    ctype = raw[-1]
    if ctype != 0:
        raise ValueError(
            f"compressed table block (type {ctype}): TF bundle index tables "
            "are uncompressed; is this really a checkpoint .index file?")
    return _parse_block(raw[:-1])


def read_index_file(path):
    """``<prefix>.index`` -> (header fields, {name: entry fields}), raw
    protobuf field dicts (BundleHeaderProto: 1 = num_shards;
    BundleEntryProto: 1 = dtype, 2 = TensorShapeProto, 3 = shard_id,
    4 = offset, 5 = size)."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        file_len = f.tell()
        f.seek(file_len - _FOOTER_LEN)
        footer = f.read(_FOOTER_LEN)
        if footer[-8:] != _TABLE_MAGIC:
            raise ValueError(f"{path}: not a leveldb table (bad magic)")
        pos = 0
        _, pos = _read_varint(footer, pos)  # metaindex offset (unused)
        _, pos = _read_varint(footer, pos)  # metaindex size (unused)
        index_off, pos = _read_varint(footer, pos)
        index_size, pos = _read_varint(footer, pos)

        header = None
        entries = {}
        for _, handle in _read_block(f, index_off, index_size):
            off, hpos = _read_varint(handle, 0)
            size, _ = _read_varint(handle, hpos)
            for key, value in _read_block(f, off, size):
                fields = _parse_proto(value)
                if key == b"":
                    header = fields
                else:
                    entries[key.decode("utf-8")] = fields
    if header is None:
        raise ValueError(f"{path}: missing bundle header entry")
    return header, entries


def _entry_shape(entry):
    if 2 not in entry:
        return ()
    dims = _parse_proto(entry[2][0]).get(2, [])
    return tuple(_parse_proto(d).get(1, [0])[0] for d in dims)


def load_tf_checkpoint(prefix):
    """A TF V2 checkpoint as a flat {variable_name: ndarray} dict.

    ``prefix`` is the checkpoint's name as TF gives it (e.g.
    ``snapshots_posenet/model-30000``); the files are ``<prefix>.index`` and
    ``<prefix>.data-*``. bfloat16 tensors come back as float32 of the same
    values.
    """
    header, entries = read_index_file(prefix + ".index")
    num_shards = header.get(1, [1])[0]
    shards = {}

    def shard(i):
        if i not in shards:
            path = f"{prefix}.data-{i:05d}-of-{num_shards:05d}"
            shards[i] = open(path, "rb")
        return shards[i]

    try:
        out = {}
        for name, e in entries.items():
            tf_type = e.get(1, [1])[0]
            shape = _entry_shape(e)
            f = shard(e.get(3, [0])[0])
            f.seek(e.get(4, [0])[0])
            raw = f.read(e.get(5, [0])[0])
            if tf_type == DT_BFLOAT16:
                bits = np.frombuffer(raw, dtype="<u2").reshape(shape)
                out[name] = bfloat16_to_float32(bits)
            else:
                out[name] = np.frombuffer(
                    raw, dtype=_DTYPES[tf_type]).reshape(shape).copy()
        return out
    finally:
        for f in shards.values():
            f.close()


# --- fixture writer ----------------------------------------------------------


def _block_bytes(entries):
    """[(key, value)] -> leveldb block bytes with restart interval 1 (no
    prefix compression: valid, if not the most compact)."""
    out = bytearray()
    restarts = []
    for key, value in entries:
        restarts.append(len(out))
        out += (_write_varint(0) + _write_varint(len(key))
                + _write_varint(len(value)))
        out += key + value
    if not restarts:
        restarts = [0]
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def _append_block(f, block):
    """Write a block and its trailer (type 0, masked crc32c of block and
    type); return its handle."""
    offset = f.tell()
    f.write(block)
    f.write(b"\x00")
    f.write(struct.pack("<I", _masked_crc32c(block + b"\x00")))
    return _write_varint(offset) + _write_varint(len(block))


_CRC_TABLE = None


def _crc32c(data):
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        _CRC_TABLE = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            _CRC_TABLE.append(crc)
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc32c(data):
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) % (1 << 32) ^ 0xA282EAD8


def write_checkpoint(prefix, flat, bfloat16=()):
    """Write {name: ndarray} as a TF V2 checkpoint with one data shard; the
    inverse of :func:`load_tf_checkpoint`, for fixtures.

    The names in ``bfloat16`` are written as DT_BFLOAT16 from their uint16
    bit patterns.
    """
    names = sorted(flat)
    data_path = f"{prefix}.data-00000-of-00001"
    entries = []
    with open(data_path, "wb") as f:
        for name in names:
            arr = np.ascontiguousarray(flat[name])
            if name in bfloat16:
                if arr.dtype != np.uint16:
                    raise ValueError(f"{name}: bfloat16 is written from its "
                                     f"uint16 bits, not {arr.dtype}")
                tf_type = DT_BFLOAT16
            else:
                tf_type = _TF_TYPES[arr.dtype]
            offset = f.tell()
            f.write(arr.tobytes())
            shape_proto = b"".join(_field(2, _field(1, d)) for d in arr.shape)
            entry = (_field(1, tf_type) + _field(2, shape_proto)
                     + _field(4, offset) + _field(5, arr.nbytes))
            entries.append((name.encode("utf-8"), entry))

    header = _field(1, 1) + _field(2, 1)  # num_shards = 1, little endian
    with open(prefix + ".index", "wb") as f:
        data_handle = _append_block(
            f, _block_bytes([(b"", header)] + entries))
        meta_handle = _append_block(f, _block_bytes([]))
        last_key = entries[-1][0] if entries else b"\xff"
        index_handle = _append_block(
            f, _block_bytes([(last_key + b"\x00", data_handle)]))
        footer = meta_handle + index_handle
        f.write(footer + b"\x00" * (40 - len(footer)) + _TABLE_MAGIC)
    return prefix
