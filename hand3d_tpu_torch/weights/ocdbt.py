"""A read-only OCDBT key-value store reader, without tensorstore.

OCDBT (tensorstore's "optionally-cooperative distributed B+tree") is the
store Orbax writes a checkpoint's arrays into. A store is a directory:

  * ``manifest.ocdbt``: the config and the newest versions of the tree;
  * ``d/<id>`` and ``ocdbt.process_<i>/d/<id>``: data files holding the
    encoded B-tree nodes and the values too large to inline in a node.

Every manifest and node is an encoded file (or a range of a data file):

    magic u32 BE | length u64 LE (of the whole encoding) | version varint
    | compression varint (0 none, 1 zstd) | body | crc32c u32 LE

The manifest's body is the config (uuid, manifest kind, inline and node
size limits, version-tree arity, node compression), then, for a manifest
of kind "single", a table of data files, the newest versions of the tree
(each a root node reference and its height) and references to version-tree
nodes of older versions, which a reader of the newest root never needs.

A B-tree node's body is its height, its table of data files and its
entries, stored column by column: the number of entries, key prefix
lengths shared with the previous key, key suffix lengths, the suffixes,
then per entry either a child reference (interior: the child's common key
prefix, data file, offset, length and statistics) or a value (leaf: inline
bytes or a data file, offset and length). A child's keys omit the prefix
its parent names.

``OcdbtReader(directory).list()`` gives the keys and ``read(key)`` a
value's bytes. What this reader cannot read (another magic, version or
compression, a bad checksum, a manifest of kind "numbered") raises
``OcdbtError`` with the file's name.
"""

import os
import struct

from hand3d_tpu_torch.weights import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
_COMPRESSION = {0: "none", 1: "zstd"}
_HEADER = struct.Struct("<Q")  # the length after the big-endian magic


class OcdbtError(ValueError):
    """A store, or a file of it, that this reader cannot read."""


def _crc32c_table():
    table = []
    for i in range(256):
        for _ in range(8):
            i = (i >> 1) ^ 0x82F63B78 if i & 1 else i >> 1
        table.append(i)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data):
    """CRC-32C (Castagnoli) of ``data``, as OCDBT checksums its files."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads the fields of a decoded body, raising OcdbtError on a short
    body."""

    def __init__(self, buf, name):
        self.buf = buf
        self.pos = 0
        self.name = name

    def fail(self, what):
        raise OcdbtError(f"{self.name}: {what}")

    def take(self, n):
        if self.pos + n > len(self.buf):
            self.fail("truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self):
        return self.take(1)[0]

    def varint(self):
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n):
        return [self.varint() for _ in range(n)]


def decode_file(data, magic, name):
    """The body of one encoded manifest or node: header and checksum
    checked, decompressed where it is compressed."""
    data = bytes(data)
    if len(data) < 18:
        raise OcdbtError(f"{name}: {len(data)} bytes, too short for an "
                         "OCDBT file")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise OcdbtError(f"{name}: magic 0x{got:08x}, expected "
                         f"0x{magic:08x}")
    length = _HEADER.unpack(data[4:12])[0]
    if length != len(data):
        raise OcdbtError(f"{name}: header says {length} bytes, the file "
                         f"has {len(data)}")
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise OcdbtError(f"{name}: crc32c mismatch")
    cur = _Cursor(data[:-4], name)
    cur.pos = 12
    version = cur.varint()
    if version != FORMAT_VERSION:
        raise OcdbtError(f"{name}: format version {version}, this reader "
                         f"reads {FORMAT_VERSION}")
    compression = cur.varint()
    if compression not in _COMPRESSION:
        raise OcdbtError(f"{name}: unknown compression {compression}")
    body = data[cur.pos:-4]
    if compression == 1:
        try:
            body = zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{name}: {e}") from e
    return body


def _data_file_table(cur):
    """[path relative to the store's root] of a manifest's or node's data
    file table (each path is its base path and relative path joined)."""
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    cur.varints(n)  # the base path's share of each path
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            cur.fail("data file path prefix longer than the previous path")
        path = prev[:prefix[i]] + cur.take(suffix[i])
        out.append(path.decode())
        prev = path
    return out


def _keys(cur, n):
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    return prefix, suffix


def _join_keys(cur, prefix, suffix):
    out, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            cur.fail("key prefix longer than the previous key")
        key = prev[:p] + cur.take(s)
        out.append(key)
        prev = key
    return out


class OcdbtReader:
    """The keys and values of the newest version of an OCDBT store at
    ``directory`` (a checkpoint's directory, which holds manifest.ocdbt)."""

    def __init__(self, directory):
        self.directory = os.fspath(directory)
        name = os.path.join(self.directory, "manifest.ocdbt")
        with open(name, "rb") as f:
            cur = _Cursor(decode_file(f.read(), MANIFEST_MAGIC, name), name)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            cur.fail(f"manifest kind {kind} (numbered manifests) is not "
                     "read here")
        cur.varint()  # max_inline_value_bytes
        cur.varint()  # max_decoded_node_bytes
        cur.byte()  # version_tree_arity_log2
        compression = cur.varint()
        if compression not in _COMPRESSION:
            cur.fail(f"unknown node compression {compression}")
        if compression == 1:
            cur.take(4)  # zstd level, int32 LE
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            self._root = None  # an empty store
        else:
            generation = cur.varints(n)
            height = [cur.byte() for _ in range(n)]
            file_id = cur.varints(n)
            offset = cur.varints(n)
            length = cur.varints(n)
            newest = max(range(n), key=generation.__getitem__)
            if file_id[newest] >= len(files):
                cur.fail("root node names a data file out of the table")
            self._root = (files[file_id[newest]], offset[newest],
                          length[newest], height[newest])
        self._index = None

    def _read_range(self, path, offset, length):
        name = os.path.join(self.directory, path)
        try:
            with open(name, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except FileNotFoundError as e:
            raise OcdbtError(f"{name}: missing data file") from e
        if len(data) != length:
            raise OcdbtError(f"{name}: {length} bytes at {offset} run past "
                             "its end")
        return data

    def _node(self, ref, prefix, height, index):
        path, offset, length = ref
        name = f"{os.path.join(self.directory, path)}@{offset}+{length}"
        cur = _Cursor(decode_file(self._read_range(path, offset, length),
                                  BTREE_NODE_MAGIC, name), name)
        if cur.byte() != height:
            cur.fail(f"node height differs from its parent's {height}")
        files = _data_file_table(cur)

        def file_of(i):
            if i >= len(files):
                cur.fail("entry names a data file out of the table")
            return files[i]

        n = cur.varint()
        key_prefix, key_suffix = _keys(cur, n)
        if height == 0:
            keys = _join_keys(cur, key_prefix, key_suffix)
            lengths = cur.varints(n)
            kinds = [cur.byte() for _ in range(n)]
            if any(k > 1 for k in kinds):
                cur.fail("unknown value kind")
            indirect = sum(kinds)
            ids = cur.varints(indirect)
            offsets = cur.varints(indirect)
            j = 0
            for key, size, kind in zip(keys, lengths, kinds):
                full = (prefix + key).decode()
                if kind == 0:
                    index[full] = cur.take(size)
                else:
                    index[full] = (file_of(ids[j]), offsets[j], size)
                    j += 1
            if cur.pos != len(cur.buf):
                cur.fail("bytes after the last entry")
            return
        common = cur.varints(n)
        keys = _join_keys(cur, key_prefix, key_suffix)
        ids = cur.varints(n)
        offsets = cur.varints(n)
        lengths = cur.varints(n)
        for _ in range(3):  # statistics: keys, tree bytes, value bytes
            cur.varints(n)
        if cur.pos != len(cur.buf):
            cur.fail("bytes after the last entry")
        for key, c, i, off, size in zip(keys, common, ids, offsets, lengths):
            if c > len(key):
                cur.fail("subtree prefix longer than its key")
            self._node((file_of(i), off, size), prefix + key[:c], height - 1,
                       index)

    def _entries(self):
        if self._index is None:
            index = {}
            if self._root is not None:
                path, offset, length, height = self._root
                self._node((path, offset, length), b"", height, index)
            self._index = index
        return self._index

    def list(self):
        """Every key of the store, sorted."""
        return sorted(self._entries())

    def read(self, key):
        """The value of ``key``, as bytes; KeyError where it is absent."""
        value = self._entries()[key]
        if isinstance(value, tuple):
            return self._read_range(*value)
        return value
