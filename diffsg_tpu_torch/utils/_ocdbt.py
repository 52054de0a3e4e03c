"""A read-only OCDBT key-value store: every key and value of a checkpoint
directory that orbax wrote with ``use_ocdbt=True``.

OCDBT is tensorstore's B+tree store. The directory's ``manifest.ocdbt``
holds the store's configuration, a table of data files and the latest
versions; each version names the root node of a B+tree. Nodes and the
manifest share one framing: a magic number (``0x0cdb3a2a`` for a manifest,
``0x0cdb20de`` for a node, big-endian), the whole length (``uint64le``), a
format version and a compression byte (0 none, 1 zstd) as varints, the body,
and a CRC-32C of all that precedes it (``uint32le``). Bodies store their
lists column by column: all the first fields, then all the second ones.

* A data-file table lists paths as (base path, relative path) with each
  path prefix-compressed against the one before. A node's base paths are
  relative to the base path of the file that holds it, so orbax merges the
  per-process store under ``ocdbt.process_0/`` into the root by pointing
  at its files.
* A leaf (height 0) holds prefix-compressed keys and their values, inline
  or indirect (data file, offset; the length is the value's).
* An interior node holds, per child, the child's first key, how much of it
  is the prefix shared by the whole subtree (the child's keys are stored
  without it), and the child's location and statistics.

Nothing here imports orbax or tensorstore; a wrong checksum, magic, length
or height raises :class:`OcdbtError`.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Tuple

from ._zstd import decompress

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1  # the offset of an empty tree's root


class OcdbtError(ValueError):
    """A store that is corrupt or uses a feature this reader refuses."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT checksums its manifests and nodes."""
    c, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        value, shift, data = 0, 0, self.data
        while True:
            if self.pos >= len(data) or shift > 63:
                raise OcdbtError("truncated or overlong varint")
            b = data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError("truncated body")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u8s(self, n: int) -> List[int]:
        return list(self.raw(n))


def _unframe(data: bytes, magic: int, what: str) -> _Reader:
    """Check a manifest's or node's framing and return its body."""
    if len(data) < 18 or int.from_bytes(data[:4], "big") != magic:
        raise OcdbtError(f"{what}: bad magic")
    if int.from_bytes(data[4:12], "little") != len(data):
        raise OcdbtError(f"{what}: length field disagrees with its size")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Reader(data[:-4])
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = data[head.pos:-4]
    if compression == 1:
        body = decompress(body)
    elif compression != 0:
        raise OcdbtError(f"{what}: compression format {compression}")
    return _Reader(body)


def _prefixed(r: _Reader, n: int, third: bool) -> Tuple[List[bytes], List[int]]:
    """``n`` prefix-compressed byte strings: prefix lengths for all but the
    first, suffix lengths, where ``third`` a third column of ``n`` varints
    (an interior node's common-prefix lengths, a data-file table's base-path
    lengths), then the suffixes."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    column = r.varints(n) if third else []
    out, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OcdbtError("prefix longer than the string before it")
        prev = prev[:p] + r.raw(s)
        out.append(prev)
    return out, column


def _data_files(r: _Reader, base: bytes) -> Tuple[List[bytes], List[bytes]]:
    """The data-file table: each file's path and its base path, both below
    ``base`` (the base path of the file that holds the table)."""
    paths, base_len = _prefixed(r, r.varint(), True)
    return [base + p for p in paths], [base + p[:b] for p, b in zip(paths, base_len)]


class OcdbtStore:
    """The latest version of the OCDBT store in ``directory``."""

    def __init__(self, directory):
        self.root = pathlib.Path(directory)
        self._files: Dict[bytes, bytes] = {}

    def _file(self, path: bytes) -> bytes:
        if path not in self._files:
            full = self.root / path.decode()
            if not full.resolve().is_relative_to(self.root.resolve()):
                raise OcdbtError(f"data file {path!r} outside the store")
            self._files[path] = full.read_bytes()
        return self._files[path]

    def _slice(self, path: bytes, offset: int, length: int) -> bytes:
        data = self._file(path)
        if offset + length > len(data):
            raise OcdbtError(f"{path.decode()}: reference past the end of the file")
        return data[offset:offset + length]

    def _root(self) -> Tuple[bytes, bytes, int, int, int, int]:
        r = _unframe((self.root / "manifest.ocdbt").read_bytes(), MANIFEST_MAGIC,
                     "manifest.ocdbt")
        r.raw(16)  # the store's uuid
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f"manifest.ocdbt: manifest_kind {kind} (only single)")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.raw(1)  # version_tree_arity_log2
        if r.varint() == 1:  # compression_method zstd, then its level
            r.raw(4)
        paths, bases = _data_files(r, b"")
        n = r.varint()
        if n == 0:
            raise OcdbtError("manifest.ocdbt: no version")
        columns = [r.varints(n), r.u8s(n)] + [r.varints(n) for _ in range(6)]
        # the inline versions are the latest; the newest has the highest
        # generation (the version-tree nodes that follow are older ones)
        i = max(range(n), key=lambda j: columns[0][j])
        _, height, fid, offset, length, num_keys = (c[i] for c in columns[:6])
        if fid >= len(paths):
            raise OcdbtError("manifest.ocdbt: data file id out of range")
        return paths[fid], bases[fid], offset, length, height, num_keys

    def items(self) -> Dict[bytes, bytes]:
        """Every key of the latest version and its value."""
        path, base, offset, length, height, num_keys = self._root()
        out: Dict[bytes, bytes] = {}
        if offset != _NO_ROOT:
            self._node(path, base, offset, length, height, b"", out)
        if len(out) != num_keys:
            raise OcdbtError(f"tree holds {len(out)} keys, its version says {num_keys}")
        return out

    def _node(self, path: bytes, base: bytes, offset: int, length: int, height: int,
              prefix: bytes, out: Dict[bytes, bytes]):
        what = f"{path.decode()}@{offset}"
        r = _unframe(self._slice(path, offset, length), NODE_MAGIC, what)
        if r.raw(1)[0] != height:
            raise OcdbtError(f"{what}: height disagrees with its parent")
        paths, bases = _data_files(r, base)
        n = r.varint()
        if height == 0:
            keys, _ = _prefixed(r, n, False)
            lengths = r.varints(n)
            kinds = r.varints(n)
            m = sum(1 for k in kinds if k)
            if any(k > 1 for k in kinds):
                raise OcdbtError(f"{what}: unknown value kind")
            fids, offsets = r.varints(m), r.varints(m)
            j = 0
            for key, size, kind in zip(keys, lengths, kinds):
                if kind:
                    if fids[j] >= len(paths):
                        raise OcdbtError(f"{what}: data file id out of range")
                    out[prefix + key] = self._slice(paths[fids[j]], offsets[j], size)
                    j += 1
                else:
                    out[prefix + key] = r.raw(size)
            if r.pos != len(r.data):
                raise OcdbtError(f"{what}: bytes after the last value")
            return
        keys, common = _prefixed(r, n, True)
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # per child: keys, tree bytes, indirect value bytes
        if r.pos != len(r.data):
            raise OcdbtError(f"{what}: bytes after the last child")
        for key, c, fid, off, size in zip(keys, common, fids, offsets, lengths):
            if c > len(key) or fid >= len(paths):
                raise OcdbtError(f"{what}: child reference out of range")
            self._node(paths[fid], bases[fid], off, size, height - 1, prefix + key[:c], out)


def read_ocdbt(directory) -> Dict[bytes, bytes]:
    """Every key and value of the OCDBT store in ``directory``."""
    return OcdbtStore(directory).items()
