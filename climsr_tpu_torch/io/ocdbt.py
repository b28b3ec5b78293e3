# -*- coding: utf-8 -*-
"""A read-only key-value store over tensorstore's OCDBT directories, the
layout orbax writes a checkpoint's arrays in (``use_ocdbt=True``, its
default), and over the plain layout of one file per key (``use_ocdbt=False``).

OCDBT (optionally-cooperative distributed B+tree) keeps its keys in a
B+tree whose nodes and large values live in data files under ``d/``:

- every file the format defines (the manifest, a B+tree node) is a header
  (4-byte big-endian magic, u64le total length, varint format version 0, one
  compression byte: 0 none, 1 zstd), its body, and a u32le CRC32C of
  everything before it;
- ``manifest.ocdbt`` (magic ``0x0cdb3a2a``): the configuration (uuid,
  manifest kind, ``max_inline_value_bytes``, ``max_decoded_node_bytes``,
  the version tree's arity, the compression method), a data file table,
  then the newest versions column by column (generation, root height, root
  node's file, offset, length, statistics, commit time) and references to
  version-tree nodes holding older ones (not needed to read the newest);
- a B+tree node (magic ``0x0cdb20de``): its height, a data file table, the
  entries' keys (each stored as the length of the prefix it shares with the
  previous key, then the rest), and, for an interior node, each child's
  common key prefix, location and statistics; for a leaf, each value's
  length and kind, (file, offset) of the values stored apart, then the
  values stored inline;
- a data file table: file count, per file the shared prefix length with the
  previous path, the rest's length and the base path's length, then the
  path suffixes; a file is ``base path + relative path`` under the store's
  directory. Orbax's top-level ``manifest.ocdbt`` reaches the arrays each
  process wrote under ``ocdbt.process_N/`` this way.

Integers are LEB128 varints unless stated. Any magic, version, compression,
manifest kind or trailing byte this reader does not know raises
``ValueError`` naming it; a checksum that does not match raises too.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

from climsr_tpu_torch.io import zstd
from climsr_tpu_torch.io.crc32c import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.at, self.what = data, 0, what

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            if self.at >= len(self.data):
                raise ValueError(f"ocdbt: {self.what}: truncated")
            b = self.data[self.at]
            self.at += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"ocdbt: {self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise ValueError(f"ocdbt: {self.what}: truncated")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self) -> None:
        if self.at != len(self.data):
            raise ValueError(f"ocdbt: {self.what}: {len(self.data) - self.at} bytes past its last field")


def _body(raw: bytes, magic: int, what: str) -> bytes:
    """The checked, decompressed body of a manifest or node file."""
    if len(raw) < 18:
        raise ValueError(f"ocdbt: {what}: {len(raw)} bytes, shorter than a header and checksum")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"ocdbt: {what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"ocdbt: {what}: header length {length}, file holds {len(raw)}")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"ocdbt: {what}: CRC32C mismatch")
    head = _Reader(raw[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what}: format version {version} (only 0 is read)")
    compression = head.take(1)[0]
    body = raw[12 + head.at:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"ocdbt: {what}: compression format {compression} (0 none and 1 zstd are read)")


def _file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix, base = r.varints(n), r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(path):
            raise ValueError(f"ocdbt: {r.what}: base path longer than its path")
        paths.append(path.decode())
        prev = path
    return paths


class OcdbtStore:
    """The newest version of the OCDBT store in ``directory``: ``keys()`` and
    ``read(key)``. The B+tree is walked once when the store opens (its nodes
    hold the keys and the small values); a value stored apart is read from
    its data file when asked for, so a caller reads only what it needs."""

    def __init__(self, directory: Union[str, Path]):
        self.directory = Path(directory)
        path = self.directory / MANIFEST
        if not path.is_file():
            raise FileNotFoundError(f"{path}: no OCDBT manifest")
        r = _Reader(_body(path.read_bytes(), MANIFEST_MAGIC, str(path)), str(path))
        self.uuid = r.take(16).hex()
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"ocdbt: {path}: manifest kind {kind} (only 0, a single manifest file, is read)")
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        self.version_tree_arity_log2 = r.u8s(1)[0]
        method = r.varint()
        if method == 1:
            self.compression = {"id": "zstd", "level": struct.unpack("<i", r.take(4))[0]}
        elif method == 0:
            self.compression = None
        else:
            raise ValueError(f"ocdbt: {path}: compression method {method} (0 none and 1 zstd are read)")
        files = _file_table(r)
        n = r.varint()
        gens, heights, ids = r.varints(n), r.u8s(n), r.varints(n)
        offsets, lengths = r.varints(n), r.varints(n)
        num_keys, _tree_bytes, _indirect = r.varints(n), r.varints(n), r.varints(n)
        r.u64s(n)  # commit times
        m = r.varint()  # references to version-tree nodes (older versions)
        r.varints(m), r.varints(m), r.varints(m), r.varints(m), r.varints(m)
        r.u64s(m), r.u8s(m)
        r.end()
        self._index: Dict[bytes, Tuple] = {}
        if not n:
            raise ValueError(f"ocdbt: {path}: no version")
        v = max(range(n), key=lambda i: gens[i])
        self.generation = gens[v]
        if num_keys[v]:
            self._walk(files[ids[v]], offsets[v], lengths[v], heights[v], b"")
        if len(self._index) != num_keys[v]:
            raise ValueError(f"ocdbt: {path}: {len(self._index)} keys in the tree, the manifest says {num_keys[v]}")

    def _read_at(self, name: str, offset: int, length: int) -> bytes:
        with open(self.directory / name, "rb") as f:
            f.seek(offset)
            out = f.read(length)
        if len(out) != length:
            raise ValueError(f"ocdbt: {self.directory / name}: {length} bytes at {offset} run past its end")
        return out

    def _walk(self, name: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        what = f"{self.directory / name}@{offset}"
        r = _Reader(_body(self._read_at(name, offset, length), NODE_MAGIC, what), what)
        got = r.u8s(1)[0]
        if got != height:
            raise ValueError(f"ocdbt: {what}: node height {got}, its parent says {height}")
        files = _file_table(r)
        n = r.varint()
        shared = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height else []
        keys, prev = [], b""
        for i in range(n):
            prev = prev[:shared[i]] + r.take(suffix[i])
            keys.append(prev)
        if height:
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            r.varints(n), r.varints(n), r.varints(n)  # statistics
            r.end()
            for i in range(n):
                self._walk(files[ids[i]], offsets[i], lengths[i], height - 1, prefix + keys[i][:common[i]])
            return
        sizes, kinds = r.varints(n), r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"ocdbt: {what}: value kind {max(kinds)} (0 inline and 1 apart are read)")
        apart = [i for i in range(n) if kinds[i]]
        ids, offsets = r.varints(len(apart)), r.varints(len(apart))
        where = dict(zip(apart, zip(ids, offsets)))
        for i in range(n):
            key = prefix + keys[i]
            if kinds[i]:
                fid, off = where[i]
                self._index[key] = (files[fid], off, sizes[i])
            else:
                self._index[key] = (r.take(sizes[i]),)
        r.end()

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._index)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._index

    def read(self, key: str) -> bytes:
        ref = self._index.get(key.encode())
        if ref is None:
            raise KeyError(f"{key!r} is not in the OCDBT store at {self.directory}")
        return ref[0] if len(ref) == 1 else self._read_at(*ref)


class FileStore:
    """The plain layout (``use_ocdbt=False``): each key a file under ``directory``."""

    def __init__(self, directory: Union[str, Path]):
        self.directory = Path(directory)
        if not self.directory.is_dir():
            raise FileNotFoundError(f"{self.directory}: not a directory")

    def keys(self) -> List[str]:
        return sorted(p.relative_to(self.directory).as_posix() for p in self.directory.rglob("*") if p.is_file())

    def __contains__(self, key: str) -> bool:
        return (self.directory / key).is_file()

    def read(self, key: str) -> bytes:
        path = self.directory / key
        if not path.is_file():
            raise KeyError(f"{key!r} is not a file under {self.directory}")
        return path.read_bytes()


def open_store(directory: Union[str, Path]):
    """An :class:`OcdbtStore` where ``directory`` holds ``manifest.ocdbt``,
    else a :class:`FileStore`."""
    directory = Path(directory)
    return OcdbtStore(directory) if (directory / MANIFEST).is_file() else FileStore(directory)
