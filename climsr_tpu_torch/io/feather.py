# -*- coding: utf-8 -*-
"""Feather v2 (the Arrow IPC file format) with the standard library and numpy.

The JAX package reads and writes its tile indices and statistics with
pandas' ``read_feather``/``to_feather`` (pyarrow underneath). The GPU machine
has neither, so the port reads and writes the format itself:

- the file: magic ``ARROW1\\0\\0``, a Schema message, RecordBatch messages
  (each a flatbuffer ``Message`` behind a ``0xFFFFFFFF`` continuation and its
  length, then an 8-byte-aligned body), an end-of-stream marker, a ``Footer``
  flatbuffer, its length and ``ARROW1``;
- the column types the JAX package's tables hold: ``utf8``, ``large_utf8``,
  ``int32``, ``int64``, ``float32``, ``float64``, ``bool`` (bit-packed) and
  ``null``, each with a validity bitmap where it has nulls;
- bodies uncompressed or ``LZ4_FRAME``-compressed (pyarrow's default for
  ``to_feather`` where it has the codec): every buffer is then an int64
  uncompressed length (``-1``: stored raw) and an LZ4 frame, decoded here
  in pure Python. ``ZSTD`` raises a ``ValueError`` naming the codec.

Nulls read as pandas reads them: ``None`` in a string, bool or null column,
NaN in a float column, and an int column with nulls becomes float64 with NaN.
The ``pandas`` schema metadata is ignored on read. :func:`write` writes one
uncompressed record batch with a ``pandas`` metadata entry for a
``RangeIndex``, so ``pd.read_feather`` gives back the same frame.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

_MAGIC = b"ARROW1"
_CONTINUATION = 0xFFFFFFFF
_V5 = 4  # MetadataVersion.V5
# MessageHeader union
_SCHEMA, _RECORD_BATCH = 1, 3
# Type union
_NULL, _INT, _FLOAT, _UTF8, _BOOL, _LARGE_UTF8 = 1, 2, 3, 5, 6, 20
_TYPE_NAMES = {0: "NONE", 1: "Null", 2: "Int", 3: "FloatingPoint", 4: "Binary", 5: "Utf8", 6: "Bool",
               7: "Decimal", 8: "Date", 9: "Time", 10: "Timestamp", 11: "Interval", 12: "List", 13: "Struct",
               14: "Union", 15: "FixedSizeBinary", 16: "FixedSizeList", 17: "Map", 18: "Duration",
               19: "LargeBinary", 20: "LargeUtf8", 21: "LargeList"}
_CODECS = {0: "LZ4_FRAME", 1: "ZSTD"}
_FLOAT_DTYPES = {1: np.float32, 2: np.float64}  # Precision SINGLE, DOUBLE
_INT_DTYPES = {(32, True): np.int32, (64, True): np.int64}
_PANDAS_TYPES = {np.dtype(np.int32): "int32", np.dtype(np.int64): "int64", np.dtype(np.float32): "float32",
                 np.dtype(np.float64): "float64", np.dtype(bool): "bool"}


# ---- flatbuffers, read side -------------------------------------------------

class _Table:
    """A flatbuffer table at ``pos`` of ``buf``: fields by vtable slot."""

    def __init__(self, buf: memoryview, pos: int):
        self.buf, self.pos = buf, pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        vt_size = struct.unpack_from("<H", buf, vt)[0]
        self._slots = struct.unpack_from(f"<{(vt_size - 4) // 2}H", buf, vt + 4)

    def _at(self, slot: int) -> int:
        return self._slots[slot] if slot < len(self._slots) else 0

    def scalar(self, slot: int, fmt: str, default=0):
        off = self._at(slot)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0] if off else default

    def _ref(self, slot: int) -> Optional[int]:
        off = self._at(slot)
        if not off:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, slot: int) -> Optional["_Table"]:
        at = self._ref(slot)
        return None if at is None else _Table(self.buf, at)

    def string(self, slot: int) -> Optional[str]:
        at = self._ref(slot)
        if at is None:
            return None
        n = struct.unpack_from("<I", self.buf, at)[0]
        return bytes(self.buf[at + 4:at + 4 + n]).decode("utf-8")

    def tables(self, slot: int) -> List["_Table"]:
        at = self._ref(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for i in range(n):
            elem = at + 4 + 4 * i
            out.append(_Table(self.buf, elem + struct.unpack_from("<I", self.buf, elem)[0]))
        return out

    def structs(self, slot: int, fmt: str) -> List[tuple]:
        at = self._ref(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        return list(struct.iter_unpack("<" + fmt, self.buf[at + 4:at + 4 + n * struct.calcsize("<" + fmt)]))


def _root(buf: memoryview) -> _Table:
    return _Table(buf, struct.unpack_from("<I", buf, 0)[0])


# ---- flatbuffers, write side ------------------------------------------------
# A table is a list of fields by slot, each None (absent) or one of
#   ("s", fmt, value)   an inline scalar,
#   ("str", text)       a string,
#   ("table", fields)   a sub-table,
#   ("tables", [fields, ...])  a vector of tables,
#   ("structs", fmt, [tuple, ...], align)  a vector of structs.
# The writer lays the buffer out front to back: each vtable just before its
# table, each child after its parent (flatbuffer offsets point forward), every
# scalar aligned to its size from the buffer's start.

class _FlatbufferWriter:
    def __init__(self):
        self.buf = bytearray(4)  # the root offset

    def _align(self, align: int, extra: int = 0) -> None:
        self.buf.extend(b"\0" * ((-(len(self.buf) + extra)) % align))

    def _put(self, fmt: str, at: int, value) -> None:
        struct.pack_into("<" + fmt, self.buf, at, value)

    def table(self, fields: Sequence) -> int:
        inline = [(slot, f) for slot, f in enumerate(fields) if f is not None]
        sizes = {slot: (struct.calcsize("<" + f[1]) if f[0] == "s" else 4) for slot, f in inline}
        layout, offset = {}, 4  # after the soffset to the vtable
        for size in (8, 4, 2, 1):  # largest first: each field lands aligned
            for slot, _ in inline:
                if sizes[slot] == size:
                    offset += (-offset) % size
                    layout[slot] = offset
                    offset += size
        table_align = 8 if 8 in sizes.values() else 4
        table_size = offset + (-offset) % 4
        vtable = struct.pack(f"<{2 + len(fields)}H", 4 + 2 * len(fields), table_size,
                             *[layout.get(slot, 0) for slot in range(len(fields))])
        self._align(table_align, len(vtable))
        vt_pos = len(self.buf)
        self.buf.extend(vtable)
        pos = len(self.buf)
        self.buf.extend(b"\0" * table_size)
        self._put("i", pos, pos - vt_pos)
        for slot, f in inline:
            if f[0] == "s":
                self._put(f[1], pos + layout[slot], f[2])
        for slot, f in inline:
            if f[0] != "s":
                at = pos + layout[slot]
                self._put("I", at, self._child(f) - at)
        return pos

    def _child(self, f) -> int:
        kind = f[0]
        if kind == "str":
            data = f[1].encode("utf-8")
            self._align(4)
            pos = len(self.buf)
            self.buf.extend(struct.pack("<I", len(data)) + data + b"\0")
            return pos
        if kind == "table":
            return self.table(f[1])
        if kind == "tables":
            self._align(4)
            pos = len(self.buf)
            self.buf.extend(struct.pack("<I", len(f[1])) + b"\0" * (4 * len(f[1])))
            for i, fields in enumerate(f[1]):
                at = pos + 4 + 4 * i
                self._put("I", at, self.table(fields) - at)
            return pos
        if kind == "structs":
            _, fmt, items, align = f
            self._align(align, 4)
            pos = len(self.buf)
            self.buf.extend(struct.pack("<I", len(items)) + b"".join(struct.pack("<" + fmt, *t) for t in items))
            return pos
        raise ValueError(f"unknown flatbuffer field kind {kind!r}")

    def finish(self, root: Sequence) -> bytes:
        pos = self.table(root)
        self._put("I", 0, pos)
        self._align(8)
        return bytes(self.buf)


def _flatbuffer(root: Sequence) -> bytes:
    return _FlatbufferWriter().finish(root)


# ---- LZ4 frames, in pure Python ---------------------------------------------

def _lz4_block(src: memoryview, out: bytearray) -> None:
    """Decode one LZ4 block onto ``out``; a match may reach back into earlier
    blocks' output (linked blocks), so every block of a frame shares ``out``."""
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            out += src[i:i + lit]
            i += lit
        if i >= n:  # the last sequence holds literals only
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if not offset:
            raise ValueError("lz4: a match with offset 0")
        length = token & 15
        if length == 15:
            while True:
                b = src[i]
                i += 1
                length += b
                if b != 255:
                    break
        length += 4
        start = len(out) - offset
        if start < 0:
            raise ValueError("lz4: a match reaches before the start of the output")
        if offset >= length:
            out += out[start:start + length]
        else:  # the match overlaps what it writes: a repeating pattern
            pattern = out[start:]
            out += (pattern * (length // offset + 1))[:length]


def lz4_frame_decompress(data: Union[bytes, memoryview]) -> bytes:
    """One or more concatenated LZ4 frames (the LZ4 frame format 1.6) -> bytes.
    Block and content checksums are skipped, not verified."""
    src = memoryview(data)
    out = bytearray()
    i = 0
    while i < len(src):
        magic = struct.unpack_from("<I", src, i)[0]
        if 0x184D2A50 <= magic <= 0x184D2A5F:  # a skippable frame
            i += 8 + struct.unpack_from("<I", src, i + 4)[0]
            continue
        if magic != 0x184D2204:
            raise ValueError(f"lz4: bad frame magic {magic:#x}")
        flg = src[i + 4]
        if flg >> 6 != 1:
            raise ValueError(f"lz4: frame version {flg >> 6}")
        block_checksum, content_size, content_checksum, dict_id = flg & 0x10, flg & 0x08, flg & 0x04, flg & 0x01
        if dict_id:
            raise ValueError("lz4: frames with a dictionary are not read")
        i += 6 + (8 if content_size else 0) + 1  # magic, FLG, BD, content size, header checksum
        while True:
            size = struct.unpack_from("<I", src, i)[0]
            i += 4
            if size == 0:  # end mark
                break
            raw, size = size & 0x80000000, size & 0x7FFFFFFF
            block = src[i:i + size]
            if raw:
                out += block
            else:
                _lz4_block(block, out)
            i += size + (4 if block_checksum else 0)
        i += 4 if content_checksum else 0
    return bytes(out)


# ---- reading ----------------------------------------------------------------

def _message(buf: memoryview, offset: int) -> Tuple[_Table, int]:
    """The flatbuffer Message at a block's ``offset`` and where its body starts."""
    (first,) = struct.unpack_from("<I", buf, offset)
    if first == _CONTINUATION:
        (length,) = struct.unpack_from("<i", buf, offset + 4)
        start = offset + 8
    else:  # the pre-0.15 framing: the length alone
        length, start = first, offset + 4
    return _root(buf[start:start + length]), start + length


def _bits(buf: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")[:n].astype(bool)


def _field_type(field: _Table) -> Tuple[int, Optional[_Table]]:
    return field.scalar(2, "B"), field.table(3)


def _column(name: str, type_id: int, type_table: Optional[_Table], length: int, null_count: int,
            buffers: List[bytes]) -> np.ndarray:
    valid = _bits(buffers[0], length) if null_count and type_id != _NULL else None
    if type_id == _NULL:
        return np.full(length, None, dtype=object)
    if type_id in (_UTF8, _LARGE_UTF8):
        offsets = np.frombuffer(buffers[1], np.int32 if type_id == _UTF8 else np.int64, length + 1 if length else 0)
        data = bytes(buffers[2])
        if not length:
            return np.empty(0, dtype=object)
        bounds = offsets.tolist()
        if data.isascii():  # byte offsets are character offsets: decode once
            text = data.decode("ascii")
            values = [text[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        else:
            values = [data[a:b].decode("utf-8") for a, b in zip(bounds[:-1], bounds[1:])]
        arr = np.empty(length, dtype=object)
        arr[:] = values
        if valid is not None:
            arr[~valid] = None
        return arr
    if type_id == _BOOL:
        values = _bits(buffers[1], length)
        if valid is None:
            return values
        arr = values.astype(object)
        arr[~valid] = None
        return arr
    if type_id == _INT:
        key = (type_table.scalar(0, "i"), bool(type_table.scalar(1, "B")))
        if key not in _INT_DTYPES:
            raise ValueError(f"feather column {name!r}: int{key[0]} (signed={key[1]}) is not read")
        values = np.frombuffer(buffers[1], _INT_DTYPES[key], length).copy()
        if valid is None:
            return values
        values = values.astype(np.float64)  # pandas: an int column with nulls is float64
        values[~valid] = np.nan
        return values
    if type_id == _FLOAT:
        precision = type_table.scalar(0, "h")
        if precision not in _FLOAT_DTYPES:
            raise ValueError(f"feather column {name!r}: float precision {precision} is not read")
        values = np.frombuffer(buffers[1], _FLOAT_DTYPES[precision], length).copy()
        if valid is not None:
            values[~valid] = np.nan
        return values
    raise ValueError(f"feather column {name!r}: Arrow type {_TYPE_NAMES.get(type_id, type_id)} is not read")


_N_BUFFERS = {_NULL: 0, _INT: 2, _FLOAT: 2, _BOOL: 2, _UTF8: 3, _LARGE_UTF8: 3}


def _batch(buf: memoryview, message: _Table, body: int, fields: List[_Table]) -> Dict[str, np.ndarray]:
    batch = message.table(2)
    length = batch.scalar(0, "q")
    nodes = batch.structs(1, "qq")
    specs = batch.structs(2, "qq")
    compression = batch.table(3)
    codec = None if compression is None else compression.scalar(0, "b")
    if codec is not None and codec != 0:
        raise ValueError(f"feather body compressed with {_CODECS.get(codec, codec)}: only LZ4_FRAME is read")

    def buffer(k: int) -> bytes:
        off, size = specs[k]
        raw = buf[body + off:body + off + size]
        if codec is None or size == 0:
            return raw
        (n,) = struct.unpack_from("<q", raw, 0)
        return raw[8:] if n == -1 else lz4_frame_decompress(raw[8:])

    cols, k = {}, 0
    for field, (n, null_count) in zip(fields, nodes):
        name = field.string(0) or ""
        type_id, type_table = _field_type(field)
        if type_id not in _N_BUFFERS:
            raise ValueError(f"feather column {name!r}: Arrow type {_TYPE_NAMES.get(type_id, type_id)} is not read")
        count = _N_BUFFERS[type_id]
        cols[name] = _column(name, type_id, type_table, n, null_count, [buffer(k + j) for j in range(count)])
        k += count
    if len(nodes) != len(fields) or any(len(v) != length for v in cols.values()):
        raise ValueError("feather record batch does not match its schema")
    return cols


def read(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """A feather v2 file's columns, in schema order, as numpy arrays."""
    data = Path(path).read_bytes()
    if len(data) < 18 or data[:6] != _MAGIC or data[-6:] != _MAGIC:
        raise ValueError(f"{path}: not a feather v2 (Arrow IPC) file")
    buf = memoryview(data)
    (footer_len,) = struct.unpack_from("<i", buf, len(data) - 10)
    footer = _root(buf[len(data) - 10 - footer_len:len(data) - 10])
    schema = footer.table(1)
    fields = schema.tables(1)
    for field in fields:
        if field.table(4) is not None:
            raise ValueError(f"{path}: dictionary-encoded column {field.string(0)!r} is not read")
    batches = []
    for offset, _meta_len, _body_len in footer.structs(3, "qi4xq"):
        message, body = _message(buf, offset)
        if message.scalar(1, "B") != _RECORD_BATCH:
            raise ValueError(f"{path}: a record-batch block holds message type {message.scalar(1, 'B')}")
        batches.append(_batch(buf, message, body, fields))
    names = [field.string(0) or "" for field in fields]
    if not batches:
        return {name: _column(name, *_field_type(field), 0, 0, [b"", b"", b""])
                for name, field in zip(names, fields)}
    return {name: (batches[0][name] if len(batches) == 1 else np.concatenate([b[name] for b in batches]))
            for name in names}


# ---- writing ----------------------------------------------------------------

def _packbits(mask: np.ndarray) -> bytes:
    return np.packbits(mask.astype(np.uint8), bitorder="little").tobytes()


def _encode(name: str, values: np.ndarray) -> Tuple[tuple, int, List[bytes], str, str]:
    """A column -> (type union entry, null count, buffers, pandas_type, numpy_type)."""
    values = np.asarray(values)
    n = len(values)
    if values.dtype.kind == "U":
        values = values.astype(object)
    if values.dtype == object:
        is_null = np.fromiter((v is None or (isinstance(v, float) and np.isnan(v)) for v in values), bool, n)
        present = [v for v in values[~is_null]]
        if not present:
            return (_NULL, []), n, [], "empty", "object"
        if all(isinstance(v, str) for v in present):
            encoded = [b"" if null else v.encode("utf-8") for v, null in zip(values, is_null)]
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum([len(b) for b in encoded], out=offsets[1:])
            large = offsets[-1] > np.iinfo(np.int32).max
            validity = _packbits(~is_null) if is_null.any() else b""
            return ((_LARGE_UTF8 if large else _UTF8, []), int(is_null.sum()),
                    [validity, offsets.astype(np.int64 if large else np.int32).tobytes(), b"".join(encoded)],
                    "unicode", "object")
        if all(isinstance(v, (bool, np.bool_)) for v in present):
            dense = np.array([bool(v) if not null else False for v, null in zip(values, is_null)], bool)
            return ((_BOOL, []), int(is_null.sum()), [_packbits(~is_null), _packbits(dense)], "bool", "object")
        if all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_)) for v in present):
            dense = np.array([0 if null else int(v) for v, null in zip(values, is_null)], np.int64)
            validity = _packbits(~is_null) if is_null.any() else b""
            return ((_INT, [("s", "i", 64), ("s", "B", 1)]), int(is_null.sum()), [validity, dense.tobytes()],
                    "int64", "int64")
        if all(isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool) for v in present):
            dense = np.array([np.nan if null else float(v) for v, null in zip(values, is_null)], np.float64)
            return (_FLOAT, [("s", "h", 2)]), 0, [b"", dense.tobytes()], "float64", "float64"
        raise ValueError(f"feather column {name!r}: object values of mixed or unsupported types")
    dtype = values.dtype
    if dtype == bool:
        return (_BOOL, []), 0, [b"", _packbits(values)], "bool", "bool"
    if dtype.kind in "iu":
        if dtype not in (np.dtype(np.int32), np.dtype(np.int64)):
            values, dtype = values.astype(np.int64), np.dtype(np.int64)
        return ((_INT, [("s", "i", dtype.itemsize * 8), ("s", "B", 1)]), 0,
                [b"", np.ascontiguousarray(values, dtype.newbyteorder("<")).tobytes()],
                _PANDAS_TYPES[dtype], dtype.name)
    if dtype.kind == "f":
        if dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            values, dtype = values.astype(np.float64), np.dtype(np.float64)
        return ((_FLOAT, [("s", "h", 1 if dtype == np.float32 else 2)]), 0,
                [b"", np.ascontiguousarray(values, dtype.newbyteorder("<")).tobytes()],
                _PANDAS_TYPES[dtype], dtype.name)
    raise ValueError(f"feather column {name!r}: dtype {dtype} is not written")


def _pad8(data: bytes) -> bytes:
    return data + b"\0" * ((-len(data)) % 8)


def _framed(message: bytes) -> bytes:
    return struct.pack("<Ii", _CONTINUATION, len(message)) + message


def write(columns: Dict[str, Any], path: Union[str, Path]) -> None:
    """Write equal-length ``columns`` as an uncompressed feather v2 file that
    ``pd.read_feather`` reads back as the same frame (a ``RangeIndex``)."""
    names = list(columns)
    n = len(columns[names[0]]) if names else 0
    encoded = [_encode(name, columns[name]) for name in names]
    if any(len(np.asarray(columns[k])) != n for k in names):
        raise ValueError("feather columns of unequal length")

    pandas_meta = {
        "index_columns": [{"kind": "range", "name": None, "start": 0, "stop": n, "step": 1}],
        "column_indexes": [{"name": None, "field_name": None, "pandas_type": "unicode", "numpy_type": "object",
                            "metadata": {"encoding": "UTF-8"}}],
        "columns": [{"name": name, "field_name": name, "pandas_type": e[3], "numpy_type": e[4], "metadata": None}
                    for name, e in zip(names, encoded)],
        "attributes": {},
        "creator": {"library": "climsr_tpu_torch"},
        "pandas_version": "2.0.0",
    }
    fields = [[("str", name), ("s", "B", 1), ("s", "B", e[0][0]), ("table", e[0][1]), None, ("tables", [])]
              for name, e in zip(names, encoded)]
    schema = [("s", "h", 0), ("tables", fields),
              ("tables", [[("str", "pandas"), ("str", json.dumps(pandas_meta))]])]

    body, specs, nodes = bytearray(), [], []
    for e in encoded:
        nodes.append((n, e[1]))
        for data in e[2]:
            specs.append((len(body), len(data)))
            body += _pad8(data)
    batch = [("s", "q", n), ("structs", "qq", nodes, 8), ("structs", "qq", specs, 8)]

    schema_msg = _framed(_flatbuffer([("s", "h", _V5), ("s", "B", _SCHEMA), ("table", schema), ("s", "q", 0)]))
    batch_msg = _framed(_flatbuffer([("s", "h", _V5), ("s", "B", _RECORD_BATCH), ("table", batch),
                                     ("s", "q", len(body))]))
    out = bytearray(_MAGIC + b"\0\0")
    out += schema_msg
    batch_offset = len(out)
    out += batch_msg
    out += body
    out += struct.pack("<Ii", _CONTINUATION, 0)  # end of stream
    footer = _flatbuffer([("s", "h", _V5), ("table", schema), ("structs", "qi4xq", [], 8),
                          ("structs", "qi4xq", [(batch_offset, len(batch_msg), len(body))], 8)])
    out += footer
    out += struct.pack("<i", len(footer)) + _MAGIC
    Path(path).write_bytes(bytes(out))
