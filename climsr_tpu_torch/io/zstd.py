# -*- coding: utf-8 -*-
"""Zstandard frame decoder (RFC 8878) with the standard library and numpy.

The JAX package's orbax checkpoints store every array chunk as a zstd frame
(zarr's ``zstd`` compressor), and Arrow files may carry ZSTD bodies. The GPU
machine has no ``zstandard`` package, so the port decodes the format itself:

- concatenated frames and skippable frames; single-segment and windowed
  frames; raw, RLE and compressed blocks;
- literals raw, RLE, Huffman-coded in 1 or 4 streams, or treeless (the
  frame's previous Huffman table); Huffman weights direct or FSE-coded;
- sequences with predefined, RLE, FSE-coded or repeated tables, and the
  three repeat offsets;
- the content checksum, checked with :func:`xxh64`.

A frame that needs a dictionary raises ``ValueError``, as does any reserved
field or stream that does not decode to its stated size.

The hot part for weights (mostly literals) is the Huffman decode: each
stream is read backwards one code at a time (:func:`_huffman_stream`), the
next code's start depending on the last one's length.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

ZSTD_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK, _SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
_MAX_BLOCK = 1 << 17

# (baseline, extra bits) of each literals-length and match-length code
_LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6), (128, 7),
    (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4), (99, 5),
    (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
_LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                   -1, -1, -1, -1])
_ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7)
_OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5)
# (largest symbol, largest accuracy log) of each sequence field
_LL_MAX, _ML_MAX, _OF_MAX = (35, 9), (52, 9), (31, 8)


# ---- bit streams --------------------------------------------------------

class _BackwardBits:
    """A bit stream read from its end (FSE, Huffman): the last byte's highest
    set bit marks where it starts. Reading past the first bit gives zeros and
    leaves :attr:`pos` negative."""

    def __init__(self, data: bytes, what: str):
        if not data or data[-1] == 0:
            raise ValueError(f"zstd: {what}: empty bit stream or no end marker")
        self.data = bytes(data) + b"\0\0\0\0\0\0\0\0"  # reads past the end stay in range
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if n > 56:
            raise ValueError("zstd: a read of more than 56 bits")
        self.pos -= n
        p = self.pos
        if p < 0:
            if p + n <= 0:
                return 0
            return (int.from_bytes(self.data[:8], "little") & ((1 << (n + p)) - 1)) << -p
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "little") >> (p & 7)
        return v & ((1 << n) - 1)


def _read_fse_table(data: bytes, at: int, max_symbol: int, max_log: int) -> Tuple[int, List[int], int]:
    """The FSE table description at ``data[at:]`` (a forward bit stream):
    (accuracy log, normalized counts, bytes it takes)."""
    window = data[at:at + 512]  # more than any description takes
    bits = int.from_bytes(window, "little")
    n_avail = 8 * len(window)
    pos = 0

    def take(n):
        nonlocal pos
        v = (bits >> pos) & ((1 << n) - 1)
        pos += n
        return v

    log = take(4) + 5
    if log > max_log:
        raise ValueError(f"zstd: FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    while remaining > 1 and len(counts) <= max_symbol:
        big = (2 * threshold - 1) - remaining
        low = (bits >> pos) & (threshold - 1)
        if low < big:
            value = low
            pos += nbits - 1
        else:
            value = (bits >> pos) & (2 * threshold - 1)
            if value >= threshold:
                value -= big
            pos += nbits
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if count == 0:
            while True:
                rep = take(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
    if remaining != 1 or len(counts) > max_symbol + 1 or pos > n_avail:
        raise ValueError("zstd: corrupt FSE table description")
    return log, counts, (pos + 7) >> 3


class _Fse:
    """An FSE decoding table: per state its symbol, bits to read, next base."""

    def __init__(self, log: int, counts: List[int]):
        size = 1 << log
        self.log = log
        symbol = [0] * size
        high = size - 1
        nxt = [0] * len(counts)
        for s, c in enumerate(counts):
            if c == -1:
                symbol[high] = s
                high -= 1
                nxt[s] = 1
            else:
                nxt[s] = c
        step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
        for s, c in enumerate(counts):
            for _ in range(max(c, 0)):
                symbol[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ValueError("zstd: FSE counts do not fill the table")
        self.symbol, self.nbits, self.base = symbol, [0] * size, [0] * size
        for u in range(size):
            x = nxt[symbol[u]]
            nxt[symbol[u]] += 1
            nb = log - (x.bit_length() - 1)
            self.nbits[u] = nb
            self.base[u] = (x << nb) - size

    @classmethod
    def rle(cls, symbol: int) -> "_Fse":
        t = cls.__new__(cls)
        t.log, t.symbol, t.nbits, t.base = 0, [symbol], [0], [0]
        return t


# ---- Huffman literals ---------------------------------------------------------

class _Huffman:
    """A Huffman decoding table indexed by the next ``log`` bits."""

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ValueError("zstd: Huffman weights all zero")
        log = total.bit_length()  # the next power of two above the sum
        rest = (1 << log) - total
        if rest & (rest - 1):
            raise ValueError("zstd: Huffman weights do not complete to a power of two")
        if log > 11:
            raise ValueError(f"zstd: Huffman code length {log} above 11")
        weights = weights + [rest.bit_length()]
        rank_start = [0] * (log + 2)
        counts = [0] * (log + 2)
        for w in weights:
            counts[w] += 1
        nxt = 0
        for w in range(1, log + 1):
            rank_start[w] = nxt
            nxt += counts[w] << (w - 1)
        sym = np.zeros(1 << log, np.uint8)
        nb = np.zeros(1 << log, np.int64)
        for s, w in enumerate(weights):
            if w:
                n = 1 << (w - 1)
                sym[rank_start[w]:rank_start[w] + n] = s
                nb[rank_start[w]:rank_start[w] + n] = log + 1 - w
                rank_start[w] += n
        self.log, self.sym, self.nb = log, sym.tolist(), nb.tolist()


def _read_huffman(data: bytes, at: int) -> Tuple[_Huffman, int]:
    """The Huffman tree description at ``data[at:]``: (table, bytes it takes)."""
    head = data[at]
    if head >= 128:
        n = head - 127
        raw = data[at + 1:at + 1 + (n + 1) // 2]
        weights = [w for b in raw for w in (b >> 4, b & 15)][:n]
        return _Huffman(weights), 1 + (n + 1) // 2
    body = data[at + 1:at + 1 + head]
    log, counts, used = _read_fse_table(body, 0, 255, 6)
    fse = _Fse(log, counts)
    br = _BackwardBits(body[used:], "Huffman weights")
    states = [br.read(log), br.read(log)]
    weights: List[int] = []
    i = 0
    while True:  # two interleaved states; the stream's end gives the other's last symbol
        s = states[i]
        weights.append(fse.symbol[s])
        states[i] = fse.base[s] + br.read(fse.nbits[s])
        if br.pos < 0:
            weights.append(fse.symbol[states[1 - i]])
            break
        if len(weights) > 255:
            raise ValueError("zstd: more than 255 Huffman weights")
        i = 1 - i
    return _Huffman(weights), 1 + head


def _huffman_stream(table: _Huffman, data: bytes, n: int) -> bytes:
    """The ``n`` literals of one Huffman stream, read from its end marker
    down: the next ``table.log`` bits give a symbol and the code's length,
    and the next code starts that many bits lower. The stream must end on
    its first bit."""
    if not data or data[-1] == 0:
        raise ValueError("zstd: a Huffman stream is empty or has no end marker")
    # behind two zero bytes (the bits below a stream's start read as zeros)
    raw = np.frombuffer(b"\0\0" + bytes(data) + b"\0\0\0", np.uint8).astype(np.uint32)
    words = (raw[:-2] | (raw[1:-1] << 8) | (raw[2:] << 16)).tolist()  # 24 bits from each byte on
    sym, nb, log, mask = table.sym, table.nb, table.log, (1 << table.log) - 1
    p = 16 + (len(data) - 1) * 8 + data[-1].bit_length() - 1
    out = bytearray(n)
    try:
        for i in range(n):
            q = p - log
            c = (words[q >> 3] >> (q & 7)) & mask
            out[i] = sym[c]
            p -= nb[c]
    except IndexError:
        p = -1  # read far past the stream's start
    if p != 16:
        raise ValueError("zstd: a Huffman stream does not end on its first bit")
    return bytes(out)


# ---- blocks ---------------------------------------------------------------

class _FrameState:
    """What a frame's blocks carry over: the Huffman table, the three
    sequence tables, the repeat offsets."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables: List[Optional[_Fse]] = [None, None, None]  # LL, OF, ML
        self.rep = [1, 4, 8]


def _literals(block: bytes, fs: _FrameState):
    """The literals section at the start of ``block``: (the literals, the
    bytes it takes)."""
    b0 = block[0]
    kind, size_format = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if size_format in (0, 2):
            regen, head = b0 >> 3, 1
        elif size_format == 1:
            regen, head = (b0 >> 4) + (block[1] << 4), 2
        else:
            regen, head = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if kind == 0:
            lit = bytes(block[head:head + regen])
            if len(lit) != regen:
                raise ValueError("zstd: raw literals past the end of the block")
            return lit, head + regen
        return bytes(block[head:head + 1]) * regen, head + 1
    head = (3, 3, 4, 5)[size_format]
    width = (10, 10, 14, 18)[size_format]
    h = int.from_bytes(block[:head], "little")
    regen = (h >> 4) & ((1 << width) - 1)
    csize = (h >> (4 + width)) & ((1 << width) - 1)
    body = block[head:head + csize]
    if len(body) != csize:
        raise ValueError("zstd: compressed literals past the end of the block")
    at = 0
    if kind == 2:
        fs.huffman, at = _read_huffman(body, 0)
    elif fs.huffman is None:
        raise ValueError("zstd: treeless literals with no earlier Huffman table")
    table = fs.huffman
    if size_format == 0:  # one stream
        return _huffman_stream(table, body[at:], regen), head + csize
    s1, s2, s3 = struct.unpack_from("<HHH", body, at)
    at += 6
    per = (regen + 3) // 4
    sizes = (s1, s2, s3, len(body) - at - s1 - s2 - s3)
    if sizes[3] < 0 or regen < 3 * per:
        raise ValueError("zstd: Huffman jump table past the literals")
    parts = []
    for sz, n in zip(sizes, (per, per, per, regen - 3 * per)):
        parts.append(_huffman_stream(table, body[at:at + sz], n))
        at += sz
    return b"".join(parts), head + csize


def _sequence_table(block: bytes, at: int, mode: int, default, limits, fs: _FrameState, i: int) -> int:
    if mode == 0:
        fs.tables[i] = _Fse(*default)
    elif mode == 1:
        if block[at] > limits[0]:
            raise ValueError(f"zstd: RLE symbol {block[at]} above {limits[0]}")
        fs.tables[i] = _Fse.rle(block[at])
        at += 1
    elif mode == 2:
        log, counts, used = _read_fse_table(block, at, *limits)
        fs.tables[i] = _Fse(log, counts)
        at += used
    elif fs.tables[i] is None:
        raise ValueError("zstd: a repeated sequence table with no earlier table")
    return at


def _sequences(block: bytes, at: int, fs: _FrameState):
    """The sequences section at ``block[at:]``: None where the block is
    literals alone, else (count, the LL, OF and ML tables, the bit stream)."""
    b0 = block[at]
    if b0 == 0:
        if at + 1 != len(block):
            raise ValueError("zstd: bytes after a block's literals with no sequences")
        return None
    if b0 < 128:
        nseq, at = b0, at + 1
    elif b0 < 255:
        nseq, at = ((b0 - 128) << 8) + block[at + 1], at + 2
    else:
        nseq, at = block[at + 1] + (block[at + 2] << 8) + 0x7F00, at + 3
    modes = block[at]
    at += 1
    if modes & 3:
        raise ValueError("zstd: reserved bits set in the sequence modes")
    at = _sequence_table(block, at, modes >> 6, _LL_DEFAULT, _LL_MAX, fs, 0)
    at = _sequence_table(block, at, (modes >> 4) & 3, _OF_DEFAULT, _OF_MAX, fs, 1)
    at = _sequence_table(block, at, (modes >> 2) & 3, _ML_DEFAULT, _ML_MAX, fs, 2)
    return (nseq, *fs.tables, block[at:])


def _execute(lit: bytes, seqs, out: bytearray, rep: List[int]) -> None:
    """A block's sequences over its literals, onto the end of ``out``."""
    if seqs is None:
        out += lit
        return
    nseq, ll_t, of_t, ml_t, stream = seqs
    br = _BackwardBits(stream, "sequences")
    read = br.read
    ll_s, of_s, ml_s = read(ll_t.log), read(of_t.log), read(ml_t.log)
    lit_at = 0
    for k in range(nseq):
        ll_code, of_code, ml_code = ll_t.symbol[ll_s], of_t.symbol[of_s], ml_t.symbol[ml_s]
        if of_code > 31:
            raise ValueError(f"zstd: offset code {of_code}")
        offset = (1 << of_code) + read(of_code)
        base, extra = _ML_CODES[ml_code]
        ml = base + read(extra)
        base, extra = _LL_CODES[ll_code]
        ll = base + read(extra)
        if offset > 3:
            offset -= 3
            rep[:] = [offset, rep[0], rep[1]]
        else:
            idx = offset - 1 + (ll == 0)
            if idx == 0:
                offset = rep[0]
            elif idx == 1:
                offset = rep[1]
                rep[:] = [offset, rep[0], rep[2]]
            else:
                offset = rep[2] if idx == 2 else rep[0] - 1
                if offset == 0:
                    raise ValueError("zstd: repeat offset 0")
                rep[:] = [offset, rep[0], rep[1]]
        if k != nseq - 1:
            ll_s = ll_t.base[ll_s] + read(ll_t.nbits[ll_s])
            ml_s = ml_t.base[ml_s] + read(ml_t.nbits[ml_s])
            of_s = of_t.base[of_s] + read(of_t.nbits[of_s])
        if lit_at + ll > len(lit):
            raise ValueError("zstd: a sequence takes more literals than the block has")
        out += lit[lit_at:lit_at + ll]
        lit_at += ll
        start = len(out) - offset
        if start < 0:
            raise ValueError("zstd: a match reaches before the start of the frame (a dictionary?)")
        if offset >= ml:
            out += out[start:start + ml]
        else:
            unit = bytes(out[start:])
            out += (unit * (ml // offset + 1))[:ml]
    if br.pos != 0:
        raise ValueError("zstd: sequence bit stream not fully read")
    out += lit[lit_at:]


# ---- frames ---------------------------------------------------------------

def _frame(data: memoryview, at: int) -> Tuple[bytes, int]:
    """The frame whose header starts at ``data[at]``: (its content, where
    it ends)."""
    fhd = data[at]
    at += 1
    fcs_flag, single, reserved, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 3) & 1, (fhd >> 2) & 1, fhd & 3
    if reserved:
        raise ValueError("zstd: reserved bit set in the frame header")
    if not single:
        at += 1  # window descriptor: the whole frame is decoded in memory
    if dict_flag:
        raise ValueError("zstd: frames that need a dictionary are not read")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[at:at + fcs_size], "little") + (256 if fcs_size == 2 else 0)
        at += fcs_size
    fs, out = _FrameState(), bytearray()
    while True:
        if at + 3 > len(data):
            raise ValueError("zstd: truncated block header")
        h = int.from_bytes(data[at:at + 3], "little")
        at += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            if at + size > len(data):
                raise ValueError("zstd: truncated raw block")
            out += data[at:at + size]
            at += size
        elif kind == 1:
            out += bytes(data[at:at + 1]) * size
            at += 1
        elif kind == 2:
            if size > _MAX_BLOCK or at + size > len(data):
                raise ValueError("zstd: compressed block too large or truncated")
            block = bytes(data[at:at + size])
            lit, used = _literals(block, fs)
            _execute(lit, _sequences(block, used, fs), out, fs.rep)
            at += size
        else:
            raise ValueError("zstd: reserved block type")
        if last:
            break
    if content_size is not None and content_size != len(out):
        raise ValueError(f"zstd: frame holds {len(out)} bytes, its header says {content_size}")
    if checksum:
        if xxh64(bytes(out)) & 0xFFFFFFFF != int.from_bytes(data[at:at + 4], "little"):
            raise ValueError("zstd: content checksum mismatch")
        at += 4
    return bytes(out), at


def decompress(data) -> bytes:
    """Every frame of ``data`` decoded and joined (skippable frames skipped)."""
    data = memoryview(bytes(data))
    if not len(data):
        raise ValueError("zstd: empty input")
    parts, at = [], 0
    while at < len(data):
        if at + 4 > len(data):
            raise ValueError("zstd: truncated frame magic")
        magic = int.from_bytes(data[at:at + 4], "little")
        if magic == ZSTD_MAGIC:
            out, at = _frame(data, at + 4)
            parts.append(out)
        elif magic & _SKIPPABLE_MASK == _SKIPPABLE:
            at += 8 + int.from_bytes(data[at + 4:at + 8], "little")
        else:
            raise ValueError(f"zstd: bad frame magic {magic:#x}")
    if at != len(data):
        raise ValueError("zstd: a skippable frame runs past the end")
    return b"".join(parts)


# ---- XXH64 ------------------------------------------------------------------

_P1, _P2, _P3, _P4, _P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                           0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the zstd content checksum is its low 32 bits)."""
    n, at = len(data), 0
    if n >= 32:
        v1, v2, v3, v4 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        at = (n // 32) * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while at + 8 <= n:
        h = (_rotl(h ^ _round(0, struct.unpack_from("<Q", data, at)[0]), 27) * _P1 + _P4) & _M64
        at += 8
    if at + 4 <= n:
        h = (_rotl(h ^ (struct.unpack_from("<I", data, at)[0] * _P1 & _M64), 23) * _P2 + _P3) & _M64
        at += 4
    while at < n:
        h = (_rotl(h ^ (data[at] * _P5 & _M64), 11) * _P1) & _M64
        at += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)
