# -*- coding: utf-8 -*-
"""CRC32C (Castagnoli), the checksum that ends every OCDBT file: reflected
polynomial 0x82F63B78, initial value and final xor 0xFFFFFFFF, one byte at a
time from a 256-entry table."""
from __future__ import annotations


def _table():
    out = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        out.append(c)
    return tuple(out)


_TABLE = _table()


def crc32c(data, crc: int = 0) -> int:
    """The CRC32C of ``data``, continuing from ``crc`` (0 to start)."""
    c = crc ^ 0xFFFFFFFF
    table = _TABLE
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF
