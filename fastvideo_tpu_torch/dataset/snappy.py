"""Raw Snappy blocks (no ``snappy`` package needed), as Parquet stores them.

A block is the uncompressed length as a varint, then elements, each led by
a tag byte whose low two bits give its kind: a literal (its length minus 1
in the tag's upper six bits, or in the 1-4 bytes after it when those bits
read 60-63), or a copy of earlier output (its length and offset packed in
the tag and 1, 2 or 4 bytes after it). A copy whose offset is shorter than
its length repeats the last ``offset`` bytes.

:func:`decompress` builds the output with slice copies of a preallocated
``bytearray``, so its cost goes by the number of elements, not of bytes.
:func:`compress` finds no matches: it emits literals, and for each run of
one repeated byte (the zero rows of a padded text embedding) a literal of
its first byte and copies of offset 1. Other data comes out a few bytes
larger than it went in.
"""

from __future__ import annotations

import numpy as np

# the encoder's literal size, the reference compressor's block size
_LITERAL = 1 << 16
# runs of one byte at least this long become copies
_MIN_RUN = 16
# a copy of 64 bytes at offset 1: tag (63 << 2) | 2, offset 1 in 2 bytes
_COPY64 = bytes([(63 << 2) | 2, 1, 0])


class SnappyError(ValueError):
    pass


def _uvarint(data, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint longer than 32 bits")


def decompress(data) -> bytearray:
    """The bytes of one raw Snappy block."""
    n, pos = _uvarint(data, 0)
    src = memoryview(data)
    out = bytearray(n)
    o, end = 0, len(data)
    while pos < end:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(src[pos:pos + nb], "little")
                pos += nb
            ln += 1
            if o + ln > n or pos + ln > end:
                raise SnappyError("literal runs past the block")
            out[o:o + ln] = src[pos:pos + ln]
            pos += ln
            o += ln
            continue
        if pos + (1 << (kind - 1)) > end:
            raise SnappyError("copy runs past the block")
        if kind == 1:
            ln = 4 + ((tag >> 2) & 7)
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = data[pos] | (data[pos + 1] << 8)
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > o or o + ln > n:
            raise SnappyError(f"bad copy: offset {off} length {ln} at {o}")
        s = o - off
        if off >= ln:
            out[o:o + ln] = out[s:s + ln]
        else:  # the copy overlaps its own output: a repeating pattern
            out[o:o + ln] = (out[s:o] * (ln // off + 1))[:ln]
        o += ln
    if o != n:
        raise SnappyError(f"block holds {o} bytes, its header says {n}")
    return out


def _varint_bytes(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _literals(out: bytearray, src) -> None:
    for i in range(0, len(src), _LITERAL):
        chunk = src[i:i + _LITERAL]
        m = len(chunk) - 1
        if m < 60:
            out.append(m << 2)
        else:
            nb = (m.bit_length() + 7) // 8
            out.append((59 + nb) << 2)
            out += m.to_bytes(nb, "little")
        out += chunk


_UNIFORM = np.uint64(0x0101010101010101)


def _runs(src) -> list[tuple[int, int]]:
    """(start, end) of the maximal runs of one byte of at least
    ``_MIN_RUN``. Such a run holds a whole aligned 8-byte word of one byte,
    so the scan looks for those words first (one pass over the data as
    uint64, which finds none in random data), groups neighbouring ones of
    the same byte, and widens each group by the equal bytes on either side
    (at most 7: the word beyond is not uniform)."""
    arr = np.frombuffer(src, np.uint8)
    n = arr.size
    if n < _MIN_RUN:
        return []
    nw = n // 8
    words = arr[:nw * 8].view(np.uint64)
    low = words & np.uint64(0xFF)
    idx = np.flatnonzero(words == low * _UNIFORM)
    if idx.size == 0:
        return []
    val = arr[idx * 8]
    new = np.ones(idx.size, bool)
    new[1:] = (idx[1:] != idx[:-1] + 1) | (val[1:] != val[:-1])
    first = np.flatnonzero(new)
    last = np.append(first[1:], idx.size) - 1
    starts, ends, val = idx[first] * 8, idx[last] * 8 + 8, val[first]
    grow = np.ones(starts.size, bool)
    for k in range(1, 8):  # equal bytes before each group
        pos = starts - 1
        grow &= (pos >= 0) & (arr[np.maximum(pos, 0)] == val)
        starts = starts - grow
    grow = np.ones(ends.size, bool)
    for k in range(1, 8):  # and after it
        grow &= (ends < n) & (arr[np.minimum(ends, n - 1)] == val)
        ends = ends + grow
    keep = ends - starts >= _MIN_RUN
    return list(zip(starts[keep].tolist(), ends[keep].tolist()))


def compress(data) -> bytes:
    """A raw Snappy block of ``data``: literals, and copies of offset 1 for
    runs of one repeated byte."""
    src = memoryview(data).cast("B")
    out = bytearray(_varint_bytes(len(src)))
    pos = 0
    for start, end in _runs(src):
        _literals(out, src[pos:start + 1])
        n = end - start - 1
        out += _COPY64 * (n // 64)
        if n % 64:
            out += bytes([((n % 64 - 1) << 2) | 2, 1, 0])
        pos = end
    _literals(out, src[pos:])
    return bytes(out)
