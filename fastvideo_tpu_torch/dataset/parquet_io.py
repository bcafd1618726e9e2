"""Parquet reader and writer (no ``pyarrow`` package needed).

The reader takes what the JAX package's ``pyarrow`` shards hold:

* the file: ``PAR1``, column chunks, the footer (a Thrift compact-protocol
  ``FileMetaData``), its 4-byte length, ``PAR1``;
* any number of row groups, and of pages a column chunk;
* data pages v1 (repetition and definition levels RLE with a 4-byte
  length, compressed with the values) and v2 (levels uncompressed, their
  lengths in the header);
* a dictionary page, and data pages in RLE_DICTIONARY / PLAIN_DICTIONARY
  or PLAIN, page by page (pyarrow falls back to PLAIN inside one chunk when
  the dictionary outgrows its limit);
* the RLE / bit-packed hybrid of levels and dictionary indices;
* UNCOMPRESSED and SNAPPY pages;
* flat columns (required or optional) of BOOLEAN, INT32, INT64, FLOAT,
  DOUBLE and BYTE_ARRAY (``str`` where annotated UTF8 / STRING, else
  ``bytes``), and one-level lists of them (``list<int32>``: definition
  levels to 3, repetition levels to 1).

Columns come back as Python lists, equal to pyarrow's ``to_pydict()``.
The writer writes one row group a file, data pages v1 of about 1 MiB,
PLAIN values with RLE levels, Snappy (``snappy.compress``: literals, and
copies for runs of one byte).
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np

from fastvideo_tpu_torch.dataset import snappy

MAGIC = b"PAR1"

# parquet.thrift enums
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
REQUIRED, OPTIONAL, REPEATED = range(3)
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
UNCOMPRESSED, SNAPPY = 0, 1
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
CONVERTED_UTF8, CONVERTED_LIST = 0, 3
CODEC_NAMES = {UNCOMPRESSED: "UNCOMPRESSED", SNAPPY: "SNAPPY", 2: "GZIP",
               3: "LZO", 4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODING_NAMES = {PLAIN: "PLAIN", PLAIN_DICTIONARY: "PLAIN_DICTIONARY",
                  RLE: "RLE", 4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                  6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                  RLE_DICTIONARY: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
_NP_TYPES = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}

PAGE_BYTES = 1 << 20


class ParquetError(ValueError):
    pass


# -- Thrift compact protocol --------------------------------------------------

# compact type codes
_T_TRUE, _T_FALSE, _T_I8, _T_I16, _T_I32, _T_I64, _T_DOUBLE = range(1, 8)
_T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = 8, 9, 10, 11, 12


class _ThriftReader:
    """Decodes compact-protocol structs into ``{field id: value}`` dicts
    (lists as lists, binaries as bytes)."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def uvarint(self) -> int:
        buf, pos = self.buf, self.pos
        result = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                self.pos = pos
                return result
            shift += 7

    def zigzag(self) -> int:
        n = self.uvarint()
        return (n >> 1) ^ -(n & 1)

    def value(self, ttype: int) -> Any:
        if ttype in (_T_I16, _T_I32, _T_I64):
            return self.zigzag()
        if ttype == _T_BINARY:
            n = self.uvarint()
            self.pos += n
            return bytes(self.buf[self.pos - n:self.pos])
        if ttype == _T_STRUCT:
            return self.struct()
        if ttype in (_T_LIST, _T_SET):
            head = self.buf[self.pos]
            self.pos += 1
            size, etype = head >> 4, head & 0x0F
            if size == 15:
                size = self.uvarint()
            if etype in (_T_TRUE, _T_FALSE):  # a bool element is one byte
                self.pos += size
                return [b == 1 for b in self.buf[self.pos - size:self.pos]]
            return [self.value(etype) for _ in range(size)]
        if ttype == _T_I8:
            self.pos += 1
            return struct.unpack_from("<b", self.buf, self.pos - 1)[0]
        if ttype == _T_DOUBLE:
            self.pos += 8
            return struct.unpack_from("<d", self.buf, self.pos - 8)[0]
        if ttype == _T_MAP:
            size = self.uvarint()
            if not size:
                return {}
            kinds = self.buf[self.pos]
            self.pos += 1
            return {self.value(kinds >> 4): self.value(kinds & 0x0F)
                    for _ in range(size)}
        raise ParquetError(f"unknown thrift type {ttype}")

    def struct(self) -> dict[int, Any]:
        out: dict[int, Any] = {}
        last = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == 0:
                return out
            ttype, delta = head & 0x0F, head >> 4
            fid = last + delta if delta else self.zigzag()
            last = fid
            if ttype == _T_TRUE:
                out[fid] = True
            elif ttype == _T_FALSE:
                out[fid] = False
            else:
                out[fid] = self.value(ttype)


def _uvarint_bytes(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _zigzag_bytes(n: int) -> bytes:
    return _uvarint_bytes((n << 1) ^ (n >> 63))


_ELEMENT_TYPES = {"i32": _T_I32, "i64": _T_I64, "bin": _T_BINARY,
                  "struct": _T_STRUCT}


def _encode_value(kind: str, value: Any) -> tuple[int, bytes]:
    """(compact type, bytes) of a value: kinds i32, i64, bin, struct
    (a list of (field id, kind, value)) and list:<element kind>."""
    if kind in ("i32", "i64"):
        return (_T_I32 if kind == "i32" else _T_I64), _zigzag_bytes(value)
    if kind == "bin":
        raw = value.encode() if isinstance(value, str) else bytes(value)
        return _T_BINARY, _uvarint_bytes(len(raw)) + raw
    if kind == "struct":
        return _T_STRUCT, _encode_struct(value)
    if kind.startswith("list:"):
        ekind = kind[5:]
        parts = [_encode_value(ekind, v) for v in value]
        etype = _ELEMENT_TYPES[ekind]
        n = len(value)
        head = (bytes([(n << 4) | etype]) if n < 15 else
                bytes([0xF0 | etype]) + _uvarint_bytes(n))
        return _T_LIST, head + b"".join(p for _, p in parts)
    raise ParquetError(f"unknown thrift kind {kind}")


def _encode_struct(fields: list[tuple[int, str, Any]]) -> bytes:
    out = bytearray()
    last = 0
    for fid, kind, value in fields:
        if value is None:
            continue
        if kind == "bool":
            ttype, payload = (_T_TRUE if value else _T_FALSE), b""
        else:
            ttype, payload = _encode_value(kind, value)
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | ttype)
        else:
            out.append(ttype)
            out += _zigzag_bytes(fid)
        out += payload
        last = fid
    out.append(0)
    return bytes(out)


# -- the RLE / bit-packed hybrid ----------------------------------------------

def _unpack_bits(raw, bit_width: int, count: int) -> np.ndarray:
    """``count`` little-endian bit-packed values of ``bit_width`` bits."""
    if bit_width == 0:
        return np.zeros(count, np.int64)
    bits = np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="little")
    bits = bits[:count * bit_width].reshape(count, bit_width)
    return bits.astype(np.int64) @ (np.int64(1) << np.arange(
        bit_width, dtype=np.int64))


def decode_hybrid(buf, pos: int, end: int, bit_width: int,
                  count: int) -> np.ndarray:
    """``count`` values of the RLE / bit-packed hybrid in buf[pos:end]."""
    out = np.zeros(count, np.int64)
    n = 0
    byte_w = (bit_width + 7) // 8
    reader = _ThriftReader(buf, pos)
    while n < count:
        if reader.pos >= end:
            raise ParquetError(f"hybrid data ends after {n} of {count} "
                               "values")
        header = reader.uvarint()
        pos = reader.pos
        if header & 1:  # bit-packed groups of 8 values
            groups = header >> 1
            nbytes = groups * bit_width
            vals = _unpack_bits(buf[pos:pos + nbytes], bit_width, groups * 8)
            take = min(groups * 8, count - n)
            out[n:n + take] = vals[:take]
            pos += nbytes
        else:  # a run of one value
            take = min(header >> 1, count - n)
            out[n:n + take] = int.from_bytes(bytes(buf[pos:pos + byte_w]),
                                             "little")
            pos += byte_w
        n += take
        reader.pos = pos
    return out


def encode_rle(values: np.ndarray, bit_width: int) -> bytes:
    """The hybrid's RLE runs of ``values`` (one run a change of value)."""
    values = np.asarray(values)
    out = bytearray()
    byte_w = (bit_width + 7) // 8
    if values.size == 0:
        return b""
    edges = np.flatnonzero(np.diff(values)) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [values.size]])
    for s, e in zip(starts.tolist(), ends.tolist()):
        out += _uvarint_bytes((e - s) << 1)
        out += int(values[s]).to_bytes(byte_w, "little")
    return bytes(out)


# -- the schema ---------------------------------------------------------------

class Column:
    """A leaf column: its name (the top-level field), physical type,
    levels and whether it is a one-level list."""

    def __init__(self, name: str, ptype: int, max_def: int, max_rep: int,
                 is_string: bool, list_def: int | None = None):
        self.name = name
        self.ptype = ptype
        self.max_def = max_def
        self.max_rep = max_rep
        self.is_string = is_string
        # lists: the definition level of a present (maybe empty) list
        self.list_def = list_def


def _is_string(el: dict) -> bool:
    logical = el.get(10) or {}
    return el.get(6) == CONVERTED_UTF8 or 1 in logical


def _columns(schema: list[dict]) -> list[Column]:
    """Leaf columns of a flattened schema (each top-level field a flat
    leaf or a one-level list)."""
    root, pos = schema[0], 1
    cols = []
    for _ in range(root.get(5, 0)):
        el = schema[pos]
        name = el[4].decode()
        rep = el.get(3, REQUIRED)
        if rep == REPEATED:
            raise ParquetError(f"column {name}: a repeated top-level field")
        d = int(rep == OPTIONAL)
        if not el.get(5):
            cols.append(Column(name, el[1], d, 0, _is_string(el)))
            pos += 1
            continue
        # a LIST group: <optional|required> group (LIST) { repeated group
        # list { <optional|required> element } }
        mid = schema[pos + 1] if pos + 1 < len(schema) else {}
        leaf = schema[pos + 2] if pos + 2 < len(schema) else {}
        if (el.get(5) != 1 or mid.get(3) != REPEATED or mid.get(5) != 1
                or leaf.get(5)):
            raise ParquetError(f"column {name}: only flat columns and "
                               "one-level lists are read")
        max_def = d + 1 + int(leaf.get(3, REQUIRED) == OPTIONAL)
        cols.append(Column(name, leaf[1], max_def, 1, _is_string(leaf),
                           list_def=d))
        pos += 3
    return cols


# -- values -------------------------------------------------------------------

def _plain(buf, ptype: int, count: int, is_string: bool) -> list:
    """``count`` PLAIN values from the start of ``buf``."""
    if ptype == BYTE_ARRAY:
        out, pos = [], 0
        mv = memoryview(buf)
        for _ in range(count):
            (n,) = struct.unpack_from("<I", buf, pos)
            raw = bytes(mv[pos + 4:pos + 4 + n])
            out.append(raw.decode() if is_string else raw)
            pos += 4 + n
        return out
    if ptype == BOOLEAN:
        bits = np.unpackbits(np.frombuffer(buf, np.uint8, (count + 7) // 8),
                             bitorder="little")
        return bits[:count].astype(bool).tolist()
    if ptype in _NP_TYPES:
        return np.frombuffer(buf, _NP_TYPES[ptype], count).tolist()
    raise ParquetError(f"physical type {ptype} is not read")


def _decompress(codec: int, raw, size: int):
    if codec == UNCOMPRESSED:
        return raw
    if codec == SNAPPY:
        out = snappy.decompress(raw)
        if len(out) != size:
            raise ParquetError(f"page of {len(out)} bytes, header says {size}")
        return out
    raise ParquetError(f"compression {CODEC_NAMES.get(codec, codec)} is not "
                       "read (UNCOMPRESSED and SNAPPY are)")


def _assemble(col: Column, defs, reps, values: list) -> list:
    """Rows of a column from its levels and its non-null values."""
    n = len(defs) if defs is not None else len(values)
    if col.max_rep == 0:
        if col.max_def == 0 or bool((defs == col.max_def).all()):
            return values
        rows: list = [None] * n
        it = iter(values)
        for i in np.flatnonzero(defs == col.max_def).tolist():
            rows[i] = next(it)
        return rows
    rows, it = [], iter(values)
    for d, r in zip(defs.tolist(), reps.tolist()):
        if r == 0:
            if d < col.list_def:
                rows.append(None)
                continue
            rows.append([])
            if d == col.list_def:
                continue
        rows[-1].append(next(it) if d == col.max_def else None)
    return rows


def _levels(buf, pos: int, end: int, max_level: int, count: int):
    return decode_hybrid(buf, pos, end, max_level.bit_length(), count)


def _read_chunk(fh, col: Column, meta: dict) -> list:
    """All rows of one column chunk."""
    codec = meta[4]
    num_values = meta[5]
    start = meta[9]
    if meta.get(11) is not None and 0 < meta[11] < start:
        start = meta[11]
    fh.seek(start)
    data = fh.read(meta[7])
    pos = 0
    dictionary = None
    defs, reps, values = [], [], []
    seen = 0
    while seen < num_values:
        if pos >= len(data):
            raise ParquetError(f"column {col.name}: chunk ends after {seen} "
                               f"of {num_values} values")
        reader = _ThriftReader(data, pos)
        header = reader.struct()
        pos = reader.pos
        kind, size, csize = header[1], header[2], header[3]
        payload = memoryview(data)[pos:pos + csize]
        pos += csize
        if kind == DICTIONARY_PAGE:
            dh = header[7]
            if dh[2] not in (PLAIN, PLAIN_DICTIONARY):
                raise ParquetError(f"dictionary encoding {dh[2]}")
            dictionary = _plain(_decompress(codec, payload, size), col.ptype,
                                dh[1], col.is_string)
            continue
        if kind == DATA_PAGE:
            dh = header[5]
            count, encoding = dh[1], dh[2]
            page = _decompress(codec, payload, size)
            p = 0
            rep = dfn = None
            if col.max_rep:
                (n,) = struct.unpack_from("<I", page, p)
                rep = _levels(page, p + 4, p + 4 + n, col.max_rep, count)
                p += 4 + n
            if col.max_def:
                (n,) = struct.unpack_from("<I", page, p)
                dfn = _levels(page, p + 4, p + 4 + n, col.max_def, count)
                p += 4 + n
            body = memoryview(page)[p:]
        elif kind == DATA_PAGE_V2:
            dh = header[8]
            count, encoding = dh[1], dh[4]
            dlen, rlen = dh[5], dh[6]
            rep = (_levels(payload, 0, rlen, col.max_rep, count)
                   if col.max_rep else None)
            dfn = (_levels(payload, rlen, rlen + dlen, col.max_def, count)
                   if col.max_def else None)
            rest = payload[rlen + dlen:]
            compressed = dh.get(7, True)
            body = memoryview(_decompress(
                codec if compressed else UNCOMPRESSED, rest,
                size - rlen - dlen))
        elif kind == INDEX_PAGE:
            continue
        else:
            raise ParquetError(f"page type {kind}")
        present = (count if dfn is None else
                   int((dfn == col.max_def).sum()))
        if encoding == PLAIN:
            vals = _plain(body, col.ptype, present, col.is_string)
        elif encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ParquetError(f"column {col.name}: dictionary-encoded "
                                   "page without a dictionary page")
            idx = (decode_hybrid(body, 1, len(body), body[0], present)
                   if present else np.zeros(0, np.int64))
            vals = [dictionary[i] for i in idx.tolist()]
        elif encoding == RLE and col.ptype == BOOLEAN:
            (n,) = struct.unpack_from("<I", body, 0)
            vals = decode_hybrid(body, 4, 4 + n, 1,
                                 present).astype(bool).tolist()
        else:
            raise ParquetError(f"column {col.name}: encoding "
                               f"{ENCODING_NAMES.get(encoding, encoding)} "
                               "is not read")
        values.extend(vals)
        if dfn is not None:
            defs.append(dfn)
        if rep is not None:
            reps.append(rep)
        seen += count
    return _assemble(col, np.concatenate(defs) if defs else None,
                     np.concatenate(reps) if reps else None, values)


class ParquetFile:
    """One Parquet file: its footer, and its columns on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            if size < 12:
                raise ParquetError(f"{path}: not a Parquet file")
            fh.seek(size - 8)
            tail = fh.read(8)
            if tail[4:] != MAGIC:
                raise ParquetError(f"{path}: not a Parquet file")
            (n,) = struct.unpack("<I", tail[:4])
            fh.seek(size - 8 - n)
            self.metadata = _ThriftReader(fh.read(n)).struct()
        self.columns = _columns(self.metadata[2])
        self.num_rows = int(self.metadata[3])
        self.row_groups = self.metadata.get(4, [])

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def read_row_group(self, index: int,
                       columns: list[str] | None = None) -> dict[str, list]:
        names = columns if columns is not None else self.column_names
        chunks = self.row_groups[index][1]
        out = {}
        with open(self.path, "rb") as fh:
            for name in names:
                i = self.column_names.index(name)
                out[name] = _read_chunk(fh, self.columns[i], chunks[i][3])
        return out

    def read(self, columns: list[str] | None = None) -> dict[str, list]:
        """The whole file as ``{column: list of rows}``."""
        names = columns if columns is not None else self.column_names
        for name in names:
            if name not in self.column_names:
                raise KeyError(f"{self.path} has no column {name!r}")
        out: dict[str, list] = {n: [] for n in names}
        for g in range(len(self.row_groups)):
            for name, rows in self.read_row_group(g, names).items():
                out[name].extend(rows)
        return out


def read_table(path: str, columns: list[str] | None = None
               ) -> dict[str, list]:
    return ParquetFile(path).read(columns)


# -- the writer ---------------------------------------------------------------

# column kinds -> (physical type, string, list)
KINDS = {
    "string": (BYTE_ARRAY, True, False), "binary": (BYTE_ARRAY, False, False),
    "int32": (INT32, False, False), "int64": (INT64, False, False),
    "float32": (FLOAT, False, False), "float64": (DOUBLE, False, False),
    "bool": (BOOLEAN, False, False), "list<int32>": (INT32, False, True),
}


def _plain_bytes(ptype: int, values: list) -> bytes:
    if ptype == BYTE_ARRAY:
        parts = []
        for v in values:
            raw = v.encode() if isinstance(v, str) else bytes(v)
            parts.append(struct.pack("<I", len(raw)))
            parts.append(raw)
        return b"".join(parts)
    if ptype == BOOLEAN:
        return np.packbits(np.asarray(values, bool),
                           bitorder="little").tobytes()
    return np.asarray(values, _NP_TYPES[ptype]).tobytes()


def _schema_elements(schema: list[tuple[str, str]]) -> list:
    els = [[(4, "bin", "schema"), (5, "i32", len(schema))]]
    for name, kind in schema:
        ptype, is_str, is_list = KINDS[kind]
        leaf = [(1, "i32", ptype), (3, "i32", OPTIONAL)]
        ann = ([(6, "i32", CONVERTED_UTF8),
                (10, "struct", [(1, "struct", [])])] if is_str else [])
        if is_list:
            els.append([(3, "i32", OPTIONAL), (4, "bin", name),
                        (5, "i32", 1), (6, "i32", CONVERTED_LIST),
                        (10, "struct", [(3, "struct", [])])])
            els.append([(3, "i32", REPEATED), (4, "bin", "list"),
                        (5, "i32", 1)])
            els.append(leaf[:2] + [(4, "bin", "element")] + ann)
        else:
            els.append(leaf + [(4, "bin", name)] + ann)
    return els


def _levels_of(rows: list, is_list: bool):
    """(definition levels, repetition levels or None, non-null values)."""
    if not is_list:
        defs = np.array([v is not None for v in rows], np.int64)
        return defs, None, [v for v in rows if v is not None]
    defs, reps, values = [], [], []
    for row in rows:
        if row is None:
            defs.append(0)
            reps.append(0)
        elif len(row) == 0:
            defs.append(1)
            reps.append(0)
        else:
            for j, v in enumerate(row):
                defs.append(2 if v is None else 3)
                reps.append(0 if j == 0 else 1)
                if v is not None:
                    values.append(v)
    return np.array(defs, np.int64), np.array(reps, np.int64), values


def _page_slices(rows: list) -> list[tuple[int, int]]:
    """Row ranges of about PAGE_BYTES of values each (a page starts at a
    row, and holds at least one)."""
    out, start, acc = [], 0, 0
    for i, row in enumerate(rows):
        acc += (len(row) if isinstance(row, (bytes, str)) else
                4 * (len(row) if isinstance(row, list) else 1)
                if row is not None else 0)
        if acc >= PAGE_BYTES:
            out.append((start, i + 1))
            start, acc = i + 1, 0
    if start < len(rows) or not out:
        out.append((start, len(rows)))
    return out


def write_table(path: str, data: dict[str, list],
                schema: list[tuple[str, str]]) -> None:
    """One row group of ``data`` ({column: rows}) in the column kinds of
    ``schema`` (:data:`KINDS`), Snappy-compressed; every column optional."""
    num_rows = len(next(iter(data.values()))) if data else 0
    chunks = []
    body = bytearray(MAGIC)
    for name, kind in schema:
        rows = data[name]
        if len(rows) != num_rows:
            raise ParquetError(f"column {name}: {len(rows)} rows, not "
                               f"{num_rows}")
        ptype, _, is_list = KINDS[kind]
        start = len(body)
        n_values = raw_total = 0
        for lo, hi in _page_slices(rows):
            defs, reps, values = _levels_of(rows[lo:hi], is_list)
            page = bytearray()
            for levels, top in ((reps, 1), (defs, 3 if is_list else 1)):
                if levels is None:
                    continue
                enc = encode_rle(levels, top.bit_length())
                page += struct.pack("<I", len(enc)) + enc
            page += _plain_bytes(ptype, values)
            packed = snappy.compress(page)
            header = _encode_struct([
                (1, "i32", DATA_PAGE), (2, "i32", len(page)),
                (3, "i32", len(packed)),
                (5, "struct", [(1, "i32", len(defs)), (2, "i32", PLAIN),
                               (3, "i32", RLE), (4, "i32", RLE)])])
            body += header + packed
            raw_total += len(header) + len(page)
            n_values += len(defs)
        path_in_schema = [name, "list", "element"] if is_list else [name]
        meta = [(1, "i32", ptype), (2, "list:i32", [PLAIN, RLE]),
                (3, "list:bin", path_in_schema), (4, "i32", SNAPPY),
                (5, "i64", n_values), (6, "i64", raw_total),
                (7, "i64", len(body) - start), (9, "i64", start)]
        chunks.append((start, meta, len(body) - start, raw_total))
    row_group = [
        (1, "list:struct", [[(2, "i64", s), (3, "struct", m)]
                            for s, m, _, _ in chunks]),
        (2, "i64", sum(r for *_, r in chunks)), (3, "i64", num_rows),
        (5, "i64", chunks[0][0] if chunks else 4),
        (6, "i64", sum(c for _, _, c, _ in chunks)), (7, "i32", 0)]
    footer = _encode_struct([
        (1, "i32", 1), (2, "list:struct", _schema_elements(schema)),
        (3, "i64", num_rows), (4, "list:struct", [row_group]),
        (6, "bin", "fastvideo_tpu_torch parquet_io")])
    body += footer + struct.pack("<I", len(footer)) + MAGIC
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(body)
    os.replace(tmp, path)
