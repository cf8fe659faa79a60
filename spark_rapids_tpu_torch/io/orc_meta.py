"""ORC file metadata on the host (port of the host half of
spark_rapids_tpu/io/orc_device.py: `_Proto` :57, `decompress_blocks` :185,
`tail_compression` :225 and `parse_file_meta` :241 (the codec is refused
from the PostScript, before the Footer is read), `_walk_stripe_footer`
:338, `parse_stripe_footer` :375 and `normalize_stripe` :383 (one stripe
image for every codec), `column_eligible` :736 (the types of
`KIND_DTYPES`; io/orc_device.py:plan_column checks encodings) and
`present_count` :759 (counted in the native byte-RLE walk)).

ORC metadata is plain protobuf: PostScript -> Footer (stripes, types,
row count) -> one StripeFooter a stripe (streams, column encodings, the
writer's timezone). Compressed files frame every stream and metadata
section as blocks with a 3-byte header; ZLIB blocks inflate through
Python's zlib (raw deflate), SNAPPY blocks through the port's native
codec. ZSTD, LZ4 and LZO files raise a ValueError that names the codec:
neither machine has a codec for them, and the port has no host reader to
hand them to. Nested types, DECIMAL, BINARY, BYTE, CHAR and VARCHAR
columns raise the same way (the reference read them through Arrow).
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar.dtypes import DataType

MAGIC = b"ORC"


class OrcFormatError(ValueError):
    """An ORC file or column the port does not read, named."""


class _Proto:
    """Protobuf wire-format reader over buf[start:end)."""

    def __init__(self, buf, start: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = start
        self.end = len(buf) if end is None else end

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= self.end or shift > 70:
                raise OrcFormatError("malformed protobuf varint")
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def fields(self):
        """(field number, wire type, value): an int for varints, bytes for
        length-delimited and fixed fields."""
        while self.pos < self.end:
            tag = self.varint()
            fnum, wt = tag >> 3, tag & 7
            if wt == 0:
                yield fnum, wt, self.varint()
            elif wt in (1, 2, 5):
                n = {1: 8, 5: 4}.get(wt) or self.varint()
                if n > self.end - self.pos:
                    raise OrcFormatError("malformed protobuf length")
                yield fnum, wt, bytes(self.buf[self.pos:self.pos + n])
                self.pos += n
            else:
                raise OrcFormatError(f"protobuf wire type {wt}")


# Type.Kind
K_BOOL, K_BYTE, K_SHORT, K_INT, K_LONG = 0, 1, 2, 3, 4
K_FLOAT, K_DOUBLE, K_STRING, K_BINARY, K_TIMESTAMP = 5, 6, 7, 8, 9
K_LIST, K_MAP, K_STRUCT, K_UNION, K_DECIMAL = 10, 11, 12, 13, 14
K_DATE, K_VARCHAR, K_CHAR, K_TIMESTAMP_INSTANT = 15, 16, 17, 18
KIND_NAMES = ("BOOLEAN", "BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE",
              "STRING", "BINARY", "TIMESTAMP", "LIST", "MAP", "STRUCT",
              "UNION", "DECIMAL", "DATE", "VARCHAR", "CHAR",
              "TIMESTAMP_INSTANT")
# the kinds the device decodes, and their types (reference :736)
KIND_DTYPES = {K_BOOL: DataType.BOOL, K_SHORT: DataType.INT16,
               K_INT: DataType.INT32, K_LONG: DataType.INT64,
               K_FLOAT: DataType.FLOAT32, K_DOUBLE: DataType.FLOAT64,
               K_STRING: DataType.STRING, K_TIMESTAMP: DataType.TIMESTAMP,
               K_DATE: DataType.DATE}

# Stream.Kind
S_PRESENT, S_DATA, S_LENGTH, S_DICT, S_SECONDARY = 0, 1, 2, 3, 5
# ColumnEncoding.Kind
E_DIRECT, E_DICT, E_DIRECT_V2, E_DICT_V2 = 0, 1, 2, 3
# CompressionKind
COMP_NONE, COMP_ZLIB, COMP_SNAPPY, COMP_LZO, COMP_LZ4, COMP_ZSTD = range(6)
COMP_NAMES = ("NONE", "ZLIB", "SNAPPY", "LZO", "LZ4", "ZSTD")
SUPPORTED_COMPRESSION = (COMP_NONE, COMP_ZLIB, COMP_SNAPPY)
UTC_ZONES = ("UTC", "GMT", "Etc/UTC", "")
# threads that inflate one stripe's streams
HOST_THREADS = 8


@dataclass
class StripeInfo:
    offset: int = 0
    index_length: int = 0
    data_length: int = 0
    footer_length: int = 0
    num_rows: int = 0


@dataclass
class OrcColumn:
    name: str
    cid: int          # column id in the file
    dtype: Optional[DataType]  # None: the port does not read it
    unsupported: str = ""


@dataclass
class OrcMeta:
    compression: int = COMP_NONE
    stripes: List[StripeInfo] = field(default_factory=list)
    columns: List[OrcColumn] = field(default_factory=list)

    def column(self, name: str) -> OrcColumn:
        for c in self.columns:
            if c.name == name:
                return c
        raise OrcFormatError(f"column {name!r} is not in the file")


@dataclass
class StreamLoc:
    kind: int
    column: int
    start: int   # offset into the buffer the footer walk was given
    length: int


def codec_error(kind: int) -> OrcFormatError:
    name = COMP_NAMES[kind] if 0 <= kind < len(COMP_NAMES) else str(kind)
    return OrcFormatError(
        f"ORC compression {name} is not supported (NONE, ZLIB and SNAPPY "
        "are; ZSTD, LZ4 and LZO are queued)")


def _inflate(kind: int, chunk) -> bytes:
    if kind == COMP_ZLIB:
        return zlib.decompress(chunk, -15)  # raw deflate per the ORC spec
    if kind == COMP_SNAPPY:
        return native.snappy_decompress(chunk)
    raise codec_error(kind)


def _type_of(v: bytes) -> Tuple[int, List[int], List[str]]:
    kind, subtypes, names = 0, [], []
    for f2, w2, v2 in _Proto(v).fields():
        if f2 == 1:
            kind = v2
        elif f2 == 2:
            if w2 == 0:
                subtypes.append(v2)
            else:  # packed
                p = _Proto(v2)
                while p.pos < p.end:
                    subtypes.append(p.varint())
        elif f2 == 3:
            names.append(v2.decode("utf-8"))
    return kind, subtypes, names


def _why_not(kind: int, subtypes: List[int]) -> str:
    if kind in KIND_DTYPES:
        return ""
    name = KIND_NAMES[kind] if 0 <= kind < len(KIND_NAMES) else str(kind)
    if kind in (K_LIST, K_MAP, K_STRUCT, K_UNION):
        return f"nested type {name} is not read (flat schemas only)"
    return (f"type {name} is not read (BOOLEAN, SHORT, INT, LONG, DATE, "
            "FLOAT, DOUBLE, STRING and TIMESTAMP are)")


def parse_file_meta(tail: bytes, file_size: Optional[int] = None) -> OrcMeta:
    """PostScript -> Footer from the file's tail (at least the PostScript,
    the Footer and the byte after them; the whole file will do)."""
    file_size = len(tail) if file_size is None else file_size
    if len(tail) < 4 or (file_size == len(tail) and tail[:3] != MAGIC):
        raise OrcFormatError("not an ORC file")
    psl = tail[-1]
    footer_len = 0
    meta = OrcMeta()
    for fnum, _wt, v in _Proto(tail, len(tail) - 1 - psl,
                               len(tail) - 1).fields():
        if fnum == 1:
            footer_len = v
        elif fnum == 2:
            meta.compression = v
    if meta.compression not in SUPPORTED_COMPRESSION:
        raise codec_error(meta.compression)
    fstart = len(tail) - 1 - psl - footer_len
    if fstart < 0:
        raise OrcFormatError("truncated ORC tail")
    fbuf = decompress_blocks(tail, fstart, footer_len, meta.compression)
    types = []
    for fnum, _wt, v in _Proto(fbuf).fields():
        if fnum == 3:  # StripeInformation
            si = StripeInfo()
            for f2, _w2, v2 in _Proto(v).fields():
                if f2 == 1:
                    si.offset = v2
                elif f2 == 2:
                    si.index_length = v2
                elif f2 == 3:
                    si.data_length = v2
                elif f2 == 4:
                    si.footer_length = v2
                elif f2 == 5:
                    si.num_rows = v2
            meta.stripes.append(si)
        elif fnum == 4:
            types.append(_type_of(v))
    if not types or types[0][0] != K_STRUCT:
        raise OrcFormatError("the ORC root type is not a struct")
    _root_kind, root_sub, root_names = types[0]
    for name, cid in zip(root_names, root_sub):
        if cid >= len(types):
            raise OrcFormatError(f"column {name!r}: type id {cid} past the "
                                 "footer's types")
        kind, sub, _ = types[cid]
        why = _why_not(kind, sub)
        meta.columns.append(OrcColumn(name, cid, None if why else
                                      KIND_DTYPES[kind], why))
    return meta


def read_file_meta(path: str) -> OrcMeta:
    """The metadata of one file, from its tail alone."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < 4:
            raise OrcFormatError(f"{path}: not an ORC file")
        f.seek(max(0, size - 256))
        tail = f.read()
        psl = tail[-1]
        try:
            ps = {fnum: v for fnum, _w, v in _Proto(
                tail, len(tail) - 1 - psl, len(tail) - 1).fields()}
        except OrcFormatError:
            raise OrcFormatError(f"{path}: not an ORC file") from None
        if ps.get(2, COMP_NONE) not in SUPPORTED_COMPRESSION:
            raise OrcFormatError(f"{path}: {codec_error(ps[2])}")
        footer_len = ps.get(1, 0)
        need = footer_len + psl + 1
        if need > len(tail):
            f.seek(max(0, size - need))
            tail = f.read()
        f.seek(0)
        if f.read(3) != MAGIC:
            raise OrcFormatError(f"{path}: not an ORC file")
    try:
        return parse_file_meta(tail, size)
    except OrcFormatError as e:
        raise OrcFormatError(f"{path}: {e}") from None


def _walk_stripe_footer(fbuf) -> Tuple[List[StreamLoc],
                                       Dict[int, Tuple[int, int]], str]:
    """StripeFooter -> (stream locations laid out from 0 in declaration
    order, column encodings (kind, dictionary size), writer timezone)."""
    streams: List[StreamLoc] = []
    encodings: Dict[int, Tuple[int, int]] = {}
    tz = ""
    pos = 0
    for fnum, _wt, v in _Proto(fbuf).fields():
        if fnum == 1:  # Stream
            kind = column = length = 0
            for f2, _w2, v2 in _Proto(v).fields():
                if f2 == 1:
                    kind = v2
                elif f2 == 2:
                    column = v2
                elif f2 == 3:
                    length = v2
            streams.append(StreamLoc(kind, column, pos, length))
            pos += length
        elif fnum == 2:  # ColumnEncoding {kind, dictionarySize}
            enc = dict_size = 0
            for f2, _w2, v2 in _Proto(v).fields():
                if f2 == 1:
                    enc = v2
                elif f2 == 2:
                    dict_size = v2
            encodings[len(encodings)] = (enc, dict_size)
        elif fnum == 3:  # writerTimezone
            tz = v.decode("utf-8", "replace")
    return streams, encodings, tz


@dataclass
class StripeImage:
    """One stripe's streams of the columns read, uncompressed and laid end
    to end in `buf` (the upload), with their locations in it."""

    buf: np.ndarray
    streams: List[StreamLoc]
    encodings: Dict[int, Tuple[int, int]]
    timezone: str
    num_rows: int


def _blocks(raw, start: int, length: int):
    """(is_original, block) of one compressed stream's framing."""
    view = memoryview(raw)
    pos, end = start, start + length
    out = []
    while pos < end:
        if pos + 3 > end:
            raise OrcFormatError("truncated compressed ORC stream")
        h = view[pos] | (view[pos + 1] << 8) | (view[pos + 2] << 16)
        pos += 3
        if pos + (h >> 1) > end:
            raise OrcFormatError("a compressed ORC block overruns its stream")
        out.append((h & 1, view[pos:pos + (h >> 1)]))
        pos += h >> 1
    return out


def decompress_blocks(raw, start: int, length: int, kind: int) -> bytes:
    """One compressed stream or metadata section: blocks of a 3-byte
    little-endian header (length << 1 | is_original) and the block."""
    if kind == COMP_NONE:
        return bytes(raw[start:start + length])
    return b"".join(bytes(b) if orig else _inflate(kind, b)
                    for orig, b in _blocks(raw, start, length))


def normalize_stripe(payloads, keep: List[StreamLoc], compression: int,
                     pin_alloc=None) -> Tuple[np.ndarray, List[StreamLoc]]:
    """The streams `keep` (their compressed bytes `payloads`) uncompressed
    into one buffer (pin_alloc(n) gives it, e.g. in pinned memory), on
    threads: a SNAPPY stream in one native call, ZLIB a block at a time
    (zlib releases the GIL). Returns the buffer and the streams' places
    in it."""
    with ThreadPoolExecutor(max_workers=HOST_THREADS) as ex:
        if compression == COMP_SNAPPY:
            try:
                sizes = [native.orc_snappy_stream(p, 0, len(p))
                         for p in payloads]
            except ValueError as e:
                raise OrcFormatError(str(e)) from None
        elif compression == COMP_ZLIB:
            blocks = [_blocks(p, 0, len(p)) for p in payloads]
            flat = list(ex.map(lambda b: bytes(b[1]) if b[0] else
                               _inflate(COMP_ZLIB, b[1]),
                               [b for bl in blocks for b in bl]))
            parts, k = [], 0
            for bl in blocks:
                parts.append(flat[k:k + len(bl)])
                k += len(bl)
            sizes = [sum(len(p) for p in ps) for ps in parts]
        elif compression == COMP_NONE:
            sizes = [len(p) for p in payloads]
        else:
            raise codec_error(compression)
        total = sum(sizes)
        buf = pin_alloc(total) if pin_alloc else np.empty(total, np.uint8)
        out: List[StreamLoc] = []
        pos = 0
        for s, n in zip(keep, sizes):
            out.append(StreamLoc(s.kind, s.column, pos, n))
            pos += n

        def fill(i: int) -> None:
            o = out[i]
            dst = buf[o.start:o.start + o.length]
            if compression == COMP_SNAPPY:
                native.orc_snappy_stream(payloads[i], 0, len(payloads[i]),
                                         dst)
            elif compression == COMP_ZLIB:
                at = 0
                for p in parts[i]:
                    dst[at:at + len(p)] = np.frombuffer(p, np.uint8)
                    at += len(p)
            else:
                dst[:] = np.frombuffer(payloads[i], np.uint8)

        list(ex.map(fill, range(len(keep))))
    return buf, out


def _stripe_footer(f, si: StripeInfo, compression: int):
    f.seek(si.offset + si.index_length + si.data_length)
    raw = f.read(si.footer_length)
    if len(raw) != si.footer_length:
        raise OrcFormatError("truncated stripe footer")
    phys, encodings, tz = _walk_stripe_footer(
        decompress_blocks(raw, 0, len(raw), compression))
    if phys and phys[-1].start + phys[-1].length > si.index_length + \
            si.data_length:
        raise OrcFormatError("stripe streams overrun the stripe's data")
    return phys, encodings, tz


ENCODING_NAMES = ("DIRECT", "DICTIONARY", "DIRECT_V2", "DICTIONARY_V2")


def encoding_error(dtype: DataType, enc: int, tz: str) -> str:
    """Why a column of `dtype` in this encoding, written in time zone tz,
    does not decode, or '' (reference: plan_column :332's checks)."""
    if dtype is DataType.TIMESTAMP and tz not in UTC_ZONES:
        # seconds are local to the writer's zone: a zone database would be
        # needed (reference :831)
        return f"TIMESTAMP written in time zone {tz} (UTC only; queued)"
    if dtype in (DataType.BOOL, DataType.FLOAT32, DataType.FLOAT64):
        ok = (E_DIRECT,)
    elif dtype is DataType.STRING:
        ok = (E_DIRECT_V2, E_DICT_V2)
    else:
        ok = (E_DIRECT_V2,)
    if enc in ok:
        return ""
    name = ENCODING_NAMES[enc] if 0 <= enc < len(ENCODING_NAMES) else \
        str(enc)
    return (f"{name} encoding of a {dtype.name} column is not read "
            f"({', '.join(ENCODING_NAMES[e] for e in ok)} is; RLE v1 is "
            "queued)")


def check_stripe(path: str, meta: OrcMeta, si: StripeInfo, cols) -> None:
    """Raise when a column of `cols` ((attribute, OrcColumn) pairs) does
    not decode in this stripe; reads the stripe's footer alone."""
    with open(path, "rb") as f:
        try:
            _s, encodings, tz = _stripe_footer(f, si, meta.compression)
        except OrcFormatError as e:
            raise OrcFormatError(f"{path}: {e}") from None
    for a, col in cols:
        why = encoding_error(col.dtype, encodings.get(col.cid, (-1, 0))[0],
                             tz)
        if why:
            raise OrcFormatError(f"{path}: column {a.name!r}: {why}")


def read_stripe(path: str, si: StripeInfo, compression: int, columns: set,
                pin_alloc=None) -> StripeImage:
    """The image of one stripe's streams of `columns` (column ids): its
    footer, then only those streams' bytes, read and uncompressed."""
    with open(path, "rb") as f:
        phys, encodings, tz = _stripe_footer(f, si, compression)
        keep = [s for s in phys if s.column in columns and s.kind in (
            S_PRESENT, S_DATA, S_LENGTH, S_DICT, S_SECONDARY)]
        payloads = []
        for s in keep:
            f.seek(si.offset + s.start)
            payloads.append(f.read(s.length))
            if len(payloads[-1]) != s.length:
                raise OrcFormatError(f"{path}: truncated stripe at "
                                     f"{si.offset}")
    buf, streams = normalize_stripe(payloads, keep, compression, pin_alloc)
    return StripeImage(buf, streams, encodings, tz, si.num_rows)


def find_stream(streams: List[StreamLoc], cid: int,
                kind: int) -> Optional[StreamLoc]:
    return next((s for s in streams if s.column == cid and s.kind == kind),
                None)
