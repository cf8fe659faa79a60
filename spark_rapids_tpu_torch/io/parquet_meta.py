"""The Parquet footer reader: `FileMetaData` into the schema and the row
groups, without pyarrow.

Replaces every pyarrow footer call of the reference: the schema sample
(`pq.ParquetFile(f).schema_arrow`, io/reader.py:95-110), the row-group
split (`pq.ParquetFile(f).metadata`, io/scan.py:278-296) and the device
read's column chunks, max_def and FLBA lengths (io/scan.py:972-996).

The schema must be flat: a group column or a repeated column raises an
error that names it. Each leaf column maps to the port's SQL type the way
the reference's Arrow mapping does (io/arrow_convert.py:37): DATE from
INT32 with DATE, TIMESTAMP from INT64 with microsecond TIMESTAMP, DECIMAL
(precision <= 18) from INT32 / INT64 and from FIXED_LEN_BYTE_ARRAY of 1 to
16 bytes (the reference's scan, io/scan.py:995, `flba_len`), STRING from
BYTE_ARRAY. A column of another type (INT96, FIXED_LEN_BYTE_ARRAY that is
not such a decimal, a decimal past precision 18, millisecond or nanosecond
timestamps, unsigned integers) has `dtype` None and `unsupported` saying
why; reading it raises that reason.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.columnar.dtypes import DataType, DecimalType
from spark_rapids_tpu_torch.io.thrift import Compact

MAGIC = b"PAR1"

# parquet.thrift Type
T_BOOLEAN, T_INT32, T_INT64, T_INT96, T_FLOAT, T_DOUBLE, T_BYTE_ARRAY, \
    T_FLBA = range(8)
PHYSICAL_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
                  "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
               4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
CODEC_IDS = {name: i for i, name in CODEC_NAMES.items()}
# the codecs the port reads and writes; ZSTD, LZ4 and BROTLI are queued
SUPPORTED_CODECS = ("UNCOMPRESSED", "SNAPPY", "GZIP")
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                  4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                  6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                  8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2

# ConvertedType ids
_CT_UTF8, _CT_DECIMAL, _CT_DATE = 0, 5, 6
_CT_TIMESTAMP_MILLIS, _CT_TIMESTAMP_MICROS = 9, 10
_CT_INT_8, _CT_INT_16, _CT_INT_32, _CT_INT_64 = 15, 16, 17, 18
_CT_ENUM, _CT_JSON = 4, 19


class ParquetFormatError(ValueError):
    """A file, column or page the port's reader does not take."""


@dataclass
class ColumnSchema:
    name: str
    physical: int
    repetition: int
    max_def: int                  # 1 for an OPTIONAL column, 0 REQUIRED
    type_length: int = 0          # FIXED_LEN_BYTE_ARRAY byte length
    converted: Optional[int] = None
    logical: Optional[dict] = None
    scale: int = 0
    precision: int = 0
    dtype: object = None          # the port's SQL type, None if unsupported
    unsupported: str = ""

    @property
    def nullable(self) -> bool:
        return self.repetition != REQUIRED


@dataclass
class ChunkMeta:
    """One column chunk of a row group (ColumnMetaData)."""

    name: str
    physical: int
    codec: str
    encodings: List[str]
    num_values: int
    total_compressed_size: int
    total_uncompressed_size: int
    data_page_offset: int
    dictionary_page_offset: Optional[int]

    @property
    def start(self) -> int:
        """Offset of the chunk's first page (the dictionary page, if any)."""
        d = self.dictionary_page_offset
        return d if d is not None and d > 0 else self.data_page_offset


@dataclass
class RowGroupMeta:
    num_rows: int
    columns: Dict[str, ChunkMeta] = field(default_factory=dict)


@dataclass
class FileMeta:
    num_rows: int
    columns: List[ColumnSchema]
    row_groups: List[RowGroupMeta]
    created_by: str = ""

    def column(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise ParquetFormatError(f"column {name!r} is not in the file")


def _sql_type(c: ColumnSchema):
    """(SQL type, '') or (None, why not)."""
    lg = c.logical or {}
    ct = c.converted
    what = f"column {c.name!r} ({PHYSICAL_NAMES[c.physical]}"
    is_dec = ct == _CT_DECIMAL or 5 in lg
    if is_dec:
        dl = lg.get(5) or {}
        scale = dl.get(1, c.scale)
        precision = dl.get(2, c.precision)
        if c.physical not in (T_INT32, T_INT64, T_FLBA):
            return None, (f"{what} DECIMAL): INT32, INT64 and "
                          "FIXED_LEN_BYTE_ARRAY decimals are read; "
                          "BYTE_ARRAY decimals are queued")
        if precision > DecimalType.MAX_PRECISION:
            return None, (f"{what} DECIMAL({precision}, {scale})): "
                          f"precision past {DecimalType.MAX_PRECISION}")
        if c.physical == T_FLBA and not 1 <= c.type_length <= 16:
            return None, (f"{what} DECIMAL({precision}, {scale})): "
                          f"byte length {c.type_length} (1 to 16 are read)")
        return DecimalType(precision, scale), ""
    if c.physical == T_BOOLEAN:
        return DataType.BOOL, ""
    if c.physical == T_INT32:
        if ct == _CT_DATE or 6 in lg:
            return DataType.DATE, ""
        width, signed = 32, True
        if 10 in lg:
            width, signed = lg[10].get(1, 32), lg[10].get(2, True)
        elif ct in (_CT_INT_8, _CT_INT_16):
            width = 8 if ct == _CT_INT_8 else 16
        elif ct not in (None, _CT_INT_32):
            return None, f"{what} converted type {ct}) is not supported"
        if not signed:
            return None, f"{what}) unsigned integers are not supported"
        return {8: DataType.INT8, 16: DataType.INT16,
                32: DataType.INT32}[width], ""
    if c.physical == T_INT64:
        if 8 in lg or ct in (_CT_TIMESTAMP_MILLIS, _CT_TIMESTAMP_MICROS):
            unit = (lg.get(8) or {}).get(2)
            micros = 2 in unit if unit else ct == _CT_TIMESTAMP_MICROS
            if not micros:
                return None, (f"{what}) timestamps other than microseconds "
                              "are queued")
            return DataType.TIMESTAMP, ""
        if 10 in lg and not lg[10].get(2, True):
            return None, f"{what}) unsigned integers are not supported"
        if ct not in (None, _CT_INT_64) and 10 not in lg:
            return None, f"{what} converted type {ct}) is not supported"
        return DataType.INT64, ""
    if c.physical == T_FLOAT:
        return DataType.FLOAT32, ""
    if c.physical == T_DOUBLE:
        return DataType.FLOAT64, ""
    if c.physical == T_BYTE_ARRAY:
        return DataType.STRING, ""
    return None, f"{what}) is not supported"


def parse_footer(buf: bytes) -> FileMeta:
    """FileMetaData (the thrift footer bytes) into a FileMeta."""
    md = Compact(buf).struct()
    schema = md.get(2) or []
    if not schema:
        raise ParquetFormatError("footer without a schema")
    root = schema[0]
    columns: List[ColumnSchema] = []
    for el in schema[1:]:
        name = el.get(4, b"").decode("utf-8")
        rep = el.get(3, REQUIRED)
        if el.get(5, 0) or 1 not in el or rep == REPEATED:
            raise ParquetFormatError(
                f"column {name!r} is nested (a group or a repeated field): "
                "only flat schemas are read")
        c = ColumnSchema(name, el[1], rep, 1 if rep == OPTIONAL else 0,
                         type_length=el.get(2, 0), converted=el.get(6),
                         logical=el.get(10), scale=el.get(7, 0),
                         precision=el.get(8, 0))
        c.dtype, c.unsupported = _sql_type(c)
        columns.append(c)
    if root.get(5, len(columns)) != len(columns):
        raise ParquetFormatError("schema children do not match its columns")
    groups = []
    for rg in md.get(4) or []:
        g = RowGroupMeta(rg.get(3, 0))
        for cc in rg.get(1) or []:
            if cc.get(1):
                raise ParquetFormatError(
                    "column chunks in another file are not supported")
            m = cc.get(3)
            if m is None:
                raise ParquetFormatError("column chunk without metadata")
            name = ".".join(p.decode("utf-8") for p in m.get(3, []))
            g.columns[name] = ChunkMeta(
                name, m[1], CODEC_NAMES.get(m.get(4, 0), f"codec {m.get(4)}"),
                [ENCODING_NAMES.get(e, f"encoding {e}")
                 for e in m.get(2, [])],
                m.get(5, 0), m.get(7, 0), m.get(6, 0), m.get(9, 0), m.get(11))
        groups.append(g)
    return FileMeta(md.get(3, 0), columns, groups,
                    (md.get(6) or b"").decode("utf-8", "replace"))


def read_footer(path: str) -> FileMeta:
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 12:
            raise ParquetFormatError(f"{path}: too short for Parquet")
        if f.read(4) != MAGIC:
            raise ParquetFormatError(f"{path}: no Parquet magic")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != MAGIC:
            raise ParquetFormatError(f"{path}: no Parquet footer magic")
        n = struct.unpack("<I", tail[:4])[0]
        if n > size - 12:
            raise ParquetFormatError(f"{path}: footer length {n} too large")
        f.seek(size - 8 - n)
        return parse_footer(f.read(n))


def read_chunk(path: str, chunk: ChunkMeta) -> bytes:
    """The raw bytes of one column chunk (reference:
    io/parquet_device.py:read_chunk_bytes :1519)."""
    with open(path, "rb") as f:
        f.seek(chunk.start)
        data = f.read(chunk.total_compressed_size)
    if len(data) != chunk.total_compressed_size:
        raise ParquetFormatError(f"{path}: column chunk {chunk.name!r} is "
                                 "truncated")
    return data
