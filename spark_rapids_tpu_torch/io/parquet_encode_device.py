"""Device-side Parquet encode, the write path (port of
spark_rapids_tpu/io/parquet_encode_device.py).

The split mirrors the decoder's in reverse. On the DEVICE, K22
`encode_plain_page` (csrc/parquet_encode.cu) turns each column of a batch
into one PLAIN v1 page payload: the live values compacted (strings with
their 4-byte length prefixes, booleans bit-packed) and the validity packed
into the definition levels' bit-packed run. What downloads is that payload,
not padded columns. The HOST wraps payloads in thrift page headers,
block-compresses them (SNAPPY in the native library, GZIP through zlib),
and writes the footer. The files are the reference writer's, byte for byte
when uncompressed: the same schema (every column OPTIONAL), one row group a
file and one page a batch a column.

The wrapper takes its plain PyTorch version for CPU tensors (the CPU
engine's writes and the tests) and launches K22 for CUDA tensors.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    ensure_compact,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, DecimalType
from spark_rapids_tpu_torch.io.parquet_meta import (
    CODEC_IDS,
    MAGIC,
    ParquetFormatError,
    SUPPORTED_CODECS,
    T_BOOLEAN,
    T_BYTE_ARRAY,
    T_DOUBLE,
    T_FLOAT,
    T_INT32,
    T_INT64,
)
from spark_rapids_tpu_torch.io.thrift import CompactWriter, uvarint, zigzag

# ConvertedType ids for the logical annotations
_CT_UTF8 = 0
_CT_DATE = 6
_CT_TIMESTAMP_MICROS = 10
_CT_DECIMAL = 5


def _phys_type(dt) -> Optional[Tuple[int, int, Optional[int]]]:
    """(physical type, byte width, converted type), or None when the type
    cannot be written (reference :66)."""
    if isinstance(dt, DecimalType):
        return T_INT64, 8, _CT_DECIMAL
    return {
        DataType.INT32: (T_INT32, 4, None),
        DataType.INT64: (T_INT64, 8, None),
        DataType.FLOAT32: (T_FLOAT, 4, None),
        DataType.FLOAT64: (T_DOUBLE, 8, None),
        DataType.DATE: (T_INT32, 4, _CT_DATE),
        DataType.TIMESTAMP: (T_INT64, 8, _CT_TIMESTAMP_MICROS),
        DataType.STRING: (T_BYTE_ARRAY, 0, _CT_UTF8),
        DataType.BOOL: (T_BOOLEAN, 0, None),
    }.get(dt)


def schema_encodable(attrs) -> List[str]:
    """The columns whose type cannot be written (reference :83)."""
    return [f"{a.name} ({a.data_type.name})" for a in attrs
            if _phys_type(a.data_type) is None]


def codec_name(compression: str) -> str:
    name = str(compression).upper()
    return "UNCOMPRESSED" if name == "NONE" else name


def codec_supported(compression: str) -> bool:
    """Reference :92: UNCOMPRESSED, SNAPPY (the default) and GZIP."""
    return codec_name(compression) in SUPPORTED_CODECS


def require_codec(compression: str) -> str:
    """The codec's name, or an error that names it."""
    name = codec_name(compression)
    if not codec_supported(compression):
        raise ParquetFormatError(
            f"compression codec {compression} is not supported for writing "
            "(uncompressed, snappy and gzip are; zstd, lz4 and brotli are "
            "queued)")
    return name


def compress(codec: str, payload: bytes) -> bytes:
    if codec == "SNAPPY":
        return native.snappy_compress(payload)
    if codec == "GZIP":
        c = zlib.compressobj(6, zlib.DEFLATED, 31)
        return c.compress(payload) + c.flush()
    return payload


# ---------------------------------------------------------------------------
# K22 encode_plain_page
# ---------------------------------------------------------------------------
def pack_bits_plain(flags: torch.Tensor, msb: bool = False) -> torch.Tensor:
    """Flags [8k] -> k bytes, LSB first (reference: _pack_validity_bits
    :229), or MSB first (ORC: orc_encode_device.py:_pack_present :162)."""
    n = int(flags.shape[0])
    pad = (-n) % 8
    if pad:
        flags = torch.cat([flags, torch.zeros(pad, dtype=flags.dtype,
                                              device=flags.device)])
    bits = flags.reshape(-1, 8).to(torch.int32)
    weights = torch.tensor([1 << (7 - k if msb else k) for k in range(8)],
                           dtype=torch.int32, device=flags.device)
    return (bits * weights).sum(1).to(torch.uint8)


def encode_plain_page_plain(col: ColumnVector, num_rows: int,
                            orc: bool = False):
    """(values uint8, packed validity uint8 [cap / 8], counts int64 [2]:
    live rows and value bytes) of one column (reference: _encode_fixed
    :116, _pack_validity_bits :229, _encode_string_plan :133,
    _encode_string_bytes :153). orc: bits MSB first and strings without
    length prefixes (reference: orc_encode_device.py:_pack_present :162,
    _compact_fixed :225)."""
    cap = col.capacity
    dev = col.validity.device
    live = col.validity & (torch.arange(cap, device=dev) < num_rows)
    packed = pack_bits_plain(live, orc)
    prefix = 0 if orc else 4
    n = int(live.sum())
    if col.dtype is DataType.STRING:
        sel = torch.nonzero(live).flatten()
        starts = col.offsets[sel].long()
        lens = (col.offsets[sel + 1] - col.offsets[sel]).long()
        piece = lens + prefix
        out_off = torch.cumsum(piece, 0) - piece
        total = int(piece.sum())
        row = torch.repeat_interleave(torch.arange(n, device=dev), piece)
        within = torch.arange(total, device=dev) - out_off[row]
        len_byte = (lens[row] >> (8 * within.clamp(max=3))) & 0xFF
        src = (starts[row] + within - prefix).clamp(0, max(
            int(col.data.shape[0]) - 1, 0))
        body = col.data[src].long() if total else len_byte
        values = torch.where(within < prefix, len_byte, body).to(
            torch.uint8)
        return values, packed, torch.tensor([n, total], dtype=torch.int64,
                                            device=dev)
    dense = col.data[live]
    if col.dtype is DataType.BOOL:
        values = pack_bits_plain(dense, orc)
    else:
        values = dense.contiguous().view(torch.uint8)
    return values, packed, torch.tensor(
        [n, int(values.shape[0])], dtype=torch.int64, device=dev)


def encode_plain_page(col: ColumnVector, num_rows: int, orc: bool = False):
    """K22 (replaces parquet_encode_device.py:_encode_fixed :116,
    _pack_validity_bits :229, _encode_string_plan :133 and
    _encode_string_bytes :153): (values, packed validity, counts) with
    values[:counts[1]] the page's PLAIN values. orc: K22's ORC mode,
    counted as orc_pack_present (replaces orc_encode_device.py:
    _pack_present :162 and _compact_fixed :225): MSB-first bits, strings
    without length prefixes."""
    if col.validity.device.type == "cpu":
        return encode_plain_page_plain(col, num_rows, orc)
    cap = col.capacity
    dev = col.validity.device
    validity = col.validity.contiguous()
    data = col.data.contiguous()
    CB.require_cuda(data, validity)
    lib = CB.library("parquet_encode")
    scratch = torch.empty(int(lib.srt_encode_scratch_bytes(cap)),
                          dtype=torch.uint8, device=dev)
    packed = torch.empty(cap // 8, dtype=torch.uint8, device=dev)
    counts = torch.empty(2, dtype=torch.int64, device=dev)
    stream = CB.stream_of(validity)
    if col.dtype is DataType.STRING:
        offsets = col.offsets.contiguous()
        CB.require_cuda(offsets)
        byte_cap = int(data.shape[0]) + (0 if orc else 4 * cap)
        if byte_cap >= 1 << 32:
            raise ValueError("a string page past 4 GiB: write smaller "
                             "batches")
        values = torch.empty(max(byte_cap, 1), dtype=torch.uint8, device=dev)
        rc = lib.srt_encode_string_page(
            offsets.data_ptr(), data.data_ptr(), validity.data_ptr(),
            int(num_rows), cap, 1 if orc else 0, values.data_ptr(), byte_cap,
            packed.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
            scratch.numel(), stream)
    else:
        as_bool = col.dtype is DataType.BOOL
        w = data.element_size()
        values = torch.empty(cap // 8 if as_bool else cap * w,
                             dtype=torch.uint8, device=dev)
        rc = lib.srt_encode_plain_page(
            data.view(torch.uint8).data_ptr(), validity.data_ptr(),
            int(num_rows), cap, w, 1 if as_bool else 0, 1 if orc else 0,
            values.data_ptr(),
            packed.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
            scratch.numel(), stream)
    label = "orc_pack_present" if orc else "encode_plain_page"
    CB.count_launch(label)
    CB.check(lib, rc, label)
    return values, packed, counts


def encode_column_page(col: ColumnVector, num_rows: int):
    """One column of one batch as host page pieces: (definition-level
    bytes, value bytes, live rows) (reference :178). One sync reads the
    counts; only the payload downloads."""
    values, packed, counts = encode_plain_page(col, num_rows)
    n_present, n_bytes = (int(x) for x in counts.cpu())
    n_bits = (num_rows + 7) // 8
    vals = values[:n_bytes].cpu().numpy().tobytes()
    bits = packed[:n_bits].cpu().numpy().tobytes()
    # v1 definition levels: u32 length + one bit-packed run of ceil(n/8)
    # groups, which is always legal
    dl = uvarint((n_bits << 1) | 1) + bits
    return struct.pack("<I", len(dl)) + dl, vals, n_present


# ---------------------------------------------------------------------------
# Page headers, schema and footer (host)
# ---------------------------------------------------------------------------
def _page_header(n_values: int, payload_len: int,
                 compressed_len: int) -> bytes:
    w = CompactWriter()
    w.i32(1, 0)                    # type = DATA_PAGE
    w.i32(2, payload_len)          # uncompressed_size
    w.i32(3, compressed_len)       # compressed_size
    w.begin_struct(5)              # data_page_header
    w.i32(1, n_values)
    w.i32(2, 0)                    # encoding = PLAIN
    w.i32(3, 3)                    # definition_level_encoding = RLE
    w.i32(4, 3)                    # repetition_level_encoding = RLE
    w.end_struct()
    return w.stop()


def _schema_element(w: CompactWriter, a) -> None:
    phys, _width, conv = _phys_type(a.data_type)
    w.begin_element_struct()
    w.i32(1, phys)
    w.i32(3, 1)        # repetition = OPTIONAL
    w.string(4, a.name)
    if conv is not None:
        w.i32(6, conv)
    if isinstance(a.data_type, DecimalType):
        w.i32(7, a.data_type.scale)
        w.i32(8, a.data_type.precision)
    w.end_struct()


def write_file(path: str, attrs, batches: List[ColumnarBatch],
               compression: str = "UNCOMPRESSED") -> int:
    """Write one Parquet file of device-encoded pages: one row group, one
    page per batch per column (reference :341). Returns the rows
    written."""
    cname = require_codec(compression)
    bad = schema_encodable(attrs)
    if bad:
        raise ParquetFormatError(f"cannot write column(s) {', '.join(bad)}")
    codec_id = CODEC_IDS[cname]
    pages: List[List[Tuple[bytes, bytes, int, int]]] = [[] for _ in attrs]
    total_rows = 0
    for b in batches:
        b = ensure_compact(b)
        n = b.host_rows()
        for ci in range(len(attrs)):
            defb, valb, npres = encode_column_page(b.columns[ci], n)
            pages[ci].append((defb, valb, npres, n))
        total_rows += n
    # block compression is native and releases the GIL: pages compress on
    # worker threads, then write in order
    payloads = [defb + valb for col in pages for defb, valb, _, _ in col]
    with ThreadPoolExecutor(max_workers=min(8, max(len(payloads), 1))) as ex:
        wires = iter(list(ex.map(lambda b: compress(cname, b), payloads)))
    payloads = iter(payloads)
    with open(path, "wb") as f:
        f.write(MAGIC)
        offset = 4
        col_meta = []
        for ci, a in enumerate(attrs):
            first_off = offset
            n_vals = chunk_bytes = chunk_raw = 0
            for _defb, _valb, _npres, nrows in pages[ci]:
                payload = next(payloads)
                wire = next(wires)
                hdr = _page_header(nrows, len(payload), len(wire))
                f.write(hdr)
                f.write(wire)
                offset += len(hdr) + len(wire)
                chunk_bytes += len(hdr) + len(wire)
                chunk_raw += len(hdr) + len(payload)
                n_vals += nrows
            col_meta.append((a, first_off, n_vals, chunk_bytes, chunk_raw))
        w = CompactWriter()
        w.i32(1, 1)                           # version
        w.list_header(2, 12, len(attrs) + 1)  # schema
        w.begin_element_struct()              # root
        w.string(4, "schema")
        w.i32(5, len(attrs))                  # num_children
        w.end_struct()
        for a in attrs:
            _schema_element(w, a)
        w.i64(3, total_rows)                  # num_rows
        w.list_header(4, 12, 1)               # row_groups
        w.begin_element_struct()              # RowGroup
        w.list_header(1, 12, len(attrs))      # columns
        for a, first_off, n_vals, chunk_bytes, chunk_raw in col_meta:
            w.begin_element_struct()          # ColumnChunk
            w.i64(2, first_off)               # file_offset
            w.begin_struct(3)                 # ColumnMetaData
            w.i32(1, _phys_type(a.data_type)[0])
            w.list_header(2, 5, 2)            # encodings [PLAIN, RLE]
            w.buf += zigzag(0) + zigzag(3)
            w.list_header(3, 8, 1)            # path_in_schema
            nb = a.name.encode("utf-8")
            w.buf += uvarint(len(nb)) + nb
            w.i32(4, codec_id)                # codec
            w.i64(5, n_vals)
            w.i64(6, chunk_raw)               # total_uncompressed_size
            w.i64(7, chunk_bytes)             # total_compressed_size
            w.i64(9, first_off)               # data_page_offset
            w.end_struct()
            w.end_struct()
        w.i64(2, sum(m[3] for m in col_meta))  # total_byte_size
        w.i64(3, total_rows)                   # num_rows
        w.end_struct()
        w.string(6, "spark-rapids-tpu device encoder")
        footer = w.stop()
        f.write(footer)
        f.write(struct.pack("<I", len(footer)))
        f.write(MAGIC)
    return total_rows
