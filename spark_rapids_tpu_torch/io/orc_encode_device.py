"""Device-side ORC encode, the write path (port of
spark_rapids_tpu/io/orc_encode_device.py).

The split mirrors the decoder's in reverse. On the DEVICE, per column of
a batch: K29 `encode_direct` (csrc/orc_encode.cu) compacts the live values
of an integer column (and a STRING column's lengths), zigzag-encodes
signed ones and bit-packs them big-endian at one width for the column, run
headers included, beside the PRESENT bits; K22's ORC mode
(`parquet_encode_device.encode_plain_page(..., orc=True)`, counted as
orc_pack_present) compacts FLOAT / DOUBLE values, packs BOOLEAN values and
PRESENT bits MSB first, and gathers STRING bytes. What downloads is the
stream payloads. The HOST frames PRESENT and BOOLEAN bytes as byte-RLE
literal runs, block-compresses every stream (ZLIB through zlib, SNAPPY in
the native library; on 8 threads) and writes the protobuf StripeFooter,
Footer and PostScript. One stripe per input batch; every stream is
DIRECT_V2 (FLOAT / DOUBLE / BOOLEAN: DIRECT). Uncompressed files are the
reference writer's byte for byte.

Types (reference `_KIND` :44): BOOLEAN, SHORT, INT, LONG, DATE, FLOAT,
DOUBLE, STRING. Others raise.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    ensure_compact,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.io.orc_meta import (
    COMP_NONE,
    COMP_SNAPPY,
    COMP_ZLIB,
    OrcFormatError,
)
from spark_rapids_tpu_torch.io.parquet_encode_device import (
    encode_plain_page,
    pack_bits_plain,
)
from spark_rapids_tpu_torch.io.thrift import uvarint

# Type.Kind of each written type
_KIND = {DataType.BOOL: 0, DataType.INT16: 2, DataType.INT32: 3,
         DataType.INT64: 4, DataType.DATE: 15, DataType.FLOAT32: 5,
         DataType.FLOAT64: 6, DataType.STRING: 7}
_K_STRUCT = 12
_COMP = {"none": COMP_NONE, "uncompressed": COMP_NONE, "zlib": COMP_ZLIB,
         "snappy": COMP_SNAPPY}
_COMP_BLOCK = 64 * 1024
_RUN = 512   # values a DIRECT run
_LIT = 128   # bytes a PRESENT literal run
# the widths the writer uses, and their 5-bit codes
DIRECT_WIDTHS = (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64)
WIDTH_CODE = {1: 0, 2: 1, 4: 3, 8: 7, 16: 15, 24: 23, 32: 27, 40: 28,
              48: 29, 56: 30, 64: 31}
# threads that compress a file's streams (ZLIB: blocks)
HOST_THREADS = 8


def schema_encodable(attrs) -> List[str]:
    """The columns whose type cannot be written (reference :70)."""
    return [f"{a.name} ({a.data_type.name})" for a in attrs
            if a.data_type not in _KIND]


def codec_supported(compression: str) -> bool:
    """Reference :82: none / uncompressed (the default), zlib, snappy."""
    return str(compression).lower() in _COMP


def require_codec(compression: str) -> int:
    if not codec_supported(compression):
        raise OrcFormatError(
            f"ORC compression {compression} is not supported for writing "
            "(uncompressed, zlib and snappy are; zstd, lz4 and lzo are "
            "queued)")
    return _COMP[str(compression).lower()]


def _deflate(chunk: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    return c.compress(chunk) + c.flush()


def _compress_stream(payload: bytes, kind: int, mapper=map) -> bytes:
    """ORC's block framing (reference :96): a 3-byte little-endian header
    (length << 1 | is_original) a block of at most 64 KiB, the block kept
    as it is where compression does not shrink it. SNAPPY frames a whole
    stream in one native call; ZLIB blocks deflate through mapper (a
    thread pool's map: zlib releases the GIL)."""
    if kind == COMP_NONE:
        return payload
    if kind == COMP_SNAPPY:
        return native.orc_snappy_framed(payload, _COMP_BLOCK)
    chunks = [payload[i:i + _COMP_BLOCK]
              for i in range(0, len(payload), _COMP_BLOCK)]
    out = []
    for chunk, comp in zip(chunks, mapper(_deflate, chunks)):
        if len(comp) < len(chunk):
            h = len(comp) << 1
        else:
            h, comp = (len(chunk) << 1) | 1, chunk
        out.append(bytes((h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF)))
        out.append(comp)
    return b"".join(out)


# ---------------------------------------------------------------------------
# K29 encode_direct
# ---------------------------------------------------------------------------
def pick_width(max_u: int) -> int:
    """Reference :177 (max_u read as unsigned 64 bits)."""
    need = max(int(max_u) & ((1 << 64) - 1), 1).bit_length()
    return next(w for w in DIRECT_WIDTHS if w >= need)


def encode_direct_plain(data: torch.Tensor, validity, num_rows: int,
                        signed: bool):
    """(stream uint8, PRESENT bits uint8 [cap / 8], counts int64 [3]: live
    rows, width, stream bytes) (reference: _compact_zigzag :130,
    _lens_u64 :234, _pick_width :177, _bitpack_be :146 and
    _direct_stream :185): the live values in row order, zigzag-encoded
    when signed, in DIRECT runs of 512 at the width their largest value
    needs, each run's 2-byte header before its big-endian bits."""
    dev = data.device
    cap = int(data.shape[0])
    live = torch.arange(cap, device=dev) < num_rows
    if validity is not None:
        live = live & validity
    present = pack_bits_plain(live, msb=True)
    dense = data[live].long()
    u = (dense << 1) ^ (dense >> 63) if signed else dense
    n = int(u.shape[0])
    if n == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev), present,
                torch.tensor([0, 1, 0], dtype=torch.int64, device=dev))
    max_u = (1 << 63) if bool((u < 0).any()) else int(u.max())
    w = pick_width(max_u)
    if w >= 8:
        nb = w // 8
        shifts = torch.tensor([8 * (nb - 1 - i) for i in range(nb)],
                              dtype=torch.int64, device=dev)
        payload = ((u[:, None] >> shifts) & 0xFF).reshape(-1)
    else:
        per = 8 // w
        pad = (-n) % per
        uu = torch.cat([u, torch.zeros(pad, dtype=torch.int64, device=dev)])
        shifts = torch.tensor([8 - w * (t + 1) for t in range(per)],
                              dtype=torch.int64, device=dev)
        payload = ((uu.reshape(-1, per) & ((1 << w) - 1)) << shifts).sum(1)
    payload = payload.to(torch.uint8)
    full, rem = divmod(n, _RUN)
    run_bytes = _RUN * w // 8
    h1 = 0x40 | (WIDTH_CODE[w] << 1)
    parts = []
    if full:
        hdr = torch.tensor([h1 | (511 >> 8), 511 & 0xFF], dtype=torch.uint8,
                           device=dev).expand(full, 2)
        parts.append(torch.cat([hdr, payload[:full * run_bytes].reshape(
            full, run_bytes)], 1).reshape(-1))
    if rem:
        parts.append(torch.tensor([h1 | ((rem - 1) >> 8), (rem - 1) & 0xFF],
                                  dtype=torch.uint8, device=dev))
        parts.append(payload[full * run_bytes:])
    stream = torch.cat(parts)
    return stream, present, torch.tensor(
        [n, w, int(stream.shape[0])], dtype=torch.int64, device=dev)


def encode_direct(data: torch.Tensor, validity, num_rows: int,
                  signed: bool):
    """K29 (replaces orc_encode_device.py:_compact_zigzag :130, _bitpack_be
    :146, _lens_u64 :234 and _direct_stream's header loop :185): an
    integer column's RLEv2 DIRECT stream and PRESENT bits in one call.
    data: int16 / int32 / int64 [cap]; validity: bool [cap] or None."""
    if data.device.type == "cpu":
        return encode_direct_plain(data, validity, num_rows, signed)
    data = data.contiguous()
    cap = int(data.shape[0])
    dev = data.device
    CB.require_cuda(data, *([validity] if validity is not None else []))
    if data.dtype not in (torch.int16, torch.int32, torch.int64):
        raise ValueError(f"K29 takes int16 / int32 / int64, not {data.dtype}")
    lib = CB.library("orc_encode")
    scratch = torch.empty(int(lib.srt_orc_direct_scratch_bytes(cap)),
                          dtype=torch.uint8, device=dev)
    out_cap = 8 * cap + 2 * (-(-cap // _RUN))
    out = torch.empty(out_cap, dtype=torch.uint8, device=dev)
    present = torch.empty(cap // 8, dtype=torch.uint8, device=dev)
    counts = torch.empty(3, dtype=torch.int64, device=dev)
    rc = lib.srt_orc_encode_direct(
        data.data_ptr(), data.element_size(), 1 if signed else 0,
        validity.contiguous().data_ptr() if validity is not None else None,
        int(num_rows), cap, out.data_ptr(), out_cap, present.data_ptr(),
        counts.data_ptr(), scratch.data_ptr(), scratch.numel(),
        CB.stream_of(data))
    CB.count_launch("orc_encode_direct")
    CB.check(lib, rc, "orc_encode_direct")
    return out, present, counts


# ---------------------------------------------------------------------------
# Host framing and protobuf
# ---------------------------------------------------------------------------
def _present_stream(bitmap: bytes) -> bytes:
    """Byte-RLE literal runs of 128 bytes (reference :202)."""
    out = bytearray()
    for i in range(0, len(bitmap), _LIT):
        chunk = bitmap[i:i + _LIT]
        out.append(256 - len(chunk))
        out += chunk
    return bytes(out)


def _fv(fnum: int, v: int) -> bytes:
    return uvarint((fnum << 3) | 0) + uvarint(v)


def _fb(fnum: int, b: bytes) -> bytes:
    return uvarint((fnum << 3) | 2) + uvarint(len(b)) + b


def _bytes(t: torch.Tensor, n: int) -> bytes:
    return t[:n].cpu().numpy().tobytes()


def _column_streams(col: ColumnVector, dt, n_rows: int, ci: int
                    ) -> List[Tuple[int, int, bytes]]:
    """(stream kind, column id, payload) of one column of one batch; one
    sync reads the counts, then only payloads download."""
    nb = (n_rows + 7) // 8
    if dt in (DataType.STRING, DataType.BOOL, DataType.FLOAT32,
              DataType.FLOAT64):
        values, present, counts = encode_plain_page(col, n_rows, orc=True)
        lens = None
        if dt is DataType.STRING:
            ln = col.offsets[1:] - col.offsets[:-1]
            stream, _, lcounts = encode_direct(ln, col.validity, n_rows,
                                               False)
            (n, nbytes), (_, _, lbytes) = counts.tolist(), lcounts.tolist()
            lens = _bytes(stream, lbytes)
        else:
            n, nbytes = counts.tolist()
        out = []
        if n != n_rows:
            out.append((0, ci, _present_stream(_bytes(present, nb))))
        if dt is DataType.BOOL:
            out.append((1, ci, _present_stream(_bytes(values, (n + 7) // 8))))
        else:
            out.append((1, ci, _bytes(values, nbytes)))
        if lens is not None:
            out.append((2, ci, lens))
        return out
    stream, present, counts = encode_direct(col.data, col.validity, n_rows,
                                            True)
    n, _w, nbytes = counts.tolist()
    out = []
    if n != n_rows:
        out.append((0, ci, _present_stream(_bytes(present, nb))))
    out.append((1, ci, _bytes(stream, nbytes)))
    return out


def _encode_stripe(attrs, batch: ColumnarBatch
                   ) -> Tuple[List[Tuple[int, int, bytes]], int]:
    """One batch's streams (reference :252) and rows."""
    batch = ensure_compact(batch)
    n_rows = int(batch.host_rows())
    streams = []
    for ci, a in enumerate(attrs):
        streams.extend(_column_streams(batch.columns[ci], a.data_type,
                                       n_rows, ci + 1))
    return streams, n_rows


def _stripe_footer(attrs, streams, wires) -> bytes:
    footer = bytearray()
    for (kind, col, _payload), wire in zip(streams, wires):
        footer += _fb(1, _fv(1, kind) + _fv(2, col) + _fv(3, len(wire)))
    footer += _fb(2, _fv(1, 0))  # the root struct: DIRECT
    for a in attrs:
        enc = 0 if a.data_type in (DataType.FLOAT32, DataType.FLOAT64,
                                   DataType.BOOL) else 2
        footer += _fb(2, _fv(1, enc))
    return bytes(footer)


def write_file(path: str, attrs, batches: List[ColumnarBatch],
               compression: str = "uncompressed") -> int:
    """One ORC file of device-encoded stripes, one a batch (reference
    :350). Returns the rows written."""
    comp = require_codec(compression)
    bad = schema_encodable(attrs)
    if bad:
        raise OrcFormatError(f"cannot write column(s) {', '.join(bad)} as "
                             "ORC")
    stripes = []
    for b in batches:
        if b.host_rows() == 0:
            continue
        stripes.append(_encode_stripe(attrs, b))
    payloads = [p for streams, _ in stripes for _k, _c, p in streams]
    with ThreadPoolExecutor(max_workers=HOST_THREADS) as ex:
        if comp == COMP_SNAPPY:  # a stream a thread
            wires = list(ex.map(lambda p: _compress_stream(p, comp),
                                payloads))
        else:  # a ZLIB block a thread
            wires = [_compress_stream(p, comp, ex.map) for p in payloads]
    header = b"ORC"
    infos = []
    total_rows = 0
    wi = 0
    with open(path, "wb") as f:
        f.write(header)
        offset = len(header)
        for streams, rows in stripes:
            sw = wires[wi:wi + len(streams)]
            wi += len(streams)
            sfooter = _compress_stream(_stripe_footer(attrs, streams, sw),
                                       comp)
            dlen = sum(len(w) for w in sw)
            for w in sw:
                f.write(w)
            f.write(sfooter)
            infos.append((offset, dlen, len(sfooter), rows))
            offset += dlen + len(sfooter)
            total_rows += rows
        footer = bytearray()
        footer += _fv(1, len(header))          # headerLength
        footer += _fv(2, offset)               # contentLength
        for off, dlen, flen, rows in infos:
            footer += _fb(3, _fv(1, off) + _fv(2, 0) + _fv(3, dlen)
                          + _fv(4, flen) + _fv(5, rows))
        root = _fv(1, _K_STRUCT)
        for ci in range(len(attrs)):
            root += _fv(2, ci + 1)
        for a in attrs:
            root += _fb(3, a.name.encode("utf-8"))
        footer += _fb(4, root)
        for a in attrs:
            footer += _fb(4, _fv(1, _KIND[a.data_type]))
        footer += _fv(6, total_rows)           # numberOfRows
        footer += _fv(8, 0)                    # rowIndexStride: no index
        footer = _compress_stream(bytes(footer), comp)
        ps = bytearray()
        ps += _fv(1, len(footer))              # footerLength
        ps += _fv(2, comp)                     # compression
        ps += _fv(3, _COMP_BLOCK)              # compressionBlockSize
        ps += uvarint((4 << 3) | 0) + uvarint(0)    # version 0.12
        ps += uvarint((4 << 3) | 0) + uvarint(12)
        ps += _fv(5, 0)                        # metadataLength
        ps += _fv(6, 1)                        # writerVersion
        ps += _fb(8000, b"ORC")                # magic
        f.write(footer)
        f.write(bytes(ps))
        f.write(struct.pack("B", len(ps)))
    return total_rows
