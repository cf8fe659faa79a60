"""Serialized columnar batch format "TPB1" (port of
spark_rapids_tpu/columnar/serde.py).

The bytes are the reference's, byte for byte, for the same host batch
(`serialize_batch` :141, `deserialize_batch` :182), so a piece spilled or
shipped by one package reads back in the other. Layout (little-endian, no
padding):

    magic   : 4 bytes  b"TPB1"
    num_rows: u32
    num_cols: u32
    col hdr : num_cols x (dtype_code u8, nullable u8, extra u16,
                          payload_len u64)
    payloads: per column, in order:
        validity bits : ceil(n/8) bytes (np.packbits, bitorder='little')
        fixed-width   : data[:n] raw bytes, zeros under NULL
        string        : offsets int32[n+1] then utf-8 bytes (NULL rows empty)
        dictionary    : codes int32[n] re-based into the piece's pruned
                        dictionary, ndv u32, dictionary offsets
                        int32[ndv+1], dictionary bytes (code 12, extra =
                        the value dtype's code)

Where the reference walks string rows and dictionary entries in Python,
the port moves them as numpy arrays: a string column serializes from its
cached UTF-8 form (`HostColumnVector.utf8`).

The spill tier (memory/spill.py) uses two fast paths around the same
bytes: `serialize_device_batch` downloads a device batch column by column
into pinned host memory (no device allocation, so it runs while the card
is out of memory) and serializes without decoding strings to Python
objects; `deserialize_to_device` uploads a TPB1 buffer through the grouped
upload (`HostColumnarBatch.to_device`) with the same shortcut.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import strings as S
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    HostColumnarBatch,
    HostColumnVector,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, DecimalType

MAGIC = b"TPB1"

# Stable on-the-wire dtype codes (never reorder).
_DTYPE_CODE = {
    DataType.BOOL: 0,
    DataType.INT8: 1,
    DataType.INT16: 2,
    DataType.INT32: 3,
    DataType.INT64: 4,
    DataType.FLOAT32: 5,
    DataType.FLOAT64: 6,
    DataType.STRING: 7,
    DataType.DATE: 8,
    DataType.TIMESTAMP: 9,
    DataType.NULL: 10,
}
_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}
# DECIMAL(p,s): code 11, (p << 8) | s in the header's u16 extra field.
_DECIMAL_CODE = 11
# Dictionary-encoded column: code 12, the value dtype's code in extra (0 is
# legacy STRING).
_DICT_STRING_CODE = 12

_HEADER = struct.Struct("<4sII")
_COLHDR = struct.Struct("<BBHQ")


def _dtype_code(dt):
    if isinstance(dt, DecimalType):
        return _DECIMAL_CODE, (dt.precision << 8) | dt.scale
    return _DTYPE_CODE[dt], 0


def _code_dtype(code: int, extra: int):
    if code == _DECIMAL_CODE:
        return DecimalType(extra >> 8, extra & 0xFF)
    return _CODE_DTYPE[code]


def _pruned_dict_piece(col, n: int, validity: np.ndarray):
    """(re-based codes int32 [n], pruned offsets int32 [u + 1], pruned
    bytes) of one dictionary column: only the entries its valid rows use
    (reference: _pruned_dict_piece :97)."""
    d = col.dictionary
    codes = np.ascontiguousarray(col.data[:n], dtype=np.int32)
    valid = validity[:n]
    every = bool(valid.all())
    # the codes present, ascending, and each one's place among them: a
    # count and a table lookup, linear in the rows
    present = np.bincount(codes if every else codes[valid],
                          minlength=d.size) > 0 if n else \
        np.zeros(d.size, dtype=bool)
    used = np.flatnonzero(present).astype(np.int32)
    if len(used):
        rank = np.cumsum(present, dtype=np.int32) - 1
        codes = rank[codes] if every else \
            np.where(valid, rank[np.where(valid, codes, 0)],
                     0).astype(np.int32, copy=False)
    else:
        codes = np.zeros(n, dtype=np.int32)
    lens = d.host_lens[used].astype(np.int64)
    offs = np.zeros(len(used) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    starts = d.host_offsets[used].astype(np.int64)
    # each pruned entry's bytes, in order, without a per-entry loop
    within = np.arange(int(offs[-1]), dtype=np.int64) - np.repeat(offs[:-1],
                                                                   lens)
    out = d.host_bytes[np.repeat(starts, lens) + within] if len(within) \
        else np.zeros(0, dtype=np.uint8)
    return codes, offs.astype(np.int32), np.ascontiguousarray(out, np.uint8)


def _string_payload(col: HostColumnVector, n: int,
                    validity: np.ndarray) -> List[bytes]:
    """Offsets int32 [n + 1] and the bytes of the valid rows (reference:
    _string_payload :119)."""
    offs, raw = col.utf8()
    offs = np.asarray(offs[:n + 1], dtype=np.int64)
    lens = np.diff(offs)
    if n and (lens[~validity[:n]] != 0).any():
        # a NULL row that kept its bytes: drop them
        keep = np.repeat(validity[:n], lens)
        raw = raw[int(offs[0]):int(offs[-1])][keep]
        lens = np.where(validity[:n], lens, 0)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
    else:
        raw = raw[int(offs[0]):int(offs[-1])] if n else raw[:0]
        offs = offs - offs[0] if n else np.zeros(1, dtype=np.int64)
    if int(offs[-1]) > np.iinfo(np.int32).max:
        raise ValueError(
            f"string payload of {int(offs[-1])} bytes exceeds the 2 GiB "
            "serialized batch limit; reduce rapids.tpu.sql.batchSizeBytes")
    return [offs.astype(np.int32).tobytes(),
            np.ascontiguousarray(raw, dtype=np.uint8).tobytes()]


def serialize_batch(batch: HostColumnarBatch) -> bytes:
    """Host batch -> TPB1 bytes (reference: serialize_batch :141)."""
    n = batch.num_rows
    parts: List[bytes] = []
    headers: List[bytes] = []
    for col in batch.columns:
        validity = np.ascontiguousarray(col.validity[:n], dtype=bool)
        payload: List[bytes] = [
            np.packbits(validity, bitorder="little").tobytes()]
        if getattr(col, "dictionary", None) is not None:
            codes, offs, dbytes = _pruned_dict_piece(col, n, validity)
            payload += [codes.tobytes(), struct.pack("<I", len(offs) - 1),
                        offs.tobytes(), dbytes.tobytes()]
            vcode, _ = _dtype_code(col.dictionary.value_dtype)
            headers.append(_COLHDR.pack(_DICT_STRING_CODE, 1, vcode,
                                        sum(len(p) for p in payload)))
            parts.extend(payload)
            continue
        if col.dtype is DataType.STRING:
            payload.extend(_string_payload(col, n, validity))
        else:
            npdt = col.dtype.to_np()
            data = np.ascontiguousarray(col.data[:n], dtype=npdt)
            if not validity.all():
                data = np.where(validity, data, npdt.type(0))
            payload.append(data.tobytes())
        code, extra = _dtype_code(col.dtype)
        headers.append(_COLHDR.pack(code, 1, extra,
                                    sum(len(p) for p in payload)))
        parts.extend(payload)
    return b"".join(
        [_HEADER.pack(MAGIC, n, len(batch.columns))] + headers + parts)


def _parse(buf, decode_strings: bool) -> HostColumnarBatch:
    mv = memoryview(buf)
    magic, n, ncols = _HEADER.unpack_from(mv, 0)
    if magic != MAGIC:
        raise ValueError(f"bad batch magic {magic!r}")
    off = _HEADER.size
    col_meta = []
    for _ in range(ncols):
        code, _nullable, extra, plen = _COLHDR.unpack_from(mv, off)
        off += _COLHDR.size
        col_meta.append((code, extra, plen))
    vbytes = (n + 7) // 8
    cols: List[HostColumnVector] = []
    for code, extra, plen in col_meta:
        end = off + plen
        validity = np.unpackbits(
            np.frombuffer(mv, dtype=np.uint8, count=vbytes, offset=off),
            bitorder="little")[:n].astype(bool)
        doff = off + vbytes
        if code == _DICT_STRING_CODE:
            from spark_rapids_tpu_torch.columnar.encoded import (
                DeviceDictionary,
                HostDictionaryColumn,
            )

            dt = _code_dtype(extra, 0) if extra else DataType.STRING
            codes = np.frombuffer(mv, dtype=np.int32, count=n,
                                  offset=doff).copy()
            p = doff + 4 * n
            (ndv,) = struct.unpack_from("<I", mv, p)
            p += 4
            offsets = np.frombuffer(mv, dtype=np.int32, count=ndv + 1,
                                    offset=p).copy()
            p += 4 * (ndv + 1)
            dbytes = np.frombuffer(mv, dtype=np.uint8,
                                   count=int(offsets[ndv]), offset=p).copy()
            d = DeviceDictionary.from_byte_table(dbytes, offsets, dt)
            cols.append(HostDictionaryColumn(dt, codes, validity, d))
        else:
            dt = _code_dtype(code, extra)
            if dt is DataType.STRING:
                offsets = np.frombuffer(mv, dtype=np.int32, count=n + 1,
                                        offset=doff)
                sbytes = np.frombuffer(mv, dtype=np.uint8,
                                       count=int(offsets[n]),
                                       offset=doff + 4 * (n + 1))
                if decode_strings:
                    offsets, sbytes = offsets.copy(), sbytes.copy()
                    data = S.decode_utf8(offsets, sbytes, validity, n)
                else:
                    # upload-only: the UTF-8 form is all to_device reads
                    data = np.broadcast_to(np.array("", dtype=object), (n,))
                cols.append(HostColumnVector(dt, data, validity,
                                             (offsets, sbytes)))
            else:
                data = np.frombuffer(mv, dtype=dt.to_np(), count=n,
                                     offset=doff)
                cols.append(HostColumnVector(
                    dt, data.copy() if decode_strings else data, validity))
        off = end
    return HostColumnarBatch(cols, n)


def serialized_rows(buf: bytes) -> int:
    """The row count in a TPB1 header."""
    return int(_HEADER.unpack_from(buf, 0)[1])


def deserialize_batch(buf: bytes) -> HostColumnarBatch:
    """TPB1 bytes -> host batch (reference: deserialize_batch :182)."""
    return _parse(buf, decode_strings=True)


def deserialize_to_device(buf: bytes, device) -> ColumnarBatch:
    """TPB1 bytes -> device batch through the grouped upload, without
    decoding strings on the host (the spill tier's rematerialisation)."""
    return _parse(buf, decode_strings=False).to_device(device)


def serialize_device_batch(batch: ColumnarBatch) -> bytes:
    """The TPB1 bytes of serialize_batch(batch.to_host()), encoded columns
    kept as codes with a pruned dictionary (the reference's spill:
    to_host_many(keep_encoded=True) then serialize_batch). Every column
    tensor is copied on its own into pinned host memory (no device
    allocation, no torch.cat), then one wait."""
    from spark_rapids_tpu_torch.columnar.batch import ensure_compact

    batch = ensure_compact(batch)
    n = batch.host_rows()
    dev = batch.device if batch.columns else torch.device("cpu")
    pin = dev.type == "cuda"

    def host(t: torch.Tensor) -> np.ndarray:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        out.copy_(t, non_blocking=pin)
        return out

    staged = []
    for c in batch.columns:
        if c.offsets is not None:
            staged.append((c, host(c.offsets[:n + 1]), host(c.data),
                           host(c.validity[:n])))
        else:
            staged.append((c, host(c.data[:n]), None, host(c.validity[:n])))
    if pin:
        torch.cuda.current_stream(dev).synchronize()
    cols: List[HostColumnVector] = []
    for c, a, b, v in staged:
        valid = v.numpy()
        d = getattr(c, "dictionary", None)
        if d is not None:
            from spark_rapids_tpu_torch.columnar.encoded import (
                HostDictionaryColumn,
            )

            cols.append(HostDictionaryColumn(c.dtype, a.numpy(), valid, d))
        elif b is not None:
            cols.append(HostColumnVector(
                c.dtype, np.broadcast_to(np.array("", dtype=object), (n,)),
                valid, (a.numpy(), b.numpy())))
        else:
            data = a.numpy()
            npdt = c.dtype.to_np()
            cols.append(HostColumnVector(
                c.dtype, data if data.dtype == npdt else data.astype(npdt),
                valid))
    return serialize_batch(HostColumnarBatch(cols, n))
