"""Device-side Parquet column decode (port of
spark_rapids_tpu/io/parquet_device.py).

The split is the reference's: the HOST walks page headers and the RLE /
bit-packed run tables of the definition levels and dictionary indices
(runs, not values; native/srt_io.cpp), counts each page's present values
from its level runs, decompresses pages (Snappy in the native library, GZIP
through zlib) and uploads the chunk's bytes once. The DEVICE produces every
value in one pass per chunk: K20 `hybrid_expand` expands the level and
index runs, K21 `page_decode_fixed` spreads dense values onto their rows
(from PLAIN pages or through the dictionary), and STRING columns gather
their bytes with K7 (csrc/string_gather.cu): by (start, length) span for
PLAIN pages, by index through the dictionary's (offsets, bytes) table for
dictionary pages.

Scope: flat columns, PLAIN and PLAIN_DICTIONARY / RLE_DICTIONARY pages, v1
and v2; INT32, INT64, FLOAT, DOUBLE, DATE, TIMESTAMP (microseconds),
DECIMAL over INT32 / INT64, BOOLEAN (PLAIN bits and v2 RLE) and STRING;
UNCOMPRESSED, SNAPPY and GZIP. DELTA_BINARY_PACKED, DELTA_BYTE_ARRAY,
DELTA_LENGTH_BYTE_ARRAY and BYTE_STREAM_SPLIT pages, FIXED_LEN_BYTE_ARRAY
decimals, ZSTD / LZ4 / BROTLI chunks and a chunk that mixes dictionary and
PLAIN pages raise an error that names them (ROADMAP.md); nothing is
decoded elsewhere instead.

Encoded emission (reference :1010-1030 fixed, :1409-1430 strings): a
dictionary chunk of a STRING, INT64, DATE or TIMESTAMP column whose ndv /
rows clears rapids.tpu.sql.encoded.maxDictFraction leaves the scan as a
DictionaryColumn (columnar/encoded.py). The host part interns the
dictionary from the dictionary page it parses; the device part runs K20
over the indices and K21 in codes mode, which spreads them onto their
rows as int32 codes, with no dictionary gather.

Every kernel wrapper takes its plain PyTorch version for CPU tensors (the
tests and the port's CPU scan) and launches its kernel for CUDA tensors.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar import strings as S
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector,
    bucket_capacity,
    gather_string_spans,
    gather_strings,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch
from spark_rapids_tpu_torch.io.parquet_meta import (
    ChunkMeta,
    ColumnSchema,
    ENCODING_NAMES,
    ParquetFormatError,
    SUPPORTED_CODECS,
    T_INT32,
)

PAGE_DATA_V1 = 0
PAGE_DICT = 2
PAGE_DATA_V2 = 3
ENC_PLAIN = 0
ENC_PLAIN_DICT = 2
ENC_RLE = 3
ENC_RLE_DICT = 8
SUPPORTED_ENCODINGS = {"PLAIN", "PLAIN_DICTIONARY", "RLE_DICTIONARY", "RLE",
                       "BIT_PACKED"}


@dataclass
class PageInfo:
    kind: int            # PAGE_DATA_V1 | PAGE_DICT | PAGE_DATA_V2
    num_values: int
    encoding: int
    data_start: int      # offset of the page payload within the chunk
    data_len: int
    uncompressed_len: int = -1
    def_len: int = 0     # v2: definition-level bytes (never prefixed)
    rep_len: int = 0     # v2: repetition-level bytes (0 when flat)
    data_compressed: bool = True  # v2: is the data section compressed?


def parse_pages(chunk) -> List[PageInfo]:
    """Walk the page headers of one raw column chunk (reference :194)."""
    try:
        cols = native.parse_pages(chunk)
    except native.UnsupportedPage as e:
        raise ParquetFormatError(str(e)) from None
    return [PageInfo(int(k), int(nv), int(enc), int(ds), int(dl), int(ul),
                     int(df), int(rp), bool(dc))
            for k, nv, enc, ds, dl, ul, df, rp, dc in zip(*cols)]


@dataclass
class RunTable:
    """One RLE / bit-packed hybrid stream: per run its output start and a
    repeated value (RLE) or the absolute bit offset of its packed values."""

    out_start: np.ndarray   # int64 [n_runs]
    is_rle: np.ndarray      # bool  [n_runs]
    value: np.ndarray       # int32 [n_runs] (RLE runs)
    bit_off: np.ndarray     # int64 [n_runs] (bit-packed runs)
    total: int              # values described (bit-packed pads to 8)


def parse_runs(chunk, start: int, end: int, bit_width: int,
               num_values: int) -> RunTable:
    """Run table of chunk[start:end) (reference :359)."""
    return RunTable(*native.parse_runs(chunk, start, end, bit_width,
                                       num_values))


# ---------------------------------------------------------------------------
# Host page decompression
# ---------------------------------------------------------------------------
def _codec_error(codec: str) -> ParquetFormatError:
    return ParquetFormatError(
        f"compression codec {codec} is not supported (UNCOMPRESSED, "
        "SNAPPY and GZIP are; ZSTD, LZ4 and BROTLI are queued)")


def _decompress_into(codec: str, payload, out: np.ndarray) -> None:
    """Decompress one page payload into `out` (its exact size)."""
    if codec == "SNAPPY":
        native.snappy_decompress_into(payload, out)
        return
    if codec == "GZIP":
        data = zlib.decompress(bytes(payload), 47)  # gzip or zlib header
        if len(data) != out.size:
            raise ParquetFormatError(f"GZIP page inflates to {len(data)} "
                                     f"bytes, header says {out.size}")
        out[:] = np.frombuffer(data, np.uint8)
        return
    raise _codec_error(codec)


def normalize_chunk(chunk: bytes, codec: str, pin: bool = False
                    ) -> Tuple[torch.Tensor, List[PageInfo]]:
    """Decompress every page payload of a raw column chunk (reference
    :305): (uncompressed chunk as a uint8 host tensor, pages with offsets
    into it). v2 pages keep their level bytes, which are never compressed.
    pin: decompress straight into pinned memory, the one host copy an
    upload to the card needs."""
    pages = parse_pages(chunk)
    if codec != "UNCOMPRESSED" and codec not in SUPPORTED_CODECS:
        raise _codec_error(codec)
    if codec == "UNCOMPRESSED":
        out = torch.empty(len(chunk), dtype=torch.uint8, pin_memory=pin)
        out.numpy()[:] = np.frombuffer(chunk, np.uint8)
        return out, pages
    sizes = [p.data_len if p.kind == PAGE_DATA_V2 and not p.data_compressed
             else p.uncompressed_len for p in pages]
    out = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=pin)
    host = out.numpy()
    raw = memoryview(chunk)
    pos = 0
    new_pages = []
    for p, usize in zip(pages, sizes):
        payload = raw[p.data_start:p.data_start + p.data_len]
        dst = host[pos:pos + usize]
        if p.kind == PAGE_DATA_V2:
            lvl = p.rep_len + p.def_len
            dst[:lvl] = np.frombuffer(payload[:lvl], np.uint8)
            if p.data_compressed and usize > lvl:
                _decompress_into(codec, payload[lvl:], dst[lvl:])
            else:
                dst[lvl:] = np.frombuffer(payload[lvl:], np.uint8)
        elif usize:
            _decompress_into(codec, payload, dst)
        new_pages.append(replace(p, data_start=pos, data_len=usize,
                                 uncompressed_len=usize,
                                 data_compressed=False))
        pos += usize
    return out, new_pages


def unsupported_reason(chunk: ChunkMeta, col: ColumnSchema) -> str:
    """Why this column chunk cannot decode here, or '' when it can (the
    reference's column_eligible :652, which picked the Arrow host path;
    the port has none, so its scan raises the reason)."""
    if col.dtype is None:
        return col.unsupported
    if chunk.codec not in SUPPORTED_CODECS:
        return f"column {col.name!r}: {_codec_error(chunk.codec)}"
    bad = [e for e in chunk.encodings if e not in SUPPORTED_ENCODINGS]
    if bad:
        return (f"column {col.name!r}: encoding {', '.join(bad)} is queued "
                "(PLAIN and dictionary pages are read)")
    return ""


# ---------------------------------------------------------------------------
# K20 hybrid_expand
# ---------------------------------------------------------------------------
@dataclass
class DeviceRuns:
    """A run table on the device, with a bit width per run."""

    out_start: torch.Tensor  # int64
    is_rle: torch.Tensor     # uint8
    value: torch.Tensor      # int32
    bit_off: torch.Tensor    # int64
    width: torch.Tensor      # int32
    total: int               # lanes the runs cover


def hybrid_expand_plain(chunk: torch.Tensor, runs: DeviceRuns,
                        cap: int) -> torch.Tensor:
    """values[j], j < cap, of a run table over chunk's bytes (reference:
    _expand_hybrid :443): the last run starting at or before j gives its
    RLE value or the bits at bit_off + (j - start) * width; lanes past the
    runs, before the first run and bytes past the chunk read as 0."""
    dev = chunk.device
    n_runs = int(runs.out_start.shape[0])
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    if n_runs == 0 or cap == 0:
        return torch.zeros(cap, dtype=torch.int32, device=dev)
    r = torch.searchsorted(runs.out_start, j, right=True) - 1
    has = (r >= 0) & (j < runs.total)
    rc = r.clamp(0, n_runs - 1)
    w = runs.width[rc].long()
    bitpos = runs.bit_off[rc] + (j - runs.out_start[rc]) * w
    nbytes = int(chunk.shape[0])
    padded = torch.cat([chunk, torch.zeros(9, dtype=torch.uint8,
                                           device=dev)])
    byte = (bitpos >> 3).clamp(0, nbytes + 8)
    word = torch.zeros(cap, dtype=torch.int64, device=dev)
    for o in range(8):
        word |= padded[(byte + o).clamp(max=nbytes + 8)].long() << (8 * o)
    mask = (torch.ones_like(w) << w) - 1
    packed = (word >> (bitpos & 7)) & mask
    rle = runs.is_rle[rc] != 0
    v = torch.where(rle, runs.value[rc].long() & 0xFFFFFFFF, packed)
    v = torch.where(has, v, torch.zeros((), dtype=torch.int64, device=dev))
    return (v - ((v >> 31) << 32)).to(torch.int32)


def hybrid_expand(chunk: torch.Tensor, runs: DeviceRuns,
                  cap: int) -> torch.Tensor:
    """K20 (replaces parquet_device.py:_expand_hybrid :443 and
    _extract_bits_lsb :615): int32 [cap]."""
    if chunk.device.type == "cpu":
        return hybrid_expand_plain(chunk, runs, cap)
    CB.require_cuda(chunk, runs.out_start, runs.is_rle, runs.value,
                    runs.bit_off, runs.width)
    out = torch.empty(cap, dtype=torch.int32, device=chunk.device)
    lib = CB.library("parquet_decode")
    rc = lib.srt_hybrid_expand(
        chunk.data_ptr(), int(chunk.shape[0]), runs.out_start.data_ptr(),
        runs.is_rle.data_ptr(), runs.value.data_ptr(),
        runs.bit_off.data_ptr(), runs.width.data_ptr(),
        int(runs.out_start.shape[0]), int(runs.total), out.data_ptr(), cap,
        CB.stream_of(chunk))
    CB.count_launch("hybrid_expand")
    CB.check(lib, rc, "hybrid_expand")
    return out


# ---------------------------------------------------------------------------
# K21 page_decode_fixed
# ---------------------------------------------------------------------------
@dataclass
class DictSource:
    """Values through a dictionary: idx int32 [n] dense indices, dict
    uint8 [n_dict * in_w] the dictionary's values."""

    idx: torch.Tensor
    dict_bytes: torch.Tensor


@dataclass
class PlainSource:
    """Values from PLAIN pages: src uint8 bytes, dense_end / byte_pos int64
    [pages]: page p's dense values end at dense_end[p] and start at
    byte_pos[p] of src."""

    src: torch.Tensor
    dense_end: torch.Tensor
    byte_pos: torch.Tensor


def _from_le(v: torch.Tensor, out_w: int, out_dtype) -> torch.Tensor:
    """int64 lanes -> the low out_w bytes as out_dtype."""
    if out_w == 8:
        return v.view(out_dtype) if out_dtype != torch.int64 else v
    if out_dtype is torch.bool:
        return v != 0
    inter = {4: torch.int32, 2: torch.int16, 1: torch.int8}[out_w]
    low = v & ((1 << (8 * out_w)) - 1)
    low = low - ((low >> (8 * out_w - 1)) << (8 * out_w))
    t = low.to(inter)
    return t if inter == out_dtype else t.view(out_dtype)


def page_decode_fixed_plain(def_levels: Optional[torch.Tensor], num_rows: int,
                            cap: int, source, in_w: int, out_dtype,
                            sign_extend: bool):
    """(data [cap], validity [cap]) of a fixed-width chunk (reference:
    _flat_plain_kernel :865 / _flat_dict_kernel :810, _assemble :634 and
    _flat_finish :892): row j holds a value when j < num_rows and its
    level is 1; its dense slot is the count of such rows before it."""
    dev = source.idx.device if isinstance(source, DictSource) \
        else source.src.device
    lane = torch.arange(cap, dtype=torch.int64, device=dev)
    ok = lane < num_rows
    if def_levels is not None:
        ok = ok & (def_levels[:cap] != 0)
        slot = torch.cumsum(ok.long(), 0) - 1
    else:
        slot = lane
    if isinstance(source, DictSource):
        buf = source.dict_bytes
        n_dict = int(buf.shape[0]) // in_w
        n_idx = int(source.idx.shape[0])
        if n_idx == 0 or n_dict == 0:
            pos = torch.full((cap,), -in_w, dtype=torch.int64, device=dev)
        else:
            ix = source.idx[slot.clamp(0, n_idx - 1)].long()
            pos = ix.clamp(0, n_dict - 1) * in_w
    else:
        buf = source.src
        ends = source.dense_end
        n_pages = int(ends.shape[0])
        if n_pages == 0:
            pos = torch.full((cap,), -in_w, dtype=torch.int64, device=dev)
        else:
            page = torch.searchsorted(ends, slot, right=True).clamp(
                max=n_pages - 1)
            first = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                               ends[:-1]])
            pos = source.byte_pos[page] + (slot - first[page]) * in_w
    n = int(buf.shape[0])
    padded = torch.cat([torch.zeros(8, dtype=torch.uint8, device=dev), buf,
                        torch.zeros(8, dtype=torch.uint8, device=dev)])
    v = torch.zeros(cap, dtype=torch.int64, device=dev)
    for k in range(in_w):
        at = (pos + k).clamp(-8, n + 7) + 8
        v |= padded[at].long() << (8 * k)
    if sign_extend and in_w < 8:
        sh = 64 - 8 * in_w
        v = (v << sh) >> sh
    v = torch.where(ok, v, torch.zeros((), dtype=torch.int64, device=dev))
    out_w = torch.empty(0, dtype=out_dtype).element_size()
    return _from_le(v, out_w, out_dtype), ok


def page_decode_fixed(def_levels: Optional[torch.Tensor], num_rows: int,
                      cap: int, source, in_w: int, out_dtype,
                      sign_extend: bool = False):
    """K21 (replaces _flat_plain_kernel :865, _flat_dict_kernel's gather
    :810, _bitcast_values :624, _assemble :634, _flat_finish :892)."""
    dict_mode = isinstance(source, DictSource)
    lead = source.idx if dict_mode else source.src
    if lead.device.type == "cpu":
        return page_decode_fixed_plain(def_levels, num_rows, cap, source,
                                       in_w, out_dtype, sign_extend)
    dev = lead.device
    tensors = [source.idx, source.dict_bytes] if dict_mode else \
        [source.src, source.dense_end, source.byte_pos]
    if def_levels is not None:
        tensors.append(def_levels)
    CB.require_cuda(*tensors)
    out_w = torch.empty(0, dtype=out_dtype).element_size()
    out = torch.empty(cap * out_w, dtype=torch.uint8, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    lib = CB.library("parquet_decode")
    scratch = torch.empty(
        int(lib.srt_page_decode_scratch_bytes(cap))
        if def_levels is not None else 0, dtype=torch.uint8, device=dev)
    null = None
    if dict_mode:
        args = (source.idx.data_ptr(), int(source.idx.shape[0]),
                source.dict_bytes.data_ptr(),
                int(source.dict_bytes.shape[0]) // in_w, null, 0, null, null,
                0)
    else:
        args = (null, 0, null, 0, source.src.data_ptr(),
                int(source.src.shape[0]), source.dense_end.data_ptr(),
                source.byte_pos.data_ptr(), int(source.dense_end.shape[0]))
    rc = lib.srt_page_decode_fixed(
        def_levels.data_ptr() if def_levels is not None else null,
        int(num_rows), cap, 1 if dict_mode else 0, *args, in_w, out_w,
        1 if sign_extend else 0, out.data_ptr(), valid.data_ptr(),
        scratch.data_ptr() if scratch.numel() else null, scratch.numel(),
        CB.stream_of(lead))
    CB.count_launch("page_decode_fixed")
    CB.check(lib, rc, "page_decode_fixed")
    data = out.view(out_dtype) if out_dtype is not torch.bool else \
        out.view(torch.bool)
    return data, valid


def page_decode_codes_plain(def_levels: Optional[torch.Tensor],
                            num_rows: int, cap: int,
                            idx: torch.Tensor) -> torch.Tensor:
    """int32 codes [cap]: K21's plain spread over a one-page source of the
    dense indices."""
    idx = idx.to(torch.int32).contiguous()
    dev = idx.device
    source = PlainSource(idx.view(torch.uint8),
                         torch.tensor([idx.shape[0]], dtype=torch.int64,
                                      device=dev),
                         torch.zeros(1, dtype=torch.int64, device=dev))
    return page_decode_fixed_plain(def_levels, num_rows, cap, source, 4,
                                   torch.int32, False)[0]


def page_decode_codes(def_levels: Optional[torch.Tensor], num_rows: int,
                      cap: int, idx: torch.Tensor) -> torch.Tensor:
    """K21's codes mode (replaces _flat_dict_codes_kernel :824 with
    _flat_finish :892): dense dictionary indices int32 [present] spread onto
    their rows as int32 codes [cap], 0 where a row holds no value; no clip,
    no dictionary gather."""
    idx = idx.to(torch.int32).contiguous()
    if idx.device.type == "cpu":
        return page_decode_codes_plain(def_levels, num_rows, cap, idx)
    tensors = [idx] + ([def_levels] if def_levels is not None else [])
    CB.require_cuda(*tensors)
    dev = idx.device
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    lib = CB.library("parquet_decode")
    scratch = torch.empty(
        int(lib.srt_page_decode_scratch_bytes(cap))
        if def_levels is not None else 0, dtype=torch.uint8, device=dev)
    null = None
    rc = lib.srt_page_decode_fixed(
        def_levels.data_ptr() if def_levels is not None else null,
        int(num_rows), cap, 2, idx.data_ptr(), int(idx.shape[0]), null, 0,
        null, 0, null, null, 0, 4, 4, 0, out.data_ptr(), valid.data_ptr(),
        scratch.data_ptr() if scratch.numel() else null, scratch.numel(),
        CB.stream_of(idx))
    CB.count_launch("page_decode_codes")
    CB.check(lib, rc, "page_decode_codes")
    return out


# ---------------------------------------------------------------------------
# Column chunk decode: the host half, then the device half
# ---------------------------------------------------------------------------
def _in_width(dtype, physical: int) -> int:
    if dtype is DataType.BOOL:
        return 1
    if dtype in (DataType.INT8, DataType.INT16, DataType.INT32,
                 DataType.DATE, DataType.FLOAT32):
        return 4
    if getattr(dtype, "is_decimal", False):
        return 4 if physical == T_INT32 else 8
    return 8


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: through pinned memory to a card (one
    copy; the caching host allocator keeps the buffer until the copy
    ends), as a tensor of its own on the CPU."""
    arr = np.ascontiguousarray(arr)
    if device.type == "cpu":
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    pinned = torch.empty(arr.shape, dtype=torch.from_numpy(
        np.zeros(0, arr.dtype)).dtype, pin_memory=True)
    pinned.numpy()[...] = arr
    return pinned.to(device, non_blocking=True)


def device_runs(tabs, device, total: int) -> DeviceRuns:
    """A run table on `device` from (out_start, is_rle, value, bit_off,
    width) parts, covering `total` lanes."""
    cols = [np.concatenate([t[i] for t in tabs]) for i in range(5)]
    return DeviceRuns(_upload(cols[0].astype(np.int64), device),
                      _upload(cols[1].astype(np.uint8), device),
                      _upload(cols[2].astype(np.int32), device),
                      _upload(cols[3].astype(np.int64), device),
                      _upload(cols[4].astype(np.int32), device), total)


def _shifted(rt: RunTable, shift: int, width: int):
    return (rt.out_start + shift, rt.is_rle, rt.value, rt.bit_off,
            np.full(len(rt.out_start), width, np.int32))


def _one_run(start: int, is_rle: bool, value: int, bit_off: int,
             width: int):
    return (np.asarray([start], np.int64), np.asarray([is_rle]),
            np.asarray([value], np.int32), np.asarray([bit_off], np.int64),
            np.asarray([width], np.int32))


def _u32(buf: np.ndarray, pos: int, end: int, what: str) -> int:
    if pos + 4 > end:
        raise ParquetFormatError(f"{what}: truncated length prefix")
    return int(buf[pos]) | int(buf[pos + 1]) << 8 | \
        int(buf[pos + 2]) << 16 | int(buf[pos + 3]) << 24


@dataclass
class HostChunk:
    """A column chunk after the host's part of its decode: decompressed
    bytes, the run tables and page tables the kernels take."""

    dtype: object
    num_rows: int
    max_def: int
    buf_t: torch.Tensor   # the decompressed chunk (pinned for a card)
    buf: np.ndarray       # its numpy view
    dict_pages: list
    dict_mode: bool
    def_tabs: list
    val_tabs: list
    plain_end: list
    plain_pos: list
    str_parts: list
    rows: int
    present: int
    in_w: int
    what: str
    dictionary: object = None  # a DeviceDictionary: emit the chunk encoded


def decode_chunk_device(chunk: bytes, dtype, num_rows: int, max_def: int,
                        cap: Optional[int] = None,
                        codec: str = "UNCOMPRESSED",
                        device=torch.device("cpu"), physical: int = -1,
                        name: str = "?",
                        encode_fraction: Optional[float] = None
                        ) -> ColumnVector:
    """Decode one raw column chunk into a ColumnVector on `device`
    (reference: decode_chunk_device :1083, whose whole-chunk fixed-width
    form is _try_flat_fixed :902; here every type takes the whole-chunk
    form). max_def: 1 for an OPTIONAL column, 0 for a REQUIRED one, whose
    pages carry no definition levels. physical: the Parquet physical type
    (it sets the value width of a DECIMAL column). encode_fraction: see
    keep_encoded."""
    device = torch.device(device)
    hc = prepare_chunk(chunk, dtype, num_rows, max_def, codec, physical,
                       name, device.type == "cuda")
    return decode_prepared(keep_encoded(hc, encode_fraction), cap, device)


def prepare_chunk(chunk: bytes, dtype, num_rows: int, max_def: int,
                  codec: str = "UNCOMPRESSED", physical: int = -1,
                  name: str = "?", pin: bool = False) -> HostChunk:
    """The host's part of a chunk's decode: decompression, the page walk,
    level and index run tables, present counts and PLAIN string spans.
    Native code and numpy release the GIL, so a scan runs the columns of
    a row group on threads. pin: stage the chunk in pinned memory (for a
    decode on the card)."""
    what = f"column {name!r}"
    if max_def > 1:
        raise ParquetFormatError(f"{what} is nested (max definition level "
                                 f"{max_def}): only flat schemas are read")
    buf_t, pages = normalize_chunk(chunk, codec, pin)
    buf = buf_t.numpy()
    is_string = dtype is DataType.STRING
    is_bool = dtype is DataType.BOOL
    dict_pages = [p for p in pages if p.kind == PAGE_DICT]
    data_pages = [p for p in pages if p.kind != PAGE_DICT]
    if len(dict_pages) > 1:
        raise ParquetFormatError(f"{what}: more than one dictionary page")
    ok_encs = {ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE_DICT} | \
        ({ENC_RLE} if is_bool else set())
    for p in data_pages:
        if p.encoding not in ok_encs:
            raise ParquetFormatError(
                f"{what}: {ENCODING_NAMES.get(p.encoding, p.encoding)} pages "
                "are queued (PLAIN and dictionary pages are read)")
        if p.rep_len:
            raise ParquetFormatError(f"{what}: repetition levels (a nested "
                                     "column) are not supported")
    dict_enc = {p.encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT)
                for p in data_pages}
    if len(dict_enc) > 1:
        raise ParquetFormatError(f"{what}: a chunk that mixes dictionary "
                                 "and PLAIN pages is queued")
    dict_mode = dict_enc == {True}
    if dict_mode and not dict_pages:
        raise ParquetFormatError(f"{what}: dictionary page missing")
    in_w = _in_width(dtype, physical)

    def_tabs, val_tabs, plain_end, plain_pos, str_parts = [], [], [], [], []
    rows = present = 0
    for p in data_pages:
        pos, end = p.data_start, p.data_start + p.data_len
        if p.kind == PAGE_DATA_V2:
            lvl_end = pos + p.def_len
            has_levels = max_def > 0 and p.def_len > 0
            lvl_start = pos
            pos = lvl_end
        elif max_def > 0:
            lvl_len = _u32(buf, pos, end, what)
            lvl_start, lvl_end = pos + 4, pos + 4 + lvl_len
            has_levels = True
            pos = lvl_end
        else:
            has_levels = False
        if has_levels:
            if lvl_end > end:
                raise ParquetFormatError(f"{what}: definition levels past "
                                         "the page")
            rt = parse_runs(buf, lvl_start, lvl_end, 1, p.num_values)
            n_present = native.count_ones(buf, rt.out_start, rt.is_rle,
                                          rt.value, rt.bit_off, rt.total,
                                          p.num_values)
            def_tabs.append(_shifted(rt, rows, 1))
        else:
            n_present = p.num_values
            def_tabs.append(_one_run(rows, True, 1, 0, 1))
        if dict_mode:
            if pos >= end:
                if n_present:
                    raise ParquetFormatError(f"{what}: empty index page")
                bw = 0
            else:
                bw = int(buf[pos])
                pos += 1
            if bw > 32:
                raise ParquetFormatError(f"{what}: dictionary index bit "
                                         f"width {bw}")
            if bw == 0:
                val_tabs.append(_one_run(present, True, 0, 0, 0))
            else:
                val_tabs.append(_shifted(parse_runs(buf, pos, end, bw,
                                                    n_present), present, bw))
        elif is_bool and p.encoding == ENC_RLE:
            ln = _u32(buf, pos, end, what)
            if pos + 4 + ln > end:
                raise ParquetFormatError(f"{what}: boolean RLE length {ln} "
                                         "exceeds the page")
            val_tabs.append(_shifted(parse_runs(buf, pos + 4, pos + 4 + ln,
                                                1, n_present), present, 1))
        elif is_bool:
            if pos + (n_present + 7) // 8 > end:
                raise ParquetFormatError(f"{what}: truncated PLAIN page")
            val_tabs.append(_one_run(present, False, 0, pos * 8, 1))
        elif is_string:
            str_parts.append(native.plain_strings(buf, pos, end, n_present))
        else:
            if pos + n_present * in_w > end:
                raise ParquetFormatError(f"{what}: truncated PLAIN page")
            plain_end.append(present + n_present)
            plain_pos.append(pos)
        rows += p.num_values
        present += n_present
    if rows < num_rows:
        raise ParquetFormatError(f"{what}: pages hold {rows} rows, the row "
                                 f"group {num_rows}")
    return HostChunk(dtype, num_rows, max_def, buf_t, buf, dict_pages,
                     dict_mode,
                     def_tabs, val_tabs, plain_end, plain_pos, str_parts,
                     rows, present, in_w, what)


def keep_encoded(hc: HostChunk,
                 encode_fraction: Optional[float]) -> HostChunk:
    """The host part of encoded emission: a dictionary chunk whose ndv /
    rows is at most encode_fraction (None: never) gets its dictionary
    interned from the dictionary page the walk found, and decodes to a
    DictionaryColumn."""
    if encode_fraction is None or not hc.dict_mode:
        return hc
    from spark_rapids_tpu_torch.columnar import encoded as E

    dp = hc.dict_pages[0]
    if E.scan_encoded_ok(dp.num_values, hc.num_rows, encode_fraction):
        hc.dictionary = _intern_dictionary(hc.buf, dp, hc.dtype, hc.in_w,
                                           hc.what)
    return hc


def _string_dict_table(buf: np.ndarray, dp: PageInfo, what: str):
    """(offsets int64 [ndv + 1], bytes) of a PLAIN BYTE_ARRAY dictionary
    page, built by one vectorized gather (no per-value loop)."""
    starts, lens = native.plain_strings(buf, dp.data_start,
                                        dp.data_start + dp.data_len,
                                        dp.num_values)
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    total = int(offs[-1])
    if total >= 1 << 31:
        raise ParquetFormatError(f"{what}: dictionary past 2 GiB")
    src = np.repeat(starts - offs[:-1], lens) + np.arange(total)
    return offs, buf[src]


def _intern_dictionary(buf: np.ndarray, dp: PageInfo, dtype, in_w: int,
                       what: str):
    """The interned DeviceDictionary of a chunk's dictionary page."""
    from spark_rapids_tpu_torch.columnar import encoded as E

    if dtype is DataType.STRING:
        offs, raw = _string_dict_table(buf, dp, what)
        return E.DeviceDictionary.from_byte_table(raw, offs.astype(np.int32))
    if dp.data_start + dp.num_values * in_w > len(buf):
        raise ParquetFormatError(f"{what}: truncated dictionary page")
    vals = np.frombuffer(buf, dtype=np.int32 if in_w == 4 else np.int64,
                         count=dp.num_values, offset=dp.data_start)
    return E.DeviceDictionary.from_fixed_values(vals, dtype)


def decode_prepared(hc: HostChunk, cap: Optional[int],
                    device) -> ColumnVector:
    """The device's part: upload the chunk once, expand the runs (K20),
    spread values onto rows (K21) or gather strings (K7)."""
    device = torch.device(device)
    dtype, num_rows, buf, in_w, what = hc.dtype, hc.num_rows, hc.buf, \
        hc.in_w, hc.what
    rows, present, dict_pages, dict_mode = hc.rows, hc.present, \
        hc.dict_pages, hc.dict_mode
    cap = cap or bucket_capacity(max(num_rows, 1))
    is_string = dtype is DataType.STRING
    chunk_t = hc.buf_t.to(device, non_blocking=True)
    def_levels = None
    if hc.max_def > 0:
        def_levels = hybrid_expand(chunk_t, device_runs(
            hc.def_tabs, device, rows), cap) if hc.def_tabs else \
            torch.zeros(cap, dtype=torch.int32, device=device)
    cap_p = bucket_capacity(max(present, 1))
    idx = hybrid_expand(chunk_t, device_runs(hc.val_tabs, device, present),
                        cap_p) if hc.val_tabs else \
        torch.zeros(cap_p, dtype=torch.int32, device=device)
    if hc.dictionary is not None:
        from spark_rapids_tpu_torch.columnar import encoded as E

        valid = torch.arange(cap, device=device) < num_rows
        if def_levels is not None:
            valid = valid & (def_levels != 0)
        codes = page_decode_codes(def_levels, num_rows, cap,
                                  idx[:max(present, 1)])
        out = E.DictionaryColumn(dtype, codes, valid, hc.dictionary)
        E.record_scan_emission(out)
        return out
    if is_string:
        return _decode_strings(chunk_t, buf, dict_pages, dict_mode,
                               hc.str_parts, idx if dict_mode else None,
                               def_levels, num_rows, cap, present, device,
                               what)
    out_dtype = to_torch(dtype)
    if dtype is DataType.BOOL:
        source = DictSource(idx, _upload(np.asarray([0, 1], np.uint8),
                                         device))
    elif dict_mode:
        dp = dict_pages[0]
        if dp.data_start + dp.num_values * in_w > len(buf):
            raise ParquetFormatError(f"{what}: truncated dictionary page")
        source = DictSource(
            idx, chunk_t[dp.data_start:dp.data_start + dp.num_values * in_w])
    else:
        source = PlainSource(
            chunk_t, _upload(np.asarray(hc.plain_end, np.int64), device),
            _upload(np.asarray(hc.plain_pos, np.int64), device))
    data, valid = page_decode_fixed(def_levels, num_rows, cap, source, in_w,
                                    out_dtype, sign_extend=in_w < 8 and
                                    getattr(dtype, "is_decimal", False))
    return ColumnVector(dtype, data, valid)


def _spread(def_levels, num_rows: int, cap: int, dense: torch.Tensor
            ) -> torch.Tensor:
    """Dense int32 / int64 values (one per present row) onto their rows:
    K21 over a one-page PLAIN source; null rows read 0."""
    w = dense.element_size()
    dev = dense.device
    source = PlainSource(dense.contiguous().view(torch.uint8),
                         _upload(np.asarray([dense.shape[0]], np.int64), dev),
                         _upload(np.zeros(1, np.int64), dev))
    out, _ = page_decode_fixed(def_levels, num_rows, cap, source, w,
                               dense.dtype)
    return out


def _decode_strings(chunk_t, buf, dict_pages, dict_mode, str_parts, idx,
                    def_levels, num_rows, cap, present, device, what):
    valid = torch.arange(cap, device=device) < num_rows
    if def_levels is not None:
        valid = valid & (def_levels != 0)
    if dict_mode:
        offs, raw = _string_dict_table(buf, dict_pages[0], what)
        lens = np.diff(offs)
        d_offs = _upload(offs.astype(np.int32), device)
        d_bytes = _upload(raw if len(raw) else np.zeros(1, np.uint8), device)
        row_idx = _spread(def_levels, num_rows, cap, idx[:max(present, 1)])
        d_lens = d_offs[1:] - d_offs[:-1]
        ok = valid & (row_idx >= 0) & (row_idx < len(lens))
        safe = torch.where(ok, row_idx, torch.zeros_like(row_idx)).long()
        byte_total = int(torch.where(ok, d_lens[safe], 0).sum()) \
            if len(lens) else 0
        offsets, data, validity = gather_strings(
            d_offs, d_bytes, torch.ones(len(lens), dtype=torch.bool,
                                        device=device),
            row_idx, num_rows, valid, bucket_capacity(max(byte_total, 1)))
        max_len = int(lens.max()) if len(lens) else 1
        return ColumnVector(DataType.STRING, data, validity, offsets,
                            S.len_bucket(max_len))
    parts = str_parts or [(np.zeros(1, np.int64), np.zeros(1, np.int32))]
    starts = parts[0][0] if len(parts) == 1 else \
        np.concatenate([s for s, _ in parts])
    lens = parts[0][1] if len(parts) == 1 else \
        np.concatenate([n for _, n in parts])
    total = int(lens.sum(dtype=np.int64))
    if total >= 1 << 31:
        raise ParquetFormatError(f"{what}: a chunk's strings past 2 GiB")
    row_starts = _spread(def_levels, num_rows, cap, _upload(starts, device))
    row_lens = _spread(def_levels, num_rows, cap, _upload(lens, device))
    offsets, data, validity = gather_string_spans(
        chunk_t, row_starts, row_lens, valid, num_rows,
        bucket_capacity(max(total, 1)))
    max_len = int(lens.max()) if len(lens) else 1
    return ColumnVector(DataType.STRING, data, validity, offsets,
                        S.len_bucket(max_len))
