"""Device-side Parquet column decode (port of
spark_rapids_tpu/io/parquet_device.py).

The split is the reference's: the HOST walks page headers, the RLE /
bit-packed run tables of the definition levels and dictionary indices and
the DELTA_BINARY_PACKED block and miniblock headers (runs and miniblocks,
not values; native/srt_io.cpp), counts each page's present values from its
level runs, decompresses pages (Snappy in the native library, GZIP through
zlib) and uploads the chunk's bytes once. The DEVICE produces every value
in one pass per chunk: K20 `hybrid_expand` expands the level and index
runs, K25 `delta_expand` every DELTA stream of the chunk (values, or the
lengths of DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY pages), K21
`page_decode_pages` spreads a chunk's values onto their rows through a
page table with a kind per page (PLAIN, dictionary, BYTE_STREAM_SPLIT,
big-endian FIXED_LEN_BYTE_ARRAY, or a DELTA page's K25 values), K26
`delta_byte_array` rebuilds DELTA_BYTE_ARRAY strings, and STRING columns
gather their bytes with K7 (csrc/string_gather.cu): by (start, length)
span for PLAIN and DELTA pages, by index through the dictionary's
(offsets, bytes) table for dictionary chunks.

Scope: flat columns, v1 and v2 pages; PLAIN and PLAIN_DICTIONARY /
RLE_DICTIONARY pages of every type, DELTA_BINARY_PACKED and
BYTE_STREAM_SPLIT pages of INT32 / INT64 (BYTE_STREAM_SPLIT also FLOAT /
DOUBLE), DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY pages of STRING, and
a chunk that mixes dictionary pages with others (a writer's dictionary
fallback); INT32, INT64, FLOAT, DOUBLE, DATE, TIMESTAMP (microseconds),
DECIMAL over INT32 / INT64 and over FIXED_LEN_BYTE_ARRAY of 1-16 bytes
(precision <= 18), BOOLEAN (PLAIN bits and v2 RLE) and STRING;
UNCOMPRESSED, SNAPPY and GZIP. Still refused, each with an error that
names it (ROADMAP.md): ZSTD / LZ4 / BROTLI chunks, INT96 timestamps,
FIXED_LEN_BYTE_ARRAY decimals past precision 18, DELTA_BYTE_ARRAY (or any
DELTA / BYTE_STREAM_SPLIT) pages of a FIXED_LEN_BYTE_ARRAY column, nested
columns and partitioned input; nothing is decoded elsewhere instead.

Encoded emission (reference :1010-1030 fixed, :1409-1430 strings): a
dictionary chunk of a STRING, INT64, DATE or TIMESTAMP column whose ndv /
rows clears rapids.tpu.sql.encoded.maxDictFraction leaves the scan as a
DictionaryColumn (columnar/encoded.py). The host part interns the
dictionary from the dictionary page it parses; the device part runs K20
over the indices and K21 in codes mode, which spreads them onto their
rows as int32 codes, with no dictionary gather.

Run tables (reference :837-860, attached at :1008-1048 and :1427): a
dictionary chunk with no NULL whose index stream is RLE runs only (a
sorted column) also leaves with a host `columnar.runs.RunTable` on its
column, the runs' first rows and codes (an encoded column) or values
(through the dictionary page's raw values, a decoded fixed-width column),
which the run-aware aggregate reads (exec/aggregate.py). A decoded STRING
column, a bit-packed group or a NULL gives none; so do ORC and CSV.

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
    PHYSICAL_NAMES,
    ParquetFormatError,
    SUPPORTED_CODECS,
    T_BOOLEAN,
    T_BYTE_ARRAY,
    T_DOUBLE,
    T_FLBA,
    T_FLOAT,
    T_INT32,
    T_INT64,
)

PAGE_DATA_V1 = 0
PAGE_DICT = 2
PAGE_DATA_V2 = 3
ENC_PLAIN = 0
ENC_PLAIN_DICT = 2
ENC_RLE = 3
ENC_DELTA_BINARY = 5
ENC_DELTA_LENGTH = 6
ENC_DELTA_BYTE_ARRAY = 7
ENC_RLE_DICT = 8
ENC_BSS = 9
DICT_ENCODINGS = (ENC_PLAIN_DICT, ENC_RLE_DICT)
# the data page encodings each physical type decodes (reference:
# column_eligible :652 and the page loop's ok_encs :1157)
_BASE = {ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE_DICT}
PAGE_ENCODINGS = {
    T_BOOLEAN: _BASE | {ENC_RLE},
    T_INT32: _BASE | {ENC_DELTA_BINARY, ENC_BSS},
    T_INT64: _BASE | {ENC_DELTA_BINARY, ENC_BSS},
    T_FLOAT: _BASE | {ENC_BSS},
    T_DOUBLE: _BASE | {ENC_BSS},
    T_BYTE_ARRAY: _BASE | {ENC_DELTA_LENGTH, ENC_DELTA_BYTE_ARRAY},
    T_FLBA: _BASE,
}
# a chunk's encodings list also names its level encodings
SUPPORTED_ENCODINGS = {ENCODING_NAMES[e] for encs in PAGE_ENCODINGS.values()
                       for e in encs} | {"RLE", "BIT_PACKED"}


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
    the port has none, so its scan raises the reason). Refused: a type
    the footer reader marks (INT96, FIXED_LEN_BYTE_ARRAY past precision
    18, nested columns), ZSTD / LZ4 / BROTLI, and an encoding the
    column's physical type does not take (DELTA_BYTE_ARRAY or any DELTA /
    BYTE_STREAM_SPLIT page of a FIXED_LEN_BYTE_ARRAY column, DELTA on
    FLOAT / DOUBLE, BYTE_STREAM_SPLIT on BYTE_ARRAY). Partitioned input
    raises in scan.expand_paths."""
    if col.dtype is None:
        return col.unsupported
    if chunk.codec not in SUPPORTED_CODECS:
        return f"column {col.name!r}: {_codec_error(chunk.codec)}"
    ok = {ENCODING_NAMES[e] for e in PAGE_ENCODINGS.get(col.physical, ())}
    bad = [e for e in chunk.encodings if e not in ok | {"RLE", "BIT_PACKED"}]
    if bad:
        return (f"column {col.name!r}: encoding {', '.join(bad)} of a "
                f"{PHYSICAL_NAMES[col.physical]} column is not read "
                f"({', '.join(sorted(ok))} are)")
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
# K21 page_decode_pages: a fixed-width chunk's values onto their rows
# ---------------------------------------------------------------------------
KIND_PLAIN, KIND_DICT, KIND_BSS, KIND_FLBA, KIND_DENSE = range(5)


@dataclass
class PageSource:
    """Values of pages of several kinds, by dense slot. Page p's dense
    values end at dense_end[p] (int64 [pages]) and, for PLAIN / BSS / FLBA
    pages, start at byte byte_pos[p] of src; kind int32 [pages]. KIND_DICT
    pages read idx[slot] (int32, by dense slot) through dict_bytes (entries
    of dict_w little-endian bytes); KIND_DENSE pages read dense[slot]
    (int64 by dense slot: K25's output)."""

    src: torch.Tensor
    dense_end: torch.Tensor
    byte_pos: torch.Tensor
    kind: torch.Tensor
    idx: Optional[torch.Tensor] = None
    dict_bytes: Optional[torch.Tensor] = None
    dict_w: int = 8
    dense: Optional[torch.Tensor] = None
    # the launch counter: k21_bss / k21_flba when a page is BSS / FLBA
    label: str = "page_decode_fixed"


def page_source(src: torch.Tensor, kinds, dense_end, byte_pos, **kw
                ) -> PageSource:
    """A PageSource on src's device from host page tables."""
    dev = src.device
    kinds = [int(k) for k in kinds]
    kw.setdefault("label", "k21_bss" if KIND_BSS in kinds else "k21_flba"
                  if KIND_FLBA in kinds else "page_decode_fixed")
    return PageSource(src, _upload(np.asarray(dense_end, np.int64), dev),
                      _upload(np.asarray(byte_pos, np.int64), dev),
                      _upload(np.asarray(kinds, np.int32), dev), **kw)


def _one_page(dense: torch.Tensor, **kw) -> PageSource:
    """Dense values (one per present row) as one PLAIN page; its tables
    are filled on dense's device (no host copy)."""
    dense = dense.contiguous()

    def one(v, dt):
        return torch.full((1,), v, dtype=dt, device=dense.device)

    kw.setdefault("label", "page_decode_fixed")
    return PageSource(dense.view(torch.uint8),
                      one(dense.shape[0], torch.int64), one(0, torch.int64),
                      one(KIND_PLAIN, torch.int32), **kw)


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


def _gather_bytes(buf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """buf[pos] as int64 lanes, 0 where pos is outside buf."""
    n = int(buf.shape[0])
    inside = (pos >= 0) & (pos < n)
    if n == 0:
        return torch.zeros_like(pos)
    return torch.where(inside, buf[pos.clamp(0, n - 1)].long(),
                       torch.zeros((), dtype=torch.int64, device=pos.device))


def _load_le(buf: torch.Tensor, pos: torch.Tensor, w: int) -> torch.Tensor:
    v = torch.zeros_like(pos)
    for k in range(w):
        v |= _gather_bytes(buf, pos + k) << (8 * k)
    return v


def _sign_extend(v: torch.Tensor, w: int) -> torch.Tensor:
    if w >= 8:
        return v
    sh = 64 - 8 * w
    return (v << sh) >> sh


def page_decode_pages_plain(def_levels: Optional[torch.Tensor],
                            num_rows: int, cap: int, source: PageSource,
                            in_w: int, out_dtype, sign_extend: bool):
    """(data [cap], validity [cap]) through a page table (reference:
    _flat_plain_kernel :865, _flat_dict_kernel :810 and _flat_finish :892;
    _bitcast_values :624, _decode_bss :600 and _fold_flba_be :581 per page,
    then _concat_logical and _assemble :634): row j holds a value when
    j < num_rows and its level is 1; its dense slot is the count of such
    rows before it. PLAIN pages read in_w little-endian bytes (sign-extended when asked),
    BSS pages byte k of their i-th value at byte_pos + k * n + i (n the
    page's values), FLBA pages in_w big-endian bytes folded to int64 (sign-
    extended below 8 bytes, the low 8 above), DICT pages the dictionary
    entry of idx[slot] (clipped into range; sign-extended from dict_w
    bytes when asked), DENSE pages dense[slot] (sign-extended from in_w
    bytes when asked: a DELTA INT32 decimal)."""
    dev = source.src.device
    lane = torch.arange(cap, dtype=torch.int64, device=dev)
    ok = lane < num_rows
    if def_levels is not None:
        ok = ok & (def_levels[:cap] != 0)
        slot = torch.cumsum(ok.long(), 0) - 1
    else:
        slot = lane
    ends = source.dense_end
    n_pages = int(ends.shape[0])
    v = torch.zeros(cap, dtype=torch.int64, device=dev)
    if n_pages:
        page = torch.searchsorted(ends, slot, right=True).clamp(
            max=n_pages - 1)
        first = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           ends[:-1]])[page]
        i = slot - first
        n_p = ends[page] - first
        bp = source.byte_pos[page]
        kind = source.kind[page].long()
        buf = source.src
        plain = _load_le(buf, bp + i * in_w, min(in_w, 8))
        if sign_extend:
            plain = _sign_extend(plain, in_w)
        v = torch.where(kind == KIND_PLAIN, plain, v)
        if bool((source.kind == KIND_BSS).any()):
            bss = torch.zeros_like(v)
            for k in range(min(in_w, 8)):
                bss |= _gather_bytes(buf, bp + k * n_p + i) << (8 * k)
            v = torch.where(kind == KIND_BSS, bss, v)
        if bool((source.kind == KIND_FLBA).any()):
            fl = torch.zeros_like(v)
            for k in range(min(in_w, 8)):
                fl |= _gather_bytes(buf, bp + i * in_w + (in_w - 1 - k)) \
                    << (8 * k)
            v = torch.where(kind == KIND_FLBA, _sign_extend(fl, in_w), v)
        if source.idx is not None and source.dict_bytes is not None:
            n_dict = int(source.dict_bytes.shape[0]) // source.dict_w
            n_idx = int(source.idx.shape[0])
            if n_dict and n_idx:
                ix = source.idx[slot.clamp(0, n_idx - 1)].long().clamp(
                    0, n_dict - 1)
                dv = _load_le(source.dict_bytes, ix * source.dict_w,
                              source.dict_w)
                if sign_extend:
                    dv = _sign_extend(dv, source.dict_w)
                v = torch.where(kind == KIND_DICT, dv, v)
        if source.dense is not None and int(source.dense.shape[0]):
            dn = source.dense[slot.clamp(0, int(source.dense.shape[0]) - 1)]
            if sign_extend:
                dn = _sign_extend(dn, in_w)
            v = torch.where(kind == KIND_DENSE, dn, v)
    v = torch.where(ok, v, torch.zeros((), dtype=torch.int64, device=dev))
    out_w = torch.empty(0, dtype=out_dtype).element_size()
    return _from_le(v, out_w, out_dtype), ok


def page_decode_pages(def_levels: Optional[torch.Tensor], num_rows: int,
                      cap: int, source: PageSource, in_w: int, out_dtype,
                      sign_extend: bool = False):
    """K21 (replaces _flat_plain_kernel :865, _flat_dict_kernel's gather
    :810, _bitcast_values :624, _assemble :634, _flat_finish :892,
    _decode_bss :600, _fold_flba_be :581 and the generic page loop's
    _concat_logical + _assemble :1327-1455): one launch spreads a chunk's
    values onto their rows, whatever the kinds of its pages. Counted under
    source.label: k21_bss when a page is BYTE_STREAM_SPLIT, k21_flba when
    one is FLBA, else page_decode_fixed (page_decode_codes for the codes
    mode)."""
    if source.src.device.type == "cpu":
        return page_decode_pages_plain(def_levels, num_rows, cap, source,
                                       in_w, out_dtype, sign_extend)
    lib = CB.library("parquet_decode")
    dev = source.src.device
    opt = [t for t in (source.idx, source.dict_bytes, source.dense,
                       def_levels) if t is not None]
    CB.require_cuda(source.src, source.dense_end, source.byte_pos,
                    source.kind, *opt)
    if not 1 <= in_w <= 16 or source.dict_w not in (1, 2, 4, 8):
        raise ValueError(f"K21: value width {in_w}, dictionary "
                         f"width {source.dict_w}")
    out_w = torch.empty(0, dtype=out_dtype).element_size()
    out = torch.empty(cap * out_w, dtype=torch.uint8, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    scratch = torch.empty(
        int(lib.srt_page_decode_scratch_bytes(cap))
        if def_levels is not None else 0, dtype=torch.uint8, device=dev)
    null = None
    rc = lib.srt_page_decode_pages(
        def_levels.data_ptr() if def_levels is not None else null,
        int(num_rows), cap, source.src.data_ptr(), int(source.src.shape[0]),
        source.dense_end.data_ptr(), source.byte_pos.data_ptr(),
        source.kind.data_ptr(), int(source.dense_end.shape[0]),
        source.idx.data_ptr() if source.idx is not None else null,
        int(source.idx.shape[0]) if source.idx is not None else 0,
        source.dict_bytes.data_ptr() if source.dict_bytes is not None
        else null,
        int(source.dict_bytes.shape[0]) // source.dict_w
        if source.dict_bytes is not None else 0, source.dict_w,
        source.dense.data_ptr() if source.dense is not None else null,
        int(source.dense.shape[0]) if source.dense is not None else 0,
        in_w, out_w, 1 if sign_extend else 0, out.data_ptr(),
        valid.data_ptr(), scratch.data_ptr() if scratch.numel() else null,
        scratch.numel(), CB.stream_of(source.src))
    CB.count_launch(source.label)
    CB.check(lib, rc, "page_decode_pages")
    data = out.view(out_dtype) if out_dtype is not torch.bool else \
        out.view(torch.bool)
    return data, valid


def page_decode_codes_plain(def_levels: Optional[torch.Tensor],
                            num_rows: int, cap: int,
                            idx: torch.Tensor) -> torch.Tensor:
    """int32 codes [cap]: K21's plain version over the dense indices as
    one PLAIN page."""
    return page_decode_pages_plain(def_levels, num_rows, cap, _one_page(
        idx.to(torch.int32)), 4, torch.int32, False)[0]


def page_decode_codes(def_levels: Optional[torch.Tensor], num_rows: int,
                      cap: int, idx: torch.Tensor) -> torch.Tensor:
    """K21's codes mode (replaces _flat_dict_codes_kernel :824 with
    _flat_finish :892): dense dictionary indices int32 [present] spread onto
    their rows as int32 codes [cap], 0 where a row holds no value; no clip,
    no dictionary gather. K21 over the indices as one PLAIN page, counted
    as page_decode_codes."""
    return page_decode_pages(def_levels, num_rows, cap, _one_page(
        idx.to(torch.int32), label="page_decode_codes"), 4, torch.int32)[0]


# ---------------------------------------------------------------------------
# K25 delta_expand
# ---------------------------------------------------------------------------
@dataclass
class DeltaStreams:
    """DELTA_BINARY_PACKED streams of one chunk, on a device. Stream s
    covers lanes [lane_start[s], lane_start[s + 1]) (int64 [S + 1]) and
    writes them to out[dest[s] ...] (int64 [S]); its first value first[s]
    (int64), values per miniblock vpm[s] (int32), and its miniblocks
    [mb_first[s], mb_first[s + 1]) (int64 [S + 1]) of the miniblock table:
    bit offset into the chunk (int64), width 0-64 (int32), min delta
    (int64)."""

    lane_start: torch.Tensor
    dest: torch.Tensor
    first: torch.Tensor
    vpm: torch.Tensor
    mb_first: torch.Tensor
    mb_bit_off: torch.Tensor
    mb_width: torch.Tensor
    mb_min: torch.Tensor

    @property
    def lanes(self) -> int:
        return int(self.lane_start[-1]) if self.lane_start.numel() else 0


def delta_streams(streams, device) -> DeltaStreams:
    """A DeltaStreams on `device` from host streams: (dest, n values,
    first value, vpm, mb_bit_off, mb_width, mb_min_delta) each."""
    counts = np.asarray([s[1] for s in streams], np.int64)
    mbs = np.asarray([len(s[4]) for s in streams], np.int64)
    lane_start = np.zeros(len(streams) + 1, np.int64)
    np.cumsum(counts, out=lane_start[1:])
    mb_first = np.zeros(len(streams) + 1, np.int64)
    np.cumsum(mbs, out=mb_first[1:])

    def cat(i, dt):
        parts = [np.asarray(s[i], dt) for s in streams]
        return np.concatenate(parts) if parts else np.zeros(0, dt)

    return DeltaStreams(
        _upload(lane_start, device),
        _upload(np.asarray([s[0] for s in streams], np.int64), device),
        _upload(np.asarray([s[2] for s in streams], np.int64), device),
        _upload(np.asarray([s[3] for s in streams], np.int32), device),
        _upload(mb_first, device),
        _upload(cat(4, np.int64), device), _upload(cat(5, np.int32), device),
        _upload(cat(6, np.int64), device))


def _lshr(v: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 lanes by 0-63 bits."""
    keep = torch.where(sh == 0, torch.full_like(v, -1),
                       (torch.ones_like(v) << (64 - sh)) - 1)
    return (v >> sh) & keep


def delta_expand_plain(chunk: torch.Tensor, st: DeltaStreams,
                       out_len: int) -> torch.Tensor:
    """int64 [out_len], 0 outside the streams' lanes (reference:
    _expand_delta :520 with first_value added): lane k of stream s is its
    first value plus the sum of its deltas 1..k, delta d being miniblock
    bits (width 0-64, at bit_off + (d - 1) % vpm * width) plus the min
    delta, all modulo 2^64."""
    dev = chunk.device
    out = torch.zeros(out_len, dtype=torch.int64, device=dev)
    lanes = st.lanes
    if lanes == 0:
        return out
    j = torch.arange(lanes, dtype=torch.int64, device=dev)
    s = torch.searchsorted(st.lane_start[1:], j, right=True)
    k = j - st.lane_start[s]
    d = (k - 1).clamp(min=0)
    vpm = st.vpm[s].long()
    m = (st.mb_first[s] + d // vpm).clamp(
        max=max(int(st.mb_width.shape[0]) - 1, 0))
    has = (k > 0) & (st.mb_first[s] + d // vpm < st.mb_first[s + 1])
    if int(st.mb_width.shape[0]):
        w = st.mb_width[m].long()
        bitpos = st.mb_bit_off[m] + (d % vpm) * w
        byte, sh = bitpos >> 3, bitpos & 7
        lo = _load_le(chunk, byte, 8)
        hi = _gather_bytes(chunk, byte + 8)
        bits = _lshr(lo, sh) | torch.where(
            sh == 0, torch.zeros_like(hi), hi << (64 - sh))
        mask = torch.where(w >= 64, torch.full_like(w, -1),
                           (torch.ones_like(w) << w.clamp(max=63)) - 1)
        delta = (bits & mask) + st.mb_min[m]
        delta = torch.where(has, delta, torch.zeros_like(delta))
    else:
        delta = torch.zeros_like(j)
    v = torch.where(k == 0, st.first[s], delta)
    cs = torch.cumsum(v, 0)
    before = torch.where(st.lane_start[s] > 0,
                         cs[(st.lane_start[s] - 1).clamp(min=0)],
                         torch.zeros_like(cs))
    out[st.dest[s] + k] = cs - before
    return out


def delta_expand(chunk: torch.Tensor, st: DeltaStreams,
                 out_len: int) -> torch.Tensor:
    """K25 (replaces parquet_device.py:_expand_delta :520): every
    DELTA_BINARY_PACKED stream of a chunk in one launch; int64 [out_len],
    0 outside the streams' lanes."""
    if chunk.device.type == "cpu":
        return delta_expand_plain(chunk, st, out_len)
    lib = CB.library("parquet_decode")
    CB.require_cuda(chunk, st.lane_start, st.dest, st.first, st.vpm,
                    st.mb_first, st.mb_bit_off, st.mb_width, st.mb_min)
    dev = chunk.device
    out = torch.zeros(out_len, dtype=torch.int64, device=dev)
    lanes = st.lanes
    if lanes == 0:
        return out
    scratch = torch.empty(int(lib.srt_delta_expand_scratch_bytes(lanes)),
                          dtype=torch.uint8, device=dev)
    rc = lib.srt_delta_expand(
        chunk.data_ptr(), int(chunk.shape[0]), st.lane_start.data_ptr(),
        st.dest.data_ptr(), st.first.data_ptr(), st.vpm.data_ptr(),
        st.mb_first.data_ptr(), int(st.dest.shape[0]),
        st.mb_bit_off.data_ptr(), st.mb_width.data_ptr(),
        st.mb_min.data_ptr(), int(st.mb_width.shape[0]), lanes,
        out.data_ptr(), out_len, scratch.data_ptr(), scratch.numel(),
        CB.stream_of(chunk))
    CB.count_launch("delta_expand")
    CB.check(lib, rc, "delta_expand")
    return out


# ---------------------------------------------------------------------------
# K26 delta_byte_array
# ---------------------------------------------------------------------------
def _dba_plan_plain(plen, slen, page_lanes, n_pages):
    """(lengths int64, bad flag, per-page suffix bytes) of DELTA_BYTE_ARRAY
    lanes: a negative length, a page whose first prefix is not 0, or a
    prefix longer than the string before it is bad."""
    dev = plen.device
    n = int(plen.shape[0])
    lens = plen + slen
    j = torch.arange(n, dtype=torch.int64, device=dev)
    page = torch.searchsorted(page_lanes[1:], j, right=True)
    head = j == page_lanes[page]
    prev = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      lens[:-1]])
    bad = (plen < 0) | (slen < 0) | (head & (plen != 0)) | \
        (~head & (plen > prev))
    sums = torch.zeros(n_pages, dtype=torch.int64, device=dev)
    sums.index_add_(0, page, slen.clamp(min=0))
    return lens, bool(bad.any()) if n else False, sums


def _dba_check(total, bad, sums, suffix_base, suffix_end, what):
    if bad:
        raise ParquetFormatError(f"{what}: DELTA_BYTE_ARRAY prefix longer "
                                 "than the string before it, or a negative "
                                 "length")
    avail = np.asarray(suffix_end) - np.asarray(suffix_base)
    if (np.asarray(sums) > avail).any():
        raise ParquetFormatError(f"{what}: DELTA_BYTE_ARRAY suffixes past "
                                 "the page")
    if total >= 1 << 31:
        raise ParquetFormatError(f"{what}: a chunk's strings past 2 GiB")


def delta_byte_array_plain(chunk: torch.Tensor, plen: torch.Tensor,
                           slen: torch.Tensor, page_lanes: np.ndarray,
                           suffix_base: np.ndarray, suffix_end: np.ndarray,
                           what: str = "?"):
    """(bytes uint8 [total], offsets int64 [n + 1]) of DELTA_BYTE_ARRAY
    pages (reference: _expand_dba :548, its provider matrix): string i is
    the first plen[i] bytes of string i - 1, then its suffix; page p's
    lanes are [page_lanes[p], page_lanes[p + 1]) and its suffixes start at
    suffix_base[p] in order."""
    dev = chunk.device
    n = int(plen.shape[0])
    n_pages = len(page_lanes) - 1
    pl = torch.as_tensor(np.asarray(page_lanes, np.int64), device=dev)
    lens, bad, sums = _dba_plan_plain(plen, slen, pl, n_pages)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1])
    _dba_check(total, bad, sums.tolist(), suffix_base, suffix_end, what)
    if total == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev), offsets
    j = torch.arange(n, dtype=torch.int64, device=dev)
    page = torch.searchsorted(pl[1:], j, right=True)
    scum = torch.cumsum(slen, 0) - slen
    sstart = torch.as_tensor(np.asarray(suffix_base, np.int64),
                             device=dev)[page] + scum - scum[pl[page]]
    maxlen = int(lens.max())
    col = torch.arange(maxlen, dtype=torch.int64, device=dev)
    cand = torch.where(plen[:, None] <= col[None, :], j[:, None],
                       torch.full((), -1, dtype=torch.int64, device=dev))
    prov = torch.cummax(cand, 0).values
    row = torch.repeat_interleave(j, lens)
    jj = torch.arange(total, dtype=torch.int64, device=dev) - offsets[row]
    p = prov[row, jj].clamp(min=0)
    src = sstart[p] + jj - plen[p]
    return _gather_bytes(chunk, src).to(torch.uint8), offsets


def delta_byte_array(chunk: torch.Tensor, plen: torch.Tensor,
                     slen: torch.Tensor, page_lanes: np.ndarray,
                     suffix_base: np.ndarray, suffix_end: np.ndarray,
                     what: str = "?"):
    """K26 (replaces parquet_device.py:_expand_dba :548): a plan launch
    (lengths, a corrupt-input flag, per-page suffix bytes), one host sync
    that sizes the bytes and reads the flag, then a copy launch with one
    warp a page. plen, slen int64 [n]."""
    if chunk.device.type == "cpu":
        return delta_byte_array_plain(chunk, plen, slen, page_lanes,
                                      suffix_base, suffix_end, what)
    lib = CB.library("parquet_delta")
    dev = chunk.device
    plen, slen = plen.contiguous(), slen.contiguous()
    n = int(plen.shape[0])
    n_pages = len(page_lanes) - 1
    pl = _upload(np.asarray(page_lanes, np.int64), dev)
    sb = _upload(np.asarray(suffix_base, np.int64), dev)
    CB.require_cuda(chunk, plen, slen, pl, sb)
    lens = torch.empty(n, dtype=torch.int64, device=dev)
    # [flag, suffix bytes of each page]
    stats = torch.zeros(1 + n_pages, dtype=torch.int64, device=dev)
    rc = lib.srt_dba_plan(plen.data_ptr(), slen.data_ptr(), n, pl.data_ptr(),
                          n_pages, lens.data_ptr(), stats.data_ptr(),
                          CB.stream_of(chunk))
    CB.check(lib, rc, "delta_byte_array plan")
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offsets[1:])
    host = torch.cat([offsets[-1:], stats]).tolist()
    total = host[0]
    _dba_check(total, host[1] != 0, host[2:], suffix_base, suffix_end, what)
    out = torch.empty(max(total, 1), dtype=torch.uint8, device=dev)
    rc = lib.srt_dba_copy(chunk.data_ptr(), int(chunk.shape[0]),
                          plen.data_ptr(), slen.data_ptr(), offsets.data_ptr(),
                          pl.data_ptr(), sb.data_ptr(), n_pages,
                          out.data_ptr(), CB.stream_of(chunk))
    CB.count_launch("delta_byte_array")
    CB.check(lib, rc, "delta_byte_array")
    return out[:total], offsets


# ---------------------------------------------------------------------------
# Column chunk decode: the host half, then the device half
# ---------------------------------------------------------------------------
def _physical_of(dtype, physical: int) -> int:
    """The Parquet physical type of a column: `physical` when given, else
    the one the port writes for `dtype`."""
    if physical >= 0:
        return physical
    if dtype is DataType.STRING:
        return T_BYTE_ARRAY
    if dtype is DataType.BOOL:
        return T_BOOLEAN
    if dtype is DataType.FLOAT32:
        return T_FLOAT
    if dtype is DataType.FLOAT64:
        return T_DOUBLE
    if dtype in (DataType.INT8, DataType.INT16, DataType.INT32,
                 DataType.DATE):
        return T_INT32
    return T_INT64


def _in_width(dtype, physical: int, type_length: int = 0) -> int:
    if physical == T_FLBA:
        return type_length
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
    if device.type != "cuda":
        return torch.from_numpy(arr if arr.flags.writeable else
                                arr.copy()).to(device)
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


def _delta(buf, pos: int, end: int, n: int, dest: int, what: str):
    """(K25 stream, byte past it) of the DELTA_BINARY_PACKED stream at
    buf[pos:end) holding n values, written to lane `dest` on."""
    try:
        first, vpm, off, width, md, past = native.parse_delta(buf, pos, end,
                                                              n)
    except ValueError as e:
        raise ParquetFormatError(f"{what}: {e}") from None
    return (dest, n, first, vpm, off, width, md), past


@dataclass
class HostChunk:
    """A column chunk after the host's part of its decode: decompressed
    bytes, the run tables and page tables the kernels take. Data page i
    has kinds[i] (KIND_* for fixed widths; KIND_DICT, KIND_PLAIN or
    KIND_DENSE for a DELTA_* STRING page) and holds the dense values
    [dense_end[i - 1], dense_end[i]), at byte byte_pos[i] of the chunk for
    PLAIN / BSS / FLBA pages."""

    dtype: object
    num_rows: int
    max_def: int
    buf_t: torch.Tensor   # the decompressed chunk (pinned for a card)
    buf: np.ndarray       # its numpy view
    dict_pages: list
    dict_mode: bool       # every data page is a dictionary page
    def_tabs: list
    val_tabs: list
    kinds: list
    dense_end: list
    byte_pos: list
    str_parts: list       # PLAIN STRING pages: (dense start, starts, lens)
    deltas: list          # K25 streams (the slen streams of DBA pages
                          # write to lane `present` on)
    dlba: list            # DELTA_LENGTH_BYTE_ARRAY: (lo, n, bytes start)
    dba: list             # DELTA_BYTE_ARRAY: (lo, n, suffix start, end)
    rows: int
    present: int
    in_w: int
    what: str
    physical: int = -1
    dictionary: object = None  # a DeviceDictionary: emit the chunk encoded


def decode_chunk_device(chunk: bytes, dtype, num_rows: int, max_def: int,
                        cap: Optional[int] = None,
                        codec: str = "UNCOMPRESSED",
                        device=torch.device("cpu"), physical: int = -1,
                        name: str = "?",
                        encode_fraction: Optional[float] = None,
                        type_length: int = 0) -> ColumnVector:
    """Decode one raw column chunk into a ColumnVector on `device`
    (reference: decode_chunk_device :1083, whose whole-chunk fixed-width
    form is _try_flat_fixed :902; here every type takes the whole-chunk
    form). max_def: 1 for an OPTIONAL column, 0 for a REQUIRED one, whose
    pages carry no definition levels. physical: the Parquet physical type
    (it sets the value width of a DECIMAL column); type_length: a
    FIXED_LEN_BYTE_ARRAY column's byte length (the reference's flba_len).
    encode_fraction: see keep_encoded."""
    device = torch.device(device)
    hc = prepare_chunk(chunk, dtype, num_rows, max_def, codec, physical,
                       name, device.type == "cuda", type_length)
    return decode_prepared(keep_encoded(hc, encode_fraction), cap, device)


def prepare_chunk(chunk: bytes, dtype, num_rows: int, max_def: int,
                  codec: str = "UNCOMPRESSED", physical: int = -1,
                  name: str = "?", pin: bool = False,
                  type_length: int = 0) -> HostChunk:
    """The host's part of a chunk's decode: decompression, the page walk,
    level and index run tables, present counts, PLAIN string spans and the
    DELTA miniblock tables (native/srt_io.cpp). A chunk may mix dictionary
    pages with PLAIN, DELTA_* or BYTE_STREAM_SPLIT pages (a writer's
    dictionary fallback). Native code and numpy release the GIL, so a scan
    runs the columns of a row group on threads. pin: stage the chunk in
    pinned memory (for a decode on the card)."""
    what = f"column {name!r}"
    if max_def > 1:
        raise ParquetFormatError(f"{what} is nested (max definition level "
                                 f"{max_def}): only flat schemas are read")
    physical = _physical_of(dtype, physical)
    if physical == T_FLBA and not (getattr(dtype, "is_decimal", False) and
                                   1 <= type_length <= 16):
        raise ParquetFormatError(f"{what}: FIXED_LEN_BYTE_ARRAY of "
                                 f"{type_length} bytes as {dtype} (decimals "
                                 "of 1 to 16 bytes are read)")
    buf_t, pages = normalize_chunk(chunk, codec, pin)
    buf = buf_t.numpy()
    is_string = dtype is DataType.STRING
    is_bool = dtype is DataType.BOOL
    dict_pages = [p for p in pages if p.kind == PAGE_DICT]
    data_pages = [p for p in pages if p.kind != PAGE_DICT]
    if len(dict_pages) > 1:
        raise ParquetFormatError(f"{what}: more than one dictionary page")
    ok_encs = PAGE_ENCODINGS.get(physical, ())
    for p in data_pages:
        if p.encoding not in ok_encs:
            raise ParquetFormatError(
                f"{what}: {ENCODING_NAMES.get(p.encoding, p.encoding)} pages "
                f"of a {PHYSICAL_NAMES[physical]} column are not read "
                f"({', '.join(ENCODING_NAMES[e] for e in sorted(ok_encs))} "
                "are)")
        if p.rep_len:
            raise ParquetFormatError(f"{what}: repetition levels (a nested "
                                     "column) are not supported")
    has_dict = any(p.encoding in DICT_ENCODINGS for p in data_pages)
    if has_dict and not dict_pages:
        raise ParquetFormatError(f"{what}: dictionary page missing")
    in_w = _in_width(dtype, physical, type_length)

    def_tabs, val_tabs, kinds, dense_end, byte_pos = [], [], [], [], []
    str_parts, deltas, dlba, dba, slen_streams = [], [], [], [], []
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
        enc = p.encoding
        kind = KIND_PLAIN
        if enc in DICT_ENCODINGS:
            kind = KIND_DICT
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
        elif is_bool and enc == ENC_RLE:
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
        else:
            if has_dict:  # lanes of this page read index 0, unused
                val_tabs.append(_one_run(present, True, 0, 0, 0))
            if enc == ENC_DELTA_BINARY:
                kind = KIND_DENSE
                deltas.append(_delta(buf, pos, end, n_present, present,
                                     what)[0])
            elif enc == ENC_DELTA_LENGTH:
                kind = KIND_DENSE
                stream, past = _delta(buf, pos, end, n_present, present,
                                      what)
                deltas.append(stream)
                dlba.append((present, n_present, past, end))
            elif enc == ENC_DELTA_BYTE_ARRAY:
                kind = KIND_DENSE
                s1, past = _delta(buf, pos, end, n_present, present, what)
                s2, past = _delta(buf, past, end, n_present, present, what)
                deltas.append(s1)
                slen_streams.append(s2)
                dba.append((present, n_present, past, end))
            elif is_string:
                str_parts.append((present,) + native.plain_strings(
                    buf, pos, end, n_present))
            else:
                if pos + n_present * in_w > end:
                    raise ParquetFormatError(f"{what}: truncated "
                                             f"{ENCODING_NAMES[enc]} page")
                kind = KIND_BSS if enc == ENC_BSS else \
                    KIND_FLBA if physical == T_FLBA else KIND_PLAIN
        kinds.append(kind)
        dense_end.append(present + n_present)
        byte_pos.append(pos)
        rows += p.num_values
        present += n_present
    if rows < num_rows:
        raise ParquetFormatError(f"{what}: pages hold {rows} rows, the row "
                                 f"group {num_rows}")
    # a DBA page's suffix lengths land after every chunk lane
    deltas += [(s[0] + present,) + s[1:] for s in slen_streams]
    dict_mode = bool(kinds) and all(k == KIND_DICT for k in kinds)
    return HostChunk(dtype, num_rows, max_def, buf_t, buf, dict_pages,
                     dict_mode, def_tabs, val_tabs, kinds, dense_end,
                     byte_pos, str_parts, deltas, dlba, dba, rows, present,
                     in_w, what, physical)


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


def _rle_run_table(val_tabs, num_rows: int):
    """The columnar.runs.RunTable of a chunk's index streams (reference
    :837), or None when a group is bit-packed (its values are not known on
    the host), the stream is empty or the starts do not rise strictly from
    0. Meaningful only when every row is present: dense offsets are then
    row offsets."""
    from spark_rapids_tpu_torch.columnar.runs import RunTable

    if not val_tabs or not all(bool(np.all(t[1])) for t in val_tabs):
        return None
    starts = np.concatenate([t[0] for t in val_tabs]).astype(np.int64)
    values = np.concatenate([t[2] for t in val_tabs])
    keep = starts < num_rows
    starts, values = starts[keep], values[keep]
    if len(starts) == 0 or starts[0] != 0 or \
            bool(np.any(np.diff(starts) <= 0)):
        return None
    return RunTable(starts, values, num_rows)


def _chunk_runs(hc: HostChunk):
    """The run table of a whole-dictionary chunk with every row present,
    for the chunks the reference attaches one to: an encoded column (run
    values are codes) and a fixed-width column of one index width up to 24
    bits (the reference's whole-chunk path, :941-995), else None."""
    if not hc.dict_mode or hc.present != hc.rows or \
            hc.dtype is DataType.BOOL:
        return None
    widths = {int(t[4][0]) for t in hc.val_tabs if len(t[4])} - {0}
    if any(w > 24 for w in widths):
        return None
    if hc.dtype is DataType.STRING:
        if hc.dictionary is None:
            return None
    elif len(widths) > 1 or hc.physical == T_FLBA or (
            getattr(hc.dtype, "is_decimal", False) and hc.in_w != 8):
        return None
    return _rle_run_table(hc.val_tabs, hc.num_rows)


def _decoded_runs(hc: HostChunk, rt):
    """A decoded fixed-width chunk's run table with its codes taken
    through the dictionary page's raw values (reference :1036-1048)."""
    from spark_rapids_tpu_torch.columnar.runs import RunTable

    if rt is None or not hc.dict_pages[0].num_values:
        return None
    dp = hc.dict_pages[0]
    raw_dt = {4: np.float32, 8: np.float64}[hc.in_w] \
        if hc.dtype in (DataType.FLOAT32, DataType.FLOAT64) else \
        {4: np.int32, 8: np.int64}[hc.in_w]
    vals = np.frombuffer(hc.buf, dtype=raw_dt, count=dp.num_values,
                         offset=dp.data_start)
    sel = np.clip(rt.values, 0, dp.num_values - 1)
    return RunTable(rt.starts, vals[sel].astype(hc.dtype.to_np()),
                    rt.num_rows)


def decode_prepared(hc: HostChunk, cap: Optional[int],
                    device) -> ColumnVector:
    """The device's part: upload the chunk once, expand the runs (K20) and
    the DELTA streams (K25), spread values onto rows (K21) or gather
    strings (K7, after K26 for DELTA_BYTE_ARRAY pages)."""
    device = torch.device(device)
    dtype, num_rows, buf, in_w, what = hc.dtype, hc.num_rows, hc.buf, \
        hc.in_w, hc.what
    rows, present, dict_pages = hc.rows, hc.present, hc.dict_pages
    cap = cap or bucket_capacity(max(num_rows, 1))
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
        out.runs = _chunk_runs(hc)
        E.record_scan_emission(out)
        return out
    dense = delta_expand(chunk_t, delta_streams(hc.deltas, device),
                         present * (2 if hc.dba else 1)) \
        if hc.deltas else None
    if dtype is DataType.STRING:
        return _decode_strings(hc, chunk_t, idx, dense, def_levels, cap,
                               device)
    out_dtype = to_torch(dtype)
    sign = in_w < 8 and getattr(dtype, "is_decimal", False)
    kinds, dict_bytes, dict_w = hc.kinds, None, in_w
    if dtype is DataType.BOOL:  # K20 expanded the bits: 0 / 1 by slot
        kinds = [KIND_DICT] * len(kinds)
        dict_bytes = _upload(np.asarray([0, 1], np.uint8), device)
    elif dict_pages:
        dp = dict_pages[0]
        if dp.data_start + dp.num_values * in_w > len(buf):
            raise ParquetFormatError(f"{what}: truncated dictionary page")
        dict_bytes = chunk_t[dp.data_start:dp.data_start +
                             dp.num_values * in_w]
        if hc.physical == T_FLBA:  # K21's FLBA mode folds the dictionary
            folded, _ = page_decode_pages(
                None, dp.num_values, dp.num_values,
                page_source(chunk_t, [KIND_FLBA], [dp.num_values],
                            [dp.data_start]), in_w, torch.int64)
            dict_bytes, dict_w = folded.view(torch.uint8), 8
    source = page_source(chunk_t, kinds, hc.dense_end, hc.byte_pos,
                         idx=idx if dict_bytes is not None else None,
                         dict_bytes=dict_bytes, dict_w=dict_w, dense=dense)
    out = ColumnVector(dtype, *page_decode_pages(
        def_levels, num_rows, cap, source, in_w, out_dtype, sign))
    out.runs = _decoded_runs(hc, _chunk_runs(hc))
    return out


def _spread(def_levels, num_rows: int, cap: int, dense: torch.Tensor
            ) -> torch.Tensor:
    """Dense int32 / int64 values (one per present row) onto their rows:
    K21 over one PLAIN page; null rows read 0."""
    return page_decode_pages(def_levels, num_rows, cap, _one_page(dense),
                             dense.element_size(), dense.dtype)[0]


def _decode_strings(hc: HostChunk, chunk_t, idx, dense, def_levels,
                    cap: int, device) -> ColumnVector:
    num_rows, present, what = hc.num_rows, hc.present, hc.what
    valid = torch.arange(cap, device=device) < num_rows
    if def_levels is not None:
        valid = valid & (def_levels != 0)
    if hc.dict_mode:
        offs, raw = _string_dict_table(hc.buf, hc.dict_pages[0], what)
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
    return _decode_mixed_strings(hc, chunk_t, idx, dense, def_levels, valid,
                                 cap, device)


def _decode_mixed_strings(hc: HostChunk, chunk_t, idx, dense, def_levels,
                          valid, cap: int, device) -> ColumnVector:
    """A STRING chunk that is not all dictionary pages: every present
    value gets a span (start, length) by dense slot, then K21 puts the
    spans of dictionary pages (through the dictionary's span table) and of
    the others onto their rows, and K7's span entry gathers the bytes. A
    DELTA_LENGTH_BYTE_ARRAY page's lengths come from K25 and its starts
    from their exclusive sum; DELTA_BYTE_ARRAY pages are rebuilt by K26
    into a buffer laid after the chunk's bytes."""
    num_rows, present, what = hc.num_rows, hc.present, hc.what
    n_bytes = int(chunk_t.shape[0])
    # PLAIN pages' spans from the host walk, DELTA pages' on the device
    h_starts = np.zeros(max(present, 1), np.int64)
    h_lens = np.zeros(max(present, 1), np.int64)
    for lo, st, ln in hc.str_parts:
        h_starts[lo:lo + len(st)] = st
        h_lens[lo:lo + len(ln)] = ln
    starts = _upload(h_starts, device)
    lens = _upload(h_lens, device)
    over = []  # DLBA pages' bytes past their page
    for lo, n, base, end in hc.dlba:
        seg = dense[lo:lo + n]
        lens[lo:lo + n] = seg
        cum = torch.cumsum(seg, 0)
        starts[lo:lo + n] = base + cum - seg
        if n:
            over.append(cum[-1] - (end - base))
    src = chunk_t
    if hc.dba:
        lo_hi = [(lo, lo + n) for lo, n, _b, _e in hc.dba]
        plen = torch.cat([dense[a:b] for a, b in lo_hi])
        slen = torch.cat([dense[present + a:present + b] for a, b in lo_hi])
        page_lanes = np.zeros(len(hc.dba) + 1, np.int64)
        np.cumsum([n for _lo, n, _b, _e in hc.dba], out=page_lanes[1:])
        rebuilt, offs = delta_byte_array(
            chunk_t, plen, slen, page_lanes,
            np.asarray([b for _lo, _n, b, _e in hc.dba], np.int64),
            np.asarray([e for _lo, _n, _b, e in hc.dba], np.int64), what)
        for (a, b), k in zip(lo_hi, page_lanes[:-1]):
            m = b - a
            starts[a:b] = n_bytes + offs[k:k + m]
            lens[a:b] = offs[k + 1:k + m + 1] - offs[k:k + m]
        src = torch.cat([chunk_t, rebuilt])
    d_starts = d_lens = None
    if hc.dict_pages:
        dp = hc.dict_pages[0]
        ds, dl = native.plain_strings(hc.buf, dp.data_start,
                                      dp.data_start + dp.data_len,
                                      dp.num_values)
        d_starts = _upload(ds.astype(np.int64), device).view(torch.uint8)
        d_lens = _upload(dl.astype(np.int64), device).view(torch.uint8)
    kinds = [KIND_DICT if k == KIND_DICT else KIND_DENSE for k in hc.kinds]
    has_dict = d_starts is not None
    row_starts, _ = page_decode_pages(def_levels, num_rows, cap, page_source(
        chunk_t, kinds, hc.dense_end, [0] * len(kinds),
        idx=idx if has_dict else None, dict_bytes=d_starts, dense=starts),
        8, torch.int64)
    row_lens, _ = page_decode_pages(def_levels, num_rows, cap, page_source(
        chunk_t, kinds, hc.dense_end, [0] * len(kinds),
        idx=idx if has_dict else None, dict_bytes=d_lens, dense=lens),
        8, torch.int32)
    total, max_len, low, past = torch.stack([
        torch.where(valid, row_lens, 0).sum(dtype=torch.int64),
        row_lens.max().long(), row_lens.min().long(),
        torch.stack(over).max() if over else torch.zeros(
            (), dtype=torch.int64, device=device)]).tolist()
    if low < 0 or past > 0 or total >= 1 << 31:
        raise ParquetFormatError(f"{what}: negative string lengths, values "
                                 "past their page, or a chunk's strings "
                                 "past 2 GiB")
    offsets, data, validity = gather_string_spans(
        src, row_starts, row_lens, valid, num_rows,
        bucket_capacity(max(total, 1)))
    return ColumnVector(DataType.STRING, data, validity, offsets,
                        S.len_bucket(max(max_len, 1)))
