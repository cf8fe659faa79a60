"""Device-side ORC column decode (port of the device half of
spark_rapids_tpu/io/orc_device.py).

The split is the reference's. The HOST reads a stripe, inflates the
streams of the columns read (io/orc_meta.py, on threads) and walks each
RLEv2 and byte-RLE stream into a run table (native/srt_io.cpp: headers,
varints and patch lists, no values). The DEVICE expands every value from
the stripe's bytes, uploaded once:

- K27 `rlev2_expand` (csrc/orc_decode.cu) expands all runs of one RLEv2
  stream in one launch, whatever their kinds and widths (SHORT_REPEAT,
  DIRECT, DELTA, PATCHED_BASE with its patches), into dense int64 values;
- K28 `present_expand` expands a byte-RLE stream into MSB-first bits: the
  PRESENT validity, and the values of a BOOLEAN column;
- K21 (`io/parquet_device.py:page_decode_pages`) spreads dense values onto
  their rows, reading FLOAT / DOUBLE straight from the stripe's bytes;
- STRING bytes gather through K7's span entry (DIRECT_V2: the LENGTH
  stream's spans into DATA; DICTIONARY_V2: each index's dictionary span).
  A DICTIONARY_V2 column whose dictionary is small enough stays encoded:
  K21's codes mode spreads its indices onto rows as int32 codes.

Scope (reference :736 `column_eligible`): BOOLEAN, SHORT, INT, LONG, DATE,
FLOAT, DOUBLE, STRING (DIRECT_V2, DICTIONARY_V2) and TIMESTAMP written in
UTC; widths to 64. Everything else raises an OrcFormatError that names it.

Every kernel wrapper takes its plain PyTorch version for CPU tensors (the
tests and the CPU engine's scan) and launches its kernel for CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar import strings as S
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector,
    bucket_capacity,
    gather_string_spans,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch
from spark_rapids_tpu_torch.io.orc_meta import (
    E_DICT_V2,
    OrcFormatError,
    S_DATA,
    S_DICT,
    S_LENGTH,
    S_PRESENT,
    S_SECONDARY,
    StripeImage,
    encoding_error,
    find_stream,
)
from spark_rapids_tpu_torch.io.parquet_device import (
    KIND_PLAIN,
    _lshr,
    _one_page,
    _upload,
    page_decode_codes,
    page_decode_pages,
    page_source,
)

# run kinds of a run table (native/srt_io.cpp:srt_parse_rlev2)
R_REPEAT, R_DIRECT, R_DELTA, R_PATCHED = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Run tables (host)
# ---------------------------------------------------------------------------
@dataclass
class RleV2Table:
    kind: np.ndarray       # int8 a run
    out_start: np.ndarray  # int64
    count: np.ndarray      # int32
    base: np.ndarray       # int64: SHORT_REPEAT value, DELTA / PATCHED base
    delta0: np.ndarray     # int64: DELTA's first delta
    bit_off: np.ndarray    # int64: absolute bit offset of the payload
    width: np.ndarray      # int8: packed width (0: none)
    patch_pos: np.ndarray  # int64: PATCHED_BASE patch slots
    patch_add: np.ndarray  # int64: patch value << width
    produced: int
    signed: bool


def parse_rlev2(buf, start: int, end: int, num_values: int,
                signed: bool) -> RleV2Table:
    """Reference :466, natively (no loop over runs in Python)."""
    try:
        t = native.parse_rlev2(buf, start, end, num_values, signed)
    except ValueError as e:
        raise OrcFormatError(str(e)) from None
    return RleV2Table(*t, signed)


@dataclass
class ByteRleTable:
    out_start: np.ndarray  # int64, in bytes of the decoded stream
    count: np.ndarray      # int32
    is_run: np.ndarray     # bool
    value: np.ndarray      # uint8: the repeated byte
    lit_off: np.ndarray    # int64: offset of the literal bytes
    produced: int          # bytes
    ones: int              # set bits among the first num_bits


def parse_byte_rle(buf, start: int, end: int, num_bits: int) -> ByteRleTable:
    """Reference :610 with present_count :759 (the set bits among the
    first num_bits) in the same native walk."""
    try:
        return ByteRleTable(*native.parse_byte_rle(buf, start, end,
                                                   num_bits))
    except ValueError as e:
        raise OrcFormatError(str(e)) from None


@dataclass
class DeviceRleV2:
    kind: torch.Tensor
    out_start: torch.Tensor
    count: torch.Tensor
    base: torch.Tensor
    delta0: torch.Tensor
    bit_off: torch.Tensor
    width: torch.Tensor
    patch_pos: torch.Tensor
    patch_add: torch.Tensor
    signed: bool

    @property
    def runs(self) -> int:
        return int(self.kind.shape[0])


def device_rlev2(rt: RleV2Table, device) -> DeviceRleV2:
    device = torch.device(device)
    return DeviceRleV2(*[_upload(a, device) for a in (
        rt.kind, rt.out_start, rt.count, rt.base, rt.delta0, rt.bit_off,
        rt.width, rt.patch_pos, rt.patch_add)], rt.signed)


@dataclass
class DeviceByteRle:
    out_start: torch.Tensor
    count: torch.Tensor
    is_run: torch.Tensor   # uint8
    value: torch.Tensor
    lit_off: torch.Tensor


def device_byte_rle(bt: ByteRleTable, device) -> DeviceByteRle:
    device = torch.device(device)
    return DeviceByteRle(_upload(bt.out_start, device),
                         _upload(bt.count, device),
                         _upload(bt.is_run.astype(np.uint8), device),
                         _upload(bt.value, device),
                         _upload(bt.lit_off, device))


# ---------------------------------------------------------------------------
# K27 rlev2_expand
# ---------------------------------------------------------------------------
def _be_bits(buf: torch.Tensor, bitpos: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """w bits (0-64; 0 reads 0) at absolute bit bitpos of buf, most
    significant first, as int64 lanes; bytes past buf read 0."""
    n = int(buf.shape[0])
    byte = bitpos >> 3
    s = bitpos & 7
    hi = torch.zeros_like(bitpos)
    for k in range(9):
        pos = byte + k
        ok = (pos >= 0) & (pos < n)
        b = buf[pos.clamp(0, max(n - 1, 0))].long() if n else \
            torch.zeros_like(pos)
        b = torch.where(ok, b, torch.zeros_like(b))
        if k < 8:
            hi = hi | (b << (8 * (7 - k)))
        else:
            lo = b
    win = torch.where(s == 0, hi, (hi << s) | _lshr(lo, 8 - s))
    return torch.where(w == 0, torch.zeros_like(win),
                       _lshr(win, (64 - w).clamp(max=63)))


def rlev2_expand_plain(buf: torch.Tensor, rt: DeviceRleV2,
                       cap: int) -> torch.Tensor:
    """int64 [cap], 0 where no run lands (reference: _expand_rlev2 :665 with
    _extract_be_bits :645 and the patch scatter of _expand_rt_dense
    :983-986): slot j of run r (k = j - out_start[r]) is SHORT_REPEAT's
    base; DIRECT's w bits at bit_off + k * w (zigzag-decoded in a signed
    stream); PATCHED_BASE's base plus those bits; DELTA's base, then
    + delta0 from k = 1, then + sign(delta0) times the sum of its packed
    deltas 2..k (width 0: base + k * delta0); patches add to their slots.
    All arithmetic wraps modulo 2^64."""
    dev = buf.device
    out = torch.zeros(cap, dtype=torch.int64, device=dev)
    if rt.runs == 0 or cap == 0:
        return out
    ends = rt.out_start + rt.count.long()
    lanes = int(ends.max())
    j = torch.arange(min(lanes, cap), dtype=torch.int64, device=dev)
    r = (torch.searchsorted(rt.out_start, j, right=True) - 1).clamp(min=0)
    k = j - rt.out_start[r]
    inside = k < rt.count[r].long()
    kind = rt.kind[r].long()
    w = rt.width[r].long()
    base = rt.base[r]
    d0 = rt.delta0[r]
    bits = _be_bits(buf, rt.bit_off[r] + k * w, w)
    direct = _lshr(bits, torch.ones_like(bits)) ^ -(bits & 1) \
        if rt.signed else bits
    dk = _be_bits(buf, rt.bit_off[r] + (k - 2).clamp(min=0) * w, w)
    dk = torch.where((kind == R_DELTA) & (k >= 2) & inside, dk,
                     torch.zeros_like(dk))
    cs = torch.cumsum(dk, 0)
    first = rt.out_start[r]
    seg = cs - torch.where(first > 0, cs[(first - 1).clamp(min=0)],
                           torch.zeros_like(cs))
    sign = torch.where(d0 < 0, -torch.ones_like(d0), torch.ones_like(d0))
    var = base + torch.where(k >= 1, d0, torch.zeros_like(d0)) + \
        torch.where(k >= 2, sign * seg, torch.zeros_like(seg))
    delta = torch.where(w == 0, base + k * d0, var)
    v = torch.where(kind == R_DIRECT, direct,
                    torch.where(kind == R_PATCHED, base + bits,
                                torch.where(kind == R_DELTA, delta, base)))
    out[:j.shape[0]] = torch.where(inside, v, torch.zeros_like(v))
    if rt.patch_pos.numel():
        keep = rt.patch_pos < cap
        out.index_add_(0, rt.patch_pos[keep], rt.patch_add[keep])
    return out


def rlev2_expand(buf: torch.Tensor, rt: DeviceRleV2,
                 cap: int) -> torch.Tensor:
    """K27 (replaces orc_device.py:_expand_rlev2 :665, _extract_be_bits
    :645 and the patch add of _expand_rt_dense :983-986): every run of one
    RLEv2 stream, of any kind and width, in one launch; int64 [cap]."""
    if buf.device.type == "cpu":
        return rlev2_expand_plain(buf, rt, cap)
    lib = CB.library("orc_decode")
    CB.require_cuda(buf, rt.kind, rt.out_start, rt.count, rt.base,
                    rt.delta0, rt.bit_off, rt.width, rt.patch_pos,
                    rt.patch_add)
    out = torch.empty(cap, dtype=torch.int64, device=buf.device)
    rc = lib.srt_rlev2_expand(
        buf.data_ptr(), int(buf.shape[0]), rt.kind.data_ptr(),
        rt.out_start.data_ptr(), rt.count.data_ptr(), rt.base.data_ptr(),
        rt.delta0.data_ptr(), rt.bit_off.data_ptr(), rt.width.data_ptr(),
        rt.runs, 1 if rt.signed else 0, rt.patch_pos.data_ptr(),
        rt.patch_add.data_ptr(), int(rt.patch_pos.shape[0]),
        out.data_ptr(), cap, CB.stream_of(buf))
    CB.count_launch("rlev2_expand")
    CB.check(lib, rc, "rlev2_expand")
    return out


# ---------------------------------------------------------------------------
# K28 present_expand
# ---------------------------------------------------------------------------
def present_expand_plain(buf: torch.Tensor, bt: DeviceByteRle,
                         cap: int) -> torch.Tensor:
    """bool [cap] (reference: _expand_present :714): bit j is bit 7 - j % 8
    of decoded byte j // 8 (a run's byte, or its literal k at lit_off + k);
    False past the runs."""
    dev = buf.device
    n_runs = int(bt.out_start.shape[0])
    if n_runs == 0 or cap == 0:
        return torch.zeros(cap, dtype=torch.bool, device=dev)
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    bytepos = j >> 3
    r = (torch.searchsorted(bt.out_start, bytepos, right=True) - 1).clamp(
        min=0)
    k = bytepos - bt.out_start[r]
    inside = k < bt.count[r].long()
    n = int(buf.shape[0])
    lit = buf[(bt.lit_off[r] + k).clamp(0, max(n - 1, 0))].long() if n \
        else torch.zeros_like(j)
    byte = torch.where(bt.is_run[r] != 0, bt.value[r].long(), lit)
    bit = (byte >> (7 - (j & 7))) & 1
    return (bit != 0) & inside


def present_expand(buf: torch.Tensor, bt: DeviceByteRle,
                   cap: int) -> torch.Tensor:
    """K28 (replaces orc_device.py:_expand_present :714): a byte-RLE
    stream's bits, MSB first, as bool [cap]."""
    if buf.device.type == "cpu":
        return present_expand_plain(buf, bt, cap)
    lib = CB.library("orc_decode")
    CB.require_cuda(buf, bt.out_start, bt.count, bt.is_run, bt.value,
                    bt.lit_off)
    out = torch.empty(cap, dtype=torch.bool, device=buf.device)
    rc = lib.srt_present_expand(
        buf.data_ptr(), int(buf.shape[0]), bt.out_start.data_ptr(),
        bt.count.data_ptr(), bt.is_run.data_ptr(), bt.value.data_ptr(),
        bt.lit_off.data_ptr(), int(bt.out_start.shape[0]), out.data_ptr(),
        cap, CB.stream_of(buf))
    CB.count_launch("present_expand")
    CB.check(lib, rc, "present_expand")
    return out


# ---------------------------------------------------------------------------
# Column plans (host)
# ---------------------------------------------------------------------------
@dataclass
class ColumnPlan:
    """The host's part of one stripe column's decode (reference: ColumnPlan
    :299, plan_column :332). rt: the DATA stream (integers, DATE,
    TIMESTAMP seconds, DICTIONARY_V2 indices) or the LENGTH stream
    (DIRECT_V2 strings); data_start / data_len: the raw FLOAT / DOUBLE
    values, the DIRECT_V2 string bytes or the dictionary's bytes."""

    dtype: DataType
    num_rows: int
    present: Optional[ByteRleTable]
    n_present: int
    rt: Optional[RleV2Table] = None
    data_start: int = 0
    data_len: int = 0
    dict_len_rt: Optional[RleV2Table] = None
    dict_size: int = 0
    bool_bits: Optional[ByteRleTable] = None
    nanos_rt: Optional[RleV2Table] = None
    name: str = "?"


def _stream(img: StripeImage, cid: int, kind: int, what: str):
    s = find_stream(img.streams, cid, kind)
    if s is None:
        raise OrcFormatError(f"{what}: no {_stream_name(kind)} stream")
    return s


def _stream_name(kind: int) -> str:
    return {S_PRESENT: "PRESENT", S_DATA: "DATA", S_LENGTH: "LENGTH",
            S_DICT: "DICTIONARY_DATA", S_SECONDARY: "SECONDARY"}[kind]


def _rlev2_of(img: StripeImage, s, n: int, signed: bool,
              what: str) -> RleV2Table:
    rt = parse_rlev2(img.buf, s.start, s.start + s.length, n, signed)
    if rt.produced < n:
        raise OrcFormatError(f"{what}: {_stream_name(s.kind)} stream holds "
                             f"{rt.produced} values of {n}")
    return rt


def plan_column(img: StripeImage, cid: int, dtype: DataType,
                name: str = "?") -> ColumnPlan:
    """Validate a column's encodings and walk its streams (host only;
    raises OrcFormatError before any device work)."""
    what = f"column {name!r}"
    enc, dict_size = img.encodings.get(cid, (-1, 0))
    why = encoding_error(dtype, enc, img.timezone)
    if why:
        raise OrcFormatError(f"{what}: {why}")
    rows = img.num_rows
    pres = find_stream(img.streams, cid, S_PRESENT)
    present = None
    n_present = rows
    if pres is not None:
        present = parse_byte_rle(img.buf, pres.start,
                                 pres.start + pres.length, rows)
        if present.produced * 8 < rows:
            raise OrcFormatError(f"{what}: PRESENT stream shorter than the "
                                 "stripe")
        n_present = present.ones
    plan = ColumnPlan(dtype, rows, present, n_present, name=name)
    if n_present == 0:  # no value to read: writers may leave streams out
        return plan
    if dtype is DataType.TIMESTAMP:
        # seconds from 2015-01-01 UTC and trailing-zero-packed nanos
        plan.rt = _rlev2_of(img, _stream(img, cid, S_DATA, what), n_present,
                            True, what)
        plan.nanos_rt = _rlev2_of(img, _stream(img, cid, S_SECONDARY, what),
                                  n_present, False, what)
        return plan
    if dtype is DataType.BOOL:
        s = _stream(img, cid, S_DATA, what)
        plan.bool_bits = parse_byte_rle(img.buf, s.start, s.start + s.length,
                                        n_present)
        if plan.bool_bits.produced * 8 < n_present:
            raise OrcFormatError(f"{what}: BOOLEAN DATA stream too short")
        return plan
    if dtype in (DataType.FLOAT32, DataType.FLOAT64):
        s = _stream(img, cid, S_DATA, what)
        w = 4 if dtype is DataType.FLOAT32 else 8
        if s.length < n_present * w:
            raise OrcFormatError(f"{what}: DATA stream shorter than its "
                                 "values")
        plan.data_start, plan.data_len = s.start, s.length
        return plan
    if dtype is DataType.STRING:
        data = _stream(img, cid, S_DATA, what)
        if enc == E_DICT_V2:
            dct = find_stream(img.streams, cid, S_DICT)
            plan.rt = _rlev2_of(img, data, n_present, False, what)
            plan.dict_size = dict_size
            plan.dict_len_rt = _rlev2_of(img, _stream(img, cid, S_LENGTH,
                                                      what),
                                         dict_size, False, what)
            plan.data_start = dct.start if dct is not None else 0
            plan.data_len = dct.length if dct is not None else 0
            return plan
        plan.rt = _rlev2_of(img, _stream(img, cid, S_LENGTH, what),
                            n_present, False, what)
        plan.data_start, plan.data_len = data.start, data.length
        return plan
    plan.rt = _rlev2_of(img, _stream(img, cid, S_DATA, what), n_present,
                        True, what)
    return plan


# ---------------------------------------------------------------------------
# Device expansion
# ---------------------------------------------------------------------------
def _expand_validity(buf: torch.Tensor, plan: ColumnPlan, cap: int):
    """(validity bool [cap], levels int32 [cap] for K21 or None when every
    row is present)."""
    dev = buf.device
    rows = torch.arange(cap, device=dev) < plan.num_rows
    if plan.present is None:
        return rows, None
    valid = present_expand(buf, device_byte_rle(plan.present, dev),
                           cap) & rows
    return valid, valid.to(torch.int32)


def _expand_rt_dense(buf: torch.Tensor, rt: Optional[RleV2Table],
                     n: int) -> torch.Tensor:
    """One K27 launch: the stream's first n values, int64
    [bucket_capacity(n)] (reference :948, which re-ran its kernel once per
    distinct width)."""
    cap = bucket_capacity(max(n, 1))
    if rt is None or n == 0:
        return torch.zeros(cap, dtype=torch.int64, device=buf.device)
    return rlev2_expand(buf, device_rlev2(rt, buf.device), cap)


def expand_column(buf: torch.Tensor, plan: ColumnPlan,
                  cap: int) -> ColumnVector:
    """SHORT / INT / LONG / DATE (reference :990)."""
    valid, levels = _expand_validity(buf, plan, cap)
    dense = _expand_rt_dense(buf, plan.rt, plan.n_present)
    data, _ = page_decode_pages(levels, plan.num_rows, cap,
                                _one_page(dense), 8, to_torch(plan.dtype))
    return ColumnVector(plan.dtype, data, valid)


def expand_float_column(buf: torch.Tensor, plan: ColumnPlan,
                        cap: int) -> ColumnVector:
    """FLOAT / DOUBLE (reference :1107): K21 reads the raw little-endian
    values out of the stripe's bytes and spreads them."""
    valid, levels = _expand_validity(buf, plan, cap)
    w = 4 if plan.dtype is DataType.FLOAT32 else 8
    src = page_source(buf, [KIND_PLAIN], [plan.n_present], [plan.data_start])
    data, _ = page_decode_pages(levels, plan.num_rows, cap, src, w,
                                to_torch(plan.dtype))
    return ColumnVector(plan.dtype, data, valid)


def expand_bool_column(buf: torch.Tensor, plan: ColumnPlan,
                       cap: int) -> ColumnVector:
    """BOOLEAN (reference :1128): the value bits expand with K28 (the
    PRESENT layout), then K21 spreads them."""
    valid, levels = _expand_validity(buf, plan, cap)
    cap_p = bucket_capacity(max(plan.n_present, 1))
    dense = torch.zeros(cap_p, dtype=torch.bool, device=buf.device) \
        if plan.bool_bits is None else \
        present_expand(buf, device_byte_rle(plan.bool_bits, buf.device),
                       cap_p)
    data, _ = page_decode_pages(levels, plan.num_rows, cap,
                                _one_page(dense.view(torch.uint8)), 1,
                                torch.bool)
    return ColumnVector(plan.dtype, data, valid)


ORC_TS_EPOCH = 1420070400  # 2015-01-01 00:00:00 UTC, seconds
_NANO_SCALE = (1, 10**2, 10**3, 10**4, 10**5, 10**6, 10**7, 10**8)


def expand_timestamp_column(buf: torch.Tensor, plan: ColumnPlan,
                            cap: int) -> ColumnVector:
    """TIMESTAMP (reference :1149): seconds and trailing-zero-packed nanos
    combine into microseconds since the epoch; a pre-1970 value whose
    fraction is at least 1 ms borrows a second, as ORC's reader does."""
    valid, levels = _expand_validity(buf, plan, cap)
    secs = _expand_rt_dense(buf, plan.rt, plan.n_present)
    nv = _expand_rt_dense(buf, plan.nanos_rt, plan.n_present)
    scale = torch.tensor(_NANO_SCALE, dtype=torch.int64, device=buf.device)
    nanos = (nv >> 3) * scale[(nv & 7)]
    base_us = (secs + ORC_TS_EPOCH) * 1_000_000
    base_us = torch.where((base_us < 0) & (nanos > 999_999),
                          base_us - 1_000_000, base_us)
    dense = base_us + torch.div(nanos, 1000, rounding_mode="floor")
    data, _ = page_decode_pages(levels, plan.num_rows, cap, _one_page(dense),
                                8, torch.int64)
    return ColumnVector(plan.dtype, data, valid)


def _dictionary_lengths(buf: torch.Tensor, plan: ColumnPlan) -> torch.Tensor:
    dense = _expand_rt_dense(buf, plan.dict_len_rt, plan.dict_size)
    return dense[:plan.dict_size]


def expand_string_column(buf: torch.Tensor, plan: ColumnPlan,
                         cap: int) -> ColumnVector:
    """STRING (reference :1018): every present value gets a span (start,
    length) in the stripe's bytes, K21 spreads the spans onto rows and
    K7's span entry gathers the bytes. DIRECT_V2 spans follow the LENGTH
    stream through DATA; DICTIONARY_V2 spans are each index's entry."""
    dev = buf.device
    valid, levels = _expand_validity(buf, plan, cap)
    n = plan.n_present
    if plan.dict_len_rt is not None:
        d_lens = _dictionary_lengths(buf, plan)
        d_starts = torch.cumsum(d_lens, 0) - d_lens + plan.data_start
        idx = _expand_rt_dense(buf, plan.rt, n)[:n]
        bad = (idx < 0) | (idx >= plan.dict_size)
        safe = torch.where(bad, torch.zeros_like(idx), idx)
        starts = d_starts[safe] if plan.dict_size else torch.zeros_like(idx)
        lens = d_lens[safe] if plan.dict_size else torch.zeros_like(idx)
        check = [bad.any().long(), d_lens.min() if plan.dict_size else
                 torch.zeros((), dtype=torch.int64, device=dev),
                 d_lens.sum() - plan.data_len]
    else:
        lens = _expand_rt_dense(buf, plan.rt, n)[:n]
        starts = torch.cumsum(lens, 0) - lens + plan.data_start
        check = [torch.zeros((), dtype=torch.int64, device=dev),
                 lens.min() if n else torch.zeros((), dtype=torch.int64,
                                                  device=dev),
                 lens.sum() - plan.data_len]
    row_starts, _ = page_decode_pages(levels, plan.num_rows, cap,
                                      _one_page(starts), 8, torch.int64)
    row_lens, _ = page_decode_pages(levels, plan.num_rows, cap,
                                    _one_page(lens), 8, torch.int32)
    bad_idx, low, past, total, max_len = torch.stack(
        check + [torch.where(valid, row_lens, 0).sum(dtype=torch.int64),
                 row_lens.max().long()]).tolist()
    if bad_idx or low < 0 or past > 0 or total >= 1 << 31:
        raise OrcFormatError(f"column {plan.name!r}: dictionary indices "
                             "past the dictionary, negative lengths, string "
                             "bytes past their stream, or a stripe's strings "
                             "past 2 GiB")
    offsets, data, validity = gather_string_spans(
        buf, row_starts, row_lens, valid, plan.num_rows,
        bucket_capacity(max(total, 1)))
    return ColumnVector(DataType.STRING, data, validity, offsets,
                        S.len_bucket(max(max_len, 1)))


def expand_string_codes(buf: torch.Tensor, plan: ColumnPlan, cap: int,
                        host_buf: np.ndarray):
    """A DICTIONARY_V2 STRING column kept encoded (reference :1075): the
    indices spread onto rows as int32 codes (K21's codes mode); the
    dictionary's lengths expand on the device (K27) and download once, and
    its bytes are interned from the host's stripe image."""
    from spark_rapids_tpu_torch.columnar import encoded as E

    valid, levels = _expand_validity(buf, plan, cap)
    n = plan.n_present
    lens = _dictionary_lengths(buf, plan).cpu().numpy()
    offs = np.zeros(plan.dict_size + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    if (lens < 0).any() or offs[-1] > plan.data_len:
        raise OrcFormatError(f"column {plan.name!r}: dictionary lengths "
                             "past its DICTIONARY_DATA stream")
    idx = _expand_rt_dense(buf, plan.rt, n)[:max(n, 1)]
    bad = bool(((idx[:n] < 0) | (idx[:n] >= plan.dict_size)).any()) if n \
        else False
    if bad:
        raise OrcFormatError(f"column {plan.name!r}: dictionary indices past "
                             "the dictionary")
    codes = page_decode_codes(levels, plan.num_rows, cap,
                              idx.to(torch.int32))
    raw = host_buf[plan.data_start:plan.data_start + int(offs[-1])]
    dct = E.DeviceDictionary.from_byte_table(raw, offs.astype(np.int32))
    out = E.DictionaryColumn(DataType.STRING, codes, valid, dct)
    E.record_scan_emission(out)
    return out


def decode_column(plan: ColumnPlan, buf: torch.Tensor, cap: int,
                  host_buf: np.ndarray,
                  encode_fraction: Optional[float] = None) -> ColumnVector:
    """The device's part of one stripe column (reference: _orc_stripe_batches
    :687's dispatch). encode_fraction: a DICTIONARY_V2 STRING column whose
    ndv / rows is at most this stays encoded (None: never)."""
    from spark_rapids_tpu_torch.columnar import encoded as E

    dt = plan.dtype
    if dt is DataType.STRING:
        if plan.dict_len_rt is not None and encode_fraction is not None \
                and E.scan_encoded_ok(plan.dict_size, plan.num_rows,
                                      encode_fraction):
            return expand_string_codes(buf, plan, cap, host_buf)
        return expand_string_column(buf, plan, cap)
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return expand_float_column(buf, plan, cap)
    if dt is DataType.BOOL:
        return expand_bool_column(buf, plan, cap)
    if dt is DataType.TIMESTAMP:
        return expand_timestamp_column(buf, plan, cap)
    return expand_column(buf, plan, cap)
