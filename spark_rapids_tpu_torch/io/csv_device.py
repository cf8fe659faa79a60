"""Device-side CSV parse (port of spark_rapids_tpu/io/csv_device.py; the
reference parses CSV on the accelerator, GpuBatchScanExec.scala:322-520).

The split is the reference's. The HOST makes one pass over a file's bytes
and finds every field's (start, length): `plan_fields`, natively
(native/srt_io.cpp: `srt_csv_plan`, the reference's sweep made
quote-aware: it strips a field's outer quotes and deletes the second
quote of each "" pair in place). No value is converted on the host. The DEVICE gets
the bytes and the span tables once a split and parses each column with a
hand-written kernel (csrc/csv_parse.cu), one thread a field:

- K33 `csv_parse_int`: '-'? digits into INT8-INT64, overflow caught before
  the fold wraps, out of range of a narrow type malformed;
- K34 `csv_parse_float`: '-'? digits ['.' digits] of at most 15
  significant and 22 fractional digits into DOUBLE by one IEEE division;
- K35 `csv_parse_datetime`: strict 'YYYY-MM-DD' into epoch days, or
  'date[ T]HH:MM:SS[.f{1,6}]zone' into epoch microseconds;
- K36 `csv_null_sentinels`: does a field equal one of the null spellings;
- STRING columns gather their spans with K7's span entry.

Every parse kernel ORs a malformed field into one device flag a chunk, so
one host sync covers the chunk; a set flag sends that chunk to the host
grammar (io/csv_host.py), the reference's own host route. Empty
fields are NULL. Every kernel wrapper takes its plain PyTorch version for
CPU tensors (the tests and the CPU engine's scan) and launches its kernel
for CUDA tensors; nothing falls back from one to the other.

The reference's numpy planners (`_plan_fields_quoted`, `_plan_fields_py`)
stay here as the plain versions the tests hold the native planners to.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

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
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops import datetimeops as DT

MAXW = 20      # int64: up to 19 digits and a sign
MAXW_F = 24    # float: a sign, 15 digits, a dot and slack
MAXW_D = 10    # YYYY-MM-DD
MAXW_TS = 32   # 19 + .ffffff (7) + +HH:MM (6)

_NL, _CR, _QUOTE = 0x0A, 0x0D, 0x22
_MINUS, _PLUS, _ZERO, _DOT = 0x2D, 0x2B, 0x30, 0x2E

INTEGRAL = (DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64)
_INT_BYTES = {DataType.INT8: 1, DataType.INT16: 2, DataType.INT32: 4,
              DataType.INT64: 8}
_INT_TORCH = {DataType.INT8: torch.int8, DataType.INT16: torch.int16,
              DataType.INT32: torch.int32, DataType.INT64: torch.int64}

# The null spellings of the reference's host parser, pyarrow's CSV
# ConvertOptions().null_values (the reference reads them from pyarrow at
# run time, csv_device.py:576-588; the port has no pyarrow, and a test holds
# this copy to pyarrow's list). Quoted fields match after their quotes are
# stripped.
NULL_VALUES = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
               "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a",
               "nan", "null")
# the non-empty ones, as K36 matches them (empty fields are NULL by length)
NULL_SENTINELS = tuple(s.encode() for s in NULL_VALUES if s)
SENTINEL_MAXW = max(len(s) for s in NULL_SENTINELS)


class FieldTable:
    """The field spans of one CSV chunk (reference :59). The tables are
    column-major int32 [ncols, stride]: the spans of column j are
    starts_cm[j, r0:r0 + num_rows], contiguous. `starts` / `lens` view them
    as [rows, cols], the reference's layout."""

    __slots__ = ("raw", "starts_cm", "lens_cm", "r0", "num_rows",
                 "header_names", "ascii")

    def __init__(self, raw, starts_cm, lens_cm, r0, num_rows, header_names,
                 ascii=None):
        self.raw = raw              # np.uint8 [bytes]
        self.starts_cm = starts_cm  # np.int32 [ncols, stride]
        self.lens_cm = lens_cm
        self.r0 = r0
        self.num_rows = num_rows
        self.header_names = header_names  # list[str] | None
        self.ascii = ascii          # no byte past 0x7F (None: not known)

    @property
    def ncols(self) -> int:
        return int(self.starts_cm.shape[0])

    @property
    def starts(self) -> np.ndarray:
        return self.starts_cm[:, self.r0:self.r0 + self.num_rows].T

    @property
    def lens(self) -> np.ndarray:
        return self.lens_cm[:, self.r0:self.r0 + self.num_rows].T

    def field_bytes(self, col: int) -> int:
        return int(self.lens[:, col].sum(dtype=np.int64))


# ---------------------------------------------------------------------------
# The boundary plan (host)
# ---------------------------------------------------------------------------
PLAN_THREADS = 8
PIECE_BYTES = 8 << 20  # the least bytes a planning thread takes


def line_count(arr: np.ndarray, lo: int = 0, hi: Optional[int] = None) -> int:
    """Lines of arr[lo:hi), a last line without its newline included."""
    hi = arr.size if hi is None else hi
    if hi <= lo:
        return 0
    return native.count_byte(arr, _NL, lo, hi) + (0 if arr[hi - 1] == _NL
                                                  else 1)


def _tables(size: int, alloc):
    size = max(size, 1)
    if alloc is not None:
        return alloc(size), alloc(size)
    return np.empty(size, np.int32), np.empty(size, np.int32)


def plan_fields(data, ncols: int, header: bool, sep: str = ",",
                alloc=None, threads: int = PLAN_THREADS,
                piece_bytes: int = PIECE_BYTES) -> Optional[FieldTable]:
    """The field spans of `data` (reference :81), natively. None when the
    layout is not eligible for the device (a ragged line, a quote layout
    other than whole quoted fields with "" escapes, a separator that is a
    newline or a quote, or more than 2^31 - 2 bytes). `data`: bytes, or a
    writable uint8 array that the quote-aware sweep rewrites in place (its
    "" pairs lose a quote). alloc(n) makes the int32 span tables (pinned
    memory for an upload).

    The native sweep (srt_csv_plan, the reference's sweep made
    quote-aware) plans a text of up to piece_bytes at once. A larger text
    is planned on `threads` threads: the quotes of equal ranges are
    counted, their parities give whether each range starts inside quotes,
    each range's start moves to the next line outside quotes, and every
    piece is planned into its own rows of the tables (a piece's unescaped
    bytes end before its end)."""
    arr = data if isinstance(data, np.ndarray) else \
        np.frombuffer(data, dtype=np.uint8)
    size = arr.size
    if not size or size > 2 ** 31 - 2 or ncols < 1:
        return None
    sep_b = ord(sep)
    if sep_b in (_NL, _CR, _QUOTE):
        return None
    if not arr.flags.writeable:
        arr = arr.copy()
    k = max(1, min(threads, size // max(piece_bytes, 1)))
    if k > 1:
        return _plan_pieces(arr, ncols, sep_b, header, alloc, k)
    est = max(line_count(arr), 1)
    starts, lens = _tables(ncols * est, alloc)
    res = native.csv_plan(arr, 0, size, ncols, sep_b, starts, lens, 0, est,
                          est)
    if res is None:
        return None
    if res == -3:
        raise RuntimeError("a CSV text holds more rows than its lines")
    n, deleted, high = res
    return _finish(arr[:size - deleted], starts.reshape(ncols, est),
                   lens.reshape(ncols, est), n, header, not high)


def _plan_pieces(arr: np.ndarray, ncols: int, sep_b: int, header: bool,
                 alloc, k: int) -> Optional[FieldTable]:
    size = arr.size
    bounds = [size * i // k for i in range(k + 1)]
    with ThreadPoolExecutor(max_workers=k) as ex:
        stats = list(ex.map(lambda i: native.csv_stats(
            arr, bounds[i], bounds[i + 1]), range(k)))
        parity = np.cumsum([0] + [q for q, _h in stats]) % 2
        cuts = [0]
        for i in range(1, k):
            cuts.append(max(cuts[-1], native.csv_next_line(
                arr, bounds[i], size, bool(parity[i]))))
        cuts.append(size)
        pieces = [(lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
        est = list(ex.map(lambda p: line_count(arr, *p), pieces))
        total = sum(est)
        row0 = np.cumsum([0] + est[:-1]).tolist()
        starts, lens = _tables(ncols * total, alloc)
        res = list(ex.map(lambda i: native.csv_plan(
            arr, pieces[i][0], pieces[i][1], ncols, sep_b, starts, lens,
            row0[i], total, est[i]), range(len(pieces))))
    if any(r is None for r in res):
        return None
    if any(r == -3 for r in res):
        raise RuntimeError("a CSV text holds more rows than its lines")
    starts = starts[:ncols * total].reshape(ncols, total)
    lens = lens[:ncols * total].reshape(ncols, total)
    rows = [r[0] for r in res]
    if rows != est:  # newlines inside quotes: drop the unused rows
        keep = np.concatenate([np.arange(r0, r0 + n)
                               for r0, n in zip(row0, rows)])
        starts, lens = starts[:, keep], lens[:, keep]
    return _finish(arr, starts, lens, sum(rows), header,
                   not any(h for _q, h in stats))


def _finish(arr, starts_cm, lens_cm, n_lines: int, header: bool,
            ascii=None) -> Optional[FieldTable]:
    """Reference `_finish_plan` (:253) over column-major tables: blank lines
    of a one-column file are skipped (pyarrow's ignore_empty_lines), and
    the header row names the columns, read from the (unescaped) bytes."""
    ncols = starts_cm.shape[0]
    if ncols == 1:
        keep = lens_cm[0, :n_lines] > 0
        if header and n_lines >= 1:
            keep[0] = True  # never drop the header row
        if not keep.all():
            starts_cm = starts_cm[:, :n_lines][:, keep]
            lens_cm = lens_cm[:, :n_lines][:, keep]
            n_lines = int(keep.sum())
    header_names = None
    r0 = 0
    if header:
        if n_lines < 1:
            return None
        header_names = [
            bytes(arr[starts_cm[j, 0]:starts_cm[j, 0] + lens_cm[j, 0]])
            .decode("utf-8", errors="replace").strip()
            for j in range(ncols)]
        r0 = 1
        n_lines -= 1
    return FieldTable(arr, starts_cm, lens_cm, r0, n_lines, header_names,
                      ascii)


def plan_fields_plain(data: bytes, ncols: int, header: bool,
                      sep: str = ",") -> Optional[FieldTable]:
    """plan_fields through the reference's numpy planners (the plain
    versions the tests hold the native sweeps to)."""
    if not data or len(data) > 2 ** 31 - 2:
        return None
    sep_b = ord(sep)
    if sep_b in (_NL, _CR, _QUOTE):
        return None
    res = _plan_fields_quoted(data, ncols, sep_b) if b'"' in data else \
        _plan_fields_py(data, ncols, sep_b)
    if res is None:
        return None
    arr, starts, lens, n_lines = res
    return _finish(arr, np.ascontiguousarray(starts.T, dtype=np.int32),
                   np.ascontiguousarray(lens.T, dtype=np.int32), n_lines,
                   header)


def _plan_fields_quoted(data: bytes, ncols: int, sep_b: int):
    """The reference's quote-aware numpy planner (:130), kept as the plain
    version of the native sweep: separators and newlines inside quotes are
    not boundaries; whole quoted fields lose their quotes; the second quote
    of each "" pair is deleted and the spans remapped; any other quote
    layout -> None."""
    arr = np.frombuffer(data, dtype=np.uint8)
    is_q = arr == _QUOTE
    inside = (np.cumsum(is_q) - is_q) % 2 == 1
    is_bound = ((arr == sep_b) | (arr == _NL)) & ~inside & ~is_q
    bpos = np.flatnonzero(is_bound).astype(np.int64)
    if arr[-1] != _NL:
        bpos = np.append(bpos, len(arr))
    n_fields = len(bpos)
    if n_fields % ncols != 0:
        return None
    n_lines = n_fields // ncols
    ends = bpos.reshape(n_lines, ncols)
    interior = ends[:, :-1].ravel()
    if interior.size and (arr[interior] == _NL).any():
        return None
    line_final = ends[:, -1]
    real = line_final[line_final < len(arr)]
    if real.size and (arr[real] != _NL).any():
        return None
    starts = np.empty_like(ends)
    starts[:, 0] = np.concatenate(([0], ends[:-1, -1] + 1))
    starts[:, 1:] = ends[:, :-1] + 1
    lens = ends - starts
    last_ends = ends[:, -1]
    has_cr = np.zeros(n_lines, dtype=bool)
    nonempty = lens[:, -1] > 0
    prev = np.clip(last_ends - 1, 0, len(arr) - 1)
    has_cr[nonempty] = arr[prev[nonempty]] == _CR
    lens[:, -1] -= has_cr.astype(np.int32)
    fs = starts.ravel()
    fl = lens.ravel()
    first_q = np.zeros(fs.shape, dtype=bool)
    last_q = np.zeros(fs.shape, dtype=bool)
    nz = fl >= 2
    first_q[nz] = arr[fs[nz]] == _QUOTE
    last_q[nz] = arr[np.clip(fs[nz] + fl[nz] - 1, 0, len(arr) - 1)] == _QUOTE
    quoted = first_q & last_q
    nxt_q = np.zeros_like(is_q)
    nxt_q[:-1] = is_q[1:]
    pair_first = is_q & nxt_q & inside
    qcum = np.concatenate(([0], np.cumsum(is_q)))
    ecum = np.concatenate(([0], np.cumsum(pair_first)))
    lo = np.clip(fs, 0, len(arr))
    hi = np.clip(fs + fl, 0, len(arr))
    qcnt = qcum[hi] - qcum[lo]
    ecnt = ecum[hi] - ecum[lo]
    if not np.all((quoted & (qcnt == 2 + 2 * ecnt)) | (~quoted & (qcnt == 0))):
        return None
    fs = fs + quoted.astype(np.int64)
    fl = fl - 2 * quoted.astype(np.int64)
    if pair_first.any():
        second = np.zeros_like(pair_first)
        second[1:] = pair_first[:-1]
        delcum = np.concatenate(([0], np.cumsum(second)))
        fl = fl - (delcum[np.clip(fs + fl, 0, len(arr))]
                   - delcum[np.clip(fs, 0, len(arr))])
        fs = fs - delcum[np.clip(fs, 0, len(arr))]
        arr = arr[~second]
    return (arr, fs.reshape(n_lines, ncols).astype(np.int64),
            fl.reshape(n_lines, ncols).astype(np.int64), n_lines)


def _plan_fields_py(data: bytes, ncols: int, sep_b: int):
    """The reference's numpy planner for quote-free text (:213), the plain
    version of srt_csv_plan on such text."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if (arr == _QUOTE).any():
        return None
    is_bound = (arr == sep_b) | (arr == _NL)
    bpos = np.flatnonzero(is_bound).astype(np.int64)
    if arr[-1] != _NL:
        bpos = np.append(bpos, len(arr))
    n_fields = len(bpos)
    if n_fields % ncols != 0:
        return None
    n_lines = n_fields // ncols
    ends = bpos.reshape(n_lines, ncols)
    interior = ends[:, :-1].ravel()
    if interior.size and (arr[interior] == _NL).any():
        return None
    line_final = ends[:, -1]
    real = line_final[line_final < len(arr)]
    if real.size and (arr[real] != _NL).any():
        return None
    starts = np.empty_like(ends)
    starts[:, 0] = np.concatenate(([0], ends[:-1, -1] + 1))
    starts[:, 1:] = ends[:, :-1] + 1
    lens = ends - starts
    last_ends = ends[:, -1]
    has_cr = np.zeros(n_lines, dtype=bool)
    nonempty = lens[:, -1] > 0
    prev = np.clip(last_ends - 1, 0, len(arr) - 1)
    has_cr[nonempty] = arr[prev[nonempty]] == _CR
    lens[:, -1] -= has_cr.astype(np.int32)
    return arr, starts, lens, n_lines


# ---------------------------------------------------------------------------
# Plain versions (the reference's jitted kernels in PyTorch)
# ---------------------------------------------------------------------------
def _gather_chars(raw, starts, lens, maxw: int):
    """(ch int32 [n, maxw], in-field mask, positions): up to maxw bytes of
    each field, 0 past its length (reference: the gather of every kernel)."""
    dev = starts.device
    pos = torch.arange(maxw, dtype=torch.int64, device=dev)[None, :]
    nraw = int(raw.shape[0])
    idx = (starts.long()[:, None] + pos).clamp(0, max(nraw - 1, 0))
    ch = raw[idx].int() if nraw else torch.zeros(idx.shape, dtype=torch.int32,
                                                 device=dev)
    inb = pos < lens.long()[:, None]
    return torch.where(inb, ch, torch.zeros_like(ch)), inb, pos


def parse_int_plain(raw, starts, lens):
    """(value int64, validity, malformed) of each field (reference
    _parse_int_kernel :285): '-' then digits in int64 range; empty fields
    are NULL; anything else the fold does not cover is malformed, overflow
    caught before it wraps."""
    ch, inb, pos = _gather_chars(raw, starts, lens, MAXW)
    lens = lens.long()
    neg = ch[:, 0] == _MINUS
    skip = neg.long()
    digits = ch - _ZERO
    isdig = (digits >= 0) & (digits <= 9)
    digpos = (pos >= skip[:, None]) & inb
    all_digits = torch.where(digpos, isdig, torch.ones_like(isdig)).all(1)
    ok = all_digits & (lens - skip > 0) & (lens <= MAXW)
    n = starts.shape[0]
    val = torch.zeros(n, dtype=torch.int64, device=starts.device)
    imax = np.iinfo(np.int64).max
    overflow = torch.zeros(n, dtype=torch.bool, device=starts.device)
    for i in range(MAXW):
        d = torch.where(isdig[:, i], digits[:, i], 0).long()
        overflow = overflow | (digpos[:, i] & (
            val > torch.div(imax - d, 10, rounding_mode="floor")))
        val = torch.where(digpos[:, i], val * 10 + d, val)
    val = torch.where(neg, -val, val)
    validity = ok & (lens > 0) & ~overflow
    malformed = (lens > 0) & ~validity
    return torch.where(validity, val, torch.zeros_like(val)), validity, \
        malformed


_P10 = [10.0 ** k for k in range(23)]


def parse_float_plain(raw, starts, lens):
    """(value float64, validity, malformed) (reference _parse_float_kernel
    :322): '-'? digits ['.' digits] with at most 15 significant and 22
    fractional digits, the mantissa over 10^frac in one IEEE division."""
    ch, inb, pos = _gather_chars(raw, starts, lens, MAXW_F)
    lens = lens.long()
    neg = ch[:, 0] == _MINUS
    skip = neg.long()
    digits = ch - _ZERO
    isdig = (digits >= 0) & (digits <= 9)
    isdot = ch == _DOT
    body = (pos >= skip[:, None]) & inb
    ndots = (body & isdot).long().sum(1)
    ok_chars = torch.where(body, isdig | isdot, torch.ones_like(isdig)).all(1)
    dotpos = (body & isdot).to(torch.int32).argmax(1).long()
    has_dot = ndots == 1
    frac = torch.where(has_dot, lens - 1 - dotpos, torch.zeros_like(lens))
    ndig = lens - skip - has_dot.long()
    m = torch.zeros(starts.shape[0], dtype=torch.int64, device=starts.device)
    for i in range(MAXW_F):
        d = torch.where(isdig[:, i], digits[:, i], 0).long()
        m = torch.where(body[:, i] & isdig[:, i], m * 10 + d, m)
    ok = ok_chars & (ndots <= 1) & (ndig > 0) & (ndig <= 15) & \
        (frac >= 0) & (frac <= 22) & (lens <= MAXW_F)
    p10 = torch.tensor(_P10, dtype=torch.float64, device=starts.device)
    val = m.double() / p10[frac.clamp(0, 22)]
    val = torch.where(neg, -val, val)
    validity = ok & (lens > 0)
    malformed = (lens > 0) & ~validity
    return torch.where(validity, val, torch.zeros_like(val)), validity, \
        malformed


def _civil(digits, isdig, ch):
    """(layout ok, days, civil ok) of the YYYY-MM-DD prefix."""
    layout = isdig[:, [0, 1, 2, 3, 5, 6, 8, 9]].all(1) & \
        (ch[:, 4] == _MINUS) & (ch[:, 7] == _MINUS)
    dg = digits.long()
    y = dg[:, 0] * 1000 + dg[:, 1] * 100 + dg[:, 2] * 10 + dg[:, 3]
    m = dg[:, 5] * 10 + dg[:, 6]
    d = dg[:, 8] * 10 + dg[:, 9]
    days = DT.days_from_civil(y, m, d).long()
    ry, rm, rd = DT.civil_from_days(days)
    return layout, days, (ry == y) & (rm == m) & (rd == d)


def parse_date_plain(raw, starts, lens):
    """(days int32, validity, malformed) (reference _parse_date_kernel
    :417): strict ISO YYYY-MM-DD; an impossible date (2023-02-30) is
    malformed."""
    ch, _inb, _pos = _gather_chars(raw, starts, lens, MAXW_D)
    digits = ch - _ZERO
    isdig = (digits >= 0) & (digits <= 9)
    layout, days, civil_ok = _civil(digits, isdig, ch)
    lens = lens.long()
    validity = layout & (lens == 10) & civil_ok & (lens > 0)
    malformed = (lens > 0) & ~validity
    return torch.where(validity, days, torch.zeros_like(days)).to(
        torch.int32), validity, malformed


def parse_timestamp_plain(raw, starts, lens):
    """(microseconds int64, validity, malformed) (reference
    _parse_timestamp_kernel :451): 'YYYY-MM-DD[ T]HH:MM:SS[.f{1,6}]' and a
    zone 'Z', +-HH, +-HHMM or +-HH:MM, which the host parser requires."""
    ch, _inb, _pos = _gather_chars(raw, starts, lens, MAXW_TS)
    dev = starts.device
    n = starts.shape[0]
    lens = lens.long()
    digits = (ch - _ZERO).long()
    isdig = (digits >= 0) & (digits <= 9)
    layout, days, civil_ok = _civil(digits, isdig, ch)
    date_ok = (lens >= 19) & layout
    time_ok = isdig[:, [11, 12, 14, 15, 17, 18]].all(1) & \
        ((ch[:, 10] == 0x20) | (ch[:, 10] == 0x54)) & \
        (ch[:, 13] == 0x3A) & (ch[:, 16] == 0x3A)
    hh = digits[:, 11] * 10 + digits[:, 12]
    mi = digits[:, 14] * 10 + digits[:, 15]
    ss = digits[:, 17] * 10 + digits[:, 18]
    time_ok = time_ok & (hh < 24) & (mi < 60) & (ss < 60)
    has_dot = (lens > 19) & (ch[:, 19] == _DOT)
    fd = torch.zeros(n, dtype=torch.int64, device=dev)
    going = has_dot
    frac = torch.zeros(n, dtype=torch.int64, device=dev)
    for i in range(6):
        p = 20 + i
        going = going & (p < lens) & isdig[:, p]
        fd = fd + going.long()
        frac = torch.where(going, frac * 10 + digits[:, p], frac)
    frac_ok = ~has_dot | (fd >= 1)
    p10 = torch.tensor([10 ** k for k in range(7)], dtype=torch.int64,
                       device=dev)
    frac = frac * p10[(6 - fd).clamp(0, 6)]
    zstart = torch.where(has_dot, 20 + fd, torch.full_like(fd, 19))
    zlen = lens - zstart

    def at(k):
        p = (zstart + k).clamp(0, MAXW_TS - 1)
        v = ch.gather(1, p[:, None])[:, 0].long()
        return torch.where(zstart + k < lens, v, torch.zeros_like(v))

    def dg(k):
        return at(k) - _ZERO

    def isd(k):
        v = dg(k)
        return (v >= 0) & (v <= 9)

    sign = at(0)
    signed = (sign == _PLUS) | (sign == _MINUS)
    z_utc = (zlen == 1) & (sign == 0x5A)
    z_hh = (zlen == 3) & signed & isd(1) & isd(2)
    z_hhmm = (zlen == 5) & signed & isd(1) & isd(2) & isd(3) & isd(4)
    z_colon = (zlen == 6) & signed & isd(1) & isd(2) & (at(3) == 0x3A) & \
        isd(4) & isd(5)
    off_h = dg(1) * 10 + dg(2)
    off_m = torch.where(z_hhmm, dg(3) * 10 + dg(4),
                        torch.where(z_colon, dg(4) * 10 + dg(5),
                                    torch.zeros_like(off_h)))
    zone_ok = z_utc | ((z_hh | z_hhmm | z_colon) & (off_h < 24) &
                       (off_m < 60))
    off_us = torch.where(z_utc, torch.zeros_like(off_h),
                         (off_h * 3600 + off_m * 60) * 1_000_000)
    off_us = torch.where(sign == _MINUS, -off_us, off_us)
    ok = date_ok & civil_ok & time_ok & frac_ok & zone_ok
    us = days * 86_400_000_000 + (hh * 3600 + mi * 60 + ss) * 1_000_000 + \
        frac - off_us
    validity = ok & (lens > 0)
    malformed = (lens > 0) & ~validity
    return torch.where(validity, us, torch.zeros_like(us)), validity, \
        malformed


def null_sentinels_plain(raw, starts, lens):
    """bool: the field equals a null spelling (reference
    _match_sentinels_kernel :594; empty fields are NULL by length)."""
    ch, _inb, _pos = _gather_chars(raw, starts, lens, SENTINEL_MAXW)
    lens = lens.long()
    out = torch.zeros(starts.shape[0], dtype=torch.bool, device=starts.device)
    for s in NULL_SENTINELS:
        pat = torch.tensor(list(s.ljust(SENTINEL_MAXW, b"\0")),
                           dtype=torch.int32, device=starts.device)
        out = out | ((lens == len(s)) & (ch == pat[None, :]).all(1))
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers: K33-K36
# ---------------------------------------------------------------------------
def _pad(t: torch.Tensor, cap: int, fill=0) -> torch.Tensor:
    if t.shape[0] == cap:
        return t
    out = torch.full((cap,), fill, dtype=t.dtype, device=t.device)
    out[:t.shape[0]] = t
    return out


def _args(raw, starts, lens):
    CB.require_cuda(raw, starts, lens)
    if starts.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("field spans must be int32")
    return (raw.data_ptr(), int(raw.shape[0]), starts.data_ptr(),
            lens.data_ptr(), int(starts.shape[0]))


def _narrow(val, validity, malformed, dtype: DataType):
    """The reference's narrowing (decode_int_column :387): a value outside
    a narrow type's range is malformed and stored as 0."""
    tdt = _INT_TORCH[dtype]
    if tdt is torch.int64:
        return val, malformed
    info = torch.iinfo(tdt)
    in_range = (val >= info.min) & (val <= info.max)
    malformed = malformed | (validity & ~in_range)
    return torch.where(in_range, val, torch.zeros_like(val)).to(tdt), \
        malformed


def csv_parse_int(raw, starts, lens, cap: int, dtype: DataType,
                  flag: torch.Tensor):
    """K33 (replaces csv_device.py:_parse_int_kernel :285 and the narrowing
    of decode_int_column :387): (values of `dtype` [cap], validity [cap]);
    a malformed field sets flag[0] (int32)."""
    if raw.device.type == "cpu":
        val, validity, malformed = parse_int_plain(raw, starts, lens)
        val, malformed = _narrow(val, validity, malformed, dtype)
        flag |= malformed.any().int()
        return _pad(val, cap), _pad(validity, cap, False)
    lib = CB.library("csv_parse")
    args = _args(raw, starts, lens)
    CB.require_cuda(flag)
    out = torch.empty(cap, dtype=_INT_TORCH[dtype], device=raw.device)
    valid = torch.empty(cap, dtype=torch.bool, device=raw.device)
    rc = lib.srt_csv_parse_int(*args, cap, _INT_BYTES[dtype], out.data_ptr(),
                               valid.data_ptr(), flag.data_ptr(),
                               CB.stream_of(raw))
    CB.count_launch("csv_parse_int")
    CB.check(lib, rc, "csv_parse_int")
    return out, valid


def csv_parse_float(raw, starts, lens, cap: int, flag: torch.Tensor):
    """K34 (replaces csv_device.py:_parse_float_kernel :322): DOUBLE values
    and validity [cap]; a malformed field sets flag[0]."""
    if raw.device.type == "cpu":
        val, validity, malformed = parse_float_plain(raw, starts, lens)
        flag |= malformed.any().int()
        return _pad(val, cap), _pad(validity, cap, False)
    lib = CB.library("csv_parse")
    args = _args(raw, starts, lens)
    CB.require_cuda(flag)
    out = torch.empty(cap, dtype=torch.float64, device=raw.device)
    valid = torch.empty(cap, dtype=torch.bool, device=raw.device)
    rc = lib.srt_csv_parse_float(*args, cap, out.data_ptr(),
                                 valid.data_ptr(), flag.data_ptr(),
                                 CB.stream_of(raw))
    CB.count_launch("csv_parse_float")
    CB.check(lib, rc, "csv_parse_float")
    return out, valid


def csv_parse_datetime(raw, starts, lens, cap: int, timestamp: bool,
                       flag: torch.Tensor):
    """K35 (replaces csv_device.py:_parse_date_kernel :417 and
    _parse_timestamp_kernel :451, one body with a mode): DATE days (int32)
    or TIMESTAMP microseconds (int64) and validity [cap]; a malformed field
    sets flag[0]."""
    if raw.device.type == "cpu":
        fn = parse_timestamp_plain if timestamp else parse_date_plain
        val, validity, malformed = fn(raw, starts, lens)
        flag |= malformed.any().int()
        return _pad(val, cap), _pad(validity, cap, False)
    lib = CB.library("csv_parse")
    args = _args(raw, starts, lens)
    CB.require_cuda(flag)
    out = torch.empty(cap, dtype=torch.int64 if timestamp else torch.int32,
                      device=raw.device)
    valid = torch.empty(cap, dtype=torch.bool, device=raw.device)
    rc = lib.srt_csv_parse_datetime(*args, cap, 1 if timestamp else 0,
                                    out.data_ptr(), valid.data_ptr(),
                                    flag.data_ptr(), CB.stream_of(raw))
    CB.count_launch("csv_parse_datetime")
    CB.check(lib, rc, "csv_parse_datetime")
    return out, valid


def csv_null_sentinels(raw, starts, lens, cap: int) -> torch.Tensor:
    """K36 (replaces csv_device.py:_match_sentinels_kernel :594): bool
    [cap], the field equals one of NULL_SENTINELS (False past the rows)."""
    if raw.device.type == "cpu":
        return _pad(null_sentinels_plain(raw, starts, lens), cap, False)
    lib = CB.library("csv_parse")
    args = _args(raw, starts, lens)
    out = torch.empty(cap, dtype=torch.bool, device=raw.device)
    rc = lib.srt_csv_null_sentinels(*args, cap, out.data_ptr(),
                                    CB.stream_of(raw))
    CB.count_launch("csv_null_sentinels")
    CB.check(lib, rc, "csv_null_sentinels")
    return out


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------
FLOATS = (DataType.FLOAT32, DataType.FLOAT64)


def device_parseable(dtype) -> bool:
    """Reference :645. FLOAT32 stays on the host: a parse to f64 and then
    a narrowing rounds twice, where Arrow rounds the decimal once."""
    return dtype in INTEGRAL or dtype in (
        DataType.STRING, DataType.DATE, DataType.TIMESTAMP, DataType.FLOAT64)


def eligible_attrs(attrs, header_names: Optional[List[str]],
                   attr_names_in_file_order: List[str]) -> Dict[str, int]:
    """attr name -> file column of the device-parseable columns (reference
    :674)."""
    order = header_names if header_names is not None \
        else attr_names_in_file_order
    return {a.name: order.index(a.name) for a in attrs
            if device_parseable(a.data_type) and a.name in order}


class DeviceSplit:
    """A chunk's bytes and span tables on the device, uploaded once, and
    its malformed flag."""

    def __init__(self, table: FieldTable, raw: torch.Tensor,
                 starts_cm: torch.Tensor, lens_cm: torch.Tensor):
        self.table = table
        self.raw = raw
        self.starts_cm = starts_cm
        self.lens_cm = lens_cm
        self.flag = torch.zeros(1, dtype=torch.int32, device=raw.device)
        self.cap = bucket_capacity(max(table.num_rows, 1))

    def spans(self, col: int):
        t = self.table
        return (self.starts_cm[col, t.r0:t.r0 + t.num_rows],
                self.lens_cm[col, t.r0:t.r0 + t.num_rows])


def decode_column(ds: DeviceSplit, col: int, dtype) -> ColumnVector:
    """One device-parseable column of the split (reference decode_column
    :635 and decode_string_column :611)."""
    if dtype is DataType.STRING:
        return decode_string_column(ds, col)
    starts, lens = ds.spans(col)
    if dtype is DataType.FLOAT64:
        val, valid = csv_parse_float(ds.raw, starts, lens, ds.cap, ds.flag)
    elif dtype in (DataType.DATE, DataType.TIMESTAMP):
        val, valid = csv_parse_datetime(ds.raw, starts, lens, ds.cap,
                                        dtype is DataType.TIMESTAMP, ds.flag)
    else:
        val, valid = csv_parse_int(ds.raw, starts, lens, ds.cap, dtype,
                                   ds.flag)
    return ColumnVector(dtype, val, valid)


def decode_string_column(ds: DeviceSplit, col: int) -> ColumnVector:
    """A STRING column straight from the plan (reference :611): K36 marks
    the null spellings, K7's span entry packs the bytes. The byte total and
    the longest field are known on the host, so nothing syncs."""
    starts, lens = ds.spans(col)
    cap, n = ds.cap, ds.table.num_rows
    is_null = csv_null_sentinels(ds.raw, starts, lens, cap)
    lens_cap = _pad(lens, cap)
    validity = (torch.arange(cap, device=lens.device) < n) & \
        (lens_cap > 0) & ~is_null
    host_lens = ds.table.lens[:, col]
    total = int(host_lens.sum(dtype=np.int64))
    max_len = int(host_lens.max()) if n else 0
    offsets, data, valid = gather_string_spans(
        ds.raw, _pad(starts, cap).to(torch.int64), lens_cap, validity, n,
        bucket_capacity(max(total, 8)))
    return ColumnVector(DataType.STRING, data, valid, offsets,
                        S.len_bucket(max(max_len, 1)))
