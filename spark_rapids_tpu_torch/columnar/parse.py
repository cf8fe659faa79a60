"""STRING -> float and STRING -> timestamp parses: casts from STRING (port
of spark_rapids_tpu/columnar/parse.py, B16's parsing half).

Grammar and arithmetic are the reference's (its docstring :1-25):

- float: [+-]? ( digits [. digits*] | . digits+ ) ( [eE] [+-]? d{1,3} )?
  or [+-]? (inf | infinity | nan), case-insensitive, after an ASCII
  whitespace trim, at most 48 characters; the first 17 significant
  digits fold into an int64 mantissa (later integer digits shift the
  exponent, later fraction digits are dropped) and the value is
  `format.f64_scale_int(m, q)`, the one shared core;
- timestamp: 'YYYY-MM-DD' (midnight UTC) or 'YYYY-MM-DD[ T]HH:MM:SS
  [.f{1,6}][Z|+-HH:MM]' after the trim, civil dates checked, naive times
  UTC; at most 32 characters are looked at.

A malformed non-empty row is NULL, and so is an empty one; both are
flagged malformed, which an ANSI cast raises on. These parses stay apart
from the CSV scan's (io/csv_device.py): a field that fails there falls
back to the host grammar, a cast that fails gives NULL.

K43 `parse_float` (csrc/cast_parse.cu) replaces `_parse_float_kernel`
(:79, with `_trimmed_window` :50) and `parse_float_col` (:262); K44
`parse_timestamp` replaces `_parse_timestamp_kernel` (:173) and
`parse_timestamp_col` (:283). Their plain versions are the reference's
[rows, width] formulations, 2^20 rows at a time; the kernels walk each
row's own bytes, a thread a row.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar import format as FMT
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.values import ColV

MAXW_FLOAT = 48
MAXW_TS = 32

_ZERO = ord("0")
_MINUS = ord("-")
_PLUS = ord("+")
_DOT = ord(".")
_ROWS_PER_CHUNK = 1 << 20


def _is_ws(b):
    # ASCII whitespace, as the host engine's str.strip(" \t\n\r\f\x0b")
    return (b == 32) | ((b >= 9) & (b <= 13))


def _trimmed_window(offsets, data, maxw: int):
    """(chars int64 [cap, maxw], 0 past the field; trimmed lengths int64
    [cap]) of each row's ASCII-whitespace-trimmed field (reference :50)."""
    cap = int(offsets.shape[0]) - 1
    dev = offsets.device
    starts = offsets[:-1].long()
    ends = offsets[1:].long()
    byte_cap = int(data.shape[0])
    if byte_cap == 0 or cap == 0:
        return (torch.zeros(cap, maxw, dtype=torch.int64, device=dev),
                torch.zeros(cap, dtype=torch.int64, device=dev))
    lo, total = int(starts[0]), int(ends[-1])
    pos = torch.arange(lo, total, device=dev)
    row = torch.searchsorted(ends, pos, right=True).clamp(0, cap - 1)
    keep = ~_is_ws(data[lo:total])
    first = torch.full((cap,), byte_cap, dtype=torch.int64, device=dev)
    last = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, row[keep], pos[keep], "amin")
    last.scatter_reduce_(0, row[keep], pos[keep], "amax")
    none = first >= byte_cap
    start = torch.where(none, starts, first)
    lens = torch.where(none, 0, last + 1 - start)
    k = torch.arange(maxw, device=dev)
    idx = (start[:, None] + k[None, :]).clamp(0, byte_cap - 1)
    ch = data[idx].long()
    return torch.where(k[None, :] < lens[:, None], ch, 0), lens


def _cum(x):
    return torch.cumsum(x.to(torch.int64), 1)


def _parse_float_rows(ch, lens, maxw: int):
    """(value f64, parsed) of trimmed windows (reference :79-169)."""
    dev = ch.device
    n = torch.arange(maxw, device=dev)[None, :]
    inb = n < lens[:, None]
    lower = torch.where((ch >= ord("A")) & (ch <= ord("Z")), ch + 32, ch)

    def word_is(w: bytes, off):
        m = (off < lens) & (lens - off == len(w))
        for j, b in enumerate(w):
            pos = (off + j).clamp(0, maxw - 1)
            cj = torch.gather(lower, 1, pos[:, None])[:, 0]
            m = m & ((off + j) < lens) & (cj == b)
        return m

    sign_ch = ch[:, 0]
    signed = (sign_ch == _MINUS) | (sign_ch == _PLUS)
    neg = sign_ch == _MINUS
    body0 = signed.to(torch.int64)
    is_inf = word_is(b"inf", body0) | word_is(b"infinity", body0)
    is_nan = word_is(b"nan", body0)

    digits = ch - _ZERO
    isdig = (digits >= 0) & (digits <= 9)
    body = inb & (n >= body0[:, None])
    isdot = body & (ch == _DOT)
    emark_raw = body & ((ch == ord("e")) | (ch == ord("E")))
    in_exp = _cum(emark_raw) > 0
    prev_in_exp = torch.cat([torch.zeros_like(in_exp[:, :1]),
                             in_exp[:, :-1]], 1)
    first_e = in_exp & ~prev_in_exp & emark_raw
    mant = body & ~in_exp
    mant_dig = mant & isdig
    mdot = mant & isdot
    ndots = mdot.sum(1)
    seen_dot = _cum(mdot) > 0
    started = _cum(mant_dig & (digits > 0)) > 0
    counted = mant_dig & started
    crank = _cum(counted)
    fold = mant_dig & (crank <= 17)
    frank = _cum(fold)
    nfold = frank[:, -1]
    P10I = FMT._table("p10i", dev)
    mpow = P10I[(nfold[:, None] - frank).clamp(0, 18)]
    m = torch.where(fold, digits * mpow, 0).sum(1)
    scale = (fold & seen_dot).sum(1)
    dropped_int = (mant_dig & ~seen_dot & (crank > 17)).sum(1)
    ndig_mant = mant_dig.sum(1)
    exp_body = body & in_exp & ~first_e
    e_pos = torch.argmax(first_e.to(torch.int8), 1)
    esign_pos = exp_body & (n == (e_pos + 1)[:, None]) & \
        ((ch == _PLUS) | (ch == _MINUS))
    exp_neg = (esign_pos & (ch == _MINUS)).any(1)
    exp_dig = exp_body & isdig
    erank = _cum(exp_dig)
    nde = erank[:, -1]
    epow = P10I[(nde[:, None] - erank).clamp(0, 3)]
    exp_val = torch.where(exp_dig & (nde[:, None] <= 3), digits * epow,
                          0).sum(1)
    ok_char = mant_dig | mdot | first_e | esign_pos | exp_dig
    bad = (body & ~ok_char).any(1) | (ndots > 1)
    has_exp_marker = first_e.any(1)
    grammar_ok = (~bad) & (ndig_mant > 0) & \
        (~has_exp_marker | (nde >= 1)) & (nde <= 3) & \
        (lens <= maxw) & (lens > body0)
    q = torch.where(exp_neg, -exp_val, exp_val) - scale + dropped_int
    val = FMT.f64_scale_int(m, q.clamp(-400, 400))
    inf = torch.full((), float("inf"), dtype=torch.float64, device=dev)
    nan = torch.full((), float("nan"), dtype=torch.float64, device=dev)
    val = torch.where(is_inf, inf, torch.where(is_nan, nan, val))
    val = torch.where(neg, -val, val)
    parsed = (grammar_ok | is_inf | is_nan) & (lens > 0)
    return val, parsed


def _by_chunks(offsets, data, maxw: int, rows_fn, out_dtype):
    """rows_fn over 2^20-row pieces: (values [cap], parsed [cap])."""
    cap = int(offsets.shape[0]) - 1
    dev = offsets.device
    val = torch.zeros(cap, dtype=out_dtype, device=dev)
    parsed = torch.zeros(cap, dtype=torch.bool, device=dev)
    for r0 in range(0, cap, _ROWS_PER_CHUNK):
        r1 = min(cap, r0 + _ROWS_PER_CHUNK)
        ch, lens = _trimmed_window(offsets[r0:r1 + 1], data, maxw)
        v, p = rows_fn(ch, lens, maxw)
        val[r0:r1] = v
        parsed[r0:r1] = p
    return val, parsed


def _round_to_f32(val):
    """FLOAT32 results: rounded, then below the smallest normal f32 flushed
    to a signed zero (reference :268-277)."""
    v32 = val.to(torch.float32)
    zero = torch.where(torch.signbit(val), -0.0, 0.0).to(torch.float32)
    return torch.where(v32.abs() < 2.0 ** -126, zero, v32)


def parse_float_plain(offsets, data, validity, to32: bool = False):
    """(value f64 / f32 [cap], validity, malformed) of each row parsed as
    a float; invalid lanes hold 0 (reference :262)."""
    val, parsed = _by_chunks(offsets, data, MAXW_FLOAT, _parse_float_rows,
                             torch.float64)
    if to32:
        val = _round_to_f32(val)
    valid = parsed & validity
    return (torch.where(valid, val, torch.zeros((), dtype=val.dtype,
                                                 device=val.device)),
            valid, ~parsed & validity)


def _civil_ok(y, mo, d):
    """(epoch days, the date is a real one): days_from_civil and back
    (ops/datetimeops.py)."""
    mm = mo
    yy = y - (mm <= 2).to(torch.int64)
    era = torch.div(yy, 400, rounding_mode="floor")
    yoe = yy - era * 400
    mp = torch.where(mm > 2, mm - 3, mm + 9)
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + d - 1
    doe = yoe * 365 + torch.div(yoe, 4, rounding_mode="floor") - \
        torch.div(yoe, 100, rounding_mode="floor") + doy
    days = era * 146097 + doe - 719468
    ry, rm, rd = FMT._civil_from_days(days)
    return days, (ry == y) & (rm == mo) & (rd == d)


def _parse_ts_rows(ch, lens, maxw: int):
    """(micros int64, parsed) of trimmed windows (reference :173-259)."""
    dev = ch.device
    n = ch.shape[0]
    digits = ch - _ZERO
    isdig = (digits >= 0) & (digits <= 9)
    date_ok = lens >= 10
    for i in (0, 1, 2, 3, 5, 6, 8, 9):
        date_ok = date_ok & isdig[:, i]
    date_ok = date_ok & (ch[:, 4] == _MINUS) & (ch[:, 7] == _MINUS)
    y = digits[:, 0] * 1000 + digits[:, 1] * 100 + digits[:, 2] * 10 + \
        digits[:, 3]
    mo = digits[:, 5] * 10 + digits[:, 6]
    d = digits[:, 8] * 10 + digits[:, 9]
    days, civil = _civil_ok(y, mo, d)
    date_ok = date_ok & civil

    date_only = date_ok & (lens == 10)
    has_time = date_ok & (lens >= 19)
    time_ok = has_time
    for i in (11, 12, 14, 15, 17, 18):
        time_ok = time_ok & isdig[:, i]
    sep = ch[:, 10]
    time_ok = time_ok & ((sep == 0x20) | (sep == 0x54))
    time_ok = time_ok & (ch[:, 13] == 0x3A) & (ch[:, 16] == 0x3A)
    hh = digits[:, 11] * 10 + digits[:, 12]
    mi = digits[:, 14] * 10 + digits[:, 15]
    ss = digits[:, 17] * 10 + digits[:, 18]
    time_ok = time_ok & (hh < 24) & (mi < 60) & (ss < 60)

    has_dot = time_ok & (lens > 19) & (ch[:, 19] == _DOT)
    fd = torch.zeros(n, dtype=torch.int64, device=dev)
    going = has_dot
    frac = torch.zeros(n, dtype=torch.int64, device=dev)
    for i in range(6):
        p = 20 + i
        going = going & (p < lens) & isdig[:, p]
        fd = fd + going.to(torch.int64)
        frac = torch.where(going, frac * 10 + digits[:, p], frac)
    frac_ok = ~has_dot | (fd >= 1)
    frac = frac * FMT._table("p10i", dev)[(6 - fd).clamp(0, 6)]

    zstart = torch.where(has_dot, 20 + fd, 19)
    zlen = torch.where(has_time, lens - zstart, 0)

    def at(k):
        pos = (zstart + k).clamp(0, maxw - 1)
        v = torch.gather(ch, 1, pos[:, None])[:, 0]
        return torch.where(zstart + k < lens, v, 0)

    def dg(k):
        return at(k) - _ZERO

    def isd(k):
        v = dg(k)
        return (v >= 0) & (v <= 9)

    sign_ch = at(0)
    zsigned = (sign_ch == _PLUS) | (sign_ch == _MINUS)
    z_utc = (zlen == 1) & (at(0) == 0x5A)
    z_off = (zlen == 6) & zsigned & isd(1) & isd(2) & (at(3) == 0x3A) & \
        isd(4) & isd(5)
    zh = dg(1) * 10 + dg(2)
    zm = dg(4) * 10 + dg(5)
    z_off = z_off & (zh < 24) & (zm < 60)
    off_min = torch.where(z_off, zh * 60 + zm, 0)
    off_min = torch.where(z_off & (sign_ch == _MINUS), -off_min, off_min)
    zone_ok = (zlen == 0) | z_utc | z_off

    full_ok = time_ok & frac_ok & zone_ok
    parsed = (date_only | full_ok) & (lens > 0)
    micros = days * 86_400_000_000 + torch.where(
        full_ok, (hh * 3600 + mi * 60 + ss) * 1_000_000 + frac
        - off_min * 60_000_000, 0)
    return torch.where(parsed, micros, 0), parsed


def parse_timestamp_plain(offsets, data, validity):
    """(micros int64 [cap], validity, malformed) of each row parsed as a
    timestamp; invalid lanes hold 0 (reference :283)."""
    val, parsed = _by_chunks(offsets, data, MAXW_TS, _parse_ts_rows,
                             torch.int64)
    valid = parsed & validity
    return torch.where(valid, val, 0), valid, ~parsed & validity


# ---------------------------------------------------------------------------
# K43 / K44 wrappers
# ---------------------------------------------------------------------------
def _launch(entry: str, offsets, data, validity, out, *extra):
    offsets = offsets.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(offsets, data, validity)
    cap = int(validity.shape[0])
    dev = validity.device
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    malformed = torch.empty(cap, dtype=torch.bool, device=dev)
    lib = CB.library("cast_parse")
    rc = getattr(lib, f"srt_{entry}")(
        offsets.data_ptr(), data.data_ptr(), int(data.shape[0]),
        validity.data_ptr(), cap, *extra, out.data_ptr(), valid.data_ptr(),
        malformed.data_ptr(), CB.stream_of(out))
    CB.count_launch(entry)
    CB.check(lib, rc, entry)
    return out, valid, malformed


def parse_float(offsets, data, validity, to32: bool = False):
    """K43 (csrc/cast_parse.cu): `parse_float_plain`'s (value, validity,
    malformed), a thread a row walking its bytes once; the value scaled
    through the same power table. CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if validity.device.type == "cpu":
        return parse_float_plain(offsets, data, validity, to32)
    cap = int(validity.shape[0])
    dev = validity.device
    out = torch.empty(cap, dtype=torch.float32 if to32 else torch.float64,
                      device=dev)
    return _launch("parse_float", offsets, data, validity, out,
                   FMT._table("p10f", dev).data_ptr(), 1 if to32 else 0)


def parse_timestamp(offsets, data, validity):
    """K44 (csrc/cast_parse.cu): `parse_timestamp_plain`'s (micros,
    validity, malformed), a thread a row. CPU tensors run the plain
    version, CUDA tensors the kernel."""
    if validity.device.type == "cpu":
        return parse_timestamp_plain(offsets, data, validity)
    out = torch.empty(int(validity.shape[0]), dtype=torch.int64,
                      device=validity.device)
    return _launch("parse_timestamp", offsets, data, validity, out)


def parse_float_col(v: ColV, to: DataType):
    """STRING -> FLOAT32 / FLOAT64 on the device (conf castStringToFloat):
    (column, malformed)."""
    val, valid, malformed = parse_float(v.offsets, v.data, v.validity,
                                        to is DataType.FLOAT32)
    return ColV(to, val, valid), malformed


def parse_timestamp_col(v: ColV):
    """STRING -> TIMESTAMP on the device (conf castStringToTimestamp):
    (column, malformed)."""
    val, valid, malformed = parse_timestamp(v.offsets, v.data, v.validity)
    return ColV(DataType.TIMESTAMP, val, valid), malformed
