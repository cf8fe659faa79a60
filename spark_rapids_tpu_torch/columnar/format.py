"""Number, date and timestamp formatting: casts to STRING (port of
spark_rapids_tpu/columnar/format.py, B16's formatting half).

- The numeric core, `f64_scale` (:36), `f64_scale_int` (:51), `_two_prod`
  (:103), `_fast_two_sum` (:119) and `shortest_float_decomposition`
  (:126), is written once, over torch tensors. The plain versions run it
  on the tensors they are given, and the CPU engine (ops/cast.py:
  `format_float_array`, `_parse_float_text`) runs it on CPU tensors made
  from its numpy arrays, so both engines use one definition of the
  arithmetic. Every step is one rounded torch operation: nothing is
  contracted into an FMA.
- `_P10F` is built with `np.power`, as the reference builds it (:28-32):
  numpy's and torch's powers of ten differ from each other and from the
  correctly rounded ones in a few dozen entries, and the convention is
  defined by this table. The kernels read the same array, uploaded once a
  device.
- K41 `format_fixed` (csrc/cast_format.cu) replaces `int_to_string`
  (:395), `_bool_to_string` (:427), `date_to_string` (:532) and
  `timestamp_to_string` (:476, with `_year_field` :452); K42
  `format_float` replaces `float_to_string` (:284). A wrapper given CPU
  tensors runs the plain version, given CUDA tensors launches its kernel
  or raises.

Outputs are sized by static bounds, as in the reference (20, 5, 14, 30
and 26 bytes a lane): no total is read back. Every output's max_len is
the bucket of its widest text, since the sort and hash words read
max_len bytes of each row.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.values import ColV

# f64 powers of ten shared by the float <-> string casts (reference :28-33)
_P10F_OFF = 343
with np.errstate(over="ignore"):
    _P10F = np.power(10.0, np.arange(-_P10F_OFF, _P10F_OFF + 1))
_P10I = np.array([10 ** k for k in range(19)], dtype=np.int64)

# widest text of each mode: a sign and 19 digits; 'false'; a sign, 7 year
# digits and '-MM-DD'; the 8-wide year and '-MM-DD HH:MM:SS.ffffff';
# a float (reference :281)
INT_W, BOOL_W, DATE_W, TS_W, FLT_W = 20, 5, 14, 30, 26
_YEAR_W = 8
_FIXED_MODES = {"int": 0, "bool": 1, "date": 2, "timestamp": 3}
_ROWS_PER_CHUNK = 1 << 20
_TABLES: Dict[tuple, torch.Tensor] = {}


def _table(name: str, dev) -> torch.Tensor:
    """`_P10F` or `_P10I` on a device, uploaded once."""
    key = (name, str(dev))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy({"p10f": _P10F, "p10i": _P10I}[name]).to(dev)
        _TABLES[key] = t
    return t


def _pidx(k):
    return (k + _P10F_OFF).clamp(0, 2 * _P10F_OFF)


# ---------------------------------------------------------------------------
# the numeric core (reference :36-273), on torch tensors
# ---------------------------------------------------------------------------
def f64_scale(x, k):
    """x * 10^k: one table multiply for |k| <= 22, two halved multiplies
    beyond (reference :36)."""
    P = _table("p10f", x.device)
    k1 = torch.div(k, 2, rounding_mode="floor")
    k2 = k - k1
    two = x * P[_pidx(k1)] * P[_pidx(k2)]
    one = x * P[_pidx(k)]
    return torch.where((k >= -22) & (k <= 22), one, two)


def _two_prod(a, c):
    """Dekker's error-free product (reference :103): a * c == p1 + err."""
    p1 = a * c
    split = 134217729.0  # 2^27 + 1
    ah = a * split
    ah = ah - (ah - a)
    al = a - ah
    ch = c * split
    ch = ch - (ch - c)
    cl = c - ch
    err = ((ah * ch - p1) + ah * cl + al * ch) + al * cl
    return p1, err


def _fast_two_sum(h, l):
    """A renormalised pair (reference :119): s + e == h + l exactly."""
    s = h + l
    return s, l - (s - h)


def _chunk_step(P, h, l, rem):
    """One chunk of the pair scaling: (h, l) times 10^step, step = rem
    clipped to [-22, 22], by an error-free multiply or divide."""
    step = rem.clamp(-22, 22)
    cm = P[_pidx(step)]
    cd = P[_pidx(-step)]
    mp1, mperr = _two_prod(h, cm)
    mh, ml = _fast_two_sum(mp1, mperr + l * cm)
    q1 = h / cd
    pp1, pperr = _two_prod(q1, cd)
    qerr = (((h - pp1) - pperr) + l) / cd
    dh, dl = _fast_two_sum(q1, qerr)
    pos = step >= 0
    return torch.where(pos, mh, dh), torch.where(pos, ml, dl), rem - step


def f64_scale_int(m, k):
    """m * 10^k (int64 m, |m| < 10^18; int64 k) with one final rounding
    (reference :51): m split into two exact halves, the pair scaled in
    19 chunks of at most 10^22 through error-free transforms behind an
    exact 2^+-600 prescale, then collapsed; a lane whose chain overflows
    takes `f64_scale`, which gives the same infinity."""
    mq = torch.div(m, 10 ** 8, rounding_mode="floor")
    hi = mq.to(torch.float64)
    lo = (m - mq * (10 ** 8)).to(torch.float64)
    p1, e1 = _two_prod(hi, 1e8)
    h, l = _fast_two_sum(p1, e1 + lo)
    one = torch.ones((), dtype=torch.float64, device=m.device)
    s2 = torch.where(k < -250, one * 2.0 ** 600,
                     torch.where(k > 250, one * 2.0 ** -600, one))
    h = h * s2
    l = l * s2
    P = _table("p10f", m.device)
    rem = k.to(torch.int64)
    for _ in range(19):
        h, l, rem = _chunk_step(P, h, l, rem)
    h = h / s2
    l = l / s2
    out = h + l
    return torch.where(torch.isnan(out), f64_scale(m.to(torch.float64), k),
                       out)


def shortest_float_decomposition(a, maxp: int, is32: bool = False):
    """(m, p, e10) int64 of each positive finite f64 lane of `a`: the
    smallest p <= maxp whose p-digit rounding parses back to the source
    (an f32 source's granularity when is32), value ~= m * 10^(e10 - p +
    1); lanes where none does keep p = maxp (reference :126). The value is
    normalised into [1, 10) as an error-free pair, then each candidate is
    tested by the exact half-gap condition."""
    i64 = torch.int64
    dev = a.device
    P = _table("p10f", dev)
    P10I = _table("p10i", dev)
    bits = a.view(i64)  # positive lanes: the sign bit is 0
    sub = ((bits >> 52) & 0x7FF) == 0
    a_est = torch.where(sub, a * P[280 + _P10F_OFF], a)
    e2 = ((a_est.view(i64) >> 52) & 0x7FF) - 1023
    e10 = (e2 * 315653) >> 20
    e10 = e10 + (a_est >= P[_pidx(e10 + 1)]).to(i64)
    e10 = e10 - (a_est < P[_pidx(e10)]).to(i64)
    e10 = e10 - torch.where(sub, 280, 0)

    e2a = (bits >> 52) - 1023
    if is32:
        ulp_exp = torch.clamp(e2a, min=-126) - 23 + 1023
        mant_mask = ((1 << 52) - 1) - ((1 << 29) - 1)
        min_e2 = -126
    else:
        ulp_exp = e2a - 52 + 1023
        mant_mask = (1 << 52) - 1
        min_e2 = -1022
    tiny = torch.full((), 5e-324, dtype=torch.float64, device=dev)
    ulp = torch.where(ulp_exp > 0, (ulp_exp << 52).view(torch.float64), tiny)
    rel_ulp = ulp / a
    pow2 = ((bits & mant_mask) == 0) & (e2a > min_e2)

    one = torch.ones((), dtype=torch.float64, device=dev)
    s2 = torch.where(a < 1e-100, one * 2.0 ** 600, one)
    h = a * s2
    l = torch.zeros(a.shape, dtype=torch.float64, device=dev)
    rem = -e10
    for _ in range(15 if maxp > 9 else 4):
        h, l, rem = _chunk_step(P, h, l, rem)
    h = h / s2
    l = l / s2
    over = h >= 10.0
    q1 = h / 10.0
    pp1, pperr = _two_prod(q1, 10.0)
    qerr = (((h - pp1) - pperr) + l) / 10.0
    oh, ol = _fast_two_sum(q1, qerr)
    h = torch.where(over, oh, h)
    l = torch.where(over, ol, l)
    e10 = e10 + over.to(i64)
    under = h < 1.0
    mp1, mperr = _two_prod(h, 10.0)
    uh, ul = _fast_two_sum(mp1, mperr + l * 10.0)
    h = torch.where(under, uh, h)
    l = torch.where(under, ul, l)
    e10 = e10 - under.to(i64)

    m_out = torch.zeros(a.shape, dtype=i64, device=dev)
    p_out = torch.full(a.shape, maxp, dtype=i64, device=dev)
    e_out = e10
    done = torch.zeros(a.shape, dtype=torch.bool, device=dev)
    guard = 1.0 - 2.0 ** -40
    for p in range(1, maxp + 1):
        c = float(_P10F[(p - 1) + _P10F_OFF])
        w1, werr = _two_prod(h, c)
        tail = werr + l * c
        base = torch.round(w1)  # half to even, as rint
        delta = (w1 - base) + tail
        adj = torch.round(delta)
        m = base.to(i64) + adj.to(i64)
        resid = delta - adj
        half_gap = rel_ulp * (base + delta) * 0.5 * guard
        down_gap = torch.where(pow2, half_gap * 0.5, half_gap)
        carry = m >= P10I[p]
        resid_c = (base - float(_P10F[p + _P10F_OFF])) + delta
        rsel = torch.where(carry, resid_c, resid)
        ok = torch.where(rsel > 0, rsel < down_gap, -rsel < half_gap)
        m = torch.where(carry, P10I[p - 1], m)
        e_cand = e10 + carry.to(i64)
        if p == maxp:
            ok = torch.ones(a.shape, dtype=torch.bool, device=dev)
        sel = ok & ~done
        m_out = torch.where(sel, m, m_out)
        p_out = torch.where(sel, p, p_out)
        e_out = torch.where(sel, e_cand, e_out)
        done = done | ok
    return m_out, p_out, e_out


# ---------------------------------------------------------------------------
# plain versions: a per-row template packed under scanned offsets
# ---------------------------------------------------------------------------
def _offsets_of(lens):
    offsets = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                          device=lens.device)
    offsets[1:] = torch.cumsum(lens, 0)
    return offsets


def _pack(template_of, lens, byte_cap: int):
    """(offsets int32 [cap + 1], bytes [byte_cap]) of rows whose text is
    `template_of(r0, r1)` -> (uint8 [r1 - r0, W], start int64 [r1 - r0]):
    row i's bytes are its template row from `start`, `lens[i]` long.
    Bytes past the total are 0. Rows go 2^20 at a time."""
    cap = int(lens.shape[0])
    dev = lens.device
    offsets = _offsets_of(lens)
    out = torch.zeros(max(byte_cap, 1), dtype=torch.uint8, device=dev)
    for r0 in range(0, cap, _ROWS_PER_CHUNK):
        r1 = min(cap, r0 + _ROWS_PER_CHUNK)
        tmpl, start = template_of(r0, r1)
        w = int(tmpl.shape[1])
        k = torch.arange(w, device=dev)
        ln = lens[r0:r1]
        take = k[None, :] < ln[:, None]
        src = (start[:, None] + k[None, :]).clamp(0, w - 1)
        vals = torch.gather(tmpl, 1, src)
        pos = offsets[r0:r1, None] + k[None, :]
        out[pos[take]] = vals[take]
    return offsets.to(torch.int32), out[:byte_cap] if byte_cap else out[:0]


def _digit(x, p: int):
    """ASCII digit of x at 10^p (x >= 0)."""
    return (torch.div(x, p, rounding_mode="floor") % 10 + ord("0"))


def _int_template(x, neg, nd):
    """[n, 20] left-aligned decimal text of int64 x (sign, nd digits),
    built on the non-positive value so int64 min needs no unsigned
    absolute value."""
    dev = x.device
    nx = torch.where(neg, x, -x)
    cols = []
    for t in range(INT_W):
        q = t - neg.to(torch.int64)           # digit index from the left
        e = (nd - 1 - q).clamp(0, 18)         # its power of ten
        p10 = _table("p10i", dev)[e]
        d = -torch.fmod(torch.div(nx, p10, rounding_mode="trunc"), 10)
        ch = torch.where((t == 0) & neg, ord("-"), d + ord("0"))
        cols.append(ch)
    return torch.stack(cols, 1).to(torch.uint8)


def _int_digits(x):
    """(neg, number of digits) of int64 x."""
    neg = x < 0
    nx = torch.where(neg, x, -x)
    nd = torch.ones(x.shape, dtype=torch.int64, device=x.device)
    for k in range(1, 19):
        nd = nd + (nx <= -(10 ** k)).to(torch.int64)
    return neg, nd


def int_to_string_plain(x, validity):
    """(offsets, bytes [20 cap]) of int8-int64 `x` as decimal text (the
    reference's `int_to_string` :395); NULL rows are empty."""
    x = x.to(torch.int64)
    neg, nd = _int_digits(x)
    lens = torch.where(validity, nd + neg.to(torch.int64), 0)

    def tmpl(r0, r1):
        return (_int_template(x[r0:r1], neg[r0:r1], nd[r0:r1]),
                torch.zeros(r1 - r0, dtype=torch.int64, device=x.device))

    return _pack(tmpl, lens, INT_W * int(x.shape[0]))


def bool_to_string_plain(b, validity):
    """(offsets, bytes [5 cap]) of 'true' / 'false' (reference :427)."""
    b = b.to(torch.bool)
    lens = torch.where(validity, torch.where(b, 4, 5), 0).to(torch.int64)
    words = torch.tensor([list(b"false"), list(b"true\0")],
                         dtype=torch.uint8, device=b.device)

    def tmpl(r0, r1):
        return (words[b[r0:r1].to(torch.int64)],
                torch.zeros(r1 - r0, dtype=torch.int64, device=b.device))

    return _pack(tmpl, lens, BOOL_W * int(b.shape[0]))


def _civil_from_days(z):
    """Epoch days -> (year, month, day) int64 (ops/datetimeops.py)."""
    z = z + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor")
                    + torch.div(doe, 36524, rounding_mode="floor")
                    - torch.div(doe, 146096, rounding_mode="floor"), 365,
                    rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(torch.int64), m, d


def _year_field(y):
    """(8 right-aligned year chars [n, 8], year length): 4 zero-padded
    digits inside [0, 9999], a sign and at least 4 digits outside
    (reference :452)."""
    ay = y.abs()
    nd = torch.full(y.shape, 4, dtype=torch.int64, device=y.device)
    for p in (10_000, 100_000, 1_000_000, 10_000_000):
        nd = nd + (ay >= p).to(torch.int64)
    signed = (y < 0) | (y > 9999)
    sign_ch = torch.where(y < 0, ord("-"), ord("+"))
    cols = []
    for j in range(_YEAR_W):
        k = _YEAR_W - 1 - j  # digit index from the right
        cols.append(torch.where(signed & (k == nd), sign_ch,
                                torch.where(k < nd, _digit(ay, 10 ** k), 0)))
    return cols, nd + signed.to(torch.int64)


def _full(n, ch, dev):
    return torch.full((n,), ord(ch), dtype=torch.int64, device=dev)


def date_to_string_plain(days, validity):
    """(offsets, bytes [14 cap]) of int32 epoch days as 'YYYY-MM-DD', a
    signed year outside [0, 9999] (reference :532)."""
    days = days.to(torch.int64)
    dev = days.device
    y, m, d = _civil_from_days(days)
    _, ylen = _year_field(y)
    lens = torch.where(validity, ylen + 6, 0)

    def tmpl(r0, r1):
        cols, yl = _year_field(y[r0:r1])
        n = r1 - r0
        mm, dd = m[r0:r1], d[r0:r1]
        t = torch.stack(cols + [_full(n, "-", dev), _digit(mm, 10),
                                _digit(mm, 1), _full(n, "-", dev),
                                _digit(dd, 10), _digit(dd, 1)], 1)
        return t.to(torch.uint8), _YEAR_W - yl

    return _pack(tmpl, lens, DATE_W * int(days.shape[0]))


def timestamp_to_string_plain(us, validity):
    """(offsets, bytes [30 cap]) of int64 epoch microseconds as
    'YYYY-MM-DD HH:MM:SS[.f...]', the fraction's trailing zeros stripped,
    negative times floored (reference :476)."""
    us = us.to(torch.int64)
    dev = us.device
    DAY = 86_400_000_000
    days = torch.div(us, DAY, rounding_mode="floor")
    rem = us - days * DAY
    y, m, d = _civil_from_days(days)
    secs = torch.div(rem, 1_000_000, rounding_mode="floor")
    frac = rem % 1_000_000
    tz = torch.zeros(us.shape, dtype=torch.int64, device=dev)
    for k in (10, 100, 1000, 10_000, 100_000):
        tz = tz + ((frac % k) == 0).to(torch.int64)
    fdigits = torch.where(frac == 0, 0, 6 - tz)
    _, ylen = _year_field(y)
    out_len = ylen + 15 + torch.where(frac == 0, 0, 1 + fdigits)
    lens = torch.where(validity, out_len, 0)

    def tmpl(r0, r1):
        cols, yl = _year_field(y[r0:r1])
        n = r1 - r0
        mm, dd = m[r0:r1], d[r0:r1]
        s, f = secs[r0:r1], frac[r0:r1]
        hh = torch.div(s, 3600, rounding_mode="floor")
        mi = torch.div(s, 60, rounding_mode="floor") % 60
        ss = s % 60
        t = torch.stack(cols + [
            _full(n, "-", dev), _digit(mm, 10), _digit(mm, 1),
            _full(n, "-", dev), _digit(dd, 10), _digit(dd, 1),
            _full(n, " ", dev), _digit(hh, 10), _digit(hh, 1),
            _full(n, ":", dev), _digit(mi, 10), _digit(mi, 1),
            _full(n, ":", dev), _digit(ss, 10), _digit(ss, 1),
            _full(n, ".", dev)] + [_digit(f, 10 ** k)
                                   for k in range(5, -1, -1)], 1)
        return t.to(torch.uint8), _YEAR_W - yl

    return _pack(tmpl, lens, TS_W * int(us.shape[0]))


_SPECIALS = [b"NaN", b"Infinity", b"-Infinity", b"0.0", b"-0.0"]


def _float_parts(x):
    """(a, neg, kind) of an f32 / f64 tensor: a = |x| as f64 (an f32
    subnormal rebuilt from its bits, reference :301-310), kind 0 finite
    nonzero, 1 NaN, 2 Inf, 3 zero."""
    f64 = x.to(torch.float64)
    a = f64.abs()
    if x.dtype == torch.float32:
        bits32 = x.view(torch.int32)
        mant = (bits32 & 0x7FFFFF).to(torch.float64)
        is_sub = (((bits32 >> 23) & 0xFF) == 0) & (mant > 0)
        a = torch.where(is_sub, mant * (2.0 ** -149), a)
        neg = bits32 < 0
    else:
        neg = torch.signbit(f64)
    kind = torch.where(torch.isnan(f64), 1, torch.where(
        torch.isinf(f64), 2, torch.where(a == 0.0, 3, 0)))
    return a, neg, kind


def float_layout(m, p, e10, neg):
    """Java placement of (m, p, e10): plain for -3 <= e10 < 7, else
    'd.dddE[-]ee' (reference :325-333). Returns (sci, ilen, sd, elen,
    length) of each lane."""
    negi = neg.to(torch.int64)
    sci = (e10 < -3) | (e10 >= 7)
    ilen = torch.where(e10 >= 0, e10 + 1, 1)
    flen = torch.where(e10 >= 0, torch.clamp(p - 1 - e10, min=1),
                       p - e10 - 1)
    len_plain = negi + ilen + 1 + flen
    ae = e10.abs()
    elen = 1 + (ae >= 10).to(torch.int64) + (ae >= 100).to(torch.int64)
    sd = torch.clamp(p - 1, min=1)
    len_sci = negi + 2 + sd + 1 + (e10 < 0).to(torch.int64) + elen
    return sci, ilen, sd, elen, torch.where(sci, len_sci, len_plain)


def _float_template(m, p, e, neg, kind):
    """[n, 26] text of finite lanes (reference :335-372), specials
    left-aligned in their rows."""
    dev = m.device
    P10I = _table("p10i", dev)
    sci, ilen, sd, elen, _ = float_layout(m, p, e, neg)
    negi = neg.to(torch.int64)
    t = torch.arange(FLT_W, device=dev)[None, :] - negi[:, None]
    mC, pC, eC = m[:, None], p[:, None], e[:, None]

    def digit_at(q):
        shift = (pC - 1 - q).clamp(0, 18)
        d = torch.div(mC, P10I[shift], rounding_mode="floor") % 10
        return torch.where((q >= 0) & (q < pC), ord("0") + d, ord("0"))

    ilenC = ilen[:, None]
    u = t - ilenC - 1
    q_int = torch.where(eC >= 0, t, -1)
    q_plain = torch.where(t < ilenC, q_int, u + eC + 1)
    ch_plain = torch.where(t == ilenC, ord("."), digit_at(q_plain))
    epos = 2 + sd[:, None]
    ch_sd = digit_at(torch.where(pC == 1, 99, t - 1))
    vv = t - epos - 1 - (eC < 0).to(torch.int64)
    esh = (elen[:, None] - 1 - vv).clamp(0, 18)
    ch_e = ord("0") + torch.div(eC.abs(), P10I[esh],
                                rounding_mode="floor") % 10
    ch_sci = torch.where(
        t == 0, digit_at(torch.zeros_like(t)),
        torch.where(t == 1, ord("."),
                    torch.where(t < epos, ch_sd,
                                torch.where(t == epos, ord("E"),
                                            torch.where((t == epos + 1) &
                                                        (eC < 0), ord("-"),
                                                        ch_e)))))
    chm = torch.where(sci[:, None], ch_sci, ch_plain)
    chm = torch.where(t < 0, ord("-"), chm).to(torch.uint8)
    sp = torch.zeros(len(_SPECIALS), FLT_W, dtype=torch.uint8, device=dev)
    for i, s in enumerate(_SPECIALS):
        sp[i, :len(s)] = torch.tensor(list(s), dtype=torch.uint8)
    which = torch.where(kind == 1, 0, torch.where(
        kind == 2, torch.where(neg, 2, 1), torch.where(neg, 4, 3)))
    return torch.where((kind != 0)[:, None], sp[which], chm)


def _special_len(kind, neg):
    lens = torch.tensor([len(s) for s in _SPECIALS], dtype=torch.int64,
                        device=kind.device)
    return lens[torch.where(kind == 1, 0, torch.where(
        kind == 2, torch.where(neg, 2, 1), torch.where(neg, 4, 3)))]


def float_decompose(x):
    """(m, p, e10, neg, kind) of an f32 / f64 tensor: the shared core over
    its finite nonzero lanes (1.0 elsewhere)."""
    a, neg, kind = _float_parts(x)
    is32 = x.dtype == torch.float32
    m, p, e10 = shortest_float_decomposition(
        torch.where(kind == 0, a, torch.ones_like(a)), 9 if is32 else 17,
        is32=is32)
    return m, p, e10, neg, kind


def float_to_string_plain(x, validity):
    """(offsets, bytes [26 cap]) of f32 / f64 `x` as the shortest decimal
    that parses back, Java's notation, 'NaN', '[-]Infinity', '[-]0.0'
    (reference :284)."""
    m, p, e10, neg, kind = float_decompose(x)
    _, _, _, _, length = float_layout(m, p, e10, neg)
    lens = torch.where(validity, torch.where(kind == 0, length,
                                             _special_len(kind, neg)), 0)

    def tmpl(r0, r1):
        return (_float_template(m[r0:r1], p[r0:r1], e10[r0:r1],
                                neg[r0:r1], kind[r0:r1]),
                torch.zeros(r1 - r0, dtype=torch.int64, device=x.device))

    return _pack(tmpl, lens, FLT_W * int(x.shape[0]))


# ---------------------------------------------------------------------------
# K41 / K42 wrappers
# ---------------------------------------------------------------------------
def _check_cap(cap: int, width: int) -> None:
    if width * cap >= (1 << 31):
        raise ValueError("the text of this many lanes may pass 2 GiB")


def format_fixed(x, validity, mode: str):
    """K41 (csrc/cast_format.cu): `mode` 'int' (int8-int64), 'bool',
    'date' (int32 days) or 'timestamp' (int64 microseconds) as text: a
    length launch, a scan, a write launch a thread a row. CPU tensors run
    the plain versions, CUDA tensors the kernel."""
    plain = {"int": int_to_string_plain, "bool": bool_to_string_plain,
             "date": date_to_string_plain,
             "timestamp": timestamp_to_string_plain}[mode]
    if validity.device.type == "cpu":
        return plain(x, validity)
    x = x.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(x, validity)
    cap = int(validity.shape[0])
    width = {"int": INT_W, "bool": BOOL_W, "date": DATE_W,
             "timestamp": TS_W}[mode]
    _check_cap(cap, width)
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    lib = CB.library("cast_format")
    scratch = torch.empty(int(lib.srt_cast_format_scratch_bytes(cap)),
                          dtype=torch.uint8, device=x.device)
    offsets = torch.empty(cap + 1, dtype=torch.int32, device=x.device)
    out = torch.empty(max(width * cap, 8), dtype=torch.uint8,
                      device=x.device)
    rc = lib.srt_format_fixed(_FIXED_MODES[mode], x.data_ptr(),
                              x.element_size(), validity.data_ptr(), cap,
                              offsets.data_ptr(), out.data_ptr(), out.numel(),
                              scratch.data_ptr(), scratch.numel(),
                              CB.stream_of(out))
    CB.count_launch("format_fixed")
    CB.check(lib, rc, "format_fixed")
    return offsets, out


def format_float(x, validity):
    """K42 (csrc/cast_format.cu): f32 / f64 as `float_to_string_plain`'s
    text: a plan launch (the decomposition, a thread a row, stopping at
    the first precision that parses back; m, p, e10 and the length to
    scratch), a scan, a write launch. CPU tensors run the plain version,
    CUDA tensors the kernel."""
    if validity.device.type == "cpu":
        return float_to_string_plain(x, validity)
    x = x.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(x, validity)
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError("format_float takes float32 or float64")
    cap = int(validity.shape[0])
    _check_cap(cap, FLT_W)
    dev = x.device
    lib = CB.library("cast_format")
    scratch = torch.empty(int(lib.srt_cast_format_scratch_bytes(cap)),
                          dtype=torch.uint8, device=dev)
    offsets = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    out = torch.empty(max(FLT_W * cap, 8), dtype=torch.uint8, device=dev)
    rc = lib.srt_format_float(x.data_ptr(), 1 if x.dtype == torch.float32
                              else 0, validity.data_ptr(), cap,
                              _table("p10f", dev).data_ptr(),
                              offsets.data_ptr(), out.data_ptr(), out.numel(),
                              scratch.data_ptr(), scratch.numel(),
                              CB.stream_of(out))
    CB.count_launch("format_float")
    CB.check(lib, rc, "format_float")
    return offsets, out


# ---------------------------------------------------------------------------
# the device engine's casts to STRING (reference :284-556)
# ---------------------------------------------------------------------------
def _string_col(offsets, data, validity, width: int) -> ColV:
    from spark_rapids_tpu_torch.columnar.strings import len_bucket

    return ColV(DataType.STRING, data, validity, offsets, len_bucket(width))


def int_to_string(v: ColV) -> ColV:
    """Integers as decimal text, BOOL as 'true' / 'false' (reference
    :395, :427)."""
    if v.dtype is DataType.BOOL:
        offs, data = format_fixed(v.data, v.validity, "bool")
        return _string_col(offs, data, v.validity, BOOL_W)
    offs, data = format_fixed(v.data, v.validity, "int")
    return _string_col(offs, data, v.validity, INT_W)


def date_to_string(v: ColV) -> ColV:
    offs, data = format_fixed(v.data, v.validity, "date")
    return _string_col(offs, data, v.validity, DATE_W)


def timestamp_to_string(v: ColV) -> ColV:
    offs, data = format_fixed(v.data, v.validity, "timestamp")
    return _string_col(offs, data, v.validity, TS_W)


def float_to_string(v: ColV) -> ColV:
    """Gated by rapids.tpu.sql.castFloatToString.enabled (reference
    :284)."""
    offs, data = format_float(v.data, v.validity)
    return _string_col(offs, data, v.validity, FLT_W)
