"""Cast (port of spark_rapids_tpu/ops/cast.py; reference: GpuCast.scala,
with the per-direction gates of RapidsConf.scala:393-425).

Datetime: TIMESTAMP -> LONG is epoch seconds and TIMESTAMP -> DATE epoch
days, both floored (a tensor's and an array's `//` both floor, so times
before 1970 agree); DATE -> TIMESTAMP and LONG -> TIMESTAMP scale up.
Decimal: int64 unscaled math with overflow to NULL; DECIMAL -> DOUBLE is
one int64 -> double conversion then a division by 10**scale, the
reference's order, so the doubles are bit-equal. DOUBLE -> DECIMAL needs
the double's shortest decimal repr and stays on the CPU engine, as in the
reference.

Strings (B16; reference `_to_string` :221, `_to_string_host` :240,
`_from_string` :261, helpers :325-516). On the device: integers, BOOL,
DATE and TIMESTAMP to text through K41, FLOAT / DOUBLE through K42
(columnar/format.py); text to FLOAT / DOUBLE through K43 and to
TIMESTAMP through K44 (columnar/parse.py). The plan rewrite admits the
float and the parse directions only under their conf keys, and keeps
ANSI parses and the directions without a kernel (text to integers,
BOOL, DATE, DECIMAL; DECIMAL to text) on the CPU engine. The CPU engine
formats and parses as the reference's host loop does, each distinct
value once, and runs the one numeric core of columnar/format.py on CPU
tensors for the float digits and values, so both engines give the same
bytes and bits.
A malformed row is NULL; under ANSI the CPU engine raises on it.
"""

from __future__ import annotations

import datetime
import re

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import (
    DataType,
    is_decimal,
    to_torch,
)
from spark_rapids_tpu_torch.ops import decimal_util as DU
from spark_rapids_tpu_torch.ops.base import UnaryExpression
from spark_rapids_tpu_torch.ops.values import ColV

MICROS_PER_SEC = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SEC

_NUMERIC = {DataType.BOOL, DataType.INT8, DataType.INT16, DataType.INT32,
            DataType.INT64, DataType.FLOAT32, DataType.FLOAT64}


def _astype(data, dt):
    if isinstance(data, torch.Tensor):
        want = to_torch(dt)
        return data if data.dtype == want else data.to(want)
    npdt = dt.to_np()
    return data if data.dtype == npdt else data.astype(npdt)


class Cast(UnaryExpression):
    def __init__(self, child, to_type: DataType, ansi: bool = False):
        super().__init__(child)
        self.to_type = to_type
        self.ansi = ansi

    def with_children(self, new_children):
        return Cast(new_children[0], self.to_type, self.ansi)

    @property
    def data_type(self):
        return self.to_type

    @property
    def nullable(self):
        # a decimal cast can overflow to NULL, and a malformed string
        # parses to NULL
        frm, to = self.child.data_type, self.to_type
        if is_decimal(to) or (is_decimal(frm) and to.is_integral):
            return True
        if frm is DataType.STRING and to is not DataType.STRING:
            return True
        return super().nullable

    def _fingerprint_extra(self):
        return f"->{self.to_type.name};ansi={int(self.ansi)};"

    @staticmethod
    def device_supported(frm, to) -> bool:
        """The directions the device path computes without a conf gate
        (reference :61-90). FLOAT -> STRING, STRING -> FLOAT and STRING ->
        TIMESTAMP have kernels too, admitted by the plan rewrite under
        their conf keys (plan/overrides.py:_tag_cast)."""
        if frm == to:
            return True
        if is_decimal(frm):
            return is_decimal(to) or to in _NUMERIC
        if is_decimal(to):
            return frm in _NUMERIC and not frm.is_floating
        if frm in _NUMERIC and to in _NUMERIC:
            return True
        if frm is DataType.DATE and to in (DataType.TIMESTAMP,
                                           DataType.STRING, DataType.INT32):
            return True
        if frm is DataType.TIMESTAMP and to in (DataType.DATE,
                                                DataType.INT64,
                                                DataType.STRING):
            return True
        if frm in (DataType.BOOL, DataType.INT8, DataType.INT16,
                   DataType.INT32, DataType.INT64) and to is DataType.STRING:
            return True
        return frm is DataType.INT64 and to is DataType.TIMESTAMP

    def do_columnar(self, ctx, v):
        frm, to = self.child.data_type, self.to_type
        data = v.data
        if frm == to:
            return v if to is DataType.STRING else data
        if to is DataType.STRING:
            return self._to_string(ctx, v, frm)
        if frm is DataType.STRING:
            return self._from_string(ctx, v, to)
        if is_decimal(frm) or is_decimal(to):
            return self._decimal(ctx, v, frm, to)
        if frm is DataType.DATE and to is DataType.TIMESTAMP:
            return DU._i64(data) * MICROS_PER_DAY
        if frm is DataType.TIMESTAMP and to is DataType.DATE:
            return _astype(DU._i64(data) // MICROS_PER_DAY, DataType.DATE)
        if frm is DataType.TIMESTAMP and to is DataType.INT64:
            return DU._i64(data) // MICROS_PER_SEC
        if frm is DataType.INT64 and to is DataType.TIMESTAMP:
            return DU._i64(data) * MICROS_PER_SEC
        if frm is DataType.DATE and to is DataType.INT32:
            return _astype(data, DataType.INT32)
        if frm not in _NUMERIC or to not in _NUMERIC:
            raise NotImplementedError(f"cast {frm} -> {to} is not ported")
        dev = isinstance(data, torch.Tensor)
        if to is DataType.BOOL:
            return data != 0
        if frm.is_floating and to.is_integral:
            # spark truncates toward zero; NaN -> 0, out-of-range saturates
            # (non-ansi). Saturate by comparisons: float(int64.max) rounds up
            # to 2^63, and a plain convert of it would wrap.
            info = np.iinfo(to.to_np())
            if dev:
                clean = torch.where(torch.isnan(data),
                                    torch.zeros((), dtype=data.dtype,
                                                device=data.device), data)
                t = torch.trunc(clean)
                tdt = to_torch(to)
                hi = t >= float(info.max)
                lo = t <= float(info.min)
                zero = torch.zeros((), dtype=t.dtype, device=t.device)
                res = torch.where(hi | lo, zero, t).to(tdt)
                res = torch.where(hi, torch.full((), int(info.max), dtype=tdt,
                                                 device=t.device), res)
                return torch.where(lo, torch.full((), int(info.min),
                                                  dtype=tdt, device=t.device),
                                   res)
            clean = np.where(np.isnan(data), 0.0, data)
            t = np.trunc(clean)
            npdt = to.to_np()
            with np.errstate(invalid="ignore"):
                res = t.astype(npdt)
            res = np.where(t >= float(info.max), info.max, res)
            res = np.where(t <= float(info.min), info.min, res)
            return res.astype(npdt)
        return _astype(data, to)

    # -- decimal --------------------------------------------------------------
    def _decimal(self, ctx, v, frm, to):
        """Casts with a decimal end (reference :106-170); overflow is
        NULL, as in Spark's non-ANSI Decimal.changePrecision."""
        data = v.data
        if is_decimal(frm) and is_decimal(to):
            out, ok1 = DU.rescale(data, frm.scale, to.scale)
            out, ok2 = DU.fit_precision(out, to.precision)
            return self._dec_result(v, to, out, ok1 & ok2)
        if is_decimal(frm):
            if to is DataType.BOOL:
                return data != 0
            if to.is_floating:
                return _astype(DU.unscale_to_double(DU._i64(data),
                                                    frm.scale), to)
            # to an integer: truncate toward zero, overflow -> NULL
            q = DU._abs(DU._i64(data)) // DU.POW10[frm.scale]
            q = DU._where(data < 0, -q, q)
            info = np.iinfo(to.to_np())
            ok = (q >= int(info.min)) & (q <= int(info.max))
            return self._dec_result(v, to, _astype(DU._where(ok, q, 0), to),
                                    ok)
        if frm is DataType.BOOL:
            out = DU._as_i64(data) * DU.POW10[to.scale]
            return self._dec_result(v, to, out, DU._ones(out))
        if frm.is_integral:
            out, ok1 = DU.checked_mul_pow10(DU._i64(data), to.scale)
            out, ok2 = DU.fit_precision(out, to.precision)
            return self._dec_result(v, to, out, ok1 & ok2)
        if frm.is_floating and not isinstance(data, torch.Tensor):
            # the CPU engine, Spark-exact: round the double's shortest
            # decimal repr HALF_UP at the target scale (reference :147)
            out = np.zeros(len(data), dtype=np.int64)
            ok = np.zeros(len(data), dtype=bool)
            limit = DU.bound(to.precision)
            for i, x in enumerate(data):
                x = float(x)
                if not np.isfinite(x):
                    continue
                try:
                    u = DU.to_unscaled(x, to.scale)
                except OverflowError:
                    continue
                if abs(u) <= limit:
                    out[i] = u
                    ok[i] = True
            return self._dec_result(v, to, out, ok)
        raise NotImplementedError(f"cast {frm} -> {to} has no device path")

    def _dec_result(self, v, to, out, ok):
        if self.ansi and not isinstance(ok, torch.Tensor):
            if bool(np.asarray(v.validity & ~ok).any()):
                raise ArithmeticError(
                    f"cast to {to.value} overflowed (ANSI)")
        return ColV(to, out, ok)

    # -- to string (reference :221-258) --------------------------------------
    def _to_string(self, ctx, v, frm):
        if not ctx.is_device:
            return self._to_string_host(v, frm)
        from spark_rapids_tpu_torch.columnar import format as FMT

        if frm.is_integral or frm is DataType.BOOL:
            return FMT.int_to_string(v)
        if frm is DataType.DATE:
            return FMT.date_to_string(v)
        if frm is DataType.TIMESTAMP:
            return FMT.timestamp_to_string(v)
        if frm.is_floating:
            # admitted under rapids.tpu.sql.castFloatToString.enabled
            return FMT.float_to_string(v)
        raise NotImplementedError(f"device cast {frm} -> STRING")

    @staticmethod
    def _to_string_host(v, frm):
        """The CPU engine's text of each row (reference :240), each distinct
        value formatted once (floats told apart by their bits, so -0.0 is
        not 0.0)."""
        data = np.asarray(v.data)
        if frm.is_floating:
            bits = data.view(np.int32 if frm is DataType.FLOAT32
                             else np.int64)
            uniq, inv = np.unique(bits, return_inverse=True)
            return format_float_array(uniq.view(data.dtype),
                                      frm is DataType.FLOAT32)[inv]
        if is_decimal(frm):
            def fmt(x):
                return str(DU.from_unscaled(int(x), frm.scale))
        elif frm is DataType.BOOL:
            def fmt(x):
                return "true" if x else "false"
        elif frm.is_integral:
            def fmt(x):
                return str(int(x))
        elif frm is DataType.DATE:
            def fmt(x):
                return _date_str(int(x))
        elif frm is DataType.TIMESTAMP:
            def fmt(x):
                return _ts_str(int(x))
        else:
            raise NotImplementedError(f"cast {frm} -> STRING")
        uniq, inv = np.unique(data, return_inverse=True)
        return np.array([fmt(x) for x in uniq], dtype=object)[inv]

    # -- from string (reference :261-323) ------------------------------------
    def _from_string(self, ctx, v, to):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import parse as PRS

            if to.is_floating:
                out, malformed = PRS.parse_float_col(v, to)
            elif to is DataType.TIMESTAMP:
                out, malformed = PRS.parse_timestamp_col(v)
            else:
                raise NotImplementedError(f"device cast STRING -> {to}")
            # the rewrite keeps ANSI parses on the CPU engine; a direct
            # device evaluation raises here, after one host read
            if self.ansi and bool(malformed.any()):
                raise ValueError(
                    f"ANSI cast STRING -> {to.name}: malformed input")
            return out
        # the reference's row loop (:280-323) over the distinct texts of
        # the valid rows, each parsed once
        rows = np.nonzero(np.asarray(v.validity, dtype=bool))[0]
        # object rows, not numpy's fixed-width strings, which drop
        # trailing NUL characters
        texts, inv = np.unique(np.asarray(v.data, dtype=object)[rows],
                               return_inverse=True)
        vals = np.zeros(len(texts), dtype=to.to_np())
        ok = np.ones(len(texts), dtype=bool)
        folds = {}  # text -> the float fold of its trimmed text
        for i, s in enumerate(texts.tolist()):
            # ASCII whitespace only, as the device trim
            s = s.strip(" \t\n\r\f\x0b")
            try:
                if is_decimal(to):
                    u = DU.to_unscaled(s, to.scale)
                    if abs(u) > DU.bound(to.precision):
                        raise OverflowError(s)
                    vals[i] = u
                elif to.is_integral:
                    vals[i] = int(float(s)) if "." in s or "e" in s.lower() \
                        else int(s)
                elif to.is_floating:
                    folds[i] = _float_fold(s)
                elif to is DataType.BOOL:
                    low = s.lower()
                    if low in ("t", "true", "y", "yes", "1"):
                        vals[i] = True
                    elif low in ("f", "false", "n", "no", "0"):
                        vals[i] = False
                    else:
                        raise ValueError(s)
                elif to is DataType.DATE:
                    vals[i] = _parse_date(s)
                elif to is DataType.TIMESTAMP:
                    vals[i] = _parse_ts_strict(s)
                else:
                    raise NotImplementedError(f"cast STRING -> {to}")
            except (ValueError, OverflowError, ArithmeticError):
                if self.ansi:
                    raise
                ok[i] = False
                vals[i] = 0
        if folds:
            at = np.fromiter(folds, np.int64, len(folds))
            vals[at] = _float_values(list(folds.values()))
        if to is DataType.FLOAT32:
            # as the device parse: results below the smallest normal f32
            # flush to a signed zero
            tiny = np.isfinite(vals) & (np.abs(vals) < 2.0 ** -126)
            vals[tiny] = np.copysign(np.float32(0.0), vals[tiny])
        out = np.zeros(len(v.data), dtype=to.to_np())
        validity = np.zeros(len(v.data), dtype=bool)
        out[rows] = vals[inv]
        validity[rows] = ok[inv]
        return ColV(to, out, validity)


# ---------------------------------------------------------------------------
# the CPU engine's text helpers (reference :325-516)
# ---------------------------------------------------------------------------
def _civil(days: int):
    """Epoch days -> (year, month, day) in Python ints, the formula of
    ops/datetimeops.py:civil_from_days (floor divisions)."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    return yoe + era * 400 + (1 if m <= 2 else 0), m, d


def _days_from_civil(y: int, m: int, d: int) -> int:
    """ops/datetimeops.py:days_from_civil in Python ints."""
    y -= 1 if m <= 2 else 0
    era = y // 400
    yoe = y - era * 400
    mp = m - 3 if m > 2 else m + 9
    doy = (153 * mp + 2) // 5 + d - 1
    return era * 146097 + yoe * 365 + yoe // 4 - yoe // 100 + doy - 719468


def _date_str(days: int) -> str:
    """Integer civil math over the whole int32 days domain, byte-equal to
    K41's date text (datetime.date stops at year 9999)."""
    y, m, d = _civil(days)
    return f"{_year_str(y)}-{m:02d}-{d:02d}"


def _year_str(y: int) -> str:
    """4 zero-padded digits inside [0, 9999], a sign and at least 4 digits
    outside (Java's SignStyle.EXCEEDS_PAD: 10000 -> '+10000', -5 ->
    '-0005')."""
    if 0 <= y <= 9999:
        return f"{y:04d}"
    return f"{'-' if y < 0 else '+'}{abs(y):04d}"


def _ts_str(micros: int) -> str:
    """'YYYY-MM-DD HH:MM:SS[.f...]' over the whole int64 domain, floored,
    the fraction's trailing zeros stripped: K41's timestamp text."""
    days, rem = divmod(micros, MICROS_PER_DAY)
    y, m, d = _civil(days)
    secs, frac = divmod(rem, MICROS_PER_SEC)
    base = (f"{_year_str(y)}-{m:02d}-{d:02d} "
            f"{secs // 3600:02d}:{secs % 3600 // 60:02d}:{secs % 60:02d}")
    if frac:
        return f"{base}.{frac:06d}".rstrip("0")
    return base


def _parse_date(s: str) -> int:
    return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days


_FLOAT_RE = re.compile(
    r"^[+-]?(?:(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d{1,3})?|"
    r"(?i:inf|infinity|nan))$")
_TS_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})"
    r"(?:[ T](\d{2}):(\d{2}):(\d{2})(?:\.(\d{1,6}))?"
    r"(Z|[+-]\d{2}:\d{2})?)?$")


def _float_fold(s: str):
    """(m, q, negative, special) of a float text by the device grammar's
    fold (reference :381-418): the first 17 significant digits in m, the
    value m * 10^q; special is 'inf', 'nan' or None. Raises ValueError on
    a grammar violation."""
    if len(s) > 48 or not _FLOAT_RE.match(s):
        raise ValueError(s)
    low = s.lstrip("+-").lower()
    negv = s.startswith("-")
    if low in ("inf", "infinity"):
        return 0, 0, negv, "inf"
    if low == "nan":
        return 0, 0, negv, "nan"
    mant, _, ex = low.partition("e")
    ipart, _, fpart = mant.partition(".")
    digs = ipart + fpart
    # zeros before the first significant digit (int() reads any Unicode
    # digit, as the reference's loop does)
    lead = 0
    while lead < len(digs) and int(digs[lead]) == 0:
        lead += 1
    keep = digs[lead:lead + 17]  # the folded significant digits
    end = lead + len(keep)  # digits folded, leading zeros included
    scale = max(0, end - len(ipart))  # folded fraction digits
    dropped_int = max(0, len(ipart) - end)  # integer digits past 17
    q = (int(ex) if ex else 0) - scale + dropped_int
    return int(keep) if keep else 0, max(-400, min(400, q)), negv, None


def _float_values(folds) -> np.ndarray:
    """The doubles of `_float_fold` results, scaled in one call of the
    shared core (columnar/format.py:f64_scale_int) on CPU tensors."""
    from spark_rapids_tpu_torch.columnar import format as FMT

    m = torch.tensor([f[0] for f in folds], dtype=torch.int64)
    q = torch.tensor([f[1] for f in folds], dtype=torch.int64)
    val = FMT.f64_scale_int(m, q).numpy().copy()
    special = np.array([f[3] or "" for f in folds], dtype=object)
    val[special == "inf"] = np.inf
    val[special == "nan"] = np.nan
    neg = np.array([f[2] for f in folds], dtype=bool)
    val[neg] = -val[neg]
    return val


def _parse_float_text(s: str) -> float:
    """A float text's double, bit-equal to K43's (reference :381); raises
    ValueError on grammar violations."""
    return float(_float_values([_float_fold(s)])[0])


def _parse_ts_strict(s: str) -> int:
    """A timestamp text's epoch microseconds by K44's grammar (reference
    :421): 'YYYY-MM-DD' or 'YYYY-MM-DD[ T]HH:MM:SS[.f{1,6}][Z|+-HH:MM]',
    naive times UTC; raises ValueError on violations."""
    mt = _TS_RE.match(s)
    if not mt:
        raise ValueError(s)
    y, mo, d = int(mt.group(1)), int(mt.group(2)), int(mt.group(3))
    days = _days_from_civil(y, mo, d)
    if _civil(days) != (y, mo, d):
        raise ValueError(s)
    micros = days * MICROS_PER_DAY
    if mt.group(4) is not None:
        hh, mi, ss = int(mt.group(4)), int(mt.group(5)), int(mt.group(6))
        if hh >= 24 or mi >= 60 or ss >= 60:
            raise ValueError(s)
        frac = (mt.group(7) or "").ljust(6, "0")
        micros += (hh * 3600 + mi * 60 + ss) * MICROS_PER_SEC + int(frac)
        z = mt.group(8)
        if z and z != "Z":
            zh, zm = int(z[1:3]), int(z[4:6])
            if zh >= 24 or zm >= 60:
                raise ValueError(s)
            off = zh * 60 + zm
            micros -= (-off if z[0] == "-" else off) * 60_000_000
    return micros


def _emit_float_digits(m: int, p: int, e10: int, neg: bool) -> str:
    """(m, p, e10) in Java's placement: plain for -3 <= e10 < 7, else
    'd.dddE[-]ee' (reference :466); K42 writes the same bytes."""
    digs = str(m).rjust(p, "0")
    sign = "-" if neg else ""
    if -3 <= e10 < 7:
        if e10 >= p - 1:
            body = digs + "0" * (e10 - p + 1) + ".0"
        elif e10 >= 0:
            body = digs[:e10 + 1] + "." + digs[e10 + 1:]
        else:
            body = "0." + "0" * (-e10 - 1) + digs
        return sign + body
    frac = digs[1:] if p > 1 else "0"
    return f"{sign}{digs[0]}.{frac}E{e10}"


_SPECIAL_TEXT = {1: ("NaN", "NaN"), 2: ("Infinity", "-Infinity"),
                 3: ("0.0", "-0.0")}


def format_float_array(vals: np.ndarray, is32: bool) -> np.ndarray:
    """The CPU engine's float -> STRING (reference :486): the digits of the
    shared core (columnar/format.py:float_decompose) run on CPU tensors,
    placed row by row."""
    from spark_rapids_tpu_torch.columnar import format as FMT

    x = np.ascontiguousarray(vals, dtype=np.float32 if is32 else np.float64)
    m, p, e10, neg, kind = (t.numpy() for t in FMT.float_decompose(
        torch.from_numpy(x)))
    out = np.empty(len(x), dtype=object)
    for i in range(len(x)):
        k = int(kind[i])
        if k:
            out[i] = _SPECIAL_TEXT[k][int(neg[i])]
        else:
            out[i] = _emit_float_digits(int(m[i]), int(p[i]), int(e10[i]),
                                        bool(neg[i]))
    return out
