"""The CSV grammar of the host (the port's stand-in for the pyarrow calls of
spark_rapids_tpu/io/scan.py:_read_csv_arrow :320, reader.py:105-121 and
writer.py:156-165; the machine with the card has no pyarrow).

- `parse_column`: the columns the device does not parse (DECIMAL,
  BOOLEAN, FLOAT32), from a split's field spans (reference scan.py:
  596-606).
- `parse_split`: the parse of a split or of a chunk of one, the
  reference's host route when a chunk is not eligible for the device or
  a field is malformed for it: a
  tokenizer with pyarrow's quoting (a quote opens a field only at its
  start, "" escapes, newlines inside quotes, blank lines skipped, \\n,
  \\r\\n and \\r ending lines) and each type's grammar as pyarrow reads
  it: the null spellings of csv_device.NULL_VALUES, quoted or not;
  integers after trimming spaces and tabs, decimal or 0x-hex; floats with
  exponents, inf and nan; ISO dates; timestamps with a required zone and
  at most 6 fraction digits; true / false as pyarrow spells them.
  Where pyarrow raises, this raises CsvFormatError and names the column
  and the value.
- `infer_schema`: inferSchema=true over the first block (1 MiB), in
  pyarrow's order: null, int64, boolean, date32, time, timestamp (naive
  or zoned), double, string.
- `column_slots` / `join_rows`: the writer's text, byte for byte
  pyarrow's write_csv:
  a quoted header, every STRING quoted with "" escapes, NULL as an empty
  field, DOUBLE in its shortest round-trip digits (fixed notation for
  1e-6 <= |x| < 1e10, else d[.ddd]e+-N), ISO dates, timestamps as
  'YYYY-MM-DD HH:MM:SS.ffffffZ', DECIMAL with its scale's digits,
  true / false. It is vectorised with numpy digit matrices: each column
  becomes fixed-width byte slots with a mask of the bytes used, the slots
  and separators are laid side by side, and one boolean compaction gives
  the text.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import (
    HostColumnarBatch,
    HostColumnVector,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, DecimalType
from spark_rapids_tpu_torch.io.csv_device import NULL_VALUES
from spark_rapids_tpu_torch.ops import datetimeops as DT
from spark_rapids_tpu_torch.ops.base import AttributeReference


class CsvFormatError(ValueError):
    """A CSV input that the reference's host parser (pyarrow) refuses."""


_NULLS = frozenset(v.encode() for v in NULL_VALUES)
_TRUE = frozenset((b"1", b"True", b"TRUE", b"true"))
_FALSE = frozenset((b"0", b"False", b"FALSE", b"false"))
BLOCK_SIZE = 1 << 20  # pyarrow's ReadOptions().block_size


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------
def tokenize(data: bytes, sep: str) -> List[List[Tuple[bytes, bool]]]:
    """Rows of (field bytes, quoted) with pyarrow's quoting rules."""
    sep_b = sep.encode()
    if len(sep_b) != 1:
        raise CsvFormatError(f"the CSV separator must be one byte: {sep!r}")
    bare = re.compile(b"[^" + re.escape(sep_b) + b"\r\n]*")
    n = len(data)
    rows: List[List[Tuple[bytes, bool]]] = []
    row: List[Tuple[bytes, bool]] = []
    pos = 0
    if data.startswith(b"\xef\xbb\xbf"):  # a UTF-8 byte order mark
        pos = 3
    while pos < n:
        if data[pos] == 0x22:
            parts = []
            j = pos + 1
            while True:
                k = data.find(b'"', j)
                if k < 0:
                    raise CsvFormatError("CSV parse error: a quoted field "
                                         "is not closed before the end")
                parts.append(data[j:k])
                if k + 1 < n and data[k + 1] == 0x22:
                    parts.append(b'"')
                    j = k + 2
                    continue
                j = k + 1
                break
            m = bare.match(data, j)
            parts.append(m.group())
            row.append((b"".join(parts), True))
            pos = m.end()
        else:
            m = bare.match(data, pos)
            row.append((m.group(), False))
            pos = m.end()
        if pos >= n:
            break
        c = data[pos]
        if c == sep_b[0]:
            pos += 1
            if pos >= n:
                row.append((b"", False))
            continue
        pos += 2 if c == 0x0D and pos + 1 < n and data[pos + 1] == 0x0A \
            else 1
        if len(row) > 1 or row[0] != (b"", False):  # blank lines skip
            rows.append(row)
        row = []
    if row and (len(row) > 1 or row[0] != (b"", False)):
        rows.append(row)
    return rows


def _check_width(rows, ncols: int) -> None:
    for r in rows:
        if len(r) != ncols:
            text = b",".join(f for f, _ in r)[:80].decode(errors="replace")
            raise CsvFormatError(f"CSV parse error: Expected {ncols} "
                                 f"columns, got {len(r)}: {text}")


# ---------------------------------------------------------------------------
# Value grammars (pyarrow's CSV conversions)
# ---------------------------------------------------------------------------
_WS = b" \t"
_DEC_INT = re.compile(rb"-?[0-9]+")
_HEX_INT = re.compile(rb"0[xX]([0-9a-fA-F]+)")
_FLOAT = re.compile(rb"[+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?")
_FLOAT_WORD = re.compile(rb"[+-]?(?:inf|infinity|nan)", re.IGNORECASE)
_DECIMAL = re.compile(
    rb"([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?")
_DATE = re.compile(rb"([0-9]{4})-([0-9]{2})-([0-9]{2})")
_TS = re.compile(
    rb"([0-9]{4})-([0-9]{2})-([0-9]{2})(?:[ T]([0-9]{2})(?::([0-9]{2})"
    rb"(?::([0-9]{2})(?:\.([0-9]{1,9}))?)?)?)?"
    rb"(Z|[+-][0-9]{2}(?::?[0-9]{2})?)?")
_TIME = re.compile(rb"([0-9]{2}):([0-9]{2})(?::([0-9]{2})(?:\.[0-9]{1,9})?)?")

_DAYS_IN = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _bad(b: bytes, what: str) -> CsvFormatError:
    return CsvFormatError(f"CSV conversion error to {what}: invalid value "
                          f"'{b.decode(errors='replace')}'")


def parse_int(b: bytes, bits: int) -> int:
    t = b.strip(_WS)
    if _DEC_INT.fullmatch(t):
        v = int(t)
        if -(1 << (bits - 1)) <= v < 1 << (bits - 1):
            return v
        raise _bad(b, f"int{bits}")
    m = _HEX_INT.fullmatch(t)
    if m and len(m.group(1)) <= bits // 4:
        v = int(m.group(1), 16)
        return v - (1 << bits) if v >= 1 << (bits - 1) else v
    raise _bad(b, f"int{bits}")


def parse_float(b: bytes) -> float:
    t = b.strip(_WS)
    if _FLOAT.fullmatch(t) or _FLOAT_WORD.fullmatch(t):
        return float(t)
    raise _bad(b, "double")


def parse_float32(b: bytes) -> np.float32:
    """The decimal text rounded once to the nearest float32 (a double
    rounding through float64 can differ only where the double is a float32
    midpoint; that case is settled exactly)."""
    d = parse_float(b)
    with np.errstate(over="ignore"):
        f = np.float32(d)
    if not np.isfinite(d) or float(f) == d:
        return f
    toward = np.float32(np.inf) if d > float(f) else np.float32(-np.inf)
    nb = np.nextafter(f, toward)
    if np.isfinite(nb) and (float(f) + float(nb)) / 2 == d:
        exact = Fraction(b.strip(_WS).decode())
        if exact != Fraction(d):
            return nb if (exact > Fraction(d)) == (float(nb) > d) else f
    return f


def _valid_civil(y: int, m: int, d: int) -> bool:
    if not 1 <= m <= 12 or d < 1:
        return False
    leap = y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)
    return d <= _DAYS_IN[m - 1] + (1 if m == 2 and leap else 0)


def parse_date(b: bytes) -> int:
    m = _DATE.fullmatch(b.strip(_WS))
    if m:
        y, mo, d = (int(g) for g in m.groups())
        if _valid_civil(y, mo, d):
            return int(DT.days_from_civil(y, mo, d))
    raise _bad(b, "date32[day]")


def _ts_parts(b: bytes):
    """(epoch microseconds, has a zone, has a time) of a timestamp, or
    None."""
    m = _TS.fullmatch(b)
    if not m:
        return None
    y, mo, d, hh, mi, ss, frac, zone = m.groups()
    y, mo, d = int(y), int(mo), int(d)
    if not _valid_civil(y, mo, d) or (frac and len(frac) > 6):
        return None
    h = int(hh) if hh else 0
    mi = int(mi) if mi else 0
    s = int(ss) if ss else 0
    if h > 23 or mi > 59 or s > 59:
        return None
    days = int(DT.days_from_civil(y, mo, d))
    us = (days * 86400 + h * 3600 + mi * 60 + s) * 1_000_000 + \
        (int(frac.ljust(6, b"0")) if frac else 0)
    if zone and zone != b"Z":
        z = zone[1:].replace(b":", b"")
        oh, om = int(z[:2]), int(z[2:] or b"0")
        if oh > 23 or om > 59:
            return None
        off = (oh * 3600 + om * 60) * 1_000_000
        us += off if zone[:1] == b"-" else -off
    return us, zone is not None, hh is not None


def parse_timestamp(b: bytes) -> int:
    """A TIMESTAMP (UTC microseconds): pyarrow reads timestamp[us, UTC],
    which needs a time of day and a zone in the text."""
    p = _ts_parts(b)
    if p is None or not p[2]:
        raise _bad(b, "timestamp[us, tz=UTC]")
    if not p[1]:
        raise CsvFormatError("CSV conversion error to timestamp[us, tz=UTC]:"
                             f" expected a zone offset in "
                             f"'{b.decode(errors='replace')}'")
    return p[0]


def parse_bool(b: bytes) -> bool:
    if b in _TRUE:
        return True
    if b in _FALSE:
        return False
    raise _bad(b, "bool")


def parse_decimal(b: bytes, dt: DecimalType) -> int:
    """The unscaled value: the literal's digits (leading zeros dropped)
    must fit the precision, and a rescale may not drop a non-zero digit."""
    m = _DECIMAL.fullmatch(b.strip(_WS))
    if not m or not (m.group(2) or m.group(3)):
        raise CsvFormatError(f"The string '{b.decode(errors='replace')}' is "
                             "not a valid decimal128 number")
    sign, whole, frac, exp = m.groups()
    frac = frac or b""
    digits = (whole + frac).lstrip(b"0")
    value = int(whole + frac or b"0")
    scale = len(frac) - int(exp or b"0")
    precision = len(digits)
    if scale < 0:
        value *= 10 ** -scale
        precision += -scale
        scale = 0
    if precision > dt.precision:
        raise CsvFormatError(f"Error converting '{b.decode(errors='replace')}"
                             f"' to decimal128({dt.precision}, {dt.scale}): "
                             "precision not supported by type")
    if scale > dt.scale:
        q, r = divmod(value, 10 ** (scale - dt.scale))
        if r:
            raise CsvFormatError("Rescaling Decimal value would cause data "
                                 "loss")
        value = q
    else:
        value *= 10 ** (dt.scale - scale)
    return -value if sign == b"-" else value


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------
def _is_null(b: bytes) -> bool:
    return b in _NULLS


def convert(name: str, dtype, fields: Sequence[bytes]) -> HostColumnVector:
    """One column of field bytes (quotes already stripped) as pyarrow
    converts it: null spellings are NULL, the rest parse or raise."""
    n = len(fields)
    valid = np.ones(n, dtype=bool)
    memo: Dict[bytes, object] = {}
    if dtype is DataType.STRING:
        data = np.empty(n, dtype=object)
        for i, f in enumerate(fields):
            if _is_null(f):
                valid[i] = False
                data[i] = ""
                continue
            try:
                data[i] = f.decode("utf-8")
            except UnicodeDecodeError:
                raise CsvFormatError(f"column {name!r}: CSV conversion error "
                                     "to string: invalid UTF8 data") from None
        return HostColumnVector(dtype, data, valid)
    if isinstance(dtype, DecimalType):
        fn = lambda f: parse_decimal(f, dtype)  # noqa: E731
        npdt = np.int64
    elif dtype in (DataType.INT8, DataType.INT16, DataType.INT32,
                   DataType.INT64):
        bits = 8 * np.dtype(dtype.to_np()).itemsize
        fn = lambda f: parse_int(f, bits)  # noqa: E731
        npdt = dtype.to_np()
    elif dtype is DataType.FLOAT64:
        fn, npdt = parse_float, np.float64
    elif dtype is DataType.FLOAT32:
        fn, npdt = parse_float32, np.float32
    elif dtype is DataType.BOOL:
        fn, npdt = parse_bool, np.bool_
    elif dtype is DataType.DATE:
        fn, npdt = parse_date, np.int32
    elif dtype is DataType.TIMESTAMP:
        fn, npdt = parse_timestamp, np.int64
    else:
        raise CsvFormatError(f"column {name!r}: the CSV reader does not "
                             f"read {dtype}")
    out = np.zeros(n, dtype=npdt)
    for i, f in enumerate(fields):
        if _is_null(f):
            valid[i] = False
            continue
        v = memo.get(f)
        if v is None:
            try:
                v = memo[f] = fn(f)
            except CsvFormatError as e:
                raise CsvFormatError(f"column {name!r}: {e}") from None
        out[i] = v
    return HostColumnVector(dtype, out, valid)


def parse_column(name: str, dtype, raw: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray) -> HostColumnVector:
    """A column the device does not parse (DECIMAL, BOOLEAN, FLOAT32),
    from its field spans in a split's (unescaped) bytes."""
    buf = raw.tobytes() if isinstance(raw, np.ndarray) else bytes(raw)
    return convert(name, dtype, [buf[s:s + ln] for s, ln in
                                 zip(starts.tolist(), lens.tolist())])


def parse_split(data, attrs: Sequence[AttributeReference], header: bool,
                sep: str, names: Optional[Sequence[str]] = None
                ) -> Tuple[HostColumnarBatch, List[str]]:
    """A split, or a line-aligned chunk of one, on the host (the
    reference's pyarrow read of a split, scan.py:312): (the batch, the
    file's column names). The header names the file's columns, else
    `names` do (by default the schema, in order); every attribute converts
    or raises."""
    if not len(data):
        raise CsvFormatError("Empty CSV file")
    rows = tokenize(bytes(data), sep)
    if header:
        if not rows:
            raise CsvFormatError("Empty CSV file")
        names = [f.decode("utf-8", errors="replace") for f, _ in rows[0]]
        rows = rows[1:]
    elif names is None:
        names = [a.name for a in attrs]
    _check_width(rows, len(names))
    cols = []
    for a in attrs:
        if a.name not in names:
            raise CsvFormatError(f"column {a.name!r} is not in the CSV "
                                 f"header {names}")
        j = names.index(a.name)
        cols.append(convert(a.name, a.data_type, [r[j][0] for r in rows]))
    return HostColumnarBatch(cols, len(rows)), list(names)


# ---------------------------------------------------------------------------
# Schema inference
# ---------------------------------------------------------------------------
_KINDS = ("null", "int", "bool", "date", "time", "timestamp",
          "timestamp_tz", "double", "string")


def _accepts(kind: str, b: bytes) -> bool:
    try:
        if kind == "int":
            parse_int(b, 64)
        elif kind == "bool":
            parse_bool(b)
        elif kind == "date":
            parse_date(b)
        elif kind == "time":
            m = _TIME.fullmatch(b)
            return bool(m) and int(m.group(1)) < 24 and \
                int(m.group(2)) < 60 and int(m.group(3) or 0) < 60
        elif kind in ("timestamp", "timestamp_tz"):
            p = _ts_parts(b)
            return p is not None and p[1] == (kind == "timestamp_tz")
        elif kind == "double":
            parse_float(b)
        elif kind == "string":
            b.decode("utf-8")
        return True
    except (CsvFormatError, UnicodeDecodeError):
        return False


_KIND_TYPES = {"int": DataType.INT64, "bool": DataType.BOOL,
               "date": DataType.DATE, "timestamp": DataType.TIMESTAMP,
               "timestamp_tz": DataType.TIMESTAMP,
               "double": DataType.FLOAT64, "string": DataType.STRING}


def first_block(path: str, size: int = BLOCK_SIZE) -> bytes:
    """The first block of a file, cut after its last complete line."""
    with open(path, "rb") as f:
        data = f.read(size)
        if len(data) == size and f.read(1):
            cut = data.rfind(b"\n")
            data = data[:cut + 1] if cut >= 0 else data
    return data


def infer_schema(data: bytes, header: bool, sep: str,
                 infer: bool) -> List[AttributeReference]:
    """The columns of a file's first block (reference reader.py:105-121):
    the header's names or pyarrow's f0, f1, ...; every column STRING
    unless `infer`, then the first kind of pyarrow's order that reads
    every non-null value. A column of NULLs only, of times or of bytes
    that are not UTF-8 raises, as the reference's type map does."""
    rows = tokenize(data, sep)
    if not rows:
        raise CsvFormatError("Empty CSV file")
    if header:
        names = [f.decode("utf-8", errors="replace") for f, _ in rows[0]]
        rows = rows[1:]
    else:
        names = [f"f{i}" for i in range(len(rows[0]))]
    _check_width(rows, len(names))
    out = []
    for j, name in enumerate(names):
        dt = DataType.STRING
        if infer:
            values = [r[j][0] for r in rows if not _is_null(r[j][0])]
            kind = "null" if not values else next(
                (k for k in _KINDS[1:] if all(_accepts(k, v)
                                              for v in values)), "binary")
            if kind not in _KIND_TYPES:
                raise TypeError(f"column {name!r}: unsupported CSV column "
                                f"type {kind} (flat types only)")
            dt = _KIND_TYPES[kind]
        out.append(AttributeReference(name, dt, True))
    return out


# ---------------------------------------------------------------------------
# The writer's text
# ---------------------------------------------------------------------------
_POW10 = np.array([10 ** k for k in range(19)], dtype=np.int64)
_POW10F = np.array([10.0 ** k for k in range(20)], dtype=np.float64)
_QUOTE = ord('"')

# A column's text is a list of slots: (bytes [n, w], used [n, w]). Slots
# sit side by side in a row and only the used bytes are kept, so a value
# may sit anywhere in its slot (digits are right-aligned): one compaction
# of all slots gives the rows' text.
Slot = Tuple[np.ndarray, np.ndarray]


def _const(n: int, text: bytes, used: Optional[np.ndarray] = None) -> Slot:
    b = np.frombuffer(text, dtype=np.uint8)
    mat = np.broadcast_to(b[None, :], (n, b.size))
    mask = np.ones((n, b.size), dtype=bool) if used is None else \
        np.broadcast_to(used[:, None], (n, b.size))
    return mat, mask


def _digits(u: np.ndarray, count: np.ndarray) -> Slot:
    """The low `count` decimal digits of non-negative int64 values,
    most significant first, right-aligned in a slot of max(count)."""
    n = u.shape[0]
    w = int(count.max()) if n else 0
    mat = np.empty((n, w), dtype=np.uint8)
    mask = np.empty((n, w), dtype=bool)
    if n and int(u.max()) < 1 << 49:
        # doubles divide exactly enough below 2^49 and far faster
        v = u.astype(np.float64)
        for t in range(w):
            q = np.floor(v * 0.1)
            mat[:, w - 1 - t] = (v - q * 10.0).astype(np.uint8) + 48
            mask[:, w - 1 - t] = count > t
            v = q
        return mat, mask
    v = u.copy()
    for t in range(w):
        mat[:, w - 1 - t] = v % 10 + 48
        mask[:, w - 1 - t] = count > t
        v //= 10
    return mat, mask


def _ndigits(u: np.ndarray) -> np.ndarray:
    """Decimal digits of non-negative int64 values (1 for 0)."""
    count = np.ones(u.shape[0], dtype=np.int64)
    top = int(u.max()) if u.size else 0
    for k in range(1, 19):
        if _POW10[k] > top:
            break
        count += u >= _POW10[k]
    return count


def _int_slots(v: np.ndarray) -> List[Slot]:
    """'-'? digits. int64's minimum, whose magnitude int64 lacks, is
    written from its first 18 digits and its last."""
    v = v.astype(np.int64)
    n = v.shape[0]
    neg = v < 0
    low = np.where(neg, -(v % -10), v % 10)  # last digit
    high = np.abs(np.where(neg, -(v // -10), v // 10))
    count = np.where(high > 0, _ndigits(high), 0)
    return [_const(n, b"-", neg), _digits(high, count),
            _digits(low, np.ones(n, dtype=np.int64))]


def _fixed_slots(whole: np.ndarray, frac: np.ndarray, k: np.ndarray,
                 neg: np.ndarray) -> List[Slot]:
    """'-'? whole ['.' k fraction digits] of non-negative parts."""
    n = whole.shape[0]
    return [_const(n, b"-", neg), _digits(whole, _ndigits(whole)),
            _const(n, b".", k > 0), _digits(frac, k)]


def _shortest_text(x: float) -> bytes:
    """pyarrow's text of one double: the shortest round-trip digits, fixed
    for 1e-6 <= |x| < 1e10, else 'd[.ddd]e+N' / 'e-N'."""
    if x != x:
        return b"nan"
    if x in (float("inf"), float("-inf")):
        return b"inf" if x > 0 else b"-inf"
    return _layout(repr(x))


def _layout(r: str) -> bytes:
    """A shortest repr ('1.5e-07', '123.0', '0.001') in pyarrow's layout:
    fixed for a decimal exponent in [-6, 10), else d[.ddd]e+-N."""
    sign = ""
    if r.startswith("-"):
        sign, r = "-", r[1:]
    mant, _, exp = r.partition("e")
    whole, _, frac = mant.partition(".")
    digits = whole + frac
    zeros = len(digits) - len(digits.lstrip("0"))
    point = len(whole) + int(exp or 0) - zeros
    digits = digits[zeros:].rstrip("0")
    if not digits:
        return (sign + "0").encode()
    e = point - 1
    if -6 <= e < 10:
        if point > 0:
            text = digits[:point].ljust(point, "0")
            rest = digits[point:]
        else:
            text, rest = "0", "0" * -point + digits
        return (sign + text + ("." + rest if rest else "")).encode()
    m = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
    return (sign + m + "e" + ("+" if e > 0 else "-") + str(abs(e))).encode()


def _double_slots(x: np.ndarray) -> List[Slot]:
    """Shortest round-trip text of doubles. A value of 1e-6 <= |x| < 1e10
    (or 0) whose decimal m / 10^k round-trips for the least k, with one m
    only, is written from (m, k) in numpy; every other value (exponent
    form, nan, inf, more digits) from its repr.

    The decimals that round to x fill an interval at most spacing(x) wide,
    spacing(x) * 10^k in units of 10^-k: below 1/2 it holds at most one
    integer m, which then is the rounded x * 10^k; wider, the integers
    near x * 10^k are tried and only a unique one is taken."""
    n = x.shape[0]
    ax = np.abs(x)
    m_out = np.zeros(n, dtype=np.int64)
    k_out = np.zeros(n, dtype=np.int64)
    done = ax == 0
    todo = np.flatnonzero(~done & (ax >= 1e-6) & (ax < 1e10))
    for k in range(19):
        if not todo.size:
            break
        a = ax[todo]
        p = a * _POW10F[k]
        narrow = np.spacing(a) * _POW10F[k] < 0.5
        c = np.rint(p)
        hits = ((c < 2.0 ** 53) & (c / _POW10F[k] == a)).astype(np.int64)
        found = c
        wide = np.flatnonzero(~narrow)
        if wide.size:
            base = np.floor(p[wide])
            hits[wide] = 0
            for off in range(-3, 5):
                cw = base + off
                ok = (cw >= 0) & (cw < 2.0 ** 53) & \
                    (cw / _POW10F[k] == a[wide])
                found[wide] = np.where(ok & (hits[wide] == 0), cw,
                                       found[wide])
                hits[wide] += ok
        one = hits == 1
        idx = todo[one]
        m_out[idx] = found[one].astype(np.int64)
        k_out[idx] = k
        done[idx] = True
        todo = todo[hits == 0]
    pw = _POW10[k_out]
    slots = _fixed_slots(m_out // pw, m_out % pw, k_out, np.signbit(x))
    rest = np.flatnonzero(~done)
    if rest.size:
        slots = [(sm, su & done[:, None]) for sm, su in slots]
        slots.append(_text_slot(rest, [_shortest_text(float(v))
                                       for v in x[rest]], n))
    return slots


def _float32_slots(x: np.ndarray) -> List[Slot]:
    """Shortest float32 text (numpy's Dragon4 digits), a value at a time
    over the distinct values."""
    uniq, inv = np.unique(x, return_inverse=True)
    texts = []
    for v in uniq:
        if np.isnan(v):
            texts.append(b"nan")
        elif np.isinf(v):
            texts.append(b"inf" if v > 0 else b"-inf")
        else:
            texts.append(_layout(np.format_float_scientific(
                v, unique=True, trim="-")))
    return [_text_slot(np.arange(x.shape[0]),
                       [texts[i] for i in inv.ravel()], x.shape[0])]


def _text_slot(rows: np.ndarray, texts: Sequence[bytes], n: int) -> Slot:
    """A slot holding texts[i] in row rows[i], nothing elsewhere."""
    lens = np.fromiter((len(t) for t in texts), dtype=np.int64,
                       count=len(texts))
    w = int(lens.max()) if len(texts) else 0
    mat = np.zeros((n, w), dtype=np.uint8)
    mask = np.zeros((n, w), dtype=bool)
    if w:
        flat = np.frombuffer(b"".join(texts), dtype=np.uint8)
        r = np.repeat(rows, lens)
        c = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
        mat[r, c] = flat
        mask[r, c] = True
    return mat, mask


def _date_slots(days: np.ndarray) -> List[Slot]:
    """'YYYY-MM-DD': the year zero-padded to 4 digits, a '-' before a
    negative one, more digits past 9999."""
    n = days.shape[0]
    y, m, d = (x.astype(np.int64) for x in DT.civil_from_days(days))
    ay = np.abs(y)
    two = np.full(n, 2, dtype=np.int64)
    return [_const(n, b"-", y < 0),
            _digits(ay, np.maximum(_ndigits(ay), 4)), _const(n, b"-"),
            _digits(m, two), _const(n, b"-"), _digits(d, two)]


def _timestamp_slots(us: np.ndarray) -> List[Slot]:
    """'YYYY-MM-DD HH:MM:SS.ffffffZ' (UTC)."""
    n = us.shape[0]
    us = us.astype(np.int64)
    days = us // 86_400_000_000
    rem = us - days * 86_400_000_000
    secs = rem // 1_000_000
    two = np.full(n, 2, dtype=np.int64)
    return _date_slots(days) + [
        _const(n, b" "), _digits(secs // 3600, two), _const(n, b":"),
        _digits(secs // 60 % 60, two), _const(n, b":"),
        _digits(secs % 60, two), _const(n, b"."),
        _digits(rem % 1_000_000, np.full(n, 6, dtype=np.int64)),
        _const(n, b"Z")]


def _decimal_slots(unscaled: np.ndarray, scale: int) -> List[Slot]:
    v = unscaled.astype(np.int64)
    a = np.abs(v)  # |unscaled| < 10^18 at precision <= 18
    pw = np.int64(10 ** scale)
    return _fixed_slots(a // pw, a % pw,
                        np.full(v.shape[0], scale, dtype=np.int64), v < 0)


def _bool_slots(b: np.ndarray) -> List[Slot]:
    n = b.shape[0]
    return [_const(n, b"true", b), _const(n, b"false", ~b)]


def _string_slots(offsets: np.ndarray, data: np.ndarray) -> List[Slot]:
    """'"' + bytes with each '"' doubled + '"'."""
    offsets = offsets.astype(np.int64)
    data = np.asarray(data, dtype=np.uint8)[offsets[0]:offsets[-1]]
    offsets = offsets - offsets[0]
    q = data == _QUOTE
    if q.any():
        data = np.repeat(data, 1 + q)
        offsets = offsets + np.concatenate(([0], np.cumsum(q)))[offsets]
    n = offsets.shape[0] - 1
    lens = offsets[1:] - offsets[:-1]
    pos = np.arange(int(lens.max()) if n else 0)
    mask = pos[None, :] < lens[:, None]
    mat = data[np.minimum(offsets[:-1, None] + pos[None, :],
                          data.size - 1)] if data.size else \
        np.zeros(mask.shape, dtype=np.uint8)
    return [_const(n, b'"'), (mat, mask), _const(n, b'"')]


def column_slots(dtype, data: np.ndarray, valid: np.ndarray,
                 offsets: Optional[np.ndarray] = None) -> List[Slot]:
    """The text of one column's rows, NULL rows empty. STRING columns come
    as (offsets int [n + 1], bytes)."""
    if dtype is DataType.STRING:
        slots = _string_slots(offsets, data)
    elif isinstance(dtype, DecimalType):
        slots = _decimal_slots(data, dtype.scale)
    elif dtype is DataType.FLOAT64:
        slots = _double_slots(data.astype(np.float64))
    elif dtype is DataType.FLOAT32:
        slots = _float32_slots(data.astype(np.float32))
    elif dtype is DataType.BOOL:
        slots = _bool_slots(data.astype(bool))
    elif dtype is DataType.DATE:
        slots = _date_slots(data)
    elif dtype is DataType.TIMESTAMP:
        slots = _timestamp_slots(data)
    elif dtype in (DataType.INT8, DataType.INT16, DataType.INT32,
                   DataType.INT64):
        slots = _int_slots(data)
    else:
        raise CsvFormatError(f"the CSV writer does not write {dtype}")
    valid = np.asarray(valid, dtype=bool)
    if valid.all():
        return slots
    return [(m, u & valid[:, None]) for m, u in slots]


def header_line(names: Sequence[str], sep: str) -> bytes:
    return sep.encode().join(
        b'"' + n.encode().replace(b'"', b'""') + b'"' for n in names) + b"\n"


def join_rows(columns: Sequence[List[Slot]], n: int, sep: str) -> bytes:
    """The text of n rows: each row's columns with `sep` between and a
    newline after, in one compaction of the side-by-side slots."""
    if not columns or not n:
        return b""
    mats, masks = [], []
    for j, slots in enumerate(columns):
        for m, u in slots + [_const(n, b"\n" if j == len(columns) - 1
                                    else sep.encode())]:
            mats.append(m)
            masks.append(u)
    return np.hstack(mats)[np.hstack(masks)].tobytes()
