"""Fixed-point decimal math over the int64 unscaled representation (port of
spark_rapids_tpu/ops/decimal_util.py).

Result precision and scale follow Spark's DecimalPrecision rules, capped at
MAX_PRECISION = 18 (Spark's Decimal.MAX_LONG_DIGITS); an overflow is SQL
NULL, as in Spark's non-ANSI mode. Every kernel takes torch tensors (the
card) or numpy arrays (the CPU engine) and uses int64 operations only, so
the two engines agree bit for bit. Overflow is detected before it can wrap
(a checked multiply through magnitude bounds) and comes back as a False
lane of the `ok` mask.

The reference's documented deviation of the 64-bit subset carries over:
multiply and divide intermediates live in int64 at the natural scale, so an
operation whose final value would fit can still give NULL when the
intermediate exceeds int64 (reference :14-21).
"""

from __future__ import annotations

import decimal
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import (
    DecimalType,
    INTEGRAL_DECIMAL_PRECISION,
)

INT64_MAX = (1 << 63) - 1

# 10**k for k in [0, 18]
POW10 = [10 ** k for k in range(19)]


def bound(precision: int) -> int:
    """Largest unscaled magnitude representable at `precision` digits."""
    return POW10[precision] - 1


def as_decimal_type(dt) -> Optional[DecimalType]:
    """A type viewed as a decimal for mixed decimal/integral arithmetic
    (Spark DecimalPrecision: integral types widen to the exact decimal that
    holds them)."""
    if isinstance(dt, DecimalType):
        return dt
    if dt in INTEGRAL_DECIMAL_PRECISION:
        return DecimalType(INTEGRAL_DECIMAL_PRECISION[dt], 0)
    return None


def _adjust(precision: int, scale: int) -> DecimalType:
    """Spark's DecimalType.adjustPrecisionScale for MAX = 18."""
    top = DecimalType.MAX_PRECISION
    if precision <= top:
        return DecimalType(max(precision, 1), scale)
    int_digits = precision - scale
    min_scale = min(scale, 6)
    adjusted_scale = max(top - int_digits, min_scale)
    return DecimalType(top, adjusted_scale)


def bounded(precision: int, scale: int) -> DecimalType:
    """Spark's DecimalType.bounded(p, s)."""
    return _adjust(precision, scale)


def add_result_type(l: DecimalType, r: DecimalType) -> DecimalType:
    s = max(l.scale, r.scale)
    p = max(l.precision - l.scale, r.precision - r.scale) + s + 1
    return _adjust(p, s)


def multiply_result_type(l: DecimalType, r: DecimalType) -> DecimalType:
    return _adjust(l.precision + r.precision + 1, l.scale + r.scale)


def divide_result_type(l: DecimalType, r: DecimalType) -> DecimalType:
    s = max(6, l.scale + r.precision + 1)
    p = l.precision - l.scale + r.scale + s
    return _adjust(p, s)


def remainder_result_type(l: DecimalType, r: DecimalType) -> DecimalType:
    s = max(l.scale, r.scale)
    p = min(l.precision - l.scale, r.precision - r.scale) + s
    return _adjust(p, s)


# ---------------------------------------------------------------------------
# Checked kernels: each returns (data, ok) with data zeroed where not ok.
# ---------------------------------------------------------------------------
def _i64(v):
    """int64 view of a tensor or an array; a scalar becomes a python int
    (weak against a tensor, exact on its own)."""
    if isinstance(v, torch.Tensor):
        return v if v.dtype == torch.int64 else v.to(torch.int64)
    if isinstance(v, np.ndarray):
        return v.astype(np.int64) if v.dtype != np.int64 else v
    return int(v)


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        if not isinstance(a, torch.Tensor):
            a = torch.full((), a, dtype=b.dtype if isinstance(
                b, torch.Tensor) else torch.int64, device=cond.device)
        if not isinstance(b, torch.Tensor):
            b = torch.full((), b, dtype=a.dtype, device=cond.device)
        return torch.where(cond, a, b)
    if isinstance(cond, np.ndarray):
        return np.where(cond, a, b)
    return a if cond else b


def _ones(like):
    if isinstance(like, torch.Tensor):
        return torch.ones(like.shape, dtype=torch.bool, device=like.device)
    if isinstance(like, np.ndarray):
        return np.ones(like.shape, dtype=bool)
    return True


def _zeros_i64(like):
    if isinstance(like, torch.Tensor):
        return torch.zeros(like.shape, dtype=torch.int64, device=like.device)
    if isinstance(like, np.ndarray):
        return np.zeros(like.shape, dtype=np.int64)
    return 0


def _abs(x):
    if isinstance(x, torch.Tensor):
        return torch.abs(x)
    return np.abs(x) if isinstance(x, np.ndarray) else abs(x)


def _as_i64(b):
    if isinstance(b, torch.Tensor):
        return b.to(torch.int64)
    if isinstance(b, np.ndarray):
        return b.astype(np.int64)
    return int(b)


def checked_mul_pow10(data, k: int):
    """data * 10**k with overflow -> not ok; k is static per expression."""
    data = _i64(data)
    if k <= 0:
        return data, _ones(data)
    if k > 18:
        zero = _zeros_i64(data)
        return zero, zero != 0
    limit = INT64_MAX // POW10[k]
    ok = _abs(data) <= limit
    return _where(ok, data, 0) * POW10[k], ok


def checked_mul(l, r):
    """l * r with wrap-free overflow detection through a magnitude bound."""
    l = _i64(l)
    r = _i64(r)
    absr = _abs(r)
    safe_absr = _where(absr == 0, 1, absr)
    ok = (absr == 0) | (_abs(l) <= INT64_MAX // safe_absr)
    return _where(ok, l, 0) * r, ok


def div_half_up(num, den):
    """Sign-aware ROUND_HALF_UP integer division (Spark's decimal
    rounding); den == 0 lanes give 0 with ok False."""
    num = _i64(num)
    den = _i64(den)
    ok = den != 0
    an = _abs(num)
    ad = _where(ok, _abs(den), 1)
    q = an // ad
    rem = an - q * ad
    q = q + _as_i64((rem >= ad - rem) & (rem != 0))
    neg = (num < 0) ^ (den < 0)
    return _where(ok, _where(neg, -q, q), 0), ok


def rescale(data, from_scale: int, to_scale: int):
    """Change scale: down rounds HALF_UP, up checks overflow."""
    if to_scale == from_scale:
        data = _i64(data)
        return data, _ones(data)
    if to_scale > from_scale:
        return checked_mul_pow10(data, to_scale - from_scale)
    k = from_scale - to_scale
    if k > 18:
        z = _zeros_i64(_i64(data))
        return z, _ones(z)
    out, _ = div_half_up(data, POW10[k])
    return out, _ones(out)


def fit_precision(data, precision: int):
    """ok where |data| fits in `precision` digits (overflow -> NULL). Two
    comparisons, not abs: abs(INT64_MIN) wraps negative."""
    b = bound(precision)
    ok = (data <= b) & (data >= -b)
    return _where(ok, data, 0), ok


def compare_rescale(data, from_scale: int, to_scale: int):
    """Rescale for comparison: a lane whose rescaled magnitude would
    overflow saturates to +/-INT64_MAX, which keeps its order against every
    in-range operand (any valid unscaled decimal is below 10**18)."""
    data = _i64(data)
    if to_scale <= from_scale:
        return data
    out, ok = checked_mul_pow10(data, to_scale - from_scale)
    sat = _where(data < 0, -INT64_MAX, INT64_MAX)
    return _where(ok, out, sat)


def unscale_to_double(data, scale: int):
    """The DOUBLE value of unscaled decimals: one conversion, then one
    division by 10**scale (the reference's operation order, so the doubles
    are bit-equal)."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.float64) / float(POW10[scale])
    if isinstance(data, np.ndarray):
        return data.astype(np.float64) / np.float64(float(POW10[scale]))
    return float(data) / float(POW10[scale])


# ---------------------------------------------------------------------------
# Host-side value conversion (literals, builders, collect)
# ---------------------------------------------------------------------------
def to_unscaled(value, scale: int, precision: Optional[int] = None) -> int:
    """Python value (Decimal/int/float/str) -> unscaled int at `scale`,
    rounding HALF_UP like Spark's Decimal.changePrecision; beyond the
    precision bound it raises."""
    if isinstance(value, decimal.Decimal):
        d = value
    elif isinstance(value, (int, np.integer)):
        d = decimal.Decimal(int(value))
    elif isinstance(value, (float, np.floating)):
        d = decimal.Decimal(repr(float(value)))
    elif isinstance(value, str):
        d = decimal.Decimal(value.strip())
    else:
        raise TypeError(f"cannot convert {value!r} to decimal")
    q = d.scaleb(scale).to_integral_value(rounding=decimal.ROUND_HALF_UP)
    i = int(q)
    if abs(i) > INT64_MAX:
        raise OverflowError(f"decimal {value} does not fit in 64 bits at "
                            f"scale {scale}")
    if precision is not None and abs(i) > bound(precision):
        raise OverflowError(
            f"decimal {value} does not fit decimal({precision},{scale})")
    return i


def from_unscaled(unscaled: int, scale: int) -> decimal.Decimal:
    """Unscaled int -> decimal.Decimal (the value collect returns)."""
    return decimal.Decimal(int(unscaled)).scaleb(-scale)


def infer_decimal_type(value) -> DecimalType:
    """The DecimalType that holds a python Decimal literal exactly."""
    d = value if isinstance(value, decimal.Decimal) else \
        decimal.Decimal(str(value))
    t = d.as_tuple()
    scale = max(0, -t.exponent)
    digits = len(t.digits) + max(0, t.exponent)
    precision = max(digits, scale)
    top = DecimalType.MAX_PRECISION
    if precision > top or scale > top:
        raise ValueError(f"decimal literal {d} exceeds {top} digits")
    return DecimalType(max(precision, 1), scale)
