"""Arithmetic expressions (port of spark_rapids_tpu/ops/arithmetic.py; reference:
org/apache/spark/sql/rapids/arithmetic.scala — +, -, *, /, remainder, pmod).

Integer arithmetic wraps at the result type on both engines (numpy and
torch both wrap int64). A DECIMAL operand with a decimal-coercible other
side (a decimal or an integer) runs in decimal space: Spark's result type
(ops/decimal_util.py), int64 unscaled math and overflow to NULL
(reference: arithmetic.py:28-226); a decimal against a float computes in
DOUBLE.

Spark `%` is the TRUNCATED remainder (sign follows the dividend). A tensor's
`%` operator is floor-mod, so the device path uses `torch.fmod`, which is
truncated for integers and floats alike; the CPU path keeps the reference's
numpy formulation (arithmetic.py:404-414).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import (
    DataType,
    common_type,
    is_decimal,
    to_torch,
)
from spark_rapids_tpu_torch.ops import decimal_util as DU
from spark_rapids_tpu_torch.ops.base import (
    BinaryExpression,
    UnaryExpression,
    _d,
)
from spark_rapids_tpu_torch.ops.values import ColV, ScalarV, zero_nulls


class BinaryArithmetic(BinaryExpression):
    # per-op decimal result rule (None: decimal operands unsupported)
    _decimal_result = None

    def _decimal_types(self):
        """(left, right, result) DecimalTypes when this op runs in decimal
        space: a decimal operand, the other decimal-coercible (reference
        :31)."""
        lt, rt = self.left.data_type, self.right.data_type
        if not (is_decimal(lt) or is_decimal(rt)):
            return None
        ld, rd = DU.as_decimal_type(lt), DU.as_decimal_type(rt)
        if ld is None or rd is None:
            return None  # decimal op float resolves to double
        if type(self)._decimal_result is None:
            raise TypeError(
                f"{type(self).__name__} does not support decimal operands")
        return ld, rd, type(self)._decimal_result(ld, rd)

    @property
    def data_type(self):
        dts = self._decimal_types()
        if dts is not None:
            return dts[2]
        ct = common_type(self.left.data_type, self.right.data_type)
        if ct is None:
            raise TypeError(
                f"{type(self).__name__}: incompatible types "
                f"{self.left.data_type} / {self.right.data_type}")
        return ct

    @property
    def nullable(self):
        # decimal arithmetic overflows to NULL (Spark's non-ANSI mode)
        if self._decimal_types() is not None:
            return True
        return super().nullable

    def _decimal_addsub(self, lv, rv, sign: int):
        """Add or subtract at the larger operand scale, then round once to
        the result scale; a wrapped int64 intermediate is NULL, never a
        wrong value (reference :147-170)."""
        ld, rd, res = self._decimal_types()
        s = max(ld.scale, rd.scale)
        l, ok1 = DU.rescale(DU._i64(_d(lv)), ld.scale, s)
        r, ok2 = DU.rescale(DU._i64(_d(rv)), rd.scale, s)
        r = r if sign > 0 else -r
        out = l + r
        no_wrap = ~(((l >= 0) == (r >= 0)) & ((out >= 0) != (l >= 0)))
        ok = ok1 & ok2 & no_wrap
        if s != res.scale:
            out, ok4 = DU.rescale(out, s, res.scale)
            ok = ok & ok4
        out, ok3 = DU.fit_precision(out, res.precision)
        ok = ok & ok3
        return ColV(res, DU._where(ok, out, 0), ok)

    def _decimal_mod(self, lv, rv, positive: bool):
        """Truncated (or positive, for pmod) modulus at the common scale
        (reference :123-144)."""
        ld, rd, res = self._decimal_types()
        s = max(ld.scale, rd.scale)
        l, ok1 = DU.rescale(DU._i64(_d(lv)), ld.scale, s)
        r, ok2 = DU.rescale(DU._i64(_d(rv)), rd.scale, s)
        safe_r = DU._where(r == 0, 1, r)

        def trunc_mod(a, n):
            q = a // n
            rem = a - q * n
            adj = DU._as_i64((rem != 0) & ((a < 0) ^ (n < 0)))
            return a - (q + adj) * n

        m = trunc_mod(l, safe_r)
        if positive:
            m = DU._where(m < 0, trunc_mod(m + safe_r, safe_r), m)
        ok = ok1 & ok2
        return ColV(res, DU._where(ok, m, 0), ok)

    def _cast_operands(self, ctx, lv, rv):
        """Both operands at the result type: columns convert their storage,
        python scalars stay weak on the device path (torch keeps the
        tensor's dtype) and become numpy scalars on the CPU path. A decimal
        operand of a DOUBLE op enters as its real value."""
        dt = self.data_type

        def unscale(x, src):
            if is_decimal(src) and dt.is_floating:
                return DU.unscale_to_double(x, src.scale)
            return x

        def cast(x):
            if isinstance(x, torch.Tensor):
                want = to_torch(dt)
                return x if x.dtype == want else x.to(want)
            if isinstance(x, np.ndarray):
                return x.astype(dt.to_np()) if x.dtype != dt.to_np() else x
            if ctx.is_device:
                return float(x) if dt.is_floating else int(x)
            return dt.to_np().type(x)

        return (cast(unscale(_d(lv), self.left.data_type)),
                cast(unscale(_d(rv), self.right.data_type)))


class Add(BinaryArithmetic):
    _decimal_result = staticmethod(DU.add_result_type)

    def do_columnar(self, ctx, lv, rv):
        if self._decimal_types() is not None:
            return self._decimal_addsub(lv, rv, +1)
        l, r = self._cast_operands(ctx, lv, rv)
        return l + r


class Subtract(BinaryArithmetic):
    _decimal_result = staticmethod(DU.add_result_type)

    def do_columnar(self, ctx, lv, rv):
        if self._decimal_types() is not None:
            return self._decimal_addsub(lv, rv, -1)
        l, r = self._cast_operands(ctx, lv, rv)
        return l - r


class Multiply(BinaryArithmetic):
    _decimal_result = staticmethod(DU.multiply_result_type)

    def do_columnar(self, ctx, lv, rv):
        dts = self._decimal_types()
        if dts is not None:
            ld, rd, res = dts
            prod, ok1 = DU.checked_mul(_d(lv), _d(rv))
            # natural scale ld.scale + rd.scale; adjust may have shrunk it
            prod, ok2 = DU.rescale(prod, ld.scale + rd.scale, res.scale)
            prod, ok3 = DU.fit_precision(prod, res.precision)
            ok = ok1 & ok2 & ok3
            return ColV(res, DU._where(ok, prod, 0), ok)
        l, r = self._cast_operands(ctx, lv, rv)
        return l * r


def _zero_divisor_nulls(ctx, out, rv):
    """x % 0 and pmod(x, 0) are SQL NULL."""
    if isinstance(out, ColV):
        if isinstance(rv, ColV):
            validity = out.validity & (rv.data != 0)
        elif rv.value == 0:
            validity = out.validity & False
        else:
            validity = out.validity
        return ColV(out.dtype, zero_nulls(out.data, validity), validity)
    if out.value is not None and isinstance(rv, ScalarV) and rv.value == 0:
        out.value = None
    return out


def _safe_divisor(ctx, r, is_float: bool):
    """Divisor with zero lanes (NULL anyway) replaced by 1. On the device
    path -1 also becomes 1 for integers: x % -1 == 0 == x % 1, and the C
    remainder of INT64_MIN by -1 traps on the card."""
    if not isinstance(r, (torch.Tensor, np.ndarray)):
        bad = r == 0 or (ctx.is_device and not is_float and r == -1)
        return type(r)(1) if bad else r
    if isinstance(r, torch.Tensor):
        bad = (r == 0) if is_float else (r == 0) | (r == -1)
        return torch.where(bad, torch.ones((), dtype=r.dtype,
                                           device=r.device), r)
    return np.where(r == 0, 1, r)


def _trunc_mod_np(a, n):
    """Truncated remainder for numpy ints: a - trunc_div(a, n) * n."""
    q = a // n
    rem = a - q * n
    adj = (rem != 0) & ((a < 0) ^ (n < 0))
    return a - (q + adj) * n


class Remainder(BinaryArithmetic):
    """SQL % — sign follows the dividend (C semantics, like Spark)."""

    _decimal_result = staticmethod(DU.remainder_result_type)

    @property
    def nullable(self):
        return True

    def eval_kernel(self, ctx, lv, rv):
        return _zero_divisor_nulls(ctx, super().eval_kernel(ctx, lv, rv), rv)

    def do_columnar(self, ctx, lv, rv):
        if self._decimal_types() is not None:
            return self._decimal_mod(lv, rv, positive=False)
        l, r = self._cast_operands(ctx, lv, rv)
        is_float = self.data_type.is_floating
        safe_r = _safe_divisor(ctx, r, is_float)
        if isinstance(safe_r, torch.Tensor) and \
                not isinstance(l, torch.Tensor):
            l = torch.full_like(safe_r, l)
        if isinstance(l, torch.Tensor):
            return torch.fmod(l, safe_r)
        if is_float:
            return np.fmod(l, safe_r)
        return _trunc_mod_np(l, safe_r)


class Pmod(BinaryArithmetic):
    """pmod(a, b): positive modulus (reference: GpuPmod); the result's sign
    follows the divisor, as in Spark/Hive."""

    _decimal_result = staticmethod(DU.remainder_result_type)

    @property
    def nullable(self):
        return True

    def eval_kernel(self, ctx, lv, rv):
        return _zero_divisor_nulls(ctx, super().eval_kernel(ctx, lv, rv), rv)

    def do_columnar(self, ctx, lv, rv):
        if self._decimal_types() is not None:
            return self._decimal_mod(lv, rv, positive=True)
        l, r = self._cast_operands(ctx, lv, rv)
        is_float = self.data_type.is_floating
        safe_r = _safe_divisor(ctx, r, is_float)
        if isinstance(safe_r, torch.Tensor) and \
                not isinstance(l, torch.Tensor):
            l = torch.full_like(safe_r, l)
        if isinstance(l, torch.Tensor):
            m = torch.fmod(l, safe_r)
            return torch.where(m < 0, torch.fmod(m + safe_r, safe_r), m)
        if is_float:
            m = np.fmod(l, safe_r)
            return np.where(m < 0, np.fmod(m + safe_r, safe_r), m)
        m = _trunc_mod_np(l, safe_r)
        return np.where(m < 0, _trunc_mod_np(m + safe_r, safe_r), m)


class Divide(BinaryArithmetic):
    """SQL / (reference: arithmetic.py:228; Spark Divide): DOUBLE, both
    operands widened, or decimal division at Spark's result type (HALF_UP)
    when both sides are decimal-coercible and one is decimal. x / 0 is
    NULL."""

    _decimal_result = staticmethod(DU.divide_result_type)

    @property
    def data_type(self):
        dts = self._decimal_types()
        if dts is not None:
            return dts[2]
        super().data_type  # the operand type check
        return DataType.FLOAT64

    @property
    def nullable(self):
        return True

    def eval_kernel(self, ctx, lv, rv):
        return _zero_divisor_nulls(ctx, super().eval_kernel(ctx, lv, rv), rv)

    def do_columnar(self, ctx, lv, rv):
        dts = self._decimal_types()
        if dts is not None:
            ld, rd, res = dts
            l = DU._i64(_d(lv))
            r = DU._i64(_d(rv))
            # the numerator at the result scale, then a HALF_UP divide
            k = res.scale - ld.scale + rd.scale
            if k >= 0:
                num, ok1 = DU.checked_mul_pow10(l, k)
                q, ok2 = DU.div_half_up(num, r)
            else:
                q0, ok1 = DU.div_half_up(l, r)
                q, ok2 = DU.rescale(q0, ld.scale - rd.scale, res.scale)
            q, ok3 = DU.fit_precision(q, res.precision)
            ok = ok1 & ok2 & ok3
            return ColV(res, DU._where(ok, q, 0), ok)
        l, r = _d(lv), _d(rv)
        if is_decimal(self.left.data_type):
            l = DU.unscale_to_double(l, self.left.data_type.scale)
        if is_decimal(self.right.data_type):
            r = DU.unscale_to_double(r, self.right.data_type.scale)
        if isinstance(l, torch.Tensor) or isinstance(r, torch.Tensor):
            dev = (l if isinstance(l, torch.Tensor) else r).device
            l = torch.as_tensor(l, dtype=torch.float64, device=dev)
            r = torch.as_tensor(r, dtype=torch.float64, device=dev)
            return l / torch.where(r == 0, torch.ones_like(r), r)
        l = np.asarray(l, dtype=np.float64)
        r = np.asarray(r, dtype=np.float64)
        return l / np.where(r == 0, 1.0, r)


def _trunc_div(l, r):
    """Integer division toward zero, the divisor never 0; INT64_MIN div -1
    wraps (torch's trunc division of it is undefined, so -1 negates)."""
    if isinstance(l, torch.Tensor) or isinstance(r, torch.Tensor):
        dev = (l if isinstance(l, torch.Tensor) else r).device
        l = torch.as_tensor(l, dtype=torch.int64, device=dev)
        r = torch.as_tensor(r, dtype=torch.int64, device=dev)
        minus_one = r == -1
        safe = torch.where(minus_one, torch.ones_like(r), r)
        return torch.where(minus_one, -l,
                           torch.div(l, safe, rounding_mode="trunc"))
    l = np.asarray(l, dtype=np.int64)
    r = np.asarray(r, dtype=np.int64)
    q = l // r
    rem = l - q * r
    return q + ((rem != 0) & ((l < 0) ^ (r < 0))).astype(np.int64)


class IntegralDivide(BinaryExpression):
    """SQL div: integer division toward zero returning LONG (reference
    :261, Spark IntegralDivide); x div 0 is NULL. Over a DECIMAL operand
    both sides come to one scale first, and an overflow there is NULL
    (reference :297-318)."""

    @property
    def data_type(self):
        return DataType.INT64

    @property
    def nullable(self):
        return True

    def eval_kernel(self, ctx, lv, rv):
        return _zero_divisor_nulls(ctx, super().eval_kernel(ctx, lv, rv), rv)

    def do_columnar(self, ctx, lv, rv):
        l, r = _d(lv), _d(rv)
        lt, rt = self.left.data_type, self.right.data_type
        ok = None
        if is_decimal(lt) or is_decimal(rt):
            s1 = lt.scale if is_decimal(lt) else 0
            s2 = rt.scale if is_decimal(rt) else 0
            l, r = DU._i64(l), DU._i64(r)
            if s2 > s1:
                l, ok = DU.checked_mul_pow10(l, s2 - s1)
            elif s1 > s2:
                r, ok = DU.checked_mul_pow10(r, s1 - s2)
        if isinstance(r, (torch.Tensor, np.ndarray)):
            r = DU._where(r == 0, 1, r)
        elif r == 0:
            r = 1
        q = _trunc_div(l, r)
        if ok is None:
            return q
        return ColV(DataType.INT64, DU._where(ok, q, 0), ok)


class UnaryMinus(UnaryExpression):
    """-x; integers wrap at their type (-INT_MIN == INT_MIN)."""

    @property
    def data_type(self):
        return self.child.data_type

    def do_columnar(self, ctx, v):
        return -v.data


class UnaryPositive(UnaryExpression):
    @property
    def data_type(self):
        return self.child.data_type

    def do_columnar(self, ctx, v):
        return v.data


class Abs(UnaryExpression):
    """abs(x); integers wrap at their type (abs(INT_MIN) == INT_MIN)."""

    @property
    def data_type(self):
        return self.child.data_type

    def do_columnar(self, ctx, v):
        d = v.data
        return torch.abs(d) if isinstance(d, torch.Tensor) else np.abs(d)


class Signum(UnaryExpression):
    """signum(x) as a DOUBLE. The card keeps NaN and a signed zero, as the
    reference's device path (jnp.sign) does; the CPU engine is numpy's
    sign, as the reference's CPU engine (NaN stays, -0.0 gives 0.0)."""

    @property
    def data_type(self):
        return DataType.FLOAT64

    def do_columnar(self, ctx, v):
        d = v.data
        if isinstance(d, torch.Tensor):
            d = d.to(torch.float64)
            one = torch.ones((), dtype=torch.float64, device=d.device)
            return torch.where(d > 0, one, torch.where(d < 0, -one, d))
        return np.sign(d).astype(np.float64)
