"""Arithmetic expressions (port of spark_rapids_tpu/ops/arithmetic.py; reference:
org/apache/spark/sql/rapids/arithmetic.scala — +, -, *, /, remainder, pmod).

Decimal operands wait for slice 2 of the port. Integer arithmetic wraps at
the result type on both engines (numpy and torch both wrap int64).

Spark `%` is the TRUNCATED remainder (sign follows the dividend). A tensor's
`%` operator is floor-mod, so the device path uses `torch.fmod`, which is
truncated for integers and floats alike; the CPU path keeps the reference's
numpy formulation (arithmetic.py:404-414).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, common_type, to_torch
from spark_rapids_tpu_torch.ops.base import BinaryExpression, _d
from spark_rapids_tpu_torch.ops.values import ColV, ScalarV, zero_nulls


class BinaryArithmetic(BinaryExpression):
    @property
    def data_type(self):
        ct = common_type(self.left.data_type, self.right.data_type)
        if ct is None or getattr(ct, "is_decimal", False):
            raise TypeError(
                f"{type(self).__name__}: incompatible types "
                f"{self.left.data_type} / {self.right.data_type}")
        return ct

    def _cast_operands(self, ctx, lv, rv):
        """Both operands at the result type: columns convert their storage,
        python scalars stay weak on the device path (torch keeps the
        tensor's dtype) and become numpy scalars on the CPU path."""
        dt = self.data_type

        def cast(x):
            if isinstance(x, torch.Tensor):
                want = to_torch(dt)
                return x if x.dtype == want else x.to(want)
            if isinstance(x, np.ndarray):
                return x.astype(dt.to_np()) if x.dtype != dt.to_np() else x
            if ctx.is_device:
                return float(x) if dt.is_floating else int(x)
            return dt.to_np().type(x)

        return cast(_d(lv)), cast(_d(rv))


class Add(BinaryArithmetic):
    def do_columnar(self, ctx, lv, rv):
        l, r = self._cast_operands(ctx, lv, rv)
        return l + r


class Subtract(BinaryArithmetic):
    def do_columnar(self, ctx, lv, rv):
        l, r = self._cast_operands(ctx, lv, rv)
        return l - r


class Multiply(BinaryArithmetic):
    def do_columnar(self, ctx, lv, rv):
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

    @property
    def nullable(self):
        return True

    def eval_kernel(self, ctx, lv, rv):
        return _zero_divisor_nulls(ctx, super().eval_kernel(ctx, lv, rv), rv)

    def do_columnar(self, ctx, lv, rv):
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

    @property
    def nullable(self):
        return True

    def eval_kernel(self, ctx, lv, rv):
        return _zero_divisor_nulls(ctx, super().eval_kernel(ctx, lv, rv), rv)

    def do_columnar(self, ctx, lv, rv):
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
    """SQL / on DOUBLE (reference: arithmetic.py:228, its floating branch;
    Spark Divide): both operands widen to double, x / 0 is NULL. Decimal
    division waits with the decimals."""

    @property
    def data_type(self):
        super().data_type  # the operand type check
        return DataType.FLOAT64

    @property
    def nullable(self):
        return True

    def eval_kernel(self, ctx, lv, rv):
        return _zero_divisor_nulls(ctx, super().eval_kernel(ctx, lv, rv), rv)

    def do_columnar(self, ctx, lv, rv):
        l, r = _d(lv), _d(rv)
        if isinstance(l, torch.Tensor) or isinstance(r, torch.Tensor):
            dev = (l if isinstance(l, torch.Tensor) else r).device
            l = torch.as_tensor(l, dtype=torch.float64, device=dev)
            r = torch.as_tensor(r, dtype=torch.float64, device=dev)
            return l / torch.where(r == 0, torch.ones_like(r), r)
        l = np.asarray(l, dtype=np.float64)
        r = np.asarray(r, dtype=np.float64)
        return l / np.where(r == 0, 1.0, r)
