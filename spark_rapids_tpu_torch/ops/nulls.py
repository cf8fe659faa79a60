"""Null-handling expressions (port of spark_rapids_tpu/ops/nulls.py;
reference: nullExpressions.scala — coalesce, isnull/isnotnull, isnan,
nanvl, AtLeastNNonNulls)."""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import (
    BinaryExpression,
    Expression,
    UnaryExpression,
    _d,
)
from spark_rapids_tpu_torch.ops.values import (
    ColV,
    ScalarV,
    broadcast_scalar,
    where,
    zero_nulls,
)


class IsNull(UnaryExpression):
    @property
    def data_type(self):
        return DataType.BOOL

    @property
    def nullable(self):
        return False

    def eval_kernel(self, ctx, v):
        if isinstance(v, ScalarV):
            return ScalarV(DataType.BOOL, v.is_null)
        data = ~v.validity
        validity = ctx.bools(True)
        if ctx.is_device:
            validity = validity & ctx.row_mask()
            data = data & validity
        return ColV(DataType.BOOL, data, validity)


class IsNotNull(UnaryExpression):
    @property
    def data_type(self):
        return DataType.BOOL

    @property
    def nullable(self):
        return False

    def eval_kernel(self, ctx, v):
        if isinstance(v, ScalarV):
            return ScalarV(DataType.BOOL, not v.is_null)
        validity = ctx.bools(True)
        if ctx.is_device:
            validity = validity & ctx.row_mask()
        return ColV(DataType.BOOL, v.validity & validity, validity)


class Coalesce(Expression):
    def __init__(self, *exprs: Expression):
        assert exprs
        self.exprs = tuple(exprs)

    def children(self):
        return self.exprs

    def with_children(self, new_children):
        return Coalesce(*new_children)

    @property
    def data_type(self):
        return self.exprs[0].data_type

    @property
    def nullable(self):
        return all(e.nullable for e in self.exprs)

    def eval_kernel(self, ctx, *vals):
        if all(isinstance(v, ScalarV) for v in vals):
            for v in vals:
                if not v.is_null:
                    return ScalarV(self.data_type, v.value)
            return ScalarV(self.data_type, None)
        if self.data_type is DataType.STRING:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.string_coalesce(ctx, vals)
        cols = [broadcast_scalar(ctx, ScalarV(self.data_type, v.value))
                if isinstance(v, ScalarV) else v for v in vals]
        data = cols[-1].data
        validity = cols[-1].validity
        for c in reversed(cols[:-1]):
            data = where(c.validity, c.data, data)
            validity = c.validity | validity
        if ctx.is_device:
            validity = validity & ctx.row_mask()
            data = zero_nulls(data, validity)
        return ColV(self.data_type, data, validity)


def _isnan(x):
    if isinstance(x, torch.Tensor):
        return torch.isnan(x)
    return np.isnan(x) if np.asarray(x).dtype.kind == "f" else \
        np.zeros(np.shape(x), dtype=bool)


class IsNan(UnaryExpression):
    """isnan(x): true for a NaN, false for NULL (reference :56)."""

    @property
    def data_type(self):
        return DataType.BOOL

    @property
    def nullable(self):
        return False

    def eval_kernel(self, ctx, v):
        if isinstance(v, ScalarV):
            return ScalarV(DataType.BOOL, v.value is not None and
                           isinstance(v.value, float) and
                           np.isnan(v.value))
        data = _isnan(v.data) & v.validity
        validity = ctx.bools(True)
        if ctx.is_device:
            validity = validity & ctx.row_mask()
            data = data & validity
        return ColV(DataType.BOOL, data, validity)


class NaNvl(BinaryExpression):
    """nanvl(a, b): b where a is NaN, else a, at a's type (reference
    :79)."""

    @property
    def data_type(self):
        return self.left.data_type

    def do_columnar(self, ctx, lv, rv):
        from spark_rapids_tpu_torch.ops.bitwise import _at

        dt = self.data_type
        l, r = _at(_d(lv), dt), _at(_d(rv), dt)
        if isinstance(l, torch.Tensor):
            if not isinstance(r, torch.Tensor):
                r = torch.full((), r, dtype=l.dtype, device=l.device)
            return torch.where(torch.isnan(l), r, l)
        if isinstance(r, torch.Tensor):
            l = torch.full((), l, dtype=r.dtype, device=r.device)
            return torch.where(torch.isnan(l), r, l)
        return np.where(_isnan(l), r, l)


class AtLeastNNonNulls(Expression):
    """True when at least n of the values are non-NULL and not NaN
    (reference :143)."""

    def __init__(self, n: int, *exprs: Expression):
        self.n = n
        self.exprs = tuple(exprs)

    def children(self):
        return self.exprs

    def with_children(self, new_children):
        return AtLeastNNonNulls(self.n, *new_children)

    @property
    def data_type(self):
        return DataType.BOOL

    @property
    def nullable(self):
        return False

    def eval_kernel(self, ctx, *vals):
        count = ctx.full(0, DataType.INT32)
        for v in vals:
            if isinstance(v, ScalarV):
                if not v.is_null:
                    count = count + 1
                continue
            valid = v.validity
            if v.dtype.is_floating:
                valid = valid & ~_isnan(v.data)
            count = count + (valid.to(torch.int32)
                             if isinstance(valid, torch.Tensor)
                             else valid.astype(np.int32))
        data = count >= self.n
        validity = ctx.bools(True)
        if ctx.is_device:
            validity = validity & ctx.row_mask()
            data = data & validity
        return ColV(DataType.BOOL, data, validity)

    def _fingerprint_extra(self):
        return f"{self.n};"
