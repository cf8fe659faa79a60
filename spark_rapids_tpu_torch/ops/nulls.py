"""Null-handling expressions (port of spark_rapids_tpu/ops/nulls.py;
reference: nullExpressions.scala — coalesce, isnull/isnotnull)."""

from __future__ import annotations

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import Expression, UnaryExpression
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
