"""Comparisons and logical operators (port of spark_rapids_tpu/ops/predicates.py;
reference: predicates.scala). And/Or use Kleene three-valued logic like
Spark; `In` tests a value against a list of literals.

Comparison type promotion follows the reference's numpy/jnp rules
(predicates.py:46 compares the raw operands): two columns promote to their
common type, and a python scalar is weak — `b < 0.9` with `b` FLOAT
compares in float32 on both engines. torch would compare an INTEGER tensor
with a python float in float32 (its default dtype) where numpy uses float64,
so the device path widens that one case explicitly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import (
    BinaryExpression,
    Expression,
    UnaryExpression,
    _d,
)
from spark_rapids_tpu_torch.ops.values import ColV, ScalarV

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _operands(lv, rv):
    return _promote(_d(lv), _d(rv))


def _promote(l, r):
    """Raw operands of a comparison, a python scalar weak as described
    above."""
    if isinstance(l, torch.Tensor) != isinstance(r, torch.Tensor):
        t, s = (l, r) if isinstance(l, torch.Tensor) else (r, l)
        if isinstance(s, float) and not t.is_floating_point():
            t = t.to(torch.float64)
        elif isinstance(s, int) and not isinstance(s, bool) and \
                t.dtype in (torch.int8, torch.int16, torch.int32) and \
                not _I32_MIN <= s <= _I32_MAX:
            t = t.to(torch.int64)
        l, r = (t, s) if isinstance(l, torch.Tensor) else (s, t)
    return l, r


class BinaryComparison(BinaryExpression):
    """STRING operands compare through columnar/strings.py (reference:
    predicates.py:54-94): kernel K8 on the device, the decoded strings on
    the CPU engine. Null propagation is the template's."""

    op = ""

    @property
    def data_type(self):
        return DataType.BOOL

    def do_columnar(self, ctx, lv, rv):
        if self.left.data_type is DataType.STRING:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.string_compare(ctx, lv, rv, self.op)
        lt, rt = self.left.data_type, self.right.data_type
        if lt.is_decimal or rt.is_decimal:
            return self._cmp(*_decimal_operands(lv, rv, lt, rt))
        return self._cmp(*_operands(lv, rv))


def _scalar(x):
    return x.item() if isinstance(x, np.generic) else x


def _decimal_operands(lv, rv, lt, rt):
    """Operands of a comparison with a DECIMAL side (reference:
    predicates.py:29-45): two decimal-coercible sides rescale to their
    common scale (saturating, so order survives an overflow); a decimal
    against a float compares as DOUBLE."""
    from spark_rapids_tpu_torch.ops import decimal_util as DU

    ld, rd = DU.as_decimal_type(lt), DU.as_decimal_type(rt)
    if ld is not None and rd is not None:
        s = max(ld.scale, rd.scale)
        return (_scalar(DU.compare_rescale(_d(lv), ld.scale, s)),
                _scalar(DU.compare_rescale(_d(rv), rd.scale, s)))

    def unscale(x, dt):
        if not dt.is_decimal:
            return x
        return _scalar(DU.unscale_to_double(x, dt.scale))

    return _promote(unscale(_d(lv), lt), unscale(_d(rv), rt))


class EqualTo(BinaryComparison):
    op = "eq"

    @staticmethod
    def _cmp(l, r):
        return l == r


class LessThan(BinaryComparison):
    op = "lt"

    @staticmethod
    def _cmp(l, r):
        return l < r


class LessThanOrEqual(BinaryComparison):
    op = "le"

    @staticmethod
    def _cmp(l, r):
        return l <= r


class GreaterThan(BinaryComparison):
    op = "gt"

    @staticmethod
    def _cmp(l, r):
        return l > r


class GreaterThanOrEqual(BinaryComparison):
    op = "ge"

    @staticmethod
    def _cmp(l, r):
        return l >= r


def _bool_parts(ctx, v):
    if isinstance(v, ScalarV):
        if v.is_null:
            return ctx.bools(False), ctx.bools(False)
        return ctx.bools(bool(v.value)), ctx.bools(True)
    data = v.data
    if ctx.is_device:
        data = data if data.dtype == torch.bool else data != 0
    else:
        data = data.astype(bool)
    return data, v.validity


class And(BinaryExpression):
    """Kleene AND: F&null=F, T&null=null."""

    @property
    def data_type(self):
        return DataType.BOOL

    def eval_kernel(self, ctx, lv, rv):
        ld, lval = _bool_parts(ctx, lv)
        rd, rval = _bool_parts(ctx, rv)
        data = ld & rd
        false_somewhere = (~ld & lval) | (~rd & rval)
        validity = (lval & rval) | false_somewhere
        data = data & validity
        if ctx.is_device:
            validity = validity & ctx.row_mask()
            data = data & validity
        return ColV(DataType.BOOL, data, validity)


class Or(BinaryExpression):
    """Kleene OR: T|null=T, F|null=null."""

    @property
    def data_type(self):
        return DataType.BOOL

    def eval_kernel(self, ctx, lv, rv):
        ld, lval = _bool_parts(ctx, lv)
        rd, rval = _bool_parts(ctx, rv)
        data = ld | rd
        true_somewhere = (ld & lval) | (rd & rval)
        validity = (lval & rval) | true_somewhere
        data = data & validity
        if ctx.is_device:
            validity = validity & ctx.row_mask()
            data = data & validity
        return ColV(DataType.BOOL, data, validity)


class Not(UnaryExpression):
    @property
    def data_type(self):
        return DataType.BOOL

    def do_columnar(self, ctx, v):
        data = v.data
        if isinstance(data, torch.Tensor):
            return ~(data if data.dtype == torch.bool else data != 0)
        return ~data.astype(bool)


class In(Expression):
    """value IN (foldable literals) (reference: predicates.py:206-249,
    GpuInSet). Numeric candidates compare as tensor ops, a STRING
    candidate as one equality each (K8 on the device). SQL: with a NULL
    candidate the result is NULL unless the value matched."""

    def __init__(self, value: Expression, candidates: Sequence[Expression]):
        self.value = value
        self.candidates = tuple(candidates)

    def children(self):
        return (self.value,) + self.candidates

    def with_children(self, new_children):
        return In(new_children[0], new_children[1:])

    @property
    def data_type(self):
        return DataType.BOOL

    def eval_kernel(self, ctx, v, *cand_vals):
        if isinstance(v, ScalarV):
            if v.is_null:
                return ScalarV(DataType.BOOL, None)
            hit = any((not c.is_null) and c.value == v.value
                      for c in cand_vals)
            has_null = any(c.is_null for c in cand_vals)
            return ScalarV(DataType.BOOL,
                           True if hit else (None if has_null else False))
        acc = ctx.bools(False)
        has_null_candidate = False
        for c in cand_vals:
            if c.is_null:
                has_null_candidate = True
                continue
            if self.value.data_type is DataType.STRING:
                from spark_rapids_tpu_torch.columnar import strings as S

                acc = acc | S.string_compare(ctx, v, c, "eq")
            else:
                acc = acc | EqualTo._cmp(*_operands(v, c))
        validity = v.validity & (acc | ctx.bools(not has_null_candidate))
        return ColV(DataType.BOOL, acc & validity, validity)


class EqualNullSafe(BinaryExpression):
    """<=>: null-safe equality, NULL <=> NULL is true and the result is
    never NULL (reference :99). A scalar side broadcasts at its own type,
    so two sides compare at their common type."""

    @property
    def data_type(self):
        return DataType.BOOL

    @property
    def nullable(self):
        return False

    def eval_kernel(self, ctx, lv, rv):
        from spark_rapids_tpu_torch.ops.values import broadcast_scalar

        if self.left.data_type is DataType.STRING:
            from spark_rapids_tpu_torch.columnar import strings as S

            if isinstance(lv, ScalarV) and isinstance(rv, ScalarV):
                return ScalarV(DataType.BOOL, lv.value == rv.value)
            if isinstance(lv, ScalarV) and lv.is_null or \
                    isinstance(rv, ScalarV) and rv.is_null:
                eq = ctx.bools(False)
            else:
                eq = S.string_compare(ctx, lv, rv, "eq")
            lvalid = lv.validity if isinstance(lv, ColV) else \
                ctx.bools(not lv.is_null)
            rvalid = rv.validity if isinstance(rv, ColV) else \
                ctx.bools(not rv.is_null)
        else:
            if isinstance(lv, ScalarV) and isinstance(rv, ScalarV):
                if lv.is_null or rv.is_null:
                    return ScalarV(DataType.BOOL, lv.is_null and rv.is_null)
                return ScalarV(DataType.BOOL, bool(lv.value == rv.value))
            lc = broadcast_scalar(ctx, lv) if isinstance(lv, ScalarV) else lv
            rc = broadcast_scalar(ctx, rv) if isinstance(rv, ScalarV) else rv
            l, r = lc.data, rc.data
            if isinstance(l, torch.Tensor) and l.dtype != r.dtype:
                common = torch.promote_types(l.dtype, r.dtype)
                l, r = l.to(common), r.to(common)
            eq = l == r
            lvalid, rvalid = lc.validity, rc.validity
        data = (lvalid & rvalid & eq) | (~lvalid & ~rvalid)
        validity = ctx.bools(True)
        if ctx.is_device:
            validity = validity & ctx.row_mask()
            data = data & validity
        return ColV(DataType.BOOL, data, validity)
