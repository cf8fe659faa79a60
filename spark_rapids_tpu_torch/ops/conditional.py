"""Conditional expressions (port of spark_rapids_tpu/ops/conditional.py;
reference: conditionalExpressions.scala — IF and CASE WHEN).

Numeric branches merge with `where` (torch.where on the card, np.where on
the CPU engine), last branch first, so the first true condition wins; on
the card the validity is then masked by the row mask (reference :54-57).
STRING branches go through `columnar/strings.py:string_select`, which
gathers each row's bytes from the chosen branch with kernel K7. A NULL
condition counts as false.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import Expression, TernaryExpression
from spark_rapids_tpu_torch.ops.values import (
    ColV,
    ScalarV,
    broadcast_scalar,
    where,
    zero_nulls,
)


def _cond_parts(ctx, v):
    """True where a predicate value holds and is not NULL (reference :12)."""
    if isinstance(v, ScalarV):
        return ctx.bools((not v.is_null) and bool(v.value))
    data = v.data
    if isinstance(data, torch.Tensor):
        data = data if data.dtype == torch.bool else data != 0
    else:
        data = data.astype(bool)
    return data & v.validity


def _merge_branch(ctx, pred_true, then_v, else_data, else_valid):
    if isinstance(then_v, ScalarV):
        then_v = broadcast_scalar(ctx, then_v)
    return (where(pred_true, then_v.data, else_data),
            where(pred_true, then_v.validity, else_valid))


def _row_masked(ctx, data, valid):
    if ctx.is_device:
        valid = valid & ctx.row_mask()
        data = zero_nulls(data, valid)
    return data, valid


class If(TernaryExpression):
    """IF(pred, then, else) (reference :34)."""

    @property
    def data_type(self):
        return self.b.data_type if self.b.data_type is not DataType.NULL \
            else self.c.data_type

    def eval_kernel(self, ctx, pred, tv, fv):
        if isinstance(pred, ScalarV) and isinstance(tv, ScalarV) and \
                isinstance(fv, ScalarV):
            taken = tv if ((not pred.is_null) and bool(pred.value)) else fv
            return ScalarV(self.data_type, taken.value)
        pred_true = _cond_parts(ctx, pred)
        if self.data_type is DataType.STRING:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.string_select(ctx, pred_true, tv, fv)
        if isinstance(fv, ScalarV):
            fv = broadcast_scalar(ctx, ScalarV(self.data_type, fv.value))
        data, valid = _merge_branch(ctx, pred_true, tv, fv.data, fv.validity)
        data, valid = _row_masked(ctx, data, valid)
        return ColV(self.data_type, data, valid)


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 [WHEN c2 THEN v2]... [ELSE e] END (reference
    :75)."""

    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        assert branches
        self.branches = tuple((c, v) for c, v in branches)
        self.else_value = else_value

    def children(self):
        out: List[Expression] = []
        for c, v in self.branches:
            out.extend((c, v))
        if self.else_value is not None:
            out.append(self.else_value)
        return tuple(out)

    def with_children(self, new_children):
        n = len(self.branches)
        branches = [(new_children[2 * i], new_children[2 * i + 1])
                    for i in range(n)]
        else_v = new_children[2 * n] if len(new_children) > 2 * n else None
        return CaseWhen(branches, else_v)

    @property
    def data_type(self):
        return self.branches[0][1].data_type

    @property
    def nullable(self):
        if self.else_value is None:
            return True
        return any(v.nullable for _, v in self.branches) or \
            self.else_value.nullable

    def eval_kernel(self, ctx, *vals):
        n = len(self.branches)
        conds = [vals[2 * i] for i in range(n)]
        thens = [vals[2 * i + 1] for i in range(n)]
        else_v = vals[2 * n] if len(vals) > 2 * n else \
            ScalarV(self.data_type, None)
        if self.data_type is DataType.STRING:
            from spark_rapids_tpu_torch.columnar import strings as S

            result = else_v
            for c, t in zip(reversed(conds), reversed(thens)):
                result = S.string_select(ctx, _cond_parts(ctx, c), t, result)
            return result
        if isinstance(else_v, ScalarV):
            else_v = broadcast_scalar(ctx, ScalarV(self.data_type,
                                                   else_v.value))
        data, valid = else_v.data, else_v.validity
        for c, t in zip(reversed(conds), reversed(thens)):
            data, valid = _merge_branch(ctx, _cond_parts(ctx, c), t, data,
                                        valid)
        data, valid = _row_masked(ctx, data, valid)
        return ColV(self.data_type, data, valid)
