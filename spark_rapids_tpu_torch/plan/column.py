"""Column: the user-facing expression wrapper (port of
spark_rapids_tpu/plan/column.py, with the methods whose expressions the
port has: arithmetic, comparisons, logic, null tests, IN, the string
searches and LIKE, sorting, OVER a window)."""

from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.arithmetic import (
    Abs,
    Add,
    Divide,
    Multiply,
    Remainder,
    Subtract,
    UnaryMinus,
)
from spark_rapids_tpu_torch.ops.base import Alias, Expression, SortOrder
from spark_rapids_tpu_torch.ops.cast import Cast
from spark_rapids_tpu_torch.ops.literals import Literal
from spark_rapids_tpu_torch.ops.nulls import IsNotNull, IsNull
from spark_rapids_tpu_torch.ops.predicates import (
    And,
    EqualNullSafe,
    EqualTo,
    GreaterThan,
    GreaterThanOrEqual,
    LessThan,
    LessThanOrEqual,
    In,
    Not,
    Or,
)
from spark_rapids_tpu_torch.ops.stringops import (
    Contains,
    EndsWith,
    Like,
    StartsWith,
)


def _to_expr(v: Any) -> Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, Expression):
        return v
    return Literal(v)


class Column:
    __slots__ = ("expr",)

    def __init__(self, expr: Expression):
        self.expr = expr

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other):
        return Column(Add(self.expr, _to_expr(other)))

    def __radd__(self, other):
        return Column(Add(_to_expr(other), self.expr))

    def __sub__(self, other):
        return Column(Subtract(self.expr, _to_expr(other)))

    def __rsub__(self, other):
        return Column(Subtract(_to_expr(other), self.expr))

    def __mul__(self, other):
        return Column(Multiply(self.expr, _to_expr(other)))

    def __rmul__(self, other):
        return Column(Multiply(_to_expr(other), self.expr))

    def __truediv__(self, other):
        return Column(Divide(self.expr, _to_expr(other)))

    def __rtruediv__(self, other):
        return Column(Divide(_to_expr(other), self.expr))

    def __mod__(self, other):
        return Column(Remainder(self.expr, _to_expr(other)))

    # -- comparisons ---------------------------------------------------------
    def __neg__(self):
        return Column(UnaryMinus(self.expr))

    def __abs__(self):
        return Column(Abs(self.expr))

    def eqNullSafe(self, other):
        return Column(EqualNullSafe(self.expr, _to_expr(other)))

    def __eq__(self, other):  # type: ignore[override]
        return Column(EqualTo(self.expr, _to_expr(other)))

    def __ne__(self, other):  # type: ignore[override]
        return Column(Not(EqualTo(self.expr, _to_expr(other))))

    def __lt__(self, other):
        return Column(LessThan(self.expr, _to_expr(other)))

    def __le__(self, other):
        return Column(LessThanOrEqual(self.expr, _to_expr(other)))

    def __gt__(self, other):
        return Column(GreaterThan(self.expr, _to_expr(other)))

    def __ge__(self, other):
        return Column(GreaterThanOrEqual(self.expr, _to_expr(other)))

    # -- boolean -------------------------------------------------------------
    def __and__(self, other):
        return Column(And(self.expr, _to_expr(other)))

    def __or__(self, other):
        return Column(Or(self.expr, _to_expr(other)))

    def __invert__(self):
        return Column(Not(self.expr))

    # -- misc ----------------------------------------------------------------
    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    name = alias

    def cast(self, dtype) -> "Column":
        if isinstance(dtype, str):
            dtype = DataType.parse(dtype)
        return Column(Cast(self.expr, dtype))

    def isNull(self) -> "Column":
        return Column(IsNull(self.expr))

    def isNotNull(self) -> "Column":
        return Column(IsNotNull(self.expr))

    def isin(self, *values) -> "Column":
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return Column(In(self.expr, [_to_expr(v) for v in values]))

    def like(self, pattern: str) -> "Column":
        return Column(Like(self.expr, Literal(pattern)))

    def startswith(self, s) -> "Column":
        return Column(StartsWith(self.expr, _to_expr(s)))

    def endswith(self, s) -> "Column":
        return Column(EndsWith(self.expr, _to_expr(s)))

    def contains(self, s) -> "Column":
        return Column(Contains(self.expr, _to_expr(s)))

    def over(self, window) -> "Column":
        """function OVER window (reference :161, GpuWindowExpression)."""
        from spark_rapids_tpu_torch.ops.window import WindowExpression

        return Column(WindowExpression(self.expr, window.to_spec()))

    def between(self, lo, hi) -> "Column":
        return Column(And(GreaterThanOrEqual(self.expr, _to_expr(lo)),
                          LessThanOrEqual(self.expr, _to_expr(hi))))

    # -- sorting -------------------------------------------------------------
    def asc(self) -> SortOrder:
        return SortOrder(self.expr, True)

    def desc(self) -> SortOrder:
        return SortOrder(self.expr, False)

    def asc_nulls_last(self) -> SortOrder:
        return SortOrder(self.expr, True, nulls_first=False)

    def desc_nulls_first(self) -> SortOrder:
        return SortOrder(self.expr, False, nulls_first=True)

    def __repr__(self):
        return f"Column<{self.expr!r}>"

    def __bool__(self):
        raise ValueError(
            "Cannot convert Column to bool; use & | ~ for boolean logic")

    def __hash__(self):
        return id(self)
