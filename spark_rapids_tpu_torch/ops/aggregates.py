"""Declarative aggregate functions (port of spark_rapids_tpu/ops/aggregates.py:
Sum, Count, Min, Max, Average, First, Last, Percentile; reference:
AggregateFunctions.scala).

Every aggregate is an update/merge pair of reduce ops plus a final
expression over its buffer attributes, which is what makes partial/final
aggregation composable across a shuffle:

- `update_aggs`: (buffer_name, reduce_op, input_expr) over raw input rows;
- `merge_aggs`:  (buffer_name, reduce_op) over partial buffers;
- `evaluate_expression`: result expression over the buffer attributes;
- `initial_buffer_values`: buffers of the empty ungrouped reduction.

A DECIMAL sum buffers the unscaled values as int64 partials (reference:
aggregates.py:125-332): one int64 sum and the count for precision <= 9
(`_NarrowDecimalSumFinish`), else the hi/lo split (arithmetic >> 32 and
& 0xFFFFFFFF on int64, `_DecimalSumFinish`); K3 reduces both as plain
int64 sums. The finishes give NULL, never a wrapped value, and
`_DecimalAvgFinish` divides HALF_UP at Spark's avg scale.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, DecimalType
from spark_rapids_tpu_torch.ops import decimal_util as DU
from spark_rapids_tpu_torch.ops.base import (
    AttributeReference,
    BinaryExpression,
    Expression,
    TernaryExpression,
    UnaryExpression,
    _d,
)
from spark_rapids_tpu_torch.ops.values import ColV

UpdateAgg = Tuple[str, str, Expression]
MergeAgg = Tuple[str, str]


class AggregateFunction(Expression):
    """Base marker; evaluated through the aggregate exec's buffers."""

    def __init__(self, child: Expression):
        self.child = child

    def children(self):
        return (self.child,)

    def with_children(self, new_children):
        return type(self)(*new_children)

    @property
    def nullable(self):
        return True

    def buffer_attrs(self) -> List[AttributeReference]:
        raise NotImplementedError

    def update_aggs(self) -> List[UpdateAgg]:
        raise NotImplementedError

    def merge_aggs(self) -> List[MergeAgg]:
        raise NotImplementedError

    def evaluate_expression(self, buffers: List[AttributeReference]) -> Expression:
        return buffers[0]

    def initial_buffer_values(self) -> List:
        """Buffer values of the empty ungrouped reduction (None = NULL)."""
        return [None] * len(self.buffer_attrs())

    def eval_kernel(self, ctx, *vals):
        raise RuntimeError("aggregate functions evaluate via the agg exec")


class Min(AggregateFunction):
    @property
    def data_type(self):
        return self.child.data_type

    def buffer_attrs(self):
        return [AttributeReference("min", self.data_type, True)]

    def update_aggs(self):
        return [("min", "min", self.child)]

    def merge_aggs(self):
        return [("min", "min")]


class Max(AggregateFunction):
    @property
    def data_type(self):
        return self.child.data_type

    def buffer_attrs(self):
        return [AttributeReference("max", self.data_type, True)]

    def update_aggs(self):
        return [("max", "max", self.child)]

    def merge_aggs(self):
        return [("max", "max")]


def _sum_type(dt):
    if dt.is_decimal:
        # Spark: sum(decimal(p, s)) -> decimal(p + 10, s), capped at 18
        return DecimalType(min(dt.precision + 10, DecimalType.MAX_PRECISION),
                           dt.scale)
    if dt in (DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64):
        return DataType.INT64
    return DataType.FLOAT64


def _shift32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) >> 32
    return x.astype(np.int64) >> np.int64(32)


def _low32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & 0xFFFFFFFF
    return x.astype(np.int64) & np.int64(0xFFFFFFFF)


class _UnscaledHi(UnaryExpression):
    """High 32 bits (arithmetic shift) of a decimal's unscaled int64."""

    @property
    def data_type(self):
        return DataType.INT64

    def do_columnar(self, ctx, v):
        return _shift32(v.data)


class _UnscaledLo(UnaryExpression):
    """Low 32 bits (non-negative) of a decimal's unscaled int64."""

    @property
    def data_type(self):
        return DataType.INT64

    def do_columnar(self, ctx, v):
        return _low32(v.data)


class _UnscaledRaw(UnaryExpression):
    """A decimal's unscaled int64 itself."""

    @property
    def data_type(self):
        return DataType.INT64

    def do_columnar(self, ctx, v):
        return DU._i64(v.data)


def _narrow_decimal(dt) -> bool:
    """precision <= 9 bounds |unscaled| below 2^31, so one int64 sum is
    exact below 2^32 rows a group and the hi/lo split is not needed
    (reference :155)."""
    return dt.precision <= 9


class _NarrowDecimalSumFinish(BinaryExpression):
    """(sum, count) -> decimal: NULL at 2^32 rows a group (where the one
    int64 partial could have wrapped) or beyond the result precision
    (reference :165)."""

    def __init__(self, s, n, result_type):
        super().__init__(s, n)
        self._result_type = result_type

    def with_children(self, new_children):
        return _NarrowDecimalSumFinish(new_children[0], new_children[1],
                                       self._result_type)

    @property
    def data_type(self):
        return self._result_type

    @property
    def nullable(self):
        return True

    def _fingerprint_extra(self):
        return f"{self._result_type.name};"

    def do_columnar(self, ctx, lv, nv):
        s = DU._i64(_d(lv))
        n = DU._i64(_d(nv))
        exact = n < (1 << 32)
        val, ok2 = DU.fit_precision(s, self._result_type.precision)
        ok = exact & ok2
        return ColV(self._result_type, DU._where(ok, val, 0), ok)


class _DecimalSumFinish(TernaryExpression):
    """Recombine the hi/lo partial sums into the decimal sum (reference
    :208): exact below 2^31 rows a group, NULL at or above it and beyond
    the result precision."""

    def __init__(self, hi, lo, n, result_type):
        super().__init__(hi, lo, n)
        self._result_type = result_type

    def with_children(self, new_children):
        return _DecimalSumFinish(new_children[0], new_children[1],
                                 new_children[2], self._result_type)

    @property
    def data_type(self):
        return self._result_type

    @property
    def nullable(self):
        return True

    def _fingerprint_extra(self):
        return f"{self._result_type.name};"

    def do_columnar(self, ctx, lv, rv, nv):
        hi = DU._i64(_d(lv))
        lo = DU._i64(_d(rv))
        n = DU._i64(_d(nv))
        exact = n < (1 << 31)
        total_hi = hi + _shift32(lo)
        rem = _low32(lo)
        fits = (total_hi >= -(1 << 31)) & (total_hi < (1 << 31))
        val = DU._where(fits, total_hi, 0) * (1 << 32) + rem
        val, ok2 = DU.fit_precision(val, self._result_type.precision)
        ok = exact & fits & ok2
        return ColV(self._result_type, DU._where(ok, val, 0), ok)


class Sum(AggregateFunction):
    @property
    def data_type(self):
        return _sum_type(self.child.data_type)

    @property
    def _is_decimal(self):
        return self.child.data_type.is_decimal

    @property
    def _narrow_dec(self):
        return self._is_decimal and _narrow_decimal(self.child.data_type)

    def buffer_attrs(self):
        if self._narrow_dec:
            return [AttributeReference("sum_u", DataType.INT64, True),
                    AttributeReference("sum_n", DataType.INT64, False)]
        if self._is_decimal:
            return [AttributeReference("sum_hi", DataType.INT64, True),
                    AttributeReference("sum_lo", DataType.INT64, True),
                    AttributeReference("sum_n", DataType.INT64, False)]
        return [AttributeReference("sum", self.data_type, True)]

    def update_aggs(self):
        from spark_rapids_tpu_torch.ops.cast import Cast

        if self._narrow_dec:
            return [("sum_u", "sum", _UnscaledRaw(self.child)),
                    ("sum_n", "count", self.child)]
        if self._is_decimal:
            return [("sum_hi", "sum", _UnscaledHi(self.child)),
                    ("sum_lo", "sum", _UnscaledLo(self.child)),
                    ("sum_n", "count", self.child)]
        src = self.child
        if src.data_type != self.data_type:
            src = Cast(src, self.data_type)
        return [("sum", "sum", src)]

    def merge_aggs(self):
        if self._narrow_dec:
            return [("sum_u", "sum"), ("sum_n", "sum")]
        if self._is_decimal:
            return [("sum_hi", "sum"), ("sum_lo", "sum"), ("sum_n", "sum")]
        return [("sum", "sum")]

    def evaluate_expression(self, buffers):
        if self._narrow_dec:
            return _NarrowDecimalSumFinish(buffers[0], buffers[1],
                                           self.data_type)
        if self._is_decimal:
            return _DecimalSumFinish(buffers[0], buffers[1], buffers[2],
                                     self.data_type)
        return buffers[0]

    def initial_buffer_values(self):
        if self._narrow_dec:
            return [None, 0]
        if self._is_decimal:
            return [None, None, 0]
        return [None]


class Count(AggregateFunction):
    """count(expr) — counts non-null; count(*) is Count(Literal(1))."""

    @property
    def data_type(self):
        return DataType.INT64

    @property
    def nullable(self):
        return False

    def buffer_attrs(self):
        return [AttributeReference("count", DataType.INT64, False)]

    def update_aggs(self):
        return [("count", "count", self.child)]

    def merge_aggs(self):
        return [("count", "sum")]

    def initial_buffer_values(self):
        return [0]


class _DecimalAvgFinish(BinaryExpression):
    """sum(decimal) / count, HALF_UP at Spark's avg scale (s + 4, bounded);
    an overflow is NULL (reference :364)."""

    def __init__(self, sum_expr, count_expr, sum_scale, result_type):
        super().__init__(sum_expr, count_expr)
        self._sum_scale = sum_scale
        self._result_type = result_type

    def with_children(self, new_children):
        return _DecimalAvgFinish(new_children[0], new_children[1],
                                 self._sum_scale, self._result_type)

    @property
    def data_type(self):
        return self._result_type

    @property
    def nullable(self):
        return True

    def _fingerprint_extra(self):
        return f"{self._sum_scale}->{self._result_type.name};"

    def do_columnar(self, ctx, lv, rv):
        k = self._result_type.scale - self._sum_scale
        num, ok1 = DU.checked_mul_pow10(DU._i64(_d(lv)), max(k, 0))
        q, ok2 = DU.div_half_up(num, DU._i64(_d(rv)))
        if k < 0:
            q, _ = DU.rescale(q, self._sum_scale, self._result_type.scale)
        q, ok3 = DU.fit_precision(q, self._result_type.precision)
        ok = ok1 & ok2 & ok3
        return ColV(self._result_type, DU._where(ok, q, 0), ok)


class Average(AggregateFunction):
    """avg as DOUBLE (buffers sum and count, finished as sum / count, NULL
    for no input rows), or over a DECIMAL as decimal(p + 4, s + 4) through
    the decimal sum's buffers (reference: aggregates.py:405)."""

    @property
    def _dec(self):
        dt = self.child.data_type
        return dt if dt.is_decimal else None

    @property
    def _narrow_dec(self):
        return self._dec is not None and _narrow_decimal(self._dec)

    @property
    def data_type(self):
        if self._dec is not None:
            return DU.bounded(self._dec.precision + 4, self._dec.scale + 4)
        return DataType.FLOAT64

    def buffer_attrs(self):
        if self._narrow_dec:
            return [AttributeReference("sum_u", DataType.INT64, True),
                    AttributeReference("count", DataType.INT64, False)]
        if self._dec is not None:
            return [AttributeReference("sum_hi", DataType.INT64, True),
                    AttributeReference("sum_lo", DataType.INT64, True),
                    AttributeReference("count", DataType.INT64, False)]
        return [AttributeReference("sum", DataType.FLOAT64, True),
                AttributeReference("count", DataType.INT64, False)]

    def update_aggs(self):
        from spark_rapids_tpu_torch.ops.cast import Cast

        if self._narrow_dec:
            return [("sum_u", "sum", _UnscaledRaw(self.child)),
                    ("count", "count", self.child)]
        if self._dec is not None:
            return [("sum_hi", "sum", _UnscaledHi(self.child)),
                    ("sum_lo", "sum", _UnscaledLo(self.child)),
                    ("count", "count", self.child)]
        src = self.child
        if src.data_type is not DataType.FLOAT64:
            src = Cast(src, DataType.FLOAT64)
        return [("sum", "sum", src), ("count", "count", self.child)]

    def merge_aggs(self):
        if self._narrow_dec:
            return [("sum_u", "sum"), ("count", "sum")]
        if self._dec is not None:
            return [("sum_hi", "sum"), ("sum_lo", "sum"), ("count", "sum")]
        return [("sum", "sum"), ("count", "sum")]

    def evaluate_expression(self, buffers):
        from spark_rapids_tpu_torch.ops.arithmetic import Divide
        from spark_rapids_tpu_torch.ops.cast import Cast

        if self._dec is not None:
            sum_type = _sum_type(self._dec)
            if self._narrow_dec:
                total = _NarrowDecimalSumFinish(buffers[0], buffers[1],
                                                sum_type)
            else:
                total = _DecimalSumFinish(buffers[0], buffers[1],
                                          buffers[2], sum_type)
            return _DecimalAvgFinish(total, buffers[-1], sum_type.scale,
                                     self.data_type)
        return Divide(buffers[0], Cast(buffers[1], DataType.FLOAT64))

    def initial_buffer_values(self):
        if self._dec is not None and not self._narrow_dec:
            return [None, None, 0]
        return [None, 0]


class First(AggregateFunction):
    """first(expr[, ignoreNulls]) in encounter order (reference :484)."""

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    _name = "first"

    def with_children(self, new_children):
        return type(self)(new_children[0], self.ignore_nulls)

    @property
    def data_type(self):
        return self.child.data_type

    @property
    def _op(self):
        return f"{self._name}_ignore_nulls" if self.ignore_nulls \
            else self._name

    def buffer_attrs(self):
        return [AttributeReference(self._name, self.data_type, True)]

    def update_aggs(self):
        return [(self._name, self._op, self.child)]

    def merge_aggs(self):
        return [(self._name, self._op)]

    def _fingerprint_extra(self):
        return f"{self.ignore_nulls};"


class Last(First):
    """last(expr[, ignoreNulls]) (reference :514)."""

    _name = "last"


class Percentile(AggregateFunction):
    """Exact percentile(col, p): linear interpolation at rank p * (n - 1)
    over the group's sorted non-null values, as DOUBLE (reference :544).

    Holistic: no update/merge partials, so the planner exchanges raw rows
    on the grouping keys into one complete-mode aggregate over a single
    batch per partition; on the card the `pct:<p>` reduction is kernel K19
    (exec/rowkeys.py:segment_percentile)."""

    holistic = True

    def __init__(self, child: Expression, p: float):
        super().__init__(child)
        if not (0.0 <= float(p) <= 1.0):
            raise ValueError(f"percentile fraction must be in [0, 1]: {p}")
        self.p = float(p)

    def with_children(self, new_children):
        return Percentile(new_children[0], self.p)

    def _fingerprint_extra(self):
        return f"p={self.p!r};"

    @property
    def data_type(self):
        return DataType.FLOAT64

    def buffer_attrs(self):
        return [AttributeReference("pct", DataType.FLOAT64, True)]

    def update_aggs(self):
        from spark_rapids_tpu_torch.ops.cast import Cast

        child = self.child
        if child.data_type is not DataType.FLOAT64:
            child = Cast(child, DataType.FLOAT64)
        return [("pct", f"pct:{self.p!r}", child)]

    def merge_aggs(self):
        # never reached: holistic plans have no partial stage
        return [("pct", "unmergeable")]
