"""Declarative aggregate functions (port of spark_rapids_tpu/ops/aggregates.py:
Sum, Count, Min, Max, Average; reference: AggregateFunctions.scala).

Every aggregate is an update/merge pair of reduce ops plus a final
expression over its buffer attributes, which is what makes partial/final
aggregation composable across a shuffle:

- `update_aggs`: (buffer_name, reduce_op, input_expr) over raw input rows;
- `merge_aggs`:  (buffer_name, reduce_op) over partial buffers;
- `evaluate_expression`: result expression over the buffer attributes;
- `initial_buffer_values`: buffers of the empty ungrouped reduction.

Average is its DOUBLE branch (reference: aggregates.py:405); the decimal
averages and sums wait with the decimals.
"""

from __future__ import annotations

from typing import List, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import AttributeReference, Expression

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
    if dt in (DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64):
        return DataType.INT64
    return DataType.FLOAT64


class Sum(AggregateFunction):
    @property
    def data_type(self):
        return _sum_type(self.child.data_type)

    def buffer_attrs(self):
        return [AttributeReference("sum", self.data_type, True)]

    def update_aggs(self):
        from spark_rapids_tpu_torch.ops.cast import Cast

        src = self.child
        if src.data_type != self.data_type:
            src = Cast(src, self.data_type)
        return [("sum", "sum", src)]

    def merge_aggs(self):
        return [("sum", "sum")]


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


class Average(AggregateFunction):
    """avg over a numeric input as DOUBLE: buffers sum (DOUBLE) and count
    (LONG), finished as sum / count, NULL for no input rows (reference:
    aggregates.py:405, the non-decimal branch)."""

    @property
    def data_type(self):
        return DataType.FLOAT64

    def buffer_attrs(self):
        return [AttributeReference("sum", DataType.FLOAT64, True),
                AttributeReference("count", DataType.INT64, False)]

    def update_aggs(self):
        from spark_rapids_tpu_torch.ops.cast import Cast

        src = self.child
        if src.data_type is not DataType.FLOAT64:
            src = Cast(src, DataType.FLOAT64)
        return [("sum", "sum", src), ("count", "count", self.child)]

    def merge_aggs(self):
        return [("sum", "sum"), ("count", "sum")]

    def evaluate_expression(self, buffers):
        from spark_rapids_tpu_torch.ops.arithmetic import Divide
        from spark_rapids_tpu_torch.ops.cast import Cast

        return Divide(buffers[0], Cast(buffers[1], DataType.FLOAT64))

    def initial_buffer_values(self):
        return [None, 0]
