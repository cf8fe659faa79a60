"""Window spec builder, the pyspark.sql.Window analog (port of
spark_rapids_tpu/plan/window_api.py)."""

from __future__ import annotations

from spark_rapids_tpu_torch.ops.base import SortOrder
from spark_rapids_tpu_torch.ops.window import (
    CURRENT_ROW,
    UNBOUNDED,
    WindowFrame,
    WindowSpec,
)
from spark_rapids_tpu_torch.plan.column import Column

unboundedPreceding = UNBOUNDED
unboundedFollowing = UNBOUNDED
currentRow = CURRENT_ROW


class WindowBuilder:
    def __init__(self, partition_by=(), order_by=(), frame=None):
        self._partition_by = list(partition_by)
        self._order_by = list(order_by)
        self._frame = frame

    def partitionBy(self, *cols) -> "WindowBuilder":
        return WindowBuilder([_col(c) for c in cols], self._order_by,
                             self._frame)

    def orderBy(self, *cols) -> "WindowBuilder":
        orders = []
        for c in cols:
            if isinstance(c, SortOrder):
                orders.append(c)
            else:
                orders.append(SortOrder(_col(c), True))
        return WindowBuilder(self._partition_by, orders, self._frame)

    def rowsBetween(self, start, end) -> "WindowBuilder":
        lo = None if start is None else int(start)
        hi = None if end is None else int(end)
        return WindowBuilder(self._partition_by, self._order_by,
                             WindowFrame("rows", lo, hi))

    def rangeBetween(self, start, end) -> "WindowBuilder":
        """RANGE frame; bounds are ORDER-BY-value offsets (0 = CURRENT ROW,
        None = unbounded). Finite bounds need exactly one numeric ORDER BY
        column (reference: GpuWindowExpression.scala:457-683)."""
        lo = UNBOUNDED if start is None else int(start)
        hi = UNBOUNDED if end is None else int(end)
        return WindowBuilder(self._partition_by, self._order_by,
                             WindowFrame("range", lo, hi))

    def to_spec(self) -> WindowSpec:
        return WindowSpec(self._partition_by, self._order_by, self._frame)


def _col(c):
    if isinstance(c, str):
        from spark_rapids_tpu_torch.plan.functions import col

        return col(c).expr
    if isinstance(c, Column):
        return c.expr
    return c


class _WindowModule:
    """`Window.partitionBy(...)` entry point."""

    unboundedPreceding = UNBOUNDED
    unboundedFollowing = UNBOUNDED
    currentRow = CURRENT_ROW

    @staticmethod
    def partitionBy(*cols) -> WindowBuilder:
        return WindowBuilder().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowBuilder:
        return WindowBuilder().orderBy(*cols)

    @staticmethod
    def rowsBetween(start, end) -> WindowBuilder:
        return WindowBuilder().rowsBetween(start, end)


Window = _WindowModule
