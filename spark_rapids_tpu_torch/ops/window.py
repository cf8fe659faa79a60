"""Window expressions (port of spark_rapids_tpu/ops/window.py; reference:
GpuWindowExpression.scala, 723 LoC).

Reference parity:
- `GpuWindowSpecDefinition` (partition/order/frame, :390) -> `WindowSpec`.
- row/range frames with boundary checks (:457-683) -> `WindowFrame`
  (UNBOUNDED PRECEDING..CURRENT ROW default for ordered specs, matching
  Spark; ROWS offsets supported for prefix-sum-able aggregates).
- `GpuRowNumber` (:708) + rank/dense_rank/lag/lead -> ranking functions.
- aggregate-over-window via the same AggregateFunction objects the groupby
  uses (GpuWindowExpression eval via cudf window aggregation :87-235) ->
  the exec lowers them onto prefix sums and segmented scans (kernel K16)
  instead of cudf's windowed reductions.
"""

from __future__ import annotations

from typing import Optional, Sequence

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.aggregates import AggregateFunction
from spark_rapids_tpu_torch.ops.base import Expression, LeafExpression, SortOrder

UNBOUNDED = None  # frame boundary sentinel
CURRENT_ROW = 0


class WindowFrame:
    """(frame_type, lower, upper): lower/upper are row/range offsets,
    None = unbounded. ROW frame offsets are ints (negative = preceding)."""

    __slots__ = ("frame_type", "lower", "upper")

    def __init__(self, frame_type: str, lower, upper):
        if frame_type not in ("rows", "range"):
            raise ValueError(f"unknown window frame type {frame_type!r}")
        self.frame_type = frame_type
        self.lower = lower
        self.upper = upper

    @property
    def is_unbounded_to_current(self) -> bool:
        return self.lower is UNBOUNDED and self.upper == CURRENT_ROW

    @property
    def is_unbounded_both(self) -> bool:
        return self.lower is UNBOUNDED and self.upper is UNBOUNDED

    def fingerprint(self):
        return f"{self.frame_type}:{self.lower}:{self.upper}"

    def __repr__(self):
        def b(v, side):
            if v is UNBOUNDED:
                return f"UNBOUNDED {side}"
            if v == 0:
                return "CURRENT ROW"
            return f"{abs(v)} {'PRECEDING' if v < 0 else 'FOLLOWING'}"

        return (f"{self.frame_type.upper()} BETWEEN {b(self.lower, 'PRECEDING')} "
                f"AND {b(self.upper, 'FOLLOWING')}")


class WindowSpec:
    __slots__ = ("partition_by", "order_by", "frame")

    def __init__(self, partition_by: Sequence[Expression] = (),
                 order_by: Sequence[SortOrder] = (),
                 frame: Optional[WindowFrame] = None):
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        if frame is None:
            # Spark default: whole partition if unordered, else
            # RANGE UNBOUNDED PRECEDING .. CURRENT ROW
            frame = WindowFrame("range", UNBOUNDED, UNBOUNDED) \
                if not self.order_by else \
                WindowFrame("range", UNBOUNDED, CURRENT_ROW)
        self.frame = frame

    def fingerprint(self):
        return (f"W([{','.join(e.fingerprint() for e in self.partition_by)}],"
                f"[{','.join(o.fingerprint() for o in self.order_by)}],"
                f"{self.frame.fingerprint()})")

    def __repr__(self):
        return (f"Window(partitionBy={self.partition_by!r}, "
                f"orderBy={self.order_by!r}, {self.frame!r})")


class WindowFunction(LeafExpression):
    """Ranking/offset functions valid only inside a window."""

    @property
    def nullable(self):
        return False

    def eval_kernel(self, ctx):
        raise RuntimeError("window functions evaluate via the window exec")


class RowNumber(WindowFunction):
    @property
    def data_type(self):
        return DataType.INT32


class Rank(WindowFunction):
    @property
    def data_type(self):
        return DataType.INT32


class DenseRank(WindowFunction):
    @property
    def data_type(self):
        return DataType.INT32


class NTile(WindowFunction):
    def __init__(self, n: int):
        self.n = n

    @property
    def data_type(self):
        return DataType.INT32

    def _fingerprint_extra(self):
        return f"{self.n};"


class Lag(Expression):
    def __init__(self, child: Expression, offset: int = 1, default=None):
        self.child = child
        self.offset = offset
        self.default = default

    def children(self):
        return (self.child,)

    def with_children(self, new_children):
        return Lag(new_children[0], self.offset, self.default)

    @property
    def data_type(self):
        return self.child.data_type

    @property
    def nullable(self):
        return True

    def _fingerprint_extra(self):
        return f"{self.offset};{self.default!r};"

    def eval_kernel(self, ctx, v):
        raise RuntimeError("lag evaluates via the window exec")


class Lead(Lag):
    def with_children(self, new_children):
        return Lead(new_children[0], self.offset, self.default)


class WindowExpression(Expression):
    """function OVER spec. `function` is an AggregateFunction, a
    WindowFunction, or Lag/Lead."""

    def __init__(self, function: Expression, spec: WindowSpec):
        self.function = function
        self.spec = spec

    def children(self):
        # Spec expressions ARE children: analysis/transform machinery must
        # resolve partition/order columns (e.g. `Window.partitionBy("k")`
        # arrives as an unresolved name) just like the function input.
        return (self.function, *self.spec.partition_by,
                *[o.child for o in self.spec.order_by])

    def with_children(self, new_children):
        n_part = len(self.spec.partition_by)
        function = new_children[0]
        part = list(new_children[1:1 + n_part])
        orders = [
            SortOrder(c, o.ascending, o.nulls_first)
            for c, o in zip(new_children[1 + n_part:], self.spec.order_by)
        ]
        return WindowExpression(
            function, WindowSpec(part, orders, self.spec.frame))

    @property
    def data_type(self):
        if isinstance(self.function, AggregateFunction):
            return self.function.data_type
        return self.function.data_type

    @property
    def nullable(self):
        return True

    def _fingerprint_extra(self):
        return self.spec.fingerprint() + ";"

    def eval_kernel(self, ctx, *vals):
        raise RuntimeError("window expressions evaluate via the window exec")

    def __repr__(self):
        return f"{self.function!r} OVER {self.spec!r}"
