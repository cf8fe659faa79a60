"""Expression base classes (port of spark_rapids_tpu/ops/base.py).

Reference parity: GpuExpressions.scala —
- `GpuExpression.columnarEval(batch): Any` contract (:74-99) -> `Expression.eval`
- arity templates with scalar/vector dispatch and null propagation
  (GpuUnaryExpression :115-149, GpuBinaryExpression :158-199)
- GpuBoundReference / GpuBindReferences (GpuBoundAttribute.scala)
- GpuAlias / named expressions (namedExpressions.scala)

One `eval` serves both engines: `ctx.is_device` selects torch tensors on
the card or numpy arrays on the CPU oracle path. Operator kernels
(`do_columnar`) receive raw tensors/arrays and python scalars; both
libraries share the elementwise operators, and the few calls that differ
(`where`, dtype conversion) go through ops/values.py.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.values import (
    ColV,
    EvalContext,
    ScalarV,
    and_validity,
    zero_nulls,
)

_expr_id_counter = itertools.count(1)


def next_expr_id() -> int:
    return next(_expr_id_counter)


class Expression:
    """Immutable expression-tree node."""

    def children(self) -> tuple:
        return ()

    @property
    def data_type(self) -> DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children())

    @property
    def foldable(self) -> bool:
        ch = self.children()
        return bool(ch) and all(c.foldable for c in ch)

    @property
    def deterministic(self) -> bool:
        return all(c.deterministic for c in self.children())

    def with_children(self, new_children: Sequence["Expression"]) -> "Expression":
        raise NotImplementedError(type(self).__name__)

    def transform_up(self, fn) -> "Expression":
        new_children = [c.transform_up(fn) for c in self.children()]
        node = self.with_children(new_children) if new_children else self
        return fn(node)

    def collect(self, pred) -> List["Expression"]:
        out = [self] if pred(self) else []
        for c in self.children():
            out.extend(c.collect(pred))
        return out

    # -- evaluation ----------------------------------------------------------
    def eval(self, ctx: EvalContext):
        child_vals = [c.eval(ctx) for c in self.children()]
        return self.eval_kernel(ctx, *child_vals)

    def eval_kernel(self, ctx: EvalContext, *child_vals):
        raise NotImplementedError(type(self).__name__)

    # -- identity (explain output, kernel-cache keys) -------------------------
    def fingerprint(self) -> str:
        parts = ",".join(c.fingerprint() for c in self.children())
        return f"{type(self).__name__}({self._fingerprint_extra()}{parts})"

    def _fingerprint_extra(self) -> str:
        return ""

    def __repr__(self):
        ch = ", ".join(repr(c) for c in self.children())
        return f"{type(self).__name__}({ch})"


class LeafExpression(Expression):
    def with_children(self, new_children):
        assert not new_children
        return self


def _scalar_fold_ctx() -> EvalContext:
    return EvalContext(False, [], 1, 1)


def _lift(s: ScalarV) -> ColV:
    """A non-null scalar as a 1-row CPU column (constant folding)."""
    if s.dtype is DataType.STRING:
        return ColV(s.dtype, np.array([s.value], dtype=object),
                    np.array([True]))
    return ColV(s.dtype, np.array([s.value], dtype=s.dtype.to_np()),
                np.array([True]))


def _fold_result(dtype: DataType, out) -> ScalarV:
    """Convert a 1-row kernel result back to a scalar."""
    if isinstance(out, ColV):
        if not bool(np.asarray(out.validity)[0]):
            return ScalarV(dtype, None)
        out = out.data
    v = np.asarray(out)[0]
    if isinstance(v, np.generic):
        v = v.item()
    return ScalarV(dtype, v)


def _null_col(ctx: EvalContext, dtype: DataType) -> ColV:
    if dtype is DataType.STRING:
        return ColV(DataType.STRING,
                    np.full((ctx.capacity,), "", dtype=object),
                    np.zeros((ctx.capacity,), dtype=bool))
    return ColV(dtype, ctx.full(0, dtype), ctx.bools(False))


class UnaryExpression(Expression):
    """Null-propagating unary template (reference: GpuUnaryExpression,
    GpuExpressions.scala:115-149)."""

    def __init__(self, child: Expression):
        self.child = child

    def children(self):
        return (self.child,)

    def with_children(self, new_children):
        return type(self)(*new_children)

    def eval_kernel(self, ctx, v):
        if isinstance(v, ScalarV):
            if v.is_null:
                return ScalarV(self.data_type, None)
            return _fold_result(self.data_type,
                                self.do_columnar(_scalar_fold_ctx(),
                                                 _lift(v)))
        data = self.do_columnar(ctx, v)
        if isinstance(data, ColV):  # string kernels return a whole column
            return ColV(data.dtype, data.data,
                        and_validity(data.validity, v.validity), data.offsets,
                        data.max_len)
        return ColV(self.data_type, zero_nulls(data, v.validity), v.validity)

    def do_columnar(self, ctx, v: ColV):
        raise NotImplementedError(type(self).__name__)


class BinaryExpression(Expression):
    """Null-propagating binary template (reference: GpuBinaryExpression,
    GpuExpressions.scala:158-199)."""

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right

    def children(self):
        return (self.left, self.right)

    def with_children(self, new_children):
        return type(self)(*new_children)

    def eval_kernel(self, ctx, lv, rv):
        if isinstance(lv, ScalarV) and isinstance(rv, ScalarV):
            if lv.is_null or rv.is_null:
                return ScalarV(self.data_type, None)
            return self.eval_scalars(lv, rv)
        if isinstance(lv, ScalarV) and lv.is_null or \
           isinstance(rv, ScalarV) and rv.is_null:
            if self.data_type is DataType.STRING:
                return _null_string_col(ctx)
            return _null_col(ctx, self.data_type)
        data = self.do_columnar(ctx, lv, rv)
        validity = and_validity(
            lv.validity if isinstance(lv, ColV) else None,
            rv.validity if isinstance(rv, ColV) else None)
        if isinstance(data, ColV):  # string kernels return a whole column
            return ColV(data.dtype, data.data,
                        and_validity(data.validity, validity), data.offsets,
                        data.max_len)
        return ColV(self.data_type, zero_nulls(data, validity), validity)

    def do_columnar(self, ctx, lv, rv):
        """lv/rv are ColV or non-null ScalarV; kernels use `_d(v)` to get
        the broadcastable raw value."""
        raise NotImplementedError(type(self).__name__)

    def eval_scalars(self, lv: ScalarV, rv: ScalarV) -> ScalarV:
        """Constant folding of two non-null scalars through the CPU kernel
        (an expression whose kernel needs a scalar operand overrides it)."""
        return _fold_result(
            self.data_type,
            self.do_columnar(_scalar_fold_ctx(), _lift(lv), _lift(rv)))


def _null_string_col(ctx: EvalContext) -> ColV:
    """An all-NULL STRING column of the batch's lanes (reference :288)."""
    if ctx.is_device:
        dev = ctx.device
        return ColV(DataType.STRING, torch.zeros(8, dtype=torch.uint8,
                                                 device=dev),
                    torch.zeros(ctx.capacity, dtype=torch.bool, device=dev),
                    torch.zeros(ctx.capacity + 1, dtype=torch.int32,
                                device=dev), 1)
    return _null_col(ctx, DataType.STRING)


class TernaryExpression(Expression):
    """Null-propagating ternary template (reference: ops/base.py:231). A
    STRING scalar operand becomes a column first, so string kernels see
    real operands; all-scalar operands fold through the CPU kernel."""

    def __init__(self, a: Expression, b: Expression, c: Expression):
        self.a, self.b, self.c = a, b, c

    def children(self):
        return (self.a, self.b, self.c)

    def with_children(self, new_children):
        return type(self)(*new_children)

    def eval_kernel(self, ctx, *vals):
        if all(isinstance(v, ScalarV) for v in vals) and \
                not any(v.is_null for v in vals):
            return _fold_result(self.data_type, self.do_columnar(
                _scalar_fold_ctx(), *[_lift(v) for v in vals]))
        vals = tuple(_lift_string_scalar(ctx, v)
                     if isinstance(v, ScalarV) and not v.is_null and
                     v.dtype is DataType.STRING else v for v in vals)
        if any(isinstance(v, ScalarV) and v.is_null for v in vals):
            if self.data_type is DataType.STRING:
                return _null_string_col(ctx)
            return _null_col(ctx, self.data_type)
        data = self.do_columnar(ctx, *vals)
        validity = and_validity(*[v.validity for v in vals
                                  if isinstance(v, ColV)])
        if validity is None:
            validity = ctx.bools(True)
            if ctx.is_device:
                validity = validity & ctx.row_mask()
        if isinstance(data, ColV):
            return ColV(data.dtype, data.data,
                        and_validity(data.validity, validity), data.offsets,
                        data.max_len)
        return ColV(self.data_type, zero_nulls(data, validity), validity)

    def do_columnar(self, ctx, *vals):
        raise NotImplementedError(type(self).__name__)


def _lift_string_scalar(ctx: EvalContext, s: ScalarV) -> ColV:
    """A STRING scalar as a real column on either engine (reference
    :323): K7 repeats its bytes into every lane on the device."""
    if ctx.is_device:
        from spark_rapids_tpu_torch.ops.eval import _string_scalar_col

        return _string_scalar_col(ctx, s)
    return ColV(DataType.STRING, np.full((ctx.capacity,), s.value,
                                         dtype=object),
                np.ones((ctx.capacity,), dtype=bool))


def _d(v):
    """Raw broadcastable data of a ColV or non-null ScalarV operand."""
    if isinstance(v, ColV):
        return v.data
    return v.value


# ---------------------------------------------------------------------------
# References / named expressions
# ---------------------------------------------------------------------------
class AttributeReference(LeafExpression):
    """A named column of the input relation (reference: GpuBoundAttribute)."""

    def __init__(self, name: str, dtype: DataType, nullable: bool = True,
                 expr_id: Optional[int] = None):
        self.name = name
        self._dtype = dtype
        self._nullable = nullable
        self.expr_id = expr_id if expr_id is not None else next_expr_id()

    @property
    def data_type(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    @property
    def foldable(self):
        return False

    def eval_kernel(self, ctx):
        raise RuntimeError(
            f"unbound attribute {self.name}#{self.expr_id}; "
            "run bind_references first")

    def _fingerprint_extra(self):
        return f"{self.name}#{self.expr_id}:{self._dtype.name};"

    def __repr__(self):
        return f"{self.name}#{self.expr_id}"


class BoundReference(LeafExpression):
    """Ordinal reference into the input batch (reference: GpuBoundReference)."""

    def __init__(self, ordinal: int, dtype: DataType, nullable: bool = True):
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable

    @property
    def data_type(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    @property
    def foldable(self):
        return False

    def eval(self, ctx: EvalContext):
        return ctx.columns[self.ordinal]

    def _fingerprint_extra(self):
        return f"{self.ordinal}:{self._dtype.name};"

    def __repr__(self):
        return f"input[{self.ordinal}:{self._dtype.name}]"


class Alias(UnaryExpression):
    """Named result (reference: GpuAlias, namedExpressions.scala)."""

    def __init__(self, child: Expression, name: str,
                 expr_id: Optional[int] = None):
        super().__init__(child)
        self.name = name
        self.expr_id = expr_id if expr_id is not None else next_expr_id()

    def with_children(self, new_children):
        return Alias(new_children[0], self.name, self.expr_id)

    @property
    def data_type(self):
        return self.child.data_type

    @property
    def nullable(self):
        return self.child.nullable

    def eval_kernel(self, ctx, v):
        return v

    def to_attribute(self) -> AttributeReference:
        return AttributeReference(self.name, self.data_type, self.nullable,
                                  self.expr_id)

    def _fingerprint_extra(self):
        return f"{self.name};"

    def __repr__(self):
        return f"{self.child!r} AS {self.name}#{self.expr_id}"


def to_attribute(e: Expression) -> AttributeReference:
    if isinstance(e, AttributeReference):
        return e
    if isinstance(e, Alias):
        return e.to_attribute()
    raise TypeError(f"not a named expression: {e!r}")


class SortOrder:
    """Sort key descriptor (reference: ops/base.py:459, GpuSortOrder)."""

    __slots__ = ("child", "ascending", "nulls_first")

    def __init__(self, child: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.child = child
        self.ascending = ascending
        # Spark default: NULLS FIRST for ASC, NULLS LAST for DESC
        self.nulls_first = ascending if nulls_first is None else nulls_first

    def fingerprint(self):
        return (f"SortOrder({self.child.fingerprint()},{self.ascending},"
                f"{self.nulls_first})")

    def __repr__(self):
        d = "ASC" if self.ascending else "DESC"
        n = "NULLS FIRST" if self.nulls_first else "NULLS LAST"
        return f"{self.child!r} {d} {n}"
