"""Literals (port of spark_rapids_tpu/ops/literals.py; reference:
literals.scala — GpuLiteral :120, GpuScalar.from :33). A DECIMAL literal
takes its logical value (5 means 5.00 at scale 2) and holds the unscaled
int64, as a DECIMAL column does; a TIMESTAMP literal holds microseconds
since the epoch."""

from __future__ import annotations

import decimal
from typing import Any, Optional

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import LeafExpression
from spark_rapids_tpu_torch.ops.values import ScalarV


def infer_literal_type(value: Any):
    if isinstance(value, bool):
        return DataType.BOOL
    if isinstance(value, int):
        return DataType.INT32 if -(2**31) <= value < 2**31 else DataType.INT64
    if isinstance(value, float):
        return DataType.FLOAT64
    if isinstance(value, str):
        return DataType.STRING
    if isinstance(value, decimal.Decimal):
        from spark_rapids_tpu_torch.ops.decimal_util import infer_decimal_type

        return infer_decimal_type(value)
    raise TypeError(f"cannot infer literal type for {value!r}")


class Literal(LeafExpression):
    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        if dtype is None:
            dtype = DataType.NULL if value is None else infer_literal_type(value)
        if getattr(dtype, "is_decimal", False) and value is not None:
            from spark_rapids_tpu_torch.ops.decimal_util import to_unscaled

            value = to_unscaled(value, dtype.scale, dtype.precision)
        self.value = value
        self._dtype = dtype

    @property
    def data_type(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    @property
    def foldable(self):
        return True

    @property
    def deterministic(self):
        return True

    def eval(self, ctx):
        return ScalarV(self._dtype, self.value)

    def eval_kernel(self, ctx):
        return ScalarV(self._dtype, self.value)

    def _fingerprint_extra(self):
        return f"{self.value!r}:{self._dtype.name};"

    def __repr__(self):
        return f"lit({self.value!r})"


def lit(value: Any, dtype: Optional[DataType] = None) -> Literal:
    return Literal(value, dtype)
