"""Literals (port of spark_rapids_tpu/ops/literals.py; reference:
literals.scala — GpuLiteral :120, GpuScalar.from :33)."""

from __future__ import annotations

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
    raise TypeError(f"cannot infer literal type for {value!r}")


class Literal(LeafExpression):
    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        if dtype is None:
            dtype = DataType.NULL if value is None else infer_literal_type(value)
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
