"""Math expressions the port's slices need (port of
spark_rapids_tpu/ops/mathx.py: Floor :150 and Ceil :160; reference:
mathExpressions.scala GpuFloor / GpuCeil).

floor and ceil take the value as a DOUBLE and return LONG, as Spark's
do for a double input: the same code on torch tensors (the card) and
numpy arrays (the CPU engine).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import UnaryExpression


def _rounded_long(x, fn: str):
    if isinstance(x, torch.Tensor):
        return getattr(torch, fn)(x.to(torch.float64)).to(torch.int64)
    return getattr(np, fn)(np.asarray(x).astype(np.float64)).astype(np.int64)


class Floor(UnaryExpression):
    @property
    def data_type(self):
        return DataType.INT64

    def do_columnar(self, ctx, v):
        return _rounded_long(v.data, "floor")


class Ceil(UnaryExpression):
    @property
    def data_type(self):
        return DataType.INT64

    def do_columnar(self, ctx, v):
        return _rounded_long(v.data, "ceil")
