"""Evaluation value model shared by the device (torch) and CPU (numpy) paths.

Port of spark_rapids_tpu/ops/values.py. `ColV` is a column result and
`ScalarV` a scalar result (reference: GpuExpression.columnarEval returning a
GpuColumnVector or a scalar, GpuExpressions.scala:74-99).

Device path: data/validity are torch tensors on the card, padded to the batch
capacity, with explicit torch dtypes (columnar/dtypes.py:to_torch). CPU path:
numpy arrays of exactly num_rows, the independent oracle engine.

The reference narrows int64 columns whose value range fits int32 before
compute (`narrow_colv`, spark_rapids_tpu/ops/values.py:100) because a TPU
emulates int64. An H100 has native 64-bit integer lanes, so the port keeps
int64 and narrows nothing; results are the same either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch


@dataclass
class ColV:
    """A column value during evaluation (torch tensors on the device path,
    numpy arrays on the CPU path)."""

    dtype: DataType
    data: Any
    validity: Any
    offsets: Any = None   # device STRING: int32 [capacity + 1]
    max_len: Any = None   # device STRING: host-known byte-length bound

    @property
    def is_string(self) -> bool:
        return self.dtype is DataType.STRING


@dataclass
class ScalarV:
    dtype: DataType
    value: Any  # python scalar; None iff is_null

    @property
    def is_null(self) -> bool:
        return self.value is None


class EvalContext:
    """The batch being evaluated plus engine context.

    device path: tensors on `device`, capacity = padded length, num_rows an
    int or a 0-dim device tensor. CPU path: numpy, capacity == num_rows."""

    __slots__ = ("is_device", "columns", "num_rows", "capacity",
                 "partition_id", "row_start", "device")

    def __init__(self, is_device, columns, num_rows, capacity,
                 partition_id=0, row_start=0, device=None):
        self.is_device = is_device
        self.columns = columns  # list[ColV]
        self.num_rows = num_rows
        self.capacity = capacity
        self.partition_id = partition_id
        self.row_start = row_start
        self.device = device

    def row_mask(self):
        if self.is_device:
            return torch.arange(self.capacity, device=self.device) < \
                self.num_rows
        return np.arange(self.capacity) < self.num_rows

    # -- typed constructors (explicit dtypes per path) ----------------------
    def full(self, value, dt: DataType):
        if self.is_device:
            return torch.full((self.capacity,), value, dtype=to_torch(dt),
                              device=self.device)
        return np.full((self.capacity,), value, dtype=dt.to_np())

    def bools(self, value: bool):
        return self.full(bool(value), DataType.BOOL)


def and_validity(*validities):
    """Null propagation: result is null if any input is null."""
    out = None
    for v in validities:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def where(cond, a, b):
    """Elementwise select on either path (torch.where / np.where)."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def broadcast_scalar(ctx: EvalContext, s: ScalarV) -> ColV:
    """Materialize a scalar as a column (used when a kernel needs arrays)."""
    if s.dtype is DataType.STRING:
        raise NotImplementedError("string scalar broadcast is kernel-specific")
    fill = s.value if not s.is_null else 0
    data = ctx.full(fill, s.dtype)
    validity = ctx.bools(not s.is_null)
    if ctx.is_device:
        validity = validity & ctx.row_mask()
    return ColV(s.dtype, data, validity)


def zero_nulls(data, validity):
    """Re-establish the 'data is 0 at null slots' convention after a kernel
    (keeps padded/null lanes deterministic for hashing and sorting)."""
    if validity is None:
        return data
    if isinstance(data, torch.Tensor):
        return torch.where(validity, data, torch.zeros((), dtype=data.dtype,
                                                       device=data.device))
    return np.where(validity, data, np.zeros((), dtype=data.dtype))
