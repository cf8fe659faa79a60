"""Cast (port of spark_rapids_tpu/ops/cast.py, numeric directions only;
reference: GpuCast.scala). String, date, timestamp and decimal directions
wait for slice 2 and stay on the CPU engine (no device rule)."""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch

from spark_rapids_tpu_torch.ops.base import UnaryExpression

_NUMERIC = {DataType.BOOL, DataType.INT8, DataType.INT16, DataType.INT32,
            DataType.INT64, DataType.FLOAT32, DataType.FLOAT64}


class Cast(UnaryExpression):
    def __init__(self, child, to_type: DataType, ansi: bool = False):
        super().__init__(child)
        self.to_type = to_type
        self.ansi = ansi

    def with_children(self, new_children):
        return Cast(new_children[0], self.to_type, self.ansi)

    @property
    def data_type(self):
        return self.to_type

    def _fingerprint_extra(self):
        return f"->{self.to_type.name};ansi={int(self.ansi)};"

    @staticmethod
    def device_supported(frm, to) -> bool:
        return frm == to or (frm in _NUMERIC and to in _NUMERIC)

    def do_columnar(self, ctx, v):
        frm, to = self.child.data_type, self.to_type
        data = v.data
        if frm == to:
            return data
        if frm not in _NUMERIC or to not in _NUMERIC:
            raise NotImplementedError(
                f"cast {frm} -> {to} is not ported (slice 2)")
        dev = isinstance(data, torch.Tensor)
        if to is DataType.BOOL:
            return data != 0
        if frm.is_floating and to.is_integral:
            # spark truncates toward zero; NaN -> 0, out-of-range saturates
            # (non-ansi). Saturate by comparisons: float(int64.max) rounds up
            # to 2^63, and a plain convert of it would wrap.
            info = np.iinfo(to.to_np())
            if dev:
                clean = torch.where(torch.isnan(data),
                                    torch.zeros((), dtype=data.dtype,
                                                device=data.device), data)
                t = torch.trunc(clean)
                tdt = to_torch(to)
                hi = t >= float(info.max)
                lo = t <= float(info.min)
                zero = torch.zeros((), dtype=t.dtype, device=t.device)
                res = torch.where(hi | lo, zero, t).to(tdt)
                res = torch.where(hi, torch.full((), int(info.max), dtype=tdt,
                                                 device=t.device), res)
                return torch.where(lo, torch.full((), int(info.min),
                                                  dtype=tdt, device=t.device),
                                   res)
            clean = np.where(np.isnan(data), 0.0, data)
            t = np.trunc(clean)
            npdt = to.to_np()
            with np.errstate(invalid="ignore"):
                res = t.astype(npdt)
            res = np.where(t >= float(info.max), info.max, res)
            res = np.where(t <= float(info.min), info.min, res)
            return res.astype(npdt)
        if dev:
            return data.to(to_torch(to))
        return data.astype(to.to_np())
