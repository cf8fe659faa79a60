"""Cast (port of spark_rapids_tpu/ops/cast.py: the numeric, datetime and
decimal directions, `_numeric_datetime` and `_decimal` :102-220, and
`device_supported` :61-90; reference: GpuCast.scala). The string
directions (B16) are not ported and stay on the CPU engine.

Datetime: TIMESTAMP -> LONG is epoch seconds and TIMESTAMP -> DATE epoch
days, both floored (a tensor's and an array's `//` both floor, so times
before 1970 agree); DATE -> TIMESTAMP and LONG -> TIMESTAMP scale up.
Decimal: int64 unscaled math with overflow to NULL; DECIMAL -> DOUBLE is
one int64 -> double conversion then a division by 10**scale, the
reference's order, so the doubles are bit-equal. DOUBLE -> DECIMAL needs
the double's shortest decimal repr and stays on the CPU engine, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import (
    DataType,
    is_decimal,
    to_torch,
)
from spark_rapids_tpu_torch.ops import decimal_util as DU
from spark_rapids_tpu_torch.ops.base import UnaryExpression
from spark_rapids_tpu_torch.ops.values import ColV

MICROS_PER_SEC = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SEC

_NUMERIC = {DataType.BOOL, DataType.INT8, DataType.INT16, DataType.INT32,
            DataType.INT64, DataType.FLOAT32, DataType.FLOAT64}


def _astype(data, dt):
    if isinstance(data, torch.Tensor):
        want = to_torch(dt)
        return data if data.dtype == want else data.to(want)
    npdt = dt.to_np()
    return data if data.dtype == npdt else data.astype(npdt)


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

    @property
    def nullable(self):
        # a decimal cast can overflow to NULL
        if is_decimal(self.to_type) or (is_decimal(self.child.data_type)
                                        and self.to_type.is_integral):
            return True
        return super().nullable

    def _fingerprint_extra(self):
        return f"->{self.to_type.name};ansi={int(self.ansi)};"

    @staticmethod
    def device_supported(frm, to) -> bool:
        """The directions the device path computes (reference :61-90, less
        the string ones)."""
        if frm == to:
            return True
        if is_decimal(frm):
            return is_decimal(to) or to in _NUMERIC
        if is_decimal(to):
            return frm in _NUMERIC and not frm.is_floating
        if frm in _NUMERIC and to in _NUMERIC:
            return True
        if frm is DataType.DATE and to in (DataType.TIMESTAMP,
                                           DataType.INT32):
            return True
        if frm is DataType.TIMESTAMP and to in (DataType.DATE,
                                                DataType.INT64):
            return True
        return frm is DataType.INT64 and to is DataType.TIMESTAMP

    def do_columnar(self, ctx, v):
        frm, to = self.child.data_type, self.to_type
        data = v.data
        if frm == to:
            return data
        if is_decimal(frm) or is_decimal(to):
            return self._decimal(ctx, v, frm, to)
        if frm is DataType.DATE and to is DataType.TIMESTAMP:
            return DU._i64(data) * MICROS_PER_DAY
        if frm is DataType.TIMESTAMP and to is DataType.DATE:
            return _astype(DU._i64(data) // MICROS_PER_DAY, DataType.DATE)
        if frm is DataType.TIMESTAMP and to is DataType.INT64:
            return DU._i64(data) // MICROS_PER_SEC
        if frm is DataType.INT64 and to is DataType.TIMESTAMP:
            return DU._i64(data) * MICROS_PER_SEC
        if frm is DataType.DATE and to is DataType.INT32:
            return _astype(data, DataType.INT32)
        if frm not in _NUMERIC or to not in _NUMERIC:
            raise NotImplementedError(f"cast {frm} -> {to} is not ported")
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
        return _astype(data, to)

    # -- decimal --------------------------------------------------------------
    def _decimal(self, ctx, v, frm, to):
        """Casts with a decimal end (reference :106-170); overflow is
        NULL, as in Spark's non-ANSI Decimal.changePrecision."""
        data = v.data
        if is_decimal(frm) and is_decimal(to):
            out, ok1 = DU.rescale(data, frm.scale, to.scale)
            out, ok2 = DU.fit_precision(out, to.precision)
            return self._dec_result(v, to, out, ok1 & ok2)
        if is_decimal(frm):
            if to is DataType.BOOL:
                return data != 0
            if to.is_floating:
                return _astype(DU.unscale_to_double(DU._i64(data),
                                                    frm.scale), to)
            # to an integer: truncate toward zero, overflow -> NULL
            q = DU._abs(DU._i64(data)) // DU.POW10[frm.scale]
            q = DU._where(data < 0, -q, q)
            info = np.iinfo(to.to_np())
            ok = (q >= int(info.min)) & (q <= int(info.max))
            return self._dec_result(v, to, _astype(DU._where(ok, q, 0), to),
                                    ok)
        if frm is DataType.BOOL:
            out = DU._as_i64(data) * DU.POW10[to.scale]
            return self._dec_result(v, to, out, DU._ones(out))
        if frm.is_integral:
            out, ok1 = DU.checked_mul_pow10(DU._i64(data), to.scale)
            out, ok2 = DU.fit_precision(out, to.precision)
            return self._dec_result(v, to, out, ok1 & ok2)
        if frm.is_floating and not isinstance(data, torch.Tensor):
            # the CPU engine, Spark-exact: round the double's shortest
            # decimal repr HALF_UP at the target scale (reference :147)
            out = np.zeros(len(data), dtype=np.int64)
            ok = np.zeros(len(data), dtype=bool)
            limit = DU.bound(to.precision)
            for i, x in enumerate(data):
                x = float(x)
                if not np.isfinite(x):
                    continue
                try:
                    u = DU.to_unscaled(x, to.scale)
                except OverflowError:
                    continue
                if abs(u) <= limit:
                    out[i] = u
                    ok[i] = True
            return self._dec_result(v, to, out, ok)
        raise NotImplementedError(f"cast {frm} -> {to} has no device path")

    def _dec_result(self, v, to, out, ok):
        if self.ansi and not isinstance(ok, torch.Tensor):
            if bool(np.asarray(v.validity & ~ok).any()):
                raise ArithmeticError(
                    f"cast to {to.value} overflowed (ANSI)")
        return ColV(to, out, ok)
