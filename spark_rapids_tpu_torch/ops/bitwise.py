"""Bitwise and shift expressions (port of spark_rapids_tpu/ops/bitwise.py;
reference: bitwise.scala).

and / or / xor / not run at the operands' common type. A shift keeps the
left operand's type; its amount is taken mod the width (64 for LONG, 32
otherwise), as Java does, and `>>>` shifts in zeros at that width. torch
has no unsigned 64-bit shift, so the logical shift masks the arithmetic
one. On the card these run inside K48's stage program (ops/program.py)
where the stage is emittable.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, common_type, to_torch
from spark_rapids_tpu_torch.ops.base import BinaryExpression, UnaryExpression, _d


def _at(x, dt: DataType):
    """x (a tensor, an array or a python int) at dt's storage type."""
    if isinstance(x, torch.Tensor):
        want = to_torch(dt)
        return x if x.dtype == want else x.to(want)
    if isinstance(x, np.ndarray):
        npdt = dt.to_np()
        return x if x.dtype == npdt else x.astype(npdt)
    return dt.to_np().type(x) if not isinstance(x, bool) else x


class BitwiseBinary(BinaryExpression):
    @property
    def data_type(self):
        return common_type(self.left.data_type, self.right.data_type)

    def _operands(self, lv, rv):
        dt = self.data_type
        return _at(_d(lv), dt), _at(_d(rv), dt)


class BitwiseAnd(BitwiseBinary):
    def do_columnar(self, ctx, lv, rv):
        l, r = self._operands(lv, rv)
        return l & r


class BitwiseOr(BitwiseBinary):
    def do_columnar(self, ctx, lv, rv):
        l, r = self._operands(lv, rv)
        return l | r


class BitwiseXor(BitwiseBinary):
    def do_columnar(self, ctx, lv, rv):
        l, r = self._operands(lv, rv)
        return l ^ r


class BitwiseNot(UnaryExpression):
    @property
    def data_type(self):
        return self.child.data_type

    def do_columnar(self, ctx, v):
        return ~v.data


def _bits(dt: DataType) -> int:
    return 64 if dt is DataType.INT64 else 32


def _amount(rv, bits: int, like):
    """The shift amount mod the width, at the left operand's type."""
    s = _d(rv)
    if isinstance(s, torch.Tensor):
        return (s.to(torch.int64) % bits).to(like.dtype)
    if isinstance(s, np.ndarray):
        return (s.astype(np.int64) % bits).astype(like.dtype)
    s = int(s) % bits
    if isinstance(like, torch.Tensor):
        return torch.full((), s, dtype=like.dtype, device=like.device)
    return like.dtype.type(s)


class _Shift(BinaryExpression):
    @property
    def data_type(self):
        return self.left.data_type

    def do_columnar(self, ctx, lv, rv):
        dt = self.data_type
        bits = _bits(dt)
        l = _d(lv)
        if not isinstance(l, (torch.Tensor, np.ndarray)):
            ref = _d(rv)
            l = torch.full((), l, dtype=to_torch(dt), device=ref.device) \
                if isinstance(ref, torch.Tensor) else dt.to_np().type(l)
        l = _at(l, dt)
        return self._shift(l, _amount(rv, bits, l), bits)


class ShiftLeft(_Shift):
    @staticmethod
    def _shift(l, s, bits):
        return l << s


class ShiftRight(_Shift):
    """Arithmetic (sign-extending) right shift."""

    @staticmethod
    def _shift(l, s, bits):
        return l >> s


class ShiftRightUnsigned(_Shift):
    """Logical (zero-filling) right shift (Java >>>)."""

    @staticmethod
    def _shift(l, s, bits):
        if isinstance(l, torch.Tensor):
            if bits == 32:
                return ((l.to(torch.int64) & 0xFFFFFFFF) >>
                        s.to(torch.int64)).to(l.dtype)
            s64 = s.to(torch.int64)
            mask = torch.where(
                s64 == 0, torch.full((), -1, dtype=torch.int64,
                                     device=l.device),
                (torch.ones((), dtype=torch.int64, device=l.device)
                 << (64 - s64).clamp(max=63)) - 1)
            return (l >> s64) & mask
        udt = np.uint64 if bits == 64 else np.uint32
        return np.right_shift(l.astype(udt), np.asarray(s).astype(udt)) \
            .astype(l.dtype)
