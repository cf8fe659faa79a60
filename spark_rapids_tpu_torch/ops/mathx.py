"""Math expressions (port of spark_rapids_tpu/ops/mathx.py :45-214;
reference: mathExpressions.scala).

floor and ceil take the value as a DOUBLE and return LONG, as Spark's
do for a double input: the same code on torch tensors (the card) and
numpy arrays (the CPU engine).

The one-argument functions return DOUBLE. An integral input widens to
DOUBLE first; a FLOAT input computes at its own width and widens at the
batch boundary, as the reference's `ints_only` coercion does (reference
:18-32). Pow, Atan2 and Logarithm widen both operands to DOUBLE. On the
card these run inside K48's stage program (ops/program.py) wherever the
stage is emittable; the eager forms here serve the CPU engine and the
operators that evaluate expressions one by one (windows, sort keys).
torch has no cbrt, so the eager device form takes numpy's on the host
copy of the values.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import BinaryExpression, UnaryExpression, _d


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


def _float_arg(x, ints_only: bool = True):
    """The operand of a math function: an integral array widens to
    float64; with ints_only a float array keeps its width (reference
    `_to_float` :25)."""
    if isinstance(x, torch.Tensor):
        if ints_only and x.is_floating_point():
            return x
        return x.to(torch.float64)
    if isinstance(x, np.ndarray):
        if ints_only and x.dtype.kind == "f":
            return x
        return x.astype(np.float64)
    return float(x)


def _cbrt_torch(x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.cbrt(x.cpu().numpy())).to(x.device)


_NP = {"sin": np.sin, "cos": np.cos, "tan": np.tan, "asin": np.arcsin,
       "acos": np.arccos, "atan": np.arctan, "sinh": np.sinh,
       "cosh": np.cosh, "tanh": np.tanh, "asinh": np.arcsinh,
       "acosh": np.arccosh, "atanh": np.arctanh, "sqrt": np.sqrt,
       "cbrt": np.cbrt, "exp": np.exp, "expm1": np.expm1, "log": np.log,
       "log1p": np.log1p, "log2": np.log2, "log10": np.log10,
       "rint": np.rint, "degrees": np.degrees, "radians": np.radians}
_TORCH = {"sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
          "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
          "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
          "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
          "sqrt": torch.sqrt, "cbrt": _cbrt_torch, "exp": torch.exp,
          "expm1": torch.expm1, "log": torch.log, "log1p": torch.log1p,
          "log2": torch.log2, "log10": torch.log10, "rint": torch.round,
          "degrees": lambda x: x * 57.29577951308232,
          "radians": lambda x: x * 0.017453292519943295}


def apply_math(fn: str, x):
    """`fn` of a tensor (torch) or an array (numpy)."""
    if isinstance(x, torch.Tensor):
        return _TORCH[fn](x)
    with np.errstate(all="ignore"):
        return _NP[fn](x)


class UnaryMath(UnaryExpression):
    """double -> double math function (reference :12)."""

    _fn = ""  # the function's name in apply_math

    @property
    def data_type(self):
        return DataType.FLOAT64

    def do_columnar(self, ctx, v):
        return apply_math(self._fn, _float_arg(v.data))


class Sin(UnaryMath):
    _fn = "sin"


class Cos(UnaryMath):
    _fn = "cos"


class Tan(UnaryMath):
    _fn = "tan"


class Asin(UnaryMath):
    _fn = "asin"


class Acos(UnaryMath):
    _fn = "acos"


class Atan(UnaryMath):
    _fn = "atan"


class Sinh(UnaryMath):
    _fn = "sinh"


class Cosh(UnaryMath):
    _fn = "cosh"


class Tanh(UnaryMath):
    _fn = "tanh"


class Asinh(UnaryMath):
    _fn = "asinh"


class Acosh(UnaryMath):
    _fn = "acosh"


class Atanh(UnaryMath):
    _fn = "atanh"


class Sqrt(UnaryMath):
    _fn = "sqrt"


class Cbrt(UnaryMath):
    _fn = "cbrt"


class Exp(UnaryMath):
    _fn = "exp"


class Expm1(UnaryMath):
    _fn = "expm1"


class Log(UnaryMath):
    _fn = "log"


class Log1p(UnaryMath):
    _fn = "log1p"


class Log2(UnaryMath):
    _fn = "log2"


class Log10(UnaryMath):
    _fn = "log10"


class Rint(UnaryMath):
    _fn = "rint"


class ToDegrees(UnaryMath):
    _fn = "degrees"


class ToRadians(UnaryMath):
    _fn = "radians"


class Cot(UnaryMath):
    """cot(x) = 1 / tan(x) (reference :129; Infinity at 0)."""

    _fn = "cot"

    def do_columnar(self, ctx, v):
        x = _float_arg(v.data)
        with np.errstate(all="ignore"):
            return 1.0 / apply_math("tan", x)


class _BinaryMath(BinaryExpression):
    @property
    def data_type(self):
        return DataType.FLOAT64

    def do_columnar(self, ctx, lv, rv):
        l = _float_arg(_d(lv), ints_only=False)
        r = _float_arg(_d(rv), ints_only=False)
        if isinstance(l, torch.Tensor) or isinstance(r, torch.Tensor):
            dev = (l if isinstance(l, torch.Tensor) else r).device
            l = torch.as_tensor(l, dtype=torch.float64, device=dev)
            r = torch.as_tensor(r, dtype=torch.float64, device=dev)
        else:
            l = np.asarray(l, dtype=np.float64)
            r = np.asarray(r, dtype=np.float64)
        with np.errstate(all="ignore"):
            return self._fn2(l, r)


class Logarithm(_BinaryMath):
    """log(base, x) = log(x) / log(base) (reference :137)."""

    @staticmethod
    def _fn2(base, x):
        if isinstance(x, torch.Tensor):
            return torch.log(x) / torch.log(base)
        return np.log(x) / np.log(base)


class Pow(_BinaryMath):
    @staticmethod
    def _fn2(l, r):
        return torch.pow(l, r) if isinstance(l, torch.Tensor) else \
            np.power(l, r)


class Atan2(_BinaryMath):
    @staticmethod
    def _fn2(l, r):
        return torch.atan2(l, r) if isinstance(l, torch.Tensor) else \
            np.arctan2(l, r)


class NormalizeNaNAndZero(UnaryExpression):
    """-0.0 -> 0.0 and every NaN to one canonical NaN (reference :194)."""

    @property
    def data_type(self):
        return self.child.data_type

    def do_columnar(self, ctx, v):
        d = v.data
        if isinstance(d, torch.Tensor):
            zero = torch.zeros((), dtype=d.dtype, device=d.device)
            d = torch.where(d == 0, zero, d)
            return torch.where(torch.isnan(d), torch.full(
                (), float("nan"), dtype=d.dtype, device=d.device), d)
        d = np.where(d == 0.0, np.asarray(0.0, dtype=d.dtype), d)
        return np.where(np.isnan(d), np.asarray(float("nan"),
                                                dtype=d.dtype), d)
