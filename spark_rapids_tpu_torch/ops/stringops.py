"""String expressions (port of spark_rapids_tpu/ops/stringops.py :40,
:84-203, :256-304 and :419; reference: stringFunctions.scala — length,
substring, startsWith, endsWith, contains, like, locate).

The device engine runs the kernels of columnar/strings.py (K12 for the
searches, K13 + K7 for SUBSTRING, K8 for an exact LIKE, K17 for length and
locate); the CPU engine
runs Python string operations over the object arrays, as the reference's
CPU branches do.
"""

from __future__ import annotations

import re

import numpy as np

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import (
    BinaryExpression,
    TernaryExpression,
    UnaryExpression,
    _d,
    _fold_result,
    _lift_string_scalar,
    _scalar_fold_ctx,
)
from spark_rapids_tpu_torch.ops.values import (
    ColV,
    ScalarV,
    zero_nulls,
)


def _obj(fn, *arrs):
    """Apply a Python function row by row over object arrays."""
    return np.array([fn(*vals) for vals in zip(*arrs)], dtype=object)


def _like_regex(pattern: str):
    """SQL LIKE as an anchored regex (% -> .*, _ -> .) (reference :27)."""
    return re.compile(
        "^" + "".join(".*" if c == "%" else "." if c == "_" else re.escape(c)
                      for c in pattern) + "$", re.DOTALL)


def _host_substring(s: str, p: int, ln: int) -> str:
    """Spark SUBSTRING of one Python string (reference :97)."""
    ln = max(ln, 0)
    if p > 0:
        start = p - 1
    elif p < 0:
        start = max(len(s) + p, 0)
    else:
        start = 0
    return s[start:start + ln]


class Substring(TernaryExpression):
    """substring(str, pos, len): 1-based, a negative pos counts from the end
    (reference :84)."""

    @property
    def data_type(self):
        return DataType.STRING

    def do_columnar(self, ctx, sv, pv, lv):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.substring_utf8(ctx, sv, _d(pv), _d(lv))
        pos = pv.data if isinstance(pv, ColV) else \
            np.full(ctx.capacity, pv.value)
        ln = lv.data if isinstance(lv, ColV) else \
            np.full(ctx.capacity, lv.value)
        return _obj(lambda s, p, n: _host_substring(s, int(p), int(n)),
                    sv.data, pos, ln)


class _NeedleOp(BinaryExpression):
    """StartsWith / EndsWith / Contains: the right side must be a foldable
    string literal, as in the reference (:138)."""

    _host_fn = None
    _device_fn = ""

    @property
    def data_type(self):
        return DataType.BOOL

    def eval_scalars(self, lv, rv):
        return ScalarV(DataType.BOOL, self._host_fn(lv.value, rv.value))

    def do_columnar(self, ctx, lv, rv):
        assert isinstance(rv, ScalarV), \
            f"{type(self).__name__} needs a scalar needle"
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return getattr(S, self._device_fn)(ctx, lv, rv.value)
        f = self._host_fn
        return np.array([f(s, rv.value) for s in lv.data], dtype=bool)


class StartsWith(_NeedleOp):
    _host_fn = staticmethod(lambda s, n: s.startswith(n))
    _device_fn = "starts_with"


class EndsWith(_NeedleOp):
    _host_fn = staticmethod(lambda s, n: s.endswith(n))
    _device_fn = "ends_with"


class Contains(_NeedleOp):
    _host_fn = staticmethod(lambda s, n: n in s)
    _device_fn = "contains"


class Like(BinaryExpression):
    """SQL LIKE (reference :178). The device engine takes the patterns of
    columnar/strings.py:classify_like and raises on any other, as the
    reference does: its rule table gives Like no tag, so such a pattern
    reaches the device kernel."""

    @property
    def data_type(self):
        return DataType.BOOL

    def eval_scalars(self, lv, rv):
        return ScalarV(DataType.BOOL,
                       bool(_like_regex(rv.value).match(lv.value)))

    def do_columnar(self, ctx, lv, rv):
        assert isinstance(rv, ScalarV)
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.like_match(ctx, lv, rv.value)
        pat = _like_regex(rv.value)
        return np.array([bool(pat.match(s)) for s in lv.data], dtype=bool)


class Length(UnaryExpression):
    """Character length (reference :40, GpuLength): K17 on the device."""

    @property
    def data_type(self):
        return DataType.INT32

    def do_columnar(self, ctx, v):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.utf8_char_lengths(v.offsets, v.data)
        return np.array([len(s) for s in v.data], dtype=np.int32)


class _ScalarArgsTernary(TernaryExpression):
    """A ternary whose 2nd and 3rd operands stay scalars (the base template
    lifts string scalars to columns, which a needle kernel cannot take;
    reference :256)."""

    def eval_kernel(self, ctx, av, bv, cv):
        for v in (bv, cv):
            if not isinstance(v, ScalarV):
                raise TypeError(
                    f"{type(self).__name__} requires scalar arguments")
        if bv.is_null or cv.is_null or \
                (isinstance(av, ScalarV) and av.is_null):
            return ColV(self.data_type, ctx.full(0, self.data_type),
                        ctx.bools(False))
        if isinstance(av, ScalarV):
            if not ctx.is_device:
                lifted = ColV(DataType.STRING,
                              np.array([av.value], dtype=object),
                              np.array([True]))
                return _fold_result(self.data_type, self.do_columnar(
                    _scalar_fold_ctx(), lifted, bv, cv))
            av = _lift_string_scalar(ctx, av)
        data = self.do_columnar(ctx, av, bv, cv)
        validity = av.validity
        return ColV(self.data_type, zero_nulls(data, validity), validity)


class StringLocate(_ScalarArgsTernary):
    """locate(substr, str, start): 1-based character position, 0 if absent
    (reference :419, GpuStringLocate; scalar substr and start). The child
    order is (str, substr, start)."""

    @property
    def data_type(self):
        return DataType.INT32

    def do_columnar(self, ctx, sv, nv, pv):
        start = int(pv.value)
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.locate(sv.offsets, sv.data, nv.value.encode("utf-8"),
                            start)

        def loc(s):
            if start < 1:
                return 0
            if nv.value == "":
                return start if start <= len(s) + 1 else 0
            return s.find(nv.value, start - 1) + 1

        return np.fromiter((loc(s) for s in sv.data), dtype=np.int32,
                           count=len(sv.data))
