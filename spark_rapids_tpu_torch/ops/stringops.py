"""String expressions (port of spark_rapids_tpu/ops/stringops.py :84-203;
reference: stringFunctions.scala — substring, startsWith, endsWith,
contains, like).

The device engine runs the kernels of columnar/strings.py (K12 for the
searches, K13 + K7 for SUBSTRING, K8 for an exact LIKE); the CPU engine
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
    _d,
)
from spark_rapids_tpu_torch.ops.values import ColV, ScalarV


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
