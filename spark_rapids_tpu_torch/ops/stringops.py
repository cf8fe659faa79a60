"""String expressions (port of spark_rapids_tpu/ops/stringops.py;
reference: stringFunctions.scala — length, substring, startsWith,
endsWith, contains, like, locate, upper / lower / initcap, concat,
concat_ws, trim, replace, regexp_replace, substring_index).

The device engine runs the kernels of columnar/strings.py (K12 for the
searches, K13 + K7 for SUBSTRING, K8 for an exact LIKE, K17 for length and
locate, K37 for the case maps, K38 + K7 for trim and substring_index, K39
for replace and literal regexp_replace, K40 for concat and concat_ws); the
CPU engine runs Python string operations over the object arrays, as the
reference's CPU branches do.

One difference from the reference's CPU branches: they apply a string
method to every row, and a NULL row of a string result holds 0 there
(`zero_nulls`), so a string function over another's result with a NULL
row raises AttributeError (upper(lower(c))). The port's transforms read
NULL rows as '' (`_texts`); their results are NULL either way.
"""

from __future__ import annotations

import re

import numpy as np

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import (
    BinaryExpression,
    Expression,
    TernaryExpression,
    UnaryExpression,
    _d,
    _fold_result,
    _lift_string_scalar,
    _null_string_col,
    _scalar_fold_ctx,
)
from spark_rapids_tpu_torch.ops.values import (
    ColV,
    ScalarV,
    and_validity,
    zero_nulls,
)


def _obj(fn, *arrs):
    """Apply a Python function row by row over object arrays."""
    return np.array([fn(*vals) for vals in zip(*arrs)], dtype=object)


def _texts(v: ColV):
    """A CPU-engine string column's rows, '' at NULL rows."""
    if v.validity is None or bool(np.all(v.validity)):
        return v.data
    return np.where(v.validity, v.data, "")


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
            if self.data_type is DataType.STRING:
                return _null_string_col(ctx)
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
        if isinstance(data, ColV):  # string kernels return a whole column
            return ColV(data.dtype, data.data,
                        and_validity(data.validity, validity), data.offsets,
                        data.max_len)
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


# ---------------------------------------------------------------------------
# B15's rest (reference :55-82, :116-136, :205-417, :449-518)
# ---------------------------------------------------------------------------
class Upper(UnaryExpression):
    """Uppercase (reference :55). The device kernel (K37) is ASCII only:
    other bytes pass through, so the plan rewrite marks it incompat."""

    @property
    def data_type(self):
        return DataType.STRING

    def do_columnar(self, ctx, v):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.upper_ascii(v)
        return _obj(lambda s: s.upper(), _texts(v))


class Lower(UnaryExpression):
    """Lowercase (reference :71); K37, ASCII only, as Upper."""

    @property
    def data_type(self):
        return DataType.STRING

    def do_columnar(self, ctx, v):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.lower_ascii(v)
        return _obj(lambda s: s.lower(), _texts(v))


class InitCap(UnaryExpression):
    """initcap: each space-separated word's first letter uppercased, the
    rest lowercased (reference :449, GpuInitCap); K37, ASCII only, as
    Upper."""

    @property
    def data_type(self):
        return DataType.STRING

    def do_columnar(self, ctx, v):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.initcap_ascii(ctx, v)

        def cap_words(s):
            return " ".join(w[:1].upper() + w[1:].lower()
                            for w in s.split(" "))

        return _obj(cap_words, _texts(v))


class Concat(BinaryExpression):
    """concat(a, b) (reference :116): binary, as the reference's is, so
    F.concat of three columns raises TypeError; K40 on the device."""

    @property
    def data_type(self):
        return DataType.STRING

    def do_columnar(self, ctx, lv, rv):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.concat2(ctx, lv, rv)

        def side(v):
            if isinstance(v, ScalarV):
                return [v.value] * ctx.capacity
            return _texts(v)

        return _obj(lambda a, b: a + b, side(lv), side(rv))


class StringTrim(UnaryExpression):
    """TRIM of 0x20 (reference :205); K38 + K7 on the device."""

    _side = "both"

    @property
    def data_type(self):
        return DataType.STRING

    def do_columnar(self, ctx, v):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.trim_spaces(ctx, v, self._side)
        fn = {"both": str.strip, "left": str.lstrip,
              "right": str.rstrip}[self._side]
        return _obj(lambda s: fn(s, " "), _texts(v))


class StringTrimLeft(StringTrim):
    _side = "left"


class StringTrimRight(StringTrim):
    _side = "right"


def _java_replacement_to_python(repl: str) -> str:
    """A Java Matcher.replaceAll replacement as a Python re template
    (reference :229): $N -> \\g<N>, a backslash-escaped character -> that
    literal character."""
    out = []
    i, n = 0, len(repl)
    while i < n:
        ch = repl[i]
        if ch == "\\" and i + 1 < n:
            nxt = repl[i + 1]
            out.append("\\\\" if nxt == "\\" else nxt)
            i += 2
        elif ch == "$" and i + 1 < n and repl[i + 1].isdigit():
            j = i + 1
            while j < n and repl[j].isdigit():
                j += 1
            out.append(f"\\g<{repl[i + 1:j]}>")
            i = j
        elif ch == "\\":
            out.append("\\\\")  # a trailing backslash stays literal
            i += 1
        else:
            out.append(ch)
            i += 1
    return "".join(out)


class StringReplace(_ScalarArgsTernary):
    """replace(str, search, replacement) with literal search and
    replacement (reference :306, GpuStringReplace). An empty search leaves
    the string as it is (Python's str.replace would interleave). K39 on
    the device, which needs a search of one byte or without a border; the
    plan rewrite keeps the others on the CPU engine."""

    @property
    def data_type(self):
        return DataType.STRING

    def do_columnar(self, ctx, sv, fv, rv):
        if fv.value == "":
            return sv
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.replace_literal(ctx, sv, fv.value, rv.value)
        return _obj(lambda s: s.replace(fv.value, rv.value), _texts(sv))


def _host_substring_index(s: str, d: str, n: int) -> str:
    """Java UTF8String.subStringIndex (reference :350): occurrences may
    overlap (the scan moves one position, not the delimiter's length), so
    a delimiter with a border counts as Java counts it."""
    if n == 0 or d == "":
        return ""
    if n > 0:
        idx = -1
        for _ in range(n):
            idx = s.find(d, idx + 1)
            if idx == -1:
                return s
        return s[:idx]
    bound = len(s)
    idx = -1
    for _ in range(-n):
        idx = s.rfind(d, 0, bound)
        if idx == -1:
            return s
        bound = idx + len(d) - 1
    return s[idx + len(d):]


class SubstringIndex(_ScalarArgsTernary):
    """substring_index(str, delim, count) with literal delim and count
    (reference :330, GpuSubstringIndex): the part before the count-th delim
    (count > 0) or after the |count|-th from the end (count < 0). K38 + K7
    on the device, which needs a delimiter of one byte or without a
    border; the plan rewrite keeps the others on the CPU engine."""

    @property
    def data_type(self):
        return DataType.STRING

    def do_columnar(self, ctx, sv, dv, cv):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.substring_index(ctx, sv, dv.value, int(cv.value))
        d, n = dv.value, int(cv.value)
        return _obj(lambda s: _host_substring_index(s, d, n), _texts(sv))


class RegExpReplace(_ScalarArgsTernary):
    """regexp_replace(str, pattern, replacement) (reference :377). The
    device engine takes a literal pattern with no regex metacharacter
    (K39: a literal replace); the plan rewrite keeps any other on the CPU
    engine, where Python's re runs it with Java's replacement syntax."""

    # the reference's regexList (metacharacter blocklist) plus '+'
    REGEX_CHARS = ("\\", "\x00", "\t", "\n", "\r", "\f", "[", "]", "^",
                   "&", ".", "*", "+", "$", "?", "|", "(", ")", "{", "}",
                   ":", "!", "<=", ">")

    @classmethod
    def is_simple_pattern(cls, pattern: str) -> bool:
        return not any(ch in pattern for ch in cls.REGEX_CHARS)

    @property
    def data_type(self):
        return DataType.STRING

    def do_columnar(self, ctx, sv, pv, rv):
        if ctx.is_device:
            from spark_rapids_tpu_torch.columnar import strings as S

            return S.replace_literal(ctx, sv, pv.value, rv.value)
        pat = re.compile(pv.value)
        repl = rv.value
        if "$" in repl or "\\" in repl:
            py_repl = _java_replacement_to_python(repl)
            return _obj(lambda s: pat.sub(py_repl, s), _texts(sv))
        return _obj(lambda s: pat.sub(lambda _m: repl, s), _texts(sv))


class ConcatWs(Expression):
    """concat_ws(sep, c1, c2, ...): the non-NULL values joined by sep,
    never NULL (reference :471); K40 on the device."""

    def __init__(self, sep: str, children):
        self.sep = sep
        self._children = tuple(children)

    def children(self):
        return self._children

    def with_children(self, new_children):
        return ConcatWs(self.sep, new_children)

    @property
    def data_type(self):
        return DataType.STRING

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        from spark_rapids_tpu_torch.columnar import strings as S

        vals = [c.eval(ctx) for c in self._children]
        if all(isinstance(v, ScalarV) for v in vals):
            return ScalarV(DataType.STRING, self.sep.join(
                v.value for v in vals if not v.is_null))
        if ctx.is_device:
            from spark_rapids_tpu_torch.ops.eval import scalar_to_colv

            vals = [scalar_to_colv(ctx, v, DataType.STRING)
                    if isinstance(v, ScalarV) else v for v in vals]
        return S.concat_ws(ctx, self.sep, vals)

    def _fingerprint_extra(self):
        return f"ws:{self.sep!r};"

    def __repr__(self):
        return (f"concat_ws({self.sep!r}, "
                f"{', '.join(map(repr, self._children))})")
