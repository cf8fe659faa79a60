"""User-facing function library (port of spark_rapids_tpu/plan/functions.py).

`from_unixtime` takes the default format only: the reference's passes a
second argument to a one-argument expression and raises TypeError
(ROADMAP §3), and the port's expression formats nothing."""

from __future__ import annotations

from typing import Any, Union

from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import bitwise as B
from spark_rapids_tpu_torch.ops import datetimeops as DT
from spark_rapids_tpu_torch.ops import mathx as MX
from spark_rapids_tpu_torch.ops import misc as MISC
from spark_rapids_tpu_torch.ops import nulls as N
from spark_rapids_tpu_torch.ops import stringops as S
from spark_rapids_tpu_torch.ops import window as W
from spark_rapids_tpu_torch.ops.base import Expression
from spark_rapids_tpu_torch.ops.conditional import CaseWhen, If
from spark_rapids_tpu_torch.ops.literals import Literal
from spark_rapids_tpu_torch.plan.column import Column, _to_expr

ColumnOrName = Union[Column, str]


def col(name: str) -> Column:
    """An unresolved named column, resolved against the DataFrame schema
    when the plan is built (plan/dataframe.py)."""
    return Column(_UnresolvedAttribute(name))


class _UnresolvedAttribute(Expression):
    """Placeholder resolved by DataFrame methods; never evaluated."""

    def __init__(self, name: str):
        self.name = name

    def children(self):
        return ()

    def with_children(self, new_children):
        return self

    @property
    def data_type(self):
        raise RuntimeError(f"unresolved column {self.name!r}")

    def eval(self, ctx):
        raise RuntimeError(f"unresolved column {self.name!r}")

    def _fingerprint_extra(self):
        return f"{self.name};"

    def __repr__(self):
        return f"'{self.name}"


def lit(v: Any) -> Column:
    return Column(Literal(v))


def _c(e: ColumnOrName) -> Expression:
    if isinstance(e, str):
        return _UnresolvedAttribute(e)
    return _to_expr(e)


# -- conditional (reference :73-90) -------------------------------------------
def when(cond: Column, value) -> "CaseBuilder":
    return CaseBuilder([(cond.expr, _to_expr(value))])


class CaseBuilder:
    def __init__(self, branches):
        self._branches = branches

    def when(self, cond: Column, value) -> "CaseBuilder":
        return CaseBuilder(self._branches + [(cond.expr, _to_expr(value))])

    def otherwise(self, value) -> Column:
        return Column(CaseWhen(self._branches, _to_expr(value)))

    @property
    def expr(self):
        return CaseWhen(self._branches, None)


def expr_if(cond: Column, a, b) -> Column:
    return Column(If(cond.expr, _to_expr(a), _to_expr(b)))


def substring(c: ColumnOrName, pos: int, length_: int) -> Column:
    """Reference :198."""
    return Column(S.Substring(_c(c), Literal(pos), Literal(length_)))


def length(c: ColumnOrName) -> Column:
    """Reference :186."""
    return Column(S.Length(_c(c)))


def locate(substr: str, c: ColumnOrName, pos: int = 1) -> Column:
    """1-based position of substr in c, 0 if absent (reference :228)."""
    return Column(S.StringLocate(_c(c), Literal(substr), Literal(pos)))


# -- string transforms (reference :190-247) ----------------------------------
def upper(c: ColumnOrName) -> Column:
    return Column(S.Upper(_c(c)))


def lower(c: ColumnOrName) -> Column:
    return Column(S.Lower(_c(c)))


def initcap(c: ColumnOrName) -> Column:
    return Column(S.InitCap(_c(c)))


def substring_index(c: ColumnOrName, delim: str, count: int) -> Column:
    return Column(S.SubstringIndex(_c(c), Literal(delim), Literal(count)))


def concat(*cols: ColumnOrName) -> Column:
    """Binary, as the reference's: three columns raise TypeError."""
    return Column(S.Concat(*[_c(c) for c in cols]))


def trim(c: ColumnOrName) -> Column:
    return Column(S.StringTrim(_c(c)))


def ltrim(c: ColumnOrName) -> Column:
    return Column(S.StringTrimLeft(_c(c)))


def rtrim(c: ColumnOrName) -> Column:
    return Column(S.StringTrimRight(_c(c)))


def regexp_replace(c: ColumnOrName, pattern: str, repl: str) -> Column:
    """Only literal (metacharacter-free) patterns run on the device, as in
    the reference (GpuOverrides.scala:1458-1468)."""
    return Column(S.RegExpReplace(_c(c), Literal(pattern), Literal(repl)))


def concat_ws(sep: str, *cols: ColumnOrName) -> Column:
    """Join the non-NULL values with sep; '' (never NULL) when all are
    NULL, as Spark."""
    if not cols:
        raise ValueError("concat_ws requires at least one column")
    return Column(S.ConcatWs(sep, [_c(c) for c in cols]))


def replace(c: ColumnOrName, search: str, repl: str) -> Column:
    return Column(S.StringReplace(_c(c), Literal(search), Literal(repl)))


# -- date parts (reference :251) ---------------------------------------------
def year(c: ColumnOrName) -> Column:
    return Column(DT.Year(_c(c)))


def month(c: ColumnOrName) -> Column:
    return Column(DT.Month(_c(c)))


def dayofmonth(c: ColumnOrName) -> Column:
    return Column(DT.DayOfMonth(_c(c)))


def hour(c: ColumnOrName) -> Column:
    return Column(DT.Hour(_c(c)))


def minute(c: ColumnOrName) -> Column:
    return Column(DT.Minute(_c(c)))


def second(c: ColumnOrName) -> Column:
    return Column(DT.Second(_c(c)))


def quarter(c: ColumnOrName) -> Column:
    return Column(DT.Quarter(_c(c)))


def unix_timestamp(c: ColumnOrName) -> Column:
    return Column(DT.UnixTimestamp(_c(c)))


# -- math (reference :143) ---------------------------------------------------
def dayofweek(c: ColumnOrName) -> Column:
    return Column(DT.DayOfWeek(_c(c)))


def weekday(c: ColumnOrName) -> Column:
    return Column(DT.WeekDay(_c(c)))


def dayofyear(c: ColumnOrName) -> Column:
    return Column(DT.DayOfYear(_c(c)))


def last_day(c: ColumnOrName) -> Column:
    return Column(DT.LastDay(_c(c)))


def datediff(end: ColumnOrName, start: ColumnOrName) -> Column:
    return Column(DT.DateDiff(_c(end), _c(start)))


def date_add(c: ColumnOrName, days) -> Column:
    return Column(DT.DateAdd(_c(c), _to_expr(days)))


def date_sub(c: ColumnOrName, days) -> Column:
    return Column(DT.DateSub(_c(c), _to_expr(days)))


def to_unix_timestamp(c: ColumnOrName) -> Column:
    return Column(DT.ToUnixTimestamp(_c(c)))


def from_unixtime(c: ColumnOrName, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    if fmt != "yyyy-MM-dd HH:mm:ss":
        raise ValueError(f"from_unixtime: format {fmt!r} is not supported "
                         "(the default format only)")
    return Column(DT.FromUnixTime(_c(c)))


# -- math (reference :113-182) -------------------------------------------------
def _unary(klass):
    def fn(c: ColumnOrName) -> Column:
        return Column(klass(_c(c)))
    fn.__name__ = klass.__name__.lower()
    return fn


sqrt = _unary(MX.Sqrt)
exp = _unary(MX.Exp)
expm1 = _unary(MX.Expm1)
log = _unary(MX.Log)
log1p = _unary(MX.Log1p)
log2 = _unary(MX.Log2)
log10 = _unary(MX.Log10)
cbrt = _unary(MX.Cbrt)
sin = _unary(MX.Sin)
cos = _unary(MX.Cos)
tan = _unary(MX.Tan)
asin = _unary(MX.Asin)
acos = _unary(MX.Acos)
atan = _unary(MX.Atan)
sinh = _unary(MX.Sinh)
cosh = _unary(MX.Cosh)
tanh = _unary(MX.Tanh)
asinh = _unary(MX.Asinh)
acosh = _unary(MX.Acosh)
atanh = _unary(MX.Atanh)
cot = _unary(MX.Cot)
rint = _unary(MX.Rint)
degrees = _unary(MX.ToDegrees)
radians = _unary(MX.ToRadians)
abs_ = _unary(AR.Abs)
signum = _unary(AR.Signum)


def pow(a: ColumnOrName, b) -> Column:  # noqa: A001
    return Column(MX.Pow(_c(a), _to_expr(b)))


def log_base(base, c: ColumnOrName) -> Column:
    """log(base, x) (Spark's two-argument log)."""
    return Column(MX.Logarithm(_to_expr(base), _c(c)))


def atan2(a: ColumnOrName, b) -> Column:
    return Column(MX.Atan2(_c(a), _to_expr(b)))


def shiftleft(c: ColumnOrName, n: int) -> Column:
    return Column(B.ShiftLeft(_c(c), Literal(n)))


def shiftright(c: ColumnOrName, n: int) -> Column:
    return Column(B.ShiftRight(_c(c), Literal(n)))


def shiftrightunsigned(c: ColumnOrName, n: int) -> Column:
    return Column(B.ShiftRightUnsigned(_c(c), Literal(n)))


def bitwise_not(c: ColumnOrName) -> Column:
    return Column(B.BitwiseNot(_c(c)))


def isnan(c: ColumnOrName) -> Column:
    return Column(N.IsNan(_c(c)))


def nanvl(a: ColumnOrName, b: ColumnOrName) -> Column:
    return Column(N.NaNvl(_c(a), _c(b)))


# -- nondeterministic and context (reference :321-342) ------------------------
def rand(seed: int = 0) -> Column:
    return Column(MISC.Rand(seed))


def monotonically_increasing_id() -> Column:
    return Column(MISC.MonotonicallyIncreasingID())


def spark_partition_id() -> Column:
    return Column(MISC.SparkPartitionID())


def input_file_name() -> Column:
    return Column(MISC.InputFileName())


def input_file_block_start() -> Column:
    return Column(MISC.InputFileBlockStart())


def input_file_block_length() -> Column:
    return Column(MISC.InputFileBlockLength())


def floor(c: ColumnOrName) -> Column:
    return Column(MX.Floor(_c(c)))


def ceil(c: ColumnOrName) -> Column:
    return Column(MX.Ceil(_c(c)))


# -- generators (reference :289-318) ------------------------------------------
def array(*cols: ColumnOrName) -> Column:
    """array(e1, e2, ...) — consumable only by explode()/posexplode()."""
    from spark_rapids_tpu_torch.ops.generators import CreateArray

    return Column(CreateArray([_c(c) for c in cols]))


def explode(c: Column) -> Column:
    """One output row per array element per input row. Requires
    array(...)."""
    from spark_rapids_tpu_torch.ops.generators import CreateArray, Explode

    e = _to_expr(c)
    if not isinstance(e, CreateArray):
        raise TypeError("explode() requires array(...) — arrays exist only "
                        "as created arrays (flat column types)")
    return Column(Explode(e))


def posexplode(c: Column) -> Column:
    """explode() plus the element position column."""
    from spark_rapids_tpu_torch.ops.generators import CreateArray, PosExplode

    e = _to_expr(c)
    if not isinstance(e, CreateArray):
        raise TypeError("posexplode() requires array(...)")
    return Column(PosExplode(e))


def coalesce(*cols: ColumnOrName) -> Column:
    return Column(N.Coalesce(*[_c(c) for c in cols]))


def isnull(c: ColumnOrName) -> Column:
    return Column(N.IsNull(_c(c)))


def pmod(a: ColumnOrName, b) -> Column:
    return Column(AR.Pmod(_c(a), _to_expr(b)))


def sum(c: ColumnOrName) -> Column:  # noqa: A001
    return Column(A.Sum(_c(c)))


def min(c: ColumnOrName) -> Column:  # noqa: A001
    return Column(A.Min(_c(c)))


def max(c: ColumnOrName) -> Column:  # noqa: A001
    return Column(A.Max(_c(c)))


def count(c: ColumnOrName = "*") -> Column:
    if isinstance(c, str) and c == "*":
        return Column(A.Count(Literal(1)))
    return Column(A.Count(_c(c)))


def avg(c: ColumnOrName) -> Column:
    return Column(A.Average(_c(c)))


def percentile(c: ColumnOrName, p: float) -> Column:
    """Exact percentile at fraction p in [0, 1] (Spark `percentile`)."""
    return Column(A.Percentile(_c(c), p))


def first(c: ColumnOrName, ignorenulls: bool = False) -> Column:
    return Column(A.First(_c(c), ignorenulls))


def last(c: ColumnOrName, ignorenulls: bool = False) -> Column:
    return Column(A.Last(_c(c), ignorenulls))


mean = avg


# -- window functions (reference :385-418) -----------------------------------
def row_number() -> Column:
    return Column(W.RowNumber())


def rank() -> Column:
    return Column(W.Rank())


def dense_rank() -> Column:
    return Column(W.DenseRank())


def ntile(n: int) -> Column:
    return Column(W.NTile(n))


def lead(c: ColumnOrName, offset: int = 1, default=None) -> Column:
    return Column(W.Lead(_c(c), offset, default))


def lag(c: ColumnOrName, offset: int = 1, default=None) -> Column:
    return Column(W.Lag(_c(c), offset, default))
