"""TpuOverrides: the CPU -> device plan rewrite and its rule table (port
of spark_rapids_tpu/plan/overrides.py; reference: GpuOverrides.scala).

Only what the port's slices cover has a rule: an expression or exec without one
cannot go on the device, stays on the CPU engine, and `explain("ALL")`
reports why. The reference's `import jax` at overrides.py:17 was unused and
has no counterpart here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.base import PhysicalExec
from spark_rapids_tpu_torch.ops import aggregates as AGG
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import bitwise as BW
from spark_rapids_tpu_torch.ops import datetimeops as DT
from spark_rapids_tpu_torch.ops import mathx as MX
from spark_rapids_tpu_torch.ops import misc as MISC
from spark_rapids_tpu_torch.ops import nulls as N
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import stringops as S
from spark_rapids_tpu_torch.ops.base import (
    Alias,
    AttributeReference,
    BoundReference,
    Expression,
)
from spark_rapids_tpu_torch.ops.cast import Cast
from spark_rapids_tpu_torch.ops.conditional import CaseWhen, If
from spark_rapids_tpu_torch.ops.literals import Literal
from spark_rapids_tpu_torch.plan import meta as MT
from spark_rapids_tpu_torch.plan.meta import ExecMeta, ExecRule, ExprMeta, ExprRule

EXPR_RULES: Dict[Type[Expression], ExprRule] = {}
EXEC_RULES: Dict[Type[PhysicalExec], ExecRule] = {}


def register_expr(expr_cls, desc, incompat=None, disabled_by_default=False,
                  tag_fn=None):
    rule = ExprRule(expr_cls, desc, incompat, disabled_by_default, tag_fn)
    EXPR_RULES[expr_cls] = rule
    return rule


def register_exec(cpu_cls, desc, convert, incompat=None,
                  disabled_by_default=False, tag_fn=None):
    rule = ExecRule(cpu_cls, desc, convert, incompat, disabled_by_default,
                    tag_fn)
    EXEC_RULES[cpu_cls] = rule
    return rule


def _tag_cast(m: ExprMeta) -> None:
    """The reference's gates (:241-300), reasons word for word: FLOAT ->
    STRING, STRING -> FLOAT and STRING -> TIMESTAMP under their conf keys
    (RapidsConf.scala:393-425), the float directions on an f64 backend,
    ANSI parses on the CPU engine; the rest of what `device_supported`
    refuses has no device kernel. The reference then tags DOUBLE on a TPU
    (`_tag_f64_on_tpu`), which an H100 never needs."""
    e: Cast = m.expr
    src = e.child.data_type
    dst = e.to_type
    if Cast.device_supported(src, dst):
        return
    from spark_rapids_tpu_torch.columnar.batch import (
        device_float64_supported,
    )

    if src.is_floating and dst is DataType.STRING:
        if not m.conf.get(C.ENABLE_CAST_FLOAT_TO_STRING):
            m.will_not_work(
                "cast float->STRING on device is disabled by default "
                "(set rapids.tpu.sql.castFloatToString.enabled; output "
                "follows this framework's shortest-round-trip "
                "convention, not Java's)")
        elif not device_float64_supported():
            m.will_not_work(
                "cast float->STRING device kernel needs an f64-capable "
                "backend (shortest-decimal search runs in f64)")
        return
    if src is DataType.STRING and dst.is_floating:
        if not m.conf.get(C.ENABLE_CAST_STRING_TO_FLOAT):
            m.will_not_work(
                "cast STRING->float on device is disabled by default "
                "(set rapids.tpu.sql.castStringToFloat.enabled)")
        elif not device_float64_supported():
            m.will_not_work(
                "cast STRING->float device kernel needs an f64-capable "
                "backend")
        elif e.ansi:
            m.will_not_work("ANSI STRING->float cast runs on the CPU "
                            "engine (deferred device errors only "
                            "surface at project/filter boundaries)")
        return
    if src is DataType.STRING and dst is DataType.TIMESTAMP:
        if not m.conf.get(C.ENABLE_CAST_STRING_TO_TIMESTAMP):
            m.will_not_work(
                "cast STRING->TIMESTAMP on device is disabled by "
                "default (set "
                "rapids.tpu.sql.castStringToTimestamp.enabled)")
        elif e.ansi:
            m.will_not_work("ANSI STRING->TIMESTAMP cast runs on the "
                            "CPU engine (deferred device errors only "
                            "surface at project/filter boundaries)")
        return
    m.will_not_work(
        f"cast {getattr(src, 'name', src)}->{getattr(dst, 'name', dst)} "
        "has no device kernel")


def _tag_window_expr(m: ExprMeta) -> None:
    """Window shapes the device kernels do not cover (reference
    :305-342)."""
    from spark_rapids_tpu_torch.exec.window import RANGE_KEY_TYPES
    from spark_rapids_tpu_torch.ops import window as W

    w = m.expr
    f = w.function
    frame = w.spec.frame
    if frame.frame_type == "range" and (
            frame.lower not in (W.UNBOUNDED, 0)
            or frame.upper not in (W.UNBOUNDED, 0)):
        # bounded RANGE frames binary-search the one integer-kind ORDER BY
        # key (K16); float keys would round at the frame edges
        ob = w.spec.order_by
        dt = ob[0].child.data_type if len(ob) == 1 else None
        if dt not in RANGE_KEY_TYPES:
            m.will_not_work(
                "bounded range frames need exactly one integer/date/"
                "timestamp ORDER BY column on the device engine")
    input_child = f.children()[0] if f.children() else None
    if input_child is not None and \
            input_child.data_type is DataType.STRING:
        m.will_not_work(
            "window functions over STRING inputs run on the CPU engine "
            "(no device string gather in the window kernel yet)")
    if isinstance(f, W.NTile) and f.n <= 0:
        m.will_not_work("ntile(n) requires n > 0")


def _literal_value(e):
    """The value of a literal argument (under any unary wrapper), else
    None (reference :140)."""
    node = e
    while hasattr(node, "child") and not isinstance(node, Literal):
        node = node.child
    return node.value if isinstance(node, Literal) else None


def _borderless_literal_tag(child_idx: int, what: str):
    """The device gate of K38's and K39's needles (reference :148): a
    literal, one byte or without a border, so matches never overlap and
    byte-order ranks equal Java's one-position scan."""
    def tag(m: ExprMeta) -> None:
        from spark_rapids_tpu_torch.columnar.strings import has_border

        v = _literal_value(m.expr.children()[child_idx])
        if not isinstance(v, str):
            m.will_not_work(f"{what} needs a literal string argument")
        elif len(v.encode("utf-8")) > 1 and has_border(v.encode("utf-8")):
            m.will_not_work(
                f"device {what} requires a self-overlap-free string "
                f"({v!r} can overlap itself)")
    return tag


def _tag_regexp_replace(m: ExprMeta) -> None:
    """Reference :168: the device replaces literally, so a $ or \\ in the
    replacement, an empty or non-literal pattern, a pattern with regex
    metacharacters or one with a border runs on the CPU engine."""
    from spark_rapids_tpu_torch.columnar.strings import has_border

    repl = _literal_value(m.expr.children()[2])
    if isinstance(repl, str) and ("$" in repl or "\\" in repl):
        m.will_not_work(
            "regexp replacement with $-references or escapes runs on "
            "the CPU (device replacement is literal)")
    pat = _literal_value(m.expr.children()[1])
    if not isinstance(pat, str) or pat == "":
        m.will_not_work("regexp_replace needs a non-empty literal pattern")
    elif not S.RegExpReplace.is_simple_pattern(pat):
        m.will_not_work(
            f"regexp pattern {pat!r} contains regex metacharacters; "
            "only literal patterns are supported on device")
    elif len(pat.encode("utf-8")) > 1 and has_border(pat.encode("utf-8")):
        m.will_not_work(
            f"device replace requires a self-overlap-free pattern "
            f"({pat!r} can overlap itself)")


def _tag_agg(m: ExprMeta) -> None:
    """Reference :345-366, reasons word for word: BOOL min / max reduce on
    the device (K3's bool lanes), min / max over a plain STRING column
    through K47, any other aggregate over STRING (first / last, or min /
    max of a computed string) on the CPU engine. The reference then tags
    DOUBLE on a TPU (`_tag_f64_on_tpu`), which an H100 never needs."""
    e = m.expr
    if isinstance(e, (AGG.Sum, AGG.Average)) and \
            e.child.data_type.is_floating:
        if not m.conf.get(C.ENABLE_FLOAT_AGG):
            m.will_not_work(
                "float aggregation order differs from CPU; set "
                "rapids.tpu.sql.variableFloatAgg.enabled=true")
    if e.child.data_type is DataType.STRING and not isinstance(e, AGG.Count):
        if isinstance(e, (AGG.Min, AGG.Max)) and \
                isinstance(e.child, AttributeReference):
            # device string min/max via the arg-extreme reduction (K47);
            # computed string inputs need a length bound -> CPU
            pass
        else:
            m.will_not_work(
                "this aggregate over STRING inputs runs on the CPU engine "
                "(device string reductions cover min/max of plain columns "
                "and count)")


def _register_expr_rules():
    r = register_expr
    r(Alias, "name a result")
    r(AttributeReference, "reference an input column")
    r(BoundReference, "ordinal input reference")
    r(Literal, "literal value (numeric, boolean, DATE, TIMESTAMP, DECIMAL, "
               "STRING)")
    r(Cast, "cast between types", tag_fn=_tag_cast)
    for cls in (AR.Add, AR.Subtract, AR.Multiply, AR.Divide,
                AR.IntegralDivide, AR.Remainder, AR.Pmod, AR.UnaryMinus,
                AR.UnaryPositive, AR.Abs, AR.Signum):
        r(cls, f"arithmetic {cls.__name__}")
    for cls in (P.EqualTo, P.LessThan, P.LessThanOrEqual, P.GreaterThan,
                P.GreaterThanOrEqual, P.EqualNullSafe, P.And, P.Or, P.Not,
                P.In):
        r(cls, f"predicate {cls.__name__}")
    # math (reference :113-124): transcendental results can differ in ulps
    # from the CPU engine's libm
    for cls in (MX.Sin, MX.Cos, MX.Tan, MX.Asin, MX.Acos, MX.Atan, MX.Sinh,
                MX.Cosh, MX.Tanh, MX.Asinh, MX.Acosh, MX.Atanh, MX.Cot,
                MX.Exp, MX.Expm1, MX.Log, MX.Log1p, MX.Log2, MX.Log10,
                MX.Sqrt, MX.Cbrt, MX.Pow, MX.Atan2, MX.Logarithm):
        r(cls, f"math {cls.__name__}",
          incompat="floating point results may differ in ulps from the CPU")
    for cls in (MX.Rint, MX.ToDegrees, MX.ToRadians):
        r(cls, f"math {cls.__name__}")
    r(MX.NormalizeNaNAndZero, "normalize -0.0 and NaN for float keys")
    for cls in (BW.BitwiseAnd, BW.BitwiseOr, BW.BitwiseXor, BW.BitwiseNot,
                BW.ShiftLeft, BW.ShiftRight, BW.ShiftRightUnsigned):
        r(cls, f"bitwise {cls.__name__}")
    for cls in (N.IsNull, N.IsNotNull, N.IsNan, N.NaNvl, N.Coalesce,
                N.AtLeastNNonNulls):
        r(cls, f"null-handling {cls.__name__}")
    r(If, "if/else")
    r(CaseWhen, "case when")
    # strings (reference :135-202): Like has no tag there either, so a
    # pattern outside classify_like's subset raises in the device kernel
    for cls in (S.Substring, S.StartsWith, S.EndsWith, S.Contains, S.Like,
                S.Length, S.Concat, S.StringTrim, S.StringTrimLeft,
                S.StringTrimRight, S.ConcatWs):
        r(cls, f"string {cls.__name__}")
    r(S.StringReplace, "string StringReplace",
      tag_fn=_borderless_literal_tag(1, "replace"))
    r(S.RegExpReplace, "string RegExpReplace (literal patterns)",
      tag_fn=_tag_regexp_replace)
    r(S.StringLocate, "string locate (scalar substring/start)")
    r(S.SubstringIndex, "string substring_index (scalar delim/count)",
      tag_fn=_borderless_literal_tag(1, "substring_index"))
    for cls in (S.Upper, S.Lower, S.InitCap):
        r(cls, f"string {cls.__name__}",
          incompat="device case conversion is ASCII-only; non-ASCII "
                   "characters pass through unchanged")
    for cls in (MX.Floor, MX.Ceil):
        r(cls, f"math {cls.__name__}")
    for cls in (DT.Year, DT.Month, DT.DayOfMonth, DT.Hour, DT.Minute,
                DT.Second, DT.DateDiff, DT.DateAdd, DT.DateSub, DT.LastDay,
                DT.DayOfWeek, DT.WeekDay, DT.DayOfYear, DT.Quarter):
        r(cls, f"datetime {cls.__name__}")
    for cls in (DT.UnixTimestamp, DT.ToUnixTimestamp):
        r(cls, "parse/convert to unix seconds",
          incompat="range/overflow behavior differs slightly from CPU "
                   "(reference: improvedTimeOps)")
    r(DT.FromUnixTime, "format unix seconds as string")
    # nondeterministic and context (reference :216-222)
    r(MISC.Rand, "uniform random",
      incompat="the card's RNG stream differs from the CPU engine's")
    r(MISC.MonotonicallyIncreasingID, "monotonically increasing id")
    r(MISC.SparkPartitionID, "partition id")
    r(MISC.InputFileName, "input file name")
    r(MISC.InputFileBlockStart, "input file block start")
    r(MISC.InputFileBlockLength, "input file block length")
    for cls in (AGG.Min, AGG.Max, AGG.Sum, AGG.Count, AGG.Average,
                AGG.First, AGG.Last):
        r(cls, f"aggregate {cls.__name__}", tag_fn=_tag_agg)
    r(AGG.Percentile, "exact percentile (holistic sort-based aggregate)",
      tag_fn=_tag_agg)
    # window (reference :229-239)
    from spark_rapids_tpu_torch.ops import window as W

    r(W.WindowExpression, "function over a window spec",
      tag_fn=_tag_window_expr)
    for cls in (W.RowNumber, W.Rank, W.DenseRank, W.NTile):
        r(cls, f"window ranking {cls.__name__}")
    r(W.Lag, "value from a preceding row")
    r(W.Lead, "value from a following row")


def _computed_string_keys(orders) -> bool:
    return any(o.child.data_type is DataType.STRING and
               not isinstance(o.child, AttributeReference) for o in orders)


def _tag_sort(m: ExecMeta) -> None:
    if _computed_string_keys(m.plan.orders):
        # plain string columns sort on the device through K6; a computed
        # string key waits for the device string functions
        m.will_not_work("device ordering of computed string expressions is "
                        "not implemented (plain string columns sort on the "
                        "device)")


def _tag_exchange(m: ExecMeta) -> None:
    from spark_rapids_tpu_torch.shuffle import exchange as X

    p = m.plan.partitioning
    if isinstance(p, X.RangePartitioning) and \
            _computed_string_keys(p.orders):
        m.will_not_work("device range partitioning on computed string "
                        "expressions is not implemented")


def _register_exec_rules():
    from spark_rapids_tpu_torch.exec.aggregate import (
        CpuHashAggregateExec,
        TpuHashAggregateExec,
    )
    from spark_rapids_tpu_torch.exec import join as J
    from spark_rapids_tpu_torch.exec.cache import (
        CpuCachedScanExec,
        TpuCachedScanExec,
    )
    from spark_rapids_tpu_torch.exec.sort import CpuSortExec, TpuSortExec
    from spark_rapids_tpu_torch.exec.window import CpuWindowExec, TpuWindowExec
    from spark_rapids_tpu_torch.shuffle import exchange as X

    register_exec(
        B.CpuProjectExec, "columnar projection",
        lambda cpu, ch: B.TpuProjectExec(cpu.project_list, ch[0]))
    register_exec(
        B.CpuFilterExec, "columnar filter",
        lambda cpu, ch: B.TpuFilterExec(cpu.condition, ch[0]))
    register_exec(
        CpuHashAggregateExec, "hash aggregate (sort + segment reduce)",
        lambda cpu, ch: TpuHashAggregateExec(
            cpu.grouping, cpu.agg_exprs, cpu.mode, ch[0], cpu.specs))
    register_exec(
        X.CpuShuffleExchangeExec, "columnar shuffle exchange",
        lambda cpu, ch: X.TpuShuffleExchangeExec(cpu.partitioning, ch[0],
                                                 cpu.allow_adaptive),
        tag_fn=_tag_exchange)
    register_exec(
        CpuSortExec, "multi-key stable sort",
        lambda cpu, ch: TpuSortExec(cpu.orders, ch[0]), tag_fn=_tag_sort)
    register_exec(
        CpuCachedScanExec, "device-resident in-memory table cache",
        lambda cpu, ch: TpuCachedScanExec(cpu.logical_node, ch[0]))
    register_exec(
        B.CpuUnionExec, "union-all",
        lambda cpu, ch: B.TpuUnionExec(*ch))
    register_exec(
        CpuWindowExec, "window functions (K1 sort, K14-K16)",
        lambda cpu, ch: TpuWindowExec(cpu.window_exprs, ch[0]))
    register_exec(
        B.CpuLocalLimitExec, "per-partition limit",
        lambda cpu, ch: B.TpuLocalLimitExec(cpu.limit, ch[0]))
    register_exec(
        B.CpuGlobalLimitExec, "global limit",
        lambda cpu, ch: B.TpuGlobalLimitExec(cpu.limit, ch[0]))

    def _convert_join(tpu_cls):
        return lambda cpu, ch: tpu_cls(
            cpu.left_keys, cpu.right_keys, cpu.join_type, cpu.condition,
            ch[0], ch[1])

    register_exec(
        J.CpuShuffledHashJoinExec, "shuffled hash equi-join (K9-K11)",
        _convert_join(J.TpuShuffledHashJoinExec))
    register_exec(
        J.CpuBroadcastHashJoinExec, "broadcast hash equi-join (K9-K11)",
        _convert_join(J.TpuBroadcastHashJoinExec))
    register_exec(
        J.CpuNestedLoopJoinExec, "cross/nested-loop join",
        _convert_join(J.TpuNestedLoopJoinExec))

    from spark_rapids_tpu_torch.io.scan import (
        CpuFileScanExec,
        TpuFileScanExec,
    )

    _SCAN_KEYS = {"parquet": (C.PARQUET_READ_ENABLED,
                              C.PARQUET_DEVICE_DECODE),
                  "orc": (C.ORC_READ_ENABLED, C.ORC_DEVICE_DECODE),
                  "csv": (C.CSV_READ_ENABLED, C.CSV_DEVICE_PARSE)}

    def _tag_scan(m: ExecMeta) -> None:
        """Reference :490-511; the port reads Parquet, ORC and CSV. A device
        session decodes on the device or not at all: a format's read key
        or its device decode / parse key set false, or a column type the
        device does not take, raises where the reference would fall back
        to its host scan. (A CSV chunk malformed for the device grammar
        still takes the host grammar, the reference's own semantics,
        counted in csvHostSplits.)"""
        for key in _SCAN_KEYS[m.plan.fmt]:
            if not m.conf.get(key):
                raise ValueError(
                    f"{key.key}=false: a device session decodes "
                    f"{m.plan.fmt} on the device only (the CPU engine, "
                    "rapids.tpu.sql.enabled=false, decodes on the host)")
        for a in m.plan.output:
            if not MT.is_supported_type(a.data_type):
                raise ValueError(f"column {a.name}: the device scan does "
                                 f"not take {a.data_type}")

    register_exec(
        CpuFileScanExec, "Parquet / ORC / CSV scan decoded on the device "
        "(K20, K21, K7; K27, K28; K33-K36)",
        lambda cpu, ch: TpuFileScanExec(cpu.attrs, cpu.splits, cpu.fmt,
                                        cpu.options),
        tag_fn=_tag_scan)

    from spark_rapids_tpu_torch.exec.expand import (
        CpuExpandExec,
        CpuGenerateExec,
        TpuExpandExec,
        TpuGenerateExec,
    )

    register_exec(
        CpuExpandExec, "grouping-sets expand (one projection list per set)",
        lambda cpu, ch: TpuExpandExec(cpu.projections, cpu.output_attrs,
                                      ch[0]))

    def _tag_generate(m: ExecMeta) -> None:
        """Reference :467-473."""
        if m.plan.generator_output[-1].data_type is DataType.STRING:
            m.will_not_work(
                "device explode of string elements is not implemented")

    register_exec(
        CpuGenerateExec, "explode/posexplode of a created array (K18)",
        lambda cpu, ch: TpuGenerateExec(
            cpu.include_pos, cpu.elem_exprs, cpu.generator_output, ch[0]),
        tag_fn=_tag_generate)


def _expr_rule_for(e: Expression) -> Optional[ExprRule]:
    return EXPR_RULES.get(type(e))


def _wrap_plan(plan: PhysicalExec, conf: C.TpuConf) -> ExecMeta:
    return ExecMeta(plan, conf, EXEC_RULES.get(type(plan)), _expr_rule_for)


def _wrap_expr(expr: Expression, conf: C.TpuConf) -> ExprMeta:
    return ExprMeta(expr, conf, _expr_rule_for(expr))


MT._WRAP_PLAN = _wrap_plan
MT._WRAP_EXPR = _wrap_expr
MT._NODE_EXPRESSIONS = lambda plan: plan.node_expressions()


# keys the port copies from the reference whose module or path is not
# ported yet: a session that sets one away from its default would get the
# default's behaviour with no word, so planning raises instead (ROADMAP
# queue 3 names the item that will honour each)
UNREAD_KEYS = (C.SHUFFLE_MODE, C.IO_PREFETCH_BATCHES, C.HASH_OPTIMIZE_SORT,
               C.ASYNC_DISPATCH, C.BUFFER_DONATION,
               C.BUFFER_DONATION_ASSUME_SUPPORTED, C.EXPORT_COLUMNAR_RDD,
               C.REPLACE_SORT_MERGE_JOIN)


def check_unread_keys(conf: C.TpuConf) -> None:
    """Raise, naming the key, for a key of UNREAD_KEYS set to a value other
    than its default (the pattern of _tag_scan)."""
    for key in UNREAD_KEYS:
        value = conf.get(key)
        if value != key.default:
            raise ValueError(
                f"{key.key}={value!r}: the port does not implement this "
                f"setting yet; only its default ({key.default!r}) runs")


class TpuOverrides:
    """The pre-transition columnar rule (reference: GpuOverrides.apply,
    GpuOverrides.scala:1769-1826)."""

    @staticmethod
    def apply(cpu_plan: PhysicalExec, conf: C.TpuConf,
              explain_out: Optional[List[str]] = None) -> PhysicalExec:
        check_unread_keys(conf)
        if not conf.sql_enabled:
            return cpu_plan
        wrapped = _wrap_plan(cpu_plan, conf)
        wrapped.tag_for_tpu()
        if explain_out is not None:
            explain_out.append(wrapped.explain_string(all_nodes=True))
        return wrapped.convert_if_needed()


_register_expr_rules()
_register_exec_rules()
