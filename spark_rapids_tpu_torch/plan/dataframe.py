"""DataFrame API over the logical plan (port of spark_rapids_tpu/plan/dataframe.py:
select (with explode / posexplode of a created array), withColumn (a window
column too), withColumnRenamed, drop, filter, groupBy/agg (keyed and
keyless), rollup / cube (grouping sets through Expand), distinct,
dropDuplicates, repartition, coalesce, orderBy, sortWithinPartitions,
limit, union, join, crossJoin, cache, collect, count, show, toPandas,
explain, write). `explain_analyze` and `rdd_columnar` are not ported yet
(ROADMAP.md queue 1 item 6).

Name resolution (`col("x")` -> AttributeReference) happens here, eagerly,
against the child plan's output.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

from spark_rapids_tpu_torch.ops.base import (
    Alias,
    AttributeReference,
    Expression,
    SortOrder,
    to_attribute,
)
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.column import Column, _to_expr
from spark_rapids_tpu_torch.plan.functions import _UnresolvedAttribute

ColumnOrName = Union[Column, str]


class AnalysisError(Exception):
    pass


def resolve(expr: Expression, attrs: Sequence[AttributeReference]) -> Expression:
    """Rewrite _UnresolvedAttribute leaves into schema attributes."""
    by_name: Dict[str, AttributeReference] = {}
    dupes = set()
    for a in attrs:
        if a.name in by_name:
            dupes.add(a.name)
        by_name.setdefault(a.name, a)

    def rewrite(node: Expression) -> Expression:
        if isinstance(node, _UnresolvedAttribute):
            if node.name in dupes:
                raise AnalysisError(
                    f"ambiguous column {node.name!r}; rename before combining")
            got = by_name.get(node.name)
            if got is None:
                raise AnalysisError(
                    f"column {node.name!r} not found in "
                    f"[{', '.join(a.name for a in attrs)}]")
            return got
        return node

    return expr.transform_up(rewrite)


def _auto_alias(e: Expression, fallback: str) -> Expression:
    if isinstance(e, (Alias, AttributeReference)):
        return e
    return Alias(e, fallback)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session):
        self._plan = plan
        self.session = session

    @property
    def schema(self) -> List[AttributeReference]:
        return self._plan.output

    @property
    def columns(self) -> List[str]:
        return [a.name for a in self._plan.output]

    def __getitem__(self, name: str) -> Column:
        return Column(self._resolve_name(name))

    def _resolve_name(self, name: str) -> AttributeReference:
        for a in self._plan.output:
            if a.name == name:
                return a
        raise AnalysisError(
            f"column {name!r} not found in [{', '.join(self.columns)}]")

    def _resolve(self, c: ColumnOrName) -> Expression:
        if isinstance(c, str):
            return self._resolve_name(c)
        return resolve(_to_expr(c), self._plan.output)

    def _with_plan(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(plan, self.session)

    # -- relational ops -------------------------------------------------------
    def select(self, *cols: ColumnOrName) -> "DataFrame":
        from spark_rapids_tpu_torch.ops.generators import Explode

        out: List[Expression] = []
        gen: Optional[Expression] = None
        gen_slot = -1
        for c in cols:
            if isinstance(c, str) and c == "*":
                out.extend(self._plan.output)
                continue
            e = self._resolve(c)
            core = e.child if isinstance(e, Alias) else e
            if isinstance(core, Explode):
                if gen is not None:
                    raise ValueError("only one explode()/posexplode() per "
                                     "select (Spark restriction)")
                gen = e
                gen_slot = len(out)
                out.append(e)  # placeholder, replaced below
                continue
            out.append(_auto_alias(e, c if isinstance(c, str)
                                   else f"col{len(out)}"))
        if gen is None:
            return self._with_plan(L.Project(out, self._plan))
        return self._select_generate(out, gen, gen_slot)

    def _select_generate(self, out: List[Expression], gen: Expression,
                         gen_slot: int) -> "DataFrame":
        """select(..., explode(array(...)), ...) as Generate + Project
        (reference: dataframe.py:124); every element is cast to the
        array's element type."""
        from spark_rapids_tpu_torch.columnar.dtypes import DataType
        from spark_rapids_tpu_torch.ops.cast import Cast

        alias_name = gen.name if isinstance(gen, Alias) else None
        core = gen.child if isinstance(gen, Alias) else gen
        elem_t = core.array.element_type
        elems = [e if e.data_type is elem_t else Cast(e, elem_t)
                 for e in core.array.elems]
        generator = core.with_children([core.array.with_children(elems)])
        gen_attrs: List[AttributeReference] = []
        if core.include_pos:
            if alias_name is not None:
                raise ValueError("posexplode produces two columns (pos, col)"
                                 " and cannot be aliased to one name")
            gen_attrs.append(AttributeReference("pos", DataType.INT32, False))
        gen_attrs.append(AttributeReference(alias_name or "col", elem_t,
                                            True))
        plan = L.Generate(generator, gen_attrs, False, self._plan)
        final = out[:gen_slot] + gen_attrs + out[gen_slot + 1:]
        return self._with_plan(L.Project(final, plan))

    def withColumn(self, name: str, c: Column) -> "DataFrame":
        e = Alias(self._resolve(c), name)
        out: List[Expression] = []
        replaced = False
        for a in self._plan.output:
            if a.name == name:
                out.append(e)
                replaced = True
            else:
                out.append(a)
        if not replaced:
            out.append(e)
        return self._with_plan(L.Project(out, self._plan))

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        """Reference: dataframe.py:170."""
        out = [Alias(a, new) if a.name == old else a for a in self._plan.output]
        return self._with_plan(L.Project(out, self._plan))

    def drop(self, *names: str) -> "DataFrame":
        """Reference: dataframe.py:174."""
        keep = [a for a in self._plan.output if a.name not in names]
        return self._with_plan(L.Project(keep, self._plan))

    def filter(self, condition: Column) -> "DataFrame":
        if isinstance(condition, str):
            raise AnalysisError("string predicates require the SQL frontend; "
                                "pass a Column")
        return self._with_plan(L.Filter(self._resolve(condition), self._plan))

    where = filter

    def orderBy(self, *cols, **kwargs) -> "DataFrame":
        """Global sort (reference: dataframe.py:224): names, Columns or
        SortOrders (`col.desc()`); `ascending=` applies to names/Columns."""
        orders = []
        ascending = kwargs.get("ascending", True)
        for c in cols:
            if isinstance(c, SortOrder):
                orders.append(SortOrder(resolve(c.child, self._plan.output),
                                        c.ascending, c.nulls_first))
            elif isinstance(c, str):
                orders.append(SortOrder(self._resolve_name(c), ascending))
            else:
                orders.append(SortOrder(self._resolve(c), ascending))
        return self._with_plan(L.Sort(orders, True, self._plan))

    sort = orderBy

    def limit(self, n: int) -> "DataFrame":
        """Reference: dataframe.py:187."""
        return self._with_plan(L.Limit(n, self._plan))

    def union(self, other: "DataFrame") -> "DataFrame":
        """Union-all by position (reference: dataframe.py:190)."""
        if len(other.schema) != len(self.schema):
            raise AnalysisError("union requires same number of columns")
        return self._with_plan(L.Union(self._plan, other._plan))

    unionAll = union

    def distinct(self) -> "DataFrame":
        """Reference: dataframe.py:197: a group-by on every column."""
        attrs = self._plan.output
        return self._with_plan(L.Aggregate(list(attrs), list(attrs),
                                           self._plan))

    def dropDuplicates(self, subset: Optional[List[str]] = None
                       ) -> "DataFrame":
        """Reference: dataframe.py:201: a group-by on the subset, `First`
        of every other column."""
        if not subset:
            return self.distinct()
        keys = [self._resolve_name(n) for n in subset]
        from spark_rapids_tpu_torch.ops.aggregates import First

        aggs: List[Expression] = []
        for a in self._plan.output:
            if a.name in subset:
                aggs.append(a)
            else:
                aggs.append(Alias(First(a), a.name))
        return self._with_plan(L.Aggregate(keys, aggs, self._plan))

    def repartition(self, num_partitions: int,
                    *cols: ColumnOrName) -> "DataFrame":
        """Round robin without columns, hash on the columns otherwise
        (reference: dataframe.py:215)."""
        exprs = [self._resolve(c) for c in cols]
        return self._with_plan(
            L.Repartition(num_partitions, exprs, False, self._plan))

    def coalesce(self, num_partitions: int) -> "DataFrame":
        """Reference: dataframe.py:220: merge partitions, no shuffle."""
        return self._with_plan(
            L.Repartition(num_partitions, [], True, self._plan))

    def sortWithinPartitions(self, *cols, **kwargs) -> "DataFrame":
        """Reference: dataframe.py:239: a local sort of each partition."""
        plan = self.orderBy(*cols, **kwargs)._plan
        return self._with_plan(L.Sort(plan.orders, False, self._plan))

    def join(self, other: "DataFrame",
             on: Union[str, List[str], Column, None] = None,
             how: str = "inner") -> "DataFrame":
        """Reference: dataframe.py:285. `on` is a Column condition (split
        into equi keys and a residual), a column name or a list of names
        (USING semantics: the keys appear once); `how` takes Spark's
        aliases."""
        jt = L.JoinType.parse(how)
        left_keys: List[Expression] = []
        right_keys: List[Expression] = []
        condition: Optional[Expression] = None
        if isinstance(on, str):
            on = [on]
        if isinstance(on, list):
            for name in on:
                left_keys.append(self._resolve_name(name))
                right_keys.append(other._resolve_name(name))
        elif isinstance(on, Column):
            condition = self._resolve_join_condition(on, other)
            left_keys, right_keys, condition = _extract_equi_keys(
                condition, self._plan.output, other._plan.output)
        elif on is not None:
            raise AnalysisError(f"unsupported join on: {on!r}")
        elif jt is not L.JoinType.CROSS:
            raise AnalysisError("join requires 'on' unless how='cross'")
        plan = L.Join(self._plan, other._plan, jt, left_keys, right_keys,
                      condition)
        df = self._with_plan(plan)
        if isinstance(on, list) and jt in (
                L.JoinType.INNER, L.JoinType.LEFT_OUTER,
                L.JoinType.RIGHT_OUTER, L.JoinType.FULL_OUTER):
            # USING-join semantics: emit the join columns once
            drop_ids = {a.expr_id for a in right_keys
                        if isinstance(a, AttributeReference)}
            keep = [a for a in plan.output if a.expr_id not in drop_ids]
            df = df._with_plan(L.Project(keep, plan))
        return df

    def _resolve_join_condition(self, c: Column,
                                other: "DataFrame") -> Expression:
        """Reference: dataframe.py:319."""
        both = list(self._plan.output) + list(other._plan.output)
        return resolve(c.expr, both)

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        """Reference: dataframe.py:323."""
        return self.join(other, on=None, how="cross")

    def groupBy(self, *cols: ColumnOrName) -> "GroupedData":
        keys = [self._resolve(c) for c in cols]
        named = [_auto_alias(k, c if isinstance(c, str) else f"col{i}")
                 for i, (k, c) in enumerate(zip(keys, cols))]
        return GroupedData(self, named)

    groupby = groupBy

    def rollup(self, *cols: ColumnOrName) -> "GroupedData":
        """Hierarchical grouping sets (a, b) -> {(a, b), (a), ()} through
        Expand (reference: dataframe.py:254, GpuExpandExec.scala:66-102)."""
        g = self.groupBy(*cols)
        m = len(g._grouping)
        g._grouping_sets = [frozenset(range(k)) for k in range(m, -1, -1)]
        return g

    def cube(self, *cols: ColumnOrName) -> "GroupedData":
        """All 2^m grouping-set combinations through Expand (reference:
        dataframe.py:262)."""
        import itertools as _it

        g = self.groupBy(*cols)
        m = len(g._grouping)
        g._grouping_sets = [
            frozenset(s)
            for k in range(m, -1, -1)
            for s in _it.combinations(range(m), k)
        ]
        return g

    def agg(self, *cols: Column) -> "DataFrame":
        return GroupedData(self, []).agg(*cols)

    def count(self) -> int:
        """Reference: dataframe.py:278."""
        from spark_rapids_tpu_torch.plan.functions import count as f_count

        rows = self.agg(f_count("*").alias("count")).collect()
        return rows[0][0]

    def cache(self) -> "DataFrame":
        """Keep this DataFrame's batches in memory: on the card for the
        device engine (reference: df.cache() served by the accelerated
        InMemoryTableScan)."""
        if isinstance(self._plan, L.CacheRelation):
            return self
        return self._with_plan(L.CacheRelation(self._plan))

    persist = cache

    def unpersist(self) -> "DataFrame":
        from spark_rapids_tpu_torch.exec.cache import invalidate

        if isinstance(self._plan, L.CacheRelation):
            invalidate(self._plan)
            return self._with_plan(self._plan.children[0])
        return self

    # -- actions --------------------------------------------------------------
    def collect(self) -> List[tuple]:
        return self.session.execute_collect(self._plan)

    def toLocalBatches(self):
        return self.session.execute_batches(self._plan)

    def show(self, n: int = 20) -> None:
        """Print the first n rows (reference: dataframe.py:357)."""
        rows = self.limit(n).collect()
        print(" | ".join(self.columns))
        for r in rows:
            print(" | ".join(str(v) for v in r))

    def toPandas(self):
        """Reference: dataframe.py:381 (pandas is imported only here)."""
        import pandas as pd

        return pd.DataFrame(self.collect(), columns=self.columns)

    def explain(self, mode: str = "ALL") -> str:
        return self.session.explain_plan(self._plan, mode)

    # -- write ----------------------------------------------------------------
    @property
    def write(self) -> "DataFrameWriter":
        """Reference: dataframe.py:389."""
        return DataFrameWriter(self)


class DataFrameWriter:
    """df.write (reference: dataframe.py:489-520): mode, option, parquet,
    orc and csv; partitionBy is queued and raises at the write."""

    def __init__(self, df: DataFrame):
        self._df = df
        self._mode = "error"
        self._options: Dict[str, Any] = {}
        self._partition_by: List[str] = []

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m
        return self

    def option(self, k: str, v: Any) -> "DataFrameWriter":
        self._options[k] = v
        return self

    def options(self, **kwargs) -> "DataFrameWriter":
        self._options.update(kwargs)
        return self

    def partitionBy(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    def parquet(self, path: str) -> None:
        self._write("parquet", path)

    def orc(self, path: str) -> None:
        self._write("orc", path)

    def csv(self, path: str) -> None:
        self._write("csv", path)

    def _write(self, fmt: str, path: str) -> None:
        plan = L.WriteFile(fmt, path, self._mode, self._options,
                           self._partition_by, self._df._plan)
        self._df.session.execute_write(plan)


class GroupedData:
    """groupBy / rollup / cube (reference: dataframe.py:397)."""

    def __init__(self, df: DataFrame, grouping: List[Expression]):
        self._df = df
        self._grouping = grouping
        # rollup / cube: the grouping sets, as frozensets of key ordinals
        self._grouping_sets: Optional[List[frozenset]] = None

    def agg(self, *cols: Column) -> DataFrame:
        if self._grouping_sets is not None:
            return self._agg_grouping_sets(cols)
        out: List[Expression] = list(self._grouping)
        for i, c in enumerate(cols):
            e = resolve(_to_expr(c), self._df._plan.output)
            out.append(_auto_alias(e, f"agg{i}"))
        plan = L.Aggregate([to_attribute(g) if isinstance(g, Alias) else g
                            for g in self._grouping], out, self._df._plan)
        return self._df._with_plan(plan)

    def _agg_grouping_sets(self, cols) -> DataFrame:
        """rollup / cube (reference: dataframe.py:419): Expand emits one
        copy of the input per grouping set, the dropped keys null-filled,
        with a grouping id that keeps natural NULLs apart from rolled-up
        ones; a regular aggregate then groups on the expanded keys and the
        id, which stays out of the output."""
        from spark_rapids_tpu_torch.columnar.dtypes import DataType
        from spark_rapids_tpu_torch.ops.literals import Literal

        child = self._df._plan
        m = len(self._grouping)
        g_exprs = [g.child if isinstance(g, Alias) else g
                   for g in self._grouping]
        g_names = [to_attribute(g).name if isinstance(g, Alias) else g.name
                   for g in self._grouping]
        g_types = [g.data_type for g in g_exprs]
        # fresh nullable output attributes for the expanded keys
        key_attrs = [AttributeReference(n, t, True)
                     for n, t in zip(g_names, g_types)]
        gid_attr = AttributeReference("spark_grouping_id", DataType.INT32,
                                      False)
        projections: List[List[Expression]] = []
        for s in self._grouping_sets:
            gid = 0
            proj: List[Expression] = list(child.output)
            for i in range(m):
                if i in s:
                    proj.append(g_exprs[i])
                else:
                    proj.append(Literal(None, g_types[i]))
                    gid |= 1 << (m - 1 - i)
            proj.append(Literal(gid, DataType.INT32))
            projections.append(proj)
        expand_out = list(child.output) + key_attrs + [gid_attr]
        expand = L.Expand(projections, expand_out, child)
        out: List[Expression] = [Alias(a, a.name) for a in key_attrs]
        for i, c in enumerate(cols):
            e = resolve(_to_expr(c), child.output)
            out.append(_auto_alias(e, f"agg{i}"))
        plan = L.Aggregate(key_attrs + [gid_attr], out, expand)
        return self._df._with_plan(plan)

    def _simple(self, fn, *cols: str) -> DataFrame:
        """Reference: dataframe.py:462: one aggregate of each named column,
        or of every numeric column, named `fn(col)`."""
        from spark_rapids_tpu_torch.plan import functions as F

        names = cols or [a.name for a in self._df.schema
                         if a.data_type.is_numeric]
        return self.agg(*[getattr(F, fn)(n).alias(f"{fn}({n})")
                          for n in names])

    def sum(self, *cols: str) -> DataFrame:  # noqa: A003
        return self._simple("sum", *cols)

    def min(self, *cols: str) -> DataFrame:  # noqa: A003
        return self._simple("min", *cols)

    def max(self, *cols: str) -> DataFrame:  # noqa: A003
        return self._simple("max", *cols)

    def avg(self, *cols: str) -> DataFrame:
        return self._simple("avg", *cols)

    mean = avg

    def count(self) -> DataFrame:
        from spark_rapids_tpu_torch.plan.functions import count as f_count

        return self.agg(f_count("*").alias("count"))


def _extract_equi_keys(condition: Expression, left_attrs, right_attrs):
    """Split a join condition into equi-key pairs and a residual condition
    (reference: dataframe.py:523, the planner's extractEquiJoinKeys)."""
    from spark_rapids_tpu_torch.ops.predicates import And, EqualTo

    left_ids = {a.expr_id for a in left_attrs}
    right_ids = {a.expr_id for a in right_attrs}

    def refs(e: Expression):
        return {n.expr_id for n in e.collect(
            lambda x: isinstance(x, AttributeReference))}

    conjuncts: List[Expression] = []

    def split(e: Expression):
        if isinstance(e, And):
            split(e.left)
            split(e.right)
        else:
            conjuncts.append(e)

    split(condition)
    lk, rk, residual = [], [], []
    for c in conjuncts:
        if isinstance(c, EqualTo):
            lrefs, rrefs = refs(c.left), refs(c.right)
            if lrefs <= left_ids and rrefs <= right_ids:
                lk.append(c.left)
                rk.append(c.right)
                continue
            if lrefs <= right_ids and rrefs <= left_ids:
                lk.append(c.right)
                rk.append(c.left)
                continue
        residual.append(c)
    cond: Optional[Expression] = None
    for r in residual:
        cond = r if cond is None else And(cond, r)
    return lk, rk, cond
