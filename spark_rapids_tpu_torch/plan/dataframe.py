"""DataFrame API over the logical plan (port of spark_rapids_tpu/plan/dataframe.py:
select (with explode / posexplode of a created array), withColumn (a window
column too), filter, groupBy/agg (keyed and keyless), orderBy, limit,
union, join, crossJoin, cache, collect, explain, write.parquet).

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

    def agg(self, *cols: Column) -> "DataFrame":
        return GroupedData(self, []).agg(*cols)

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
    def __init__(self, df: DataFrame, grouping: List[Expression]):
        self._df = df
        self._grouping = grouping

    def agg(self, *cols: Column) -> DataFrame:
        out: List[Expression] = list(self._grouping)
        for i, c in enumerate(cols):
            e = resolve(_to_expr(c), self._df._plan.output)
            out.append(_auto_alias(e, f"agg{i}"))
        plan = L.Aggregate([to_attribute(g) if isinstance(g, Alias) else g
                            for g in self._grouping], out, self._df._plan)
        return self._df._with_plan(plan)

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
