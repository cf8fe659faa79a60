"""Logical plan nodes (port of spark_rapids_tpu/plan/logical.py: local
relation, range :90, file scan :102, cache, project, filter, aggregate,
sort, join, limit, union :235, repartition :244, expand :261, generate
:276, window :292 and file write :318)."""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import (
    AttributeReference,
    Expression,
    SortOrder,
    to_attribute,
)


class JoinType(enum.Enum):
    """Reference: logical.py:25."""

    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    CROSS = "cross"

    @staticmethod
    def parse(s: str) -> "JoinType":
        aliases = {
            "inner": JoinType.INNER,
            "left": JoinType.LEFT_OUTER, "leftouter": JoinType.LEFT_OUTER,
            "left_outer": JoinType.LEFT_OUTER,
            "right": JoinType.RIGHT_OUTER, "rightouter": JoinType.RIGHT_OUTER,
            "right_outer": JoinType.RIGHT_OUTER,
            "outer": JoinType.FULL_OUTER, "full": JoinType.FULL_OUTER,
            "fullouter": JoinType.FULL_OUTER, "full_outer": JoinType.FULL_OUTER,
            "semi": JoinType.LEFT_SEMI, "leftsemi": JoinType.LEFT_SEMI,
            "left_semi": JoinType.LEFT_SEMI,
            "anti": JoinType.LEFT_ANTI, "leftanti": JoinType.LEFT_ANTI,
            "left_anti": JoinType.LEFT_ANTI,
            "cross": JoinType.CROSS,
        }
        k = s.strip().lower().replace(" ", "")
        if k not in aliases:
            raise ValueError(f"unknown join type {s!r}")
        return aliases[k]


class LogicalPlan:
    def __init__(self, *children: "LogicalPlan"):
        self.children: Tuple[LogicalPlan, ...] = children

    @property
    def output(self) -> List[AttributeReference]:
        raise NotImplementedError(type(self).__name__)

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def describe(self) -> str:
        return type(self).__name__


class LocalRelation(LogicalPlan):
    """In-memory host data (host batches pre-split into partitions)."""

    def __init__(self, schema: List[AttributeReference], partitions):
        super().__init__()
        self.schema = schema
        self.partitions = partitions

    @property
    def output(self):
        return self.schema

    def describe(self):
        return f"LocalRelation[{', '.join(a.name for a in self.schema)}]"


class RangeRelation(LogicalPlan):
    """session.range: int64 ids start, start + step, ... below end
    (reference: logical.py:90)."""

    def __init__(self, start: int, end: int, step: int, num_partitions: int):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.num_partitions = num_partitions
        self._attr = AttributeReference("id", DataType.INT64, False)

    @property
    def output(self):
        return [self._attr]

    def describe(self):
        return (f"Range ({self.start}, {self.end}, step={self.step}, "
                f"splits={self.num_partitions})")


class FileScan(LogicalPlan):
    """A file scan (reference: logical.py:102; GpuBatchScanExec)."""

    def __init__(self, fmt: str, paths: List[str],
                 schema: List[AttributeReference],
                 files: Optional[List[str]] = None,
                 options: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.fmt = fmt
        self.paths = paths
        self.schema = schema
        # the files schema resolution found (no second directory walk)
        self.files = files
        # the read options the scan consumes (CSV: header, sep / delimiter)
        self.options = dict(options or {})

    @property
    def output(self):
        return self.schema

    def describe(self):
        return f"FileScan {self.fmt} {self.paths}"


class WriteFile(LogicalPlan):
    """A write to files (reference: logical.py:318;
    GpuInsertIntoHadoopFsRelationCommand)."""

    def __init__(self, fmt: str, path: str, mode: str,
                 options: Dict[str, Any], partition_by: List[str],
                 child: LogicalPlan):
        super().__init__(child)
        self.fmt = fmt
        self.path = path
        self.mode = mode
        self.options = dict(options)
        self.partition_by = list(partition_by)

    @property
    def output(self):
        return []

    def describe(self):
        return f"WriteFile {self.fmt} -> {self.path} mode={self.mode}"


class Project(LogicalPlan):
    def __init__(self, project_list: Sequence[Expression], child: LogicalPlan):
        super().__init__(child)
        self.project_list = list(project_list)

    @property
    def output(self):
        return [to_attribute(e) for e in self.project_list]

    def describe(self):
        return f"Project [{', '.join(map(repr, self.project_list))}]"


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        super().__init__(child)
        self.condition = condition

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        return f"Filter ({self.condition!r})"


class Aggregate(LogicalPlan):
    """Group-by aggregate; agg_exprs are the grouping attributes and
    Alias(aggregate function) outputs."""

    def __init__(self, grouping: Sequence[Expression],
                 agg_exprs: Sequence[Expression], child: LogicalPlan):
        super().__init__(child)
        self.grouping = list(grouping)
        self.agg_exprs = list(agg_exprs)

    @property
    def output(self):
        return [to_attribute(e) for e in self.agg_exprs]

    def describe(self):
        return (f"Aggregate [{', '.join(map(repr, self.grouping))}] "
                f"[{', '.join(map(repr, self.agg_exprs))}]")


class Sort(LogicalPlan):
    """Reference: logical.py:172."""

    def __init__(self, orders: Sequence[SortOrder], is_global: bool,
                 child: LogicalPlan):
        super().__init__(child)
        self.orders = list(orders)
        self.is_global = is_global

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        scope = "global" if self.is_global else "local"
        return f"Sort {scope} [{', '.join(map(repr, self.orders))}]"


class CacheRelation(LogicalPlan):
    """Marks the child as cached in memory (reference: InMemoryRelation)."""

    def __init__(self, child: LogicalPlan):
        super().__init__(child)

    @property
    def output(self):
        return self.children[0].output


def _nullable(attrs: List[AttributeReference]) -> List[AttributeReference]:
    return [AttributeReference(a.name, a.data_type, True, a.expr_id)
            for a in attrs]


def join_output(join_type: JoinType, left: List[AttributeReference],
                right: List[AttributeReference]) -> List[AttributeReference]:
    """A join's output attributes (reference: exec/join.py:77 and
    logical.py:200): the preserved side keeps its nullability, the other
    side of an outer join becomes nullable; semi and anti keep the left."""
    if join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
        return list(left)
    if join_type is JoinType.LEFT_OUTER:
        return list(left) + _nullable(right)
    if join_type is JoinType.RIGHT_OUTER:
        return _nullable(left) + list(right)
    if join_type is JoinType.FULL_OUTER:
        return _nullable(left) + _nullable(right)
    return list(left) + list(right)


class Join(LogicalPlan):
    """Reference: logical.py:188."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 join_type: JoinType,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression] = None):
        super().__init__(left, right)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition

    @property
    def output(self):
        left, right = self.children
        return join_output(self.join_type, left.output, right.output)

    def describe(self):
        return (f"Join {self.join_type.value} keys="
                f"{list(zip(self.left_keys, self.right_keys))} "
                f"cond={self.condition!r}")


class Limit(LogicalPlan):
    """Reference: logical.py:222."""

    def __init__(self, n: int, child: LogicalPlan):
        super().__init__(child)
        self.n = n

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        return f"Limit {self.n}"


class Union(LogicalPlan):
    """Union-all by position (reference: logical.py:235)."""

    def __init__(self, *children: LogicalPlan):
        super().__init__(*children)

    @property
    def output(self):
        return self.children[0].output


class Repartition(LogicalPlan):
    """Round-robin (no exprs) or hash (exprs) repartition; `coalesce_only`
    merges partitions without a shuffle (reference: logical.py:244)."""

    def __init__(self, num_partitions: Optional[int],
                 partition_exprs: Sequence[Expression],
                 coalesce_only: bool, child: LogicalPlan):
        super().__init__(child)
        self.num_partitions = num_partitions
        self.partition_exprs = list(partition_exprs)
        self.coalesce_only = coalesce_only

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        kind = "coalesce" if self.coalesce_only else "repartition"
        return f"Repartition {kind} {self.num_partitions} " \
            f"{self.partition_exprs!r}"


class Expand(LogicalPlan):
    """Several projection lists per input row: grouping sets (reference:
    logical.py:261, GpuExpandExec)."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 output_attrs: List[AttributeReference], child: LogicalPlan):
        super().__init__(child)
        self.projections = [list(p) for p in projections]
        self.output_attrs = list(output_attrs)

    @property
    def output(self):
        return self.output_attrs

    def describe(self):
        return f"Expand [{len(self.projections)} projections]"


class Generate(LogicalPlan):
    """explode / posexplode of a created array (reference: logical.py:276);
    its output is the child's columns, then the generator's."""

    def __init__(self, generator: Expression,
                 generator_output: List[AttributeReference], outer: bool,
                 child: LogicalPlan):
        super().__init__(child)
        self.generator = generator
        self.generator_output = list(generator_output)
        self.outer = outer

    @property
    def output(self):
        return self.children[0].output + self.generator_output

    def describe(self):
        return f"Generate {self.generator!r}"


class WindowOp(LogicalPlan):
    """Window expressions appended to the child's output (reference:
    logical.py:292). The DataFrame API reaches windows through Project
    (`withColumn(name, f.over(w))`); the planner splits them out."""

    def __init__(self, window_exprs: Sequence[Expression], child: LogicalPlan):
        super().__init__(child)
        self.window_exprs = list(window_exprs)

    @property
    def output(self):
        return self.children[0].output + [to_attribute(e)
                                           for e in self.window_exprs]
