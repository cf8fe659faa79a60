"""Logical plan nodes (port of spark_rapids_tpu/plan/logical.py: the nodes of
slices 1-2 — local relation, cache, project, filter, aggregate, sort)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from spark_rapids_tpu_torch.ops.base import (
    AttributeReference,
    Expression,
    SortOrder,
    to_attribute,
)


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
