"""Reference binding (port of spark_rapids_tpu/ops/bind.py; reference:
GpuBindReferences.bindReference, GpuBoundAttribute.scala:24-89 — rewrites
AttributeReferences into ordinal-indexed BoundReferences against the child's
output schema)."""

from __future__ import annotations

from typing import List, Sequence

from spark_rapids_tpu_torch.ops.base import (
    AttributeReference,
    BoundReference,
    Expression,
    SortOrder,
)


def bind_references(expr: Expression,
                    input_attrs: Sequence[AttributeReference]) -> Expression:
    id_to_ordinal = {a.expr_id: i for i, a in enumerate(input_attrs)}
    name_to_ordinal = {}
    for i, a in enumerate(input_attrs):
        name_to_ordinal.setdefault(a.name, i)

    def rewrite(node: Expression) -> Expression:
        if isinstance(node, AttributeReference):
            ordinal = id_to_ordinal.get(node.expr_id)
            if ordinal is None:
                ordinal = name_to_ordinal.get(node.name)
            if ordinal is None:
                raise KeyError(
                    f"cannot bind {node!r}; input attrs: {list(input_attrs)}")
            return BoundReference(ordinal, node.data_type, node.nullable)
        return node

    return expr.transform_up(rewrite)


def bind_all(exprs: Sequence[Expression],
             input_attrs: Sequence[AttributeReference]) -> List[Expression]:
    return [bind_references(e, input_attrs) for e in exprs]


def bind_sort_orders(orders: Sequence[SortOrder],
                     input_attrs: Sequence[AttributeReference]
                     ) -> List[SortOrder]:
    """Reference: bind.py:44."""
    return [SortOrder(bind_references(o.child, input_attrs), o.ascending,
                      o.nulls_first) for o in orders]
