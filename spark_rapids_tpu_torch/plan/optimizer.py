"""Logical optimizer: column pruning (port of spark_rapids_tpu/plan/optimizer.py).

The reference rides Spark Catalyst, whose ColumnPruning rule narrows every
operator to the attributes its ancestors consume before the plugin sees the
plan. Standalone, this pass plays that role: without it an uncached TPC-H
q1 or q6 uploads every lineitem column, strings included, for a query that
reads seven.

Design (as the reference): one top-down walk carrying the set of attribute
expr_ids the parent may reference (`None` = everything). Each node keeps
`output ∩ required` plus whatever its own expressions reference, and
rebuilds itself over pruned children. A LocalRelation drops host columns
zero-copy; CacheRelation is a shared materialization boundary, so pruning
never pushes below it — a Project lands above the cache instead. Filter and
Aggregate never drop (they change row counts). A node pruned to zero
columns keeps its narrowest attribute as the row-count carrier.

The rules cover the logical nodes the port has (relation, range :119, file
scan :124, file write :256, cache, project, filter, limit, repartition
:180, sort, aggregate, join, window :214, expand :228, generate :247, union
:264); any other
node is left untouched, as the reference leaves an unknown node. A union
prunes the same positions in every child and pins each child's output
order with a Project. A join asks both children for what
its parent needs plus its keys and condition (reference :287), so TPC-H q3
and q5 upload and exchange only the columns they read.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.ops.base import (
    AttributeReference,
    Expression,
    to_attribute,
)
from spark_rapids_tpu_torch.plan import logical as L


def optimize(plan: L.LogicalPlan, conf: C.TpuConf) -> L.LogicalPlan:
    if conf.get(C.COLUMN_PRUNING):
        plan = _prune(plan, None)
    return plan


def _refs(exprs: Sequence[Expression]) -> Set[int]:
    out: Set[int] = set()
    for e in exprs:
        for a in e.collect(lambda n: isinstance(n, AttributeReference)):
            out.add(a.expr_id)
    return out


def _attr_cost(a: AttributeReference) -> int:
    dt = a.data_type
    return 64 if dt.is_string else dt.itemsize


def _narrowest(attrs: List[AttributeReference]) -> AttributeReference:
    """Row-count carrier when nothing is referenced: cheapest column wins
    (strings cost offsets + bytes, so any fixed-width beats them)."""
    return min(attrs, key=_attr_cost)


def _keep(attrs: List[AttributeReference],
          req: Optional[Set[int]]) -> List[AttributeReference]:
    if req is None:
        return list(attrs)
    kept = [a for a in attrs if a.expr_id in req]
    if not kept and attrs:
        kept = [_narrowest(attrs)]
    return kept


def _wrap_project(node: L.LogicalPlan,
                  req: Optional[Set[int]]) -> L.LogicalPlan:
    """Project `node` down to req (used above pruning barriers: cache)."""
    kept = _keep(node.output, req)
    if len(kept) == len(node.output):
        return node
    return L.Project(kept, node)


def _prune(plan: L.LogicalPlan,
           req: Optional[Set[int]]) -> L.LogicalPlan:
    fn = _RULES.get(type(plan))
    if fn is None:
        # unknown node: leave the whole subtree untouched (correct, unpruned)
        return plan
    return fn(plan, req)


_RULES = {}


def _rule(cls):
    def deco(fn):
        _RULES[cls] = fn
        return fn
    return deco


@_rule(L.LocalRelation)
def _local(plan: L.LocalRelation, req):
    kept = _keep(plan.schema, req)
    if len(kept) == len(plan.schema):
        return plan
    keep_ids = {k.expr_id for k in kept}
    idx = [i for i, a in enumerate(plan.schema) if a.expr_id in keep_ids]
    from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch

    parts = [[HostColumnarBatch([b.columns[i] for i in idx], b.num_rows)
              for b in part] for part in plan.partitions]
    return L.LocalRelation(kept, parts)


@_rule(L.RangeRelation)
def _range(plan: L.RangeRelation, req):
    return plan


@_rule(L.FileScan)
def _file_scan(plan: L.FileScan, req):
    """Parquet and ORC project by name: a narrowed schema means the pruned
    columns' chunks are never read or decoded (reference :124). A CSV
    schema is positional (it lays out the file), so the scan keeps every
    field and a Project above it prunes."""
    kept = _keep(plan.output, req)
    if len(kept) == len(plan.output):
        return plan
    if plan.fmt == "csv":
        return _wrap_project(plan, req)
    return L.FileScan(plan.fmt, plan.paths, kept, plan.files, plan.options)


@_rule(L.WriteFile)
def _write(plan: L.WriteFile, req):
    # a write persists its child's full schema (reference :256)
    return L.WriteFile(plan.fmt, plan.path, plan.mode, plan.options,
                       plan.partition_by, _prune(plan.children[0], None))


@_rule(L.CacheRelation)
def _cache(plan: L.CacheRelation, req):
    # the cached materialization is shared across queries; narrowing below
    # it would split the cache per consumer schema. Project above instead.
    return _wrap_project(plan, req)


@_rule(L.Project)
def _project(plan: L.Project, req):
    if req is None:
        kept = list(plan.project_list)
    else:
        kept = [e for e in plan.project_list
                if to_attribute(e).expr_id in req]
        if not kept:
            kept = [min(plan.project_list,
                        key=lambda e: 64 if e.data_type.is_string
                        else e.data_type.itemsize)]
    child = _prune(plan.children[0], _refs(kept))
    return L.Project(kept, child)


@_rule(L.Filter)
def _filter(plan: L.Filter, req):
    cond_refs = _refs([plan.condition])
    child_req = None if req is None else req | cond_refs
    pruned = L.Filter(plan.condition, _prune(plan.children[0], child_req))
    if req is not None and cond_refs - req:
        # condition-only columns the parent never asked for would otherwise
        # flow through every exchange between this Filter and the next
        # Project; Catalyst inserts the pruning Project in this position
        return _wrap_project(pruned, req)
    return pruned


@_rule(L.Sort)
def _sort(plan: L.Sort, req):
    child_req = None if req is None else \
        req | _refs([o.child for o in plan.orders])
    return L.Sort(plan.orders, plan.is_global,
                  _prune(plan.children[0], child_req))


@_rule(L.Aggregate)
def _aggregate(plan: L.Aggregate, req):
    grouping_ids = {to_attribute(g).expr_id for g in plan.grouping}
    if req is None:
        kept = list(plan.agg_exprs)
    else:
        # grouping-key computations must survive even when the key column
        # itself is unselected: grouping them determines output cardinality
        kept = [e for e in plan.agg_exprs
                if to_attribute(e).expr_id in req
                or to_attribute(e).expr_id in grouping_ids]
        if not kept:
            kept = list(plan.agg_exprs)
    child_req = _refs(kept) | _refs(plan.grouping)
    return L.Aggregate(plan.grouping, kept,
                       _prune(plan.children[0], child_req))


@_rule(L.Limit)
def _limit(plan: L.Limit, req):
    return L.Limit(plan.n, _prune(plan.children[0], req))


@_rule(L.Repartition)
def _repartition(plan: L.Repartition, req):
    child_req = None if req is None else req | _refs(plan.partition_exprs)
    return L.Repartition(plan.num_partitions, plan.partition_exprs,
                         plan.coalesce_only,
                         _prune(plan.children[0], child_req))


@_rule(L.Join)
def _join(plan: L.Join, req):
    needed = None
    if req is not None:
        needed = (req | _refs(plan.left_keys) | _refs(plan.right_keys)
                  | (_refs([plan.condition])
                     if plan.condition is not None else set()))
    return L.Join(_prune(plan.children[0], needed),
                  _prune(plan.children[1], needed),
                  plan.join_type, plan.left_keys, plan.right_keys,
                  plan.condition)


@_rule(L.WindowOp)
def _window(plan: L.WindowOp, req):
    if req is None:
        kept = list(plan.window_exprs)
    else:
        kept = [e for e in plan.window_exprs
                if to_attribute(e).expr_id in req]
    if not kept:
        # a row-preserving node with no consumed output: drop it
        return _prune(plan.children[0], req)
    child_req = None if req is None else req | _refs(kept)
    return L.WindowOp(kept, _prune(plan.children[0], child_req))


@_rule(L.Expand)
def _expand(plan: L.Expand, req):
    """Keep the consumed output positions in every projection and prune the
    child to what they read (reference :228); the row-count carrier, when
    nothing is consumed, is the cheapest position."""
    if req is None:
        keep_pos = list(range(len(plan.output_attrs)))
    else:
        keep_pos = [i for i, a in enumerate(plan.output_attrs)
                    if a.expr_id in req]
        if not keep_pos:
            keep_pos = [min(range(len(plan.output_attrs)),
                            key=lambda i: _attr_cost(plan.output_attrs[i]))]
    projections = [[p[i] for i in keep_pos] for p in plan.projections]
    attrs = [plan.output_attrs[i] for i in keep_pos]
    child_req = _refs([e for p in projections for e in p])
    return L.Expand(projections, attrs, _prune(plan.children[0], child_req))


@_rule(L.Generate)
def _generate(plan: L.Generate, req):
    """The generator multiplies rows, so the node always stays; only the
    pass-through child columns narrow (reference :247)."""
    child_req = None if req is None else req | _refs([plan.generator])
    return L.Generate(plan.generator, plan.generator_output, plan.outer,
                      _prune(plan.children[0], child_req))


@_rule(L.Union)
def _union(plan: L.Union, req):
    first = plan.children[0].output
    if req is None:
        keep_pos = list(range(len(first)))
    else:
        keep_pos = [i for i, a in enumerate(first) if a.expr_id in req]
        if not keep_pos:
            keep_pos = [first.index(_narrowest(list(first)))]
    new_children = []
    for child in plan.children:
        attrs = [child.output[i] for i in keep_pos]
        pruned = _prune(child, {a.expr_id for a in attrs})
        if [a.expr_id for a in pruned.output] != \
                [a.expr_id for a in attrs]:
            pruned = L.Project(attrs, pruned)
        new_children.append(pruned)
    return L.Union(*new_children)
