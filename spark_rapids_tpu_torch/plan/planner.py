"""Logical -> CPU physical planning (port of spark_rapids_tpu/plan/planner.py:
the LocalRelation :52, RangeRelation :57, FileScan :175, Project with its
windows :63-133, WindowOp :136, Filter :146, Union :152, Limit :157,
Repartition :165, cache, Aggregate :192-247, Expand :250, Generate :260,
Sort :273 and Join :338-416 planners).

The CPU plan is the oracle engine; TpuOverrides (plan/overrides.py) then
replaces the supported nodes with device execs, as the reference replaces
Spark execs with Gpu execs. An aggregate plans as partial aggregate ->
hash exchange on the grouping keys (one partition without keys) -> final
aggregate; one with a holistic function (percentile) exchanges its raw
rows instead, into one complete-mode aggregate. A global sort plans as range exchange -> per-partition sort.
A limit plans as local limit -> coalesce to one partition -> global limit.
An equi-join plans as a broadcast hash join when the build side's estimated
bytes fit autoBroadcastJoinThreshold (an INNER join may swap its sides for
that), else as a shuffled hash join over two hash exchanges. A CROSS join,
or an INNER join without equi keys, plans as a nested-loop join (the right
side materialised once, the condition a filter over the product); any
other join type without equi keys raises, as in the reference. Window
expressions inside a projection become one window exec per (partition,
order) spec below it, each over a hash exchange on the partition keys (or
one partition without them). A union concatenates its children's
partitions: no shuffle. A repartition plans as a round-robin or hash
exchange (`shuffle/exchange.py:plan_repartition_exchange`), a coalesce as
a partition merge without a shuffle; rollup / cube's Expand as one exec
over every projection list.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.base import PhysicalExec
from spark_rapids_tpu_torch.plan import logical as L

_PLANNERS: Dict[Type[L.LogicalPlan], Callable] = {}


def register_planner(logical_cls: Type[L.LogicalPlan]):
    def deco(fn):
        _PLANNERS[logical_cls] = fn
        return fn
    return deco


def plan_physical(plan: L.LogicalPlan, conf: C.TpuConf) -> PhysicalExec:
    fn = _PLANNERS.get(type(plan))
    if fn is None:
        raise NotImplementedError(
            f"no physical planning for {type(plan).__name__}")
    return fn(plan, conf)


def _plan_children(plan: L.LogicalPlan, conf: C.TpuConf) -> List[PhysicalExec]:
    return [plan_physical(c, conf) for c in plan.children]


@register_planner(L.LocalRelation)
def _plan_local(plan: L.LocalRelation, conf: C.TpuConf) -> PhysicalExec:
    return B.HostScanExec(plan.schema, plan.partitions)


@register_planner(L.RangeRelation)
def _plan_range(plan: L.RangeRelation, conf: C.TpuConf) -> PhysicalExec:
    return B.RangeExec(plan.start, plan.end, plan.step, plan.num_partitions,
                       plan.output[0])


@register_planner(L.FileScan)
def _plan_file_scan(plan: L.FileScan, conf: C.TpuConf) -> PhysicalExec:
    """Reference: planner.py:175."""
    from spark_rapids_tpu_torch.io.scan import CpuFileScanExec, plan_splits

    splits = plan_splits(plan.fmt, plan.paths, conf, files=plan.files)
    return CpuFileScanExec(plan.output, splits, plan.fmt, plan.options)


@register_planner(L.Project)
def _plan_project(plan: L.Project, conf: C.TpuConf) -> PhysicalExec:
    (child,) = _plan_children(plan, conf)
    return _project_with_windows(plan.project_list, child, conf)


def _project_with_windows(project_list, child: PhysicalExec,
                          conf: C.TpuConf) -> PhysicalExec:
    """Extract window expressions into window execs below the projection,
    one per distinct (partition_by, order_by) (reference :68-113,
    GpuWindowExec.scala:33-91)."""
    from spark_rapids_tpu_torch.exec.window import CpuWindowExec
    from spark_rapids_tpu_torch.ops.base import Alias, to_attribute
    from spark_rapids_tpu_torch.ops.window import WindowExpression

    wnodes = []
    for e in project_list:
        wnodes.extend(e.collect(lambda n: isinstance(n, WindowExpression)))
    if not wnodes:
        return B.CpuProjectExec(project_list, child)
    by_fp = {}
    attr_of = {}
    for w in wnodes:
        fp = w.fingerprint()
        if fp in by_fp:
            continue
        alias = Alias(w, f"_w{len(by_fp)}")
        by_fp[fp] = alias
        attr_of[fp] = to_attribute(alias)
    groups = {}
    for alias in by_fp.values():
        w = alias.child
        skey = (tuple(e.fingerprint() for e in w.spec.partition_by),
                tuple(o.fingerprint() for o in w.spec.order_by))
        groups.setdefault(skey, []).append(alias)
    node = child
    for aliases in groups.values():
        node = CpuWindowExec(
            aliases, _window_distribution(aliases[0].child.spec, node, conf))

    def rewrite(e):
        if isinstance(e, WindowExpression):
            return attr_of[e.fingerprint()]
        return e

    return B.CpuProjectExec([e.transform_up(rewrite) for e in project_list],
                            node)


def _window_distribution(spec, child: PhysicalExec,
                         conf: C.TpuConf) -> PhysicalExec:
    """All rows of a partition key in one task partition (reference :116):
    a hash exchange on partition_by, or one partition without it."""
    from spark_rapids_tpu_torch.shuffle.exchange import (
        CpuShuffleExchangeExec,
        HashPartitioning,
        SinglePartitioning,
    )

    if spec.partition_by:
        part = HashPartitioning(list(spec.partition_by),
                                conf.shuffle_partitions)
    else:
        part = SinglePartitioning()
    return CpuShuffleExchangeExec(part, child)


@register_planner(L.WindowOp)
def _plan_window(plan: L.WindowOp, conf: C.TpuConf) -> PhysicalExec:
    from spark_rapids_tpu_torch.exec.window import CpuWindowExec, _unwrap

    (child,) = _plan_children(plan, conf)
    spec = _unwrap(plan.window_exprs[0]).spec
    return CpuWindowExec(plan.window_exprs,
                         _window_distribution(spec, child, conf))


@register_planner(L.Union)
def _plan_union(plan: L.Union, conf: C.TpuConf) -> PhysicalExec:
    return B.CpuUnionExec(*_plan_children(plan, conf))


@register_planner(L.Filter)
def _plan_filter(plan: L.Filter, conf: C.TpuConf) -> PhysicalExec:
    (child,) = _plan_children(plan, conf)
    return B.CpuFilterExec(plan.condition, child)


@register_planner(L.CacheRelation)
def _plan_cache(plan: L.CacheRelation, conf: C.TpuConf) -> PhysicalExec:
    from spark_rapids_tpu_torch.exec.cache import CpuCachedScanExec

    (child,) = _plan_children(plan, conf)
    return CpuCachedScanExec(plan, child)


@register_planner(L.Aggregate)
def _plan_aggregate(plan: L.Aggregate, conf: C.TpuConf) -> PhysicalExec:
    from spark_rapids_tpu_torch.exec.aggregate import (
        FINAL,
        PARTIAL,
        CpuHashAggregateExec,
        build_agg_specs,
    )
    from spark_rapids_tpu_torch.shuffle.exchange import (
        CpuShuffleExchangeExec,
        HashPartitioning,
        SinglePartitioning,
    )

    (child,) = _plan_children(plan, conf)
    specs = build_agg_specs(plan.agg_exprs)
    if any(getattr(s.func, "holistic", False) for s in specs):
        # holistic aggregates (percentile) have no partials to merge: the
        # raw rows exchange on the grouping keys (one partition without
        # keys) into ONE complete-mode aggregate, which takes each
        # partition as a single batch (reference :211-238)
        from spark_rapids_tpu_torch.exec.aggregate import (
            COMPLETE,
            _key_exprs_for,
        )

        if plan.grouping:
            part = HashPartitioning(
                _key_exprs_for(plan.grouping, plan.agg_exprs),
                conf.shuffle_partitions)
        else:
            part = SinglePartitioning()
        return CpuHashAggregateExec(plan.grouping, plan.agg_exprs, COMPLETE,
                                    CpuShuffleExchangeExec(part, child),
                                    specs)
    partial = CpuHashAggregateExec(plan.grouping, plan.agg_exprs, PARTIAL,
                                   child, specs)
    if plan.grouping:
        part = HashPartitioning(list(plan.grouping), conf.shuffle_partitions)
    else:
        part = SinglePartitioning()
    exchange = CpuShuffleExchangeExec(part, partial)
    return CpuHashAggregateExec(plan.grouping, plan.agg_exprs, FINAL,
                                exchange, specs)


@register_planner(L.Generate)
def _plan_generate(plan: L.Generate, conf: C.TpuConf) -> PhysicalExec:
    """explode / posexplode of a created array (reference :260)."""
    from spark_rapids_tpu_torch.exec.expand import CpuGenerateExec

    (child,) = _plan_children(plan, conf)
    gen = plan.generator
    return CpuGenerateExec(gen.include_pos, list(gen.array.elems),
                           plan.generator_output, child)


@register_planner(L.Sort)
def _plan_sort(plan: L.Sort, conf: C.TpuConf) -> PhysicalExec:
    """Global sort = range exchange + per-partition sort (reference:
    planner.py:273, GpuSortExec.scala:50-98)."""
    from spark_rapids_tpu_torch.exec.sort import CpuSortExec
    from spark_rapids_tpu_torch.shuffle.exchange import (
        CpuShuffleExchangeExec,
        RangePartitioning,
    )

    (child,) = _plan_children(plan, conf)
    if plan.is_global:
        child = CpuShuffleExchangeExec(
            RangePartitioning(plan.orders, conf.shuffle_partitions), child)
    return CpuSortExec(plan.orders, child)


@register_planner(L.Limit)
def _plan_limit(plan: L.Limit, conf: C.TpuConf) -> PhysicalExec:
    (child,) = _plan_children(plan, conf)
    local = B.CpuLocalLimitExec(plan.n, child)
    merged = B.CoalescePartitionsExec(1, local)
    return B.CpuGlobalLimitExec(plan.n, merged)


@register_planner(L.Repartition)
def _plan_repartition(plan: L.Repartition, conf: C.TpuConf) -> PhysicalExec:
    """Reference: planner.py:165."""
    (child,) = _plan_children(plan, conf)
    if plan.coalesce_only:
        return B.CoalescePartitionsExec(plan.num_partitions or 1, child)
    from spark_rapids_tpu_torch.shuffle.exchange import (
        plan_repartition_exchange,
    )

    return plan_repartition_exchange(plan, child, conf)


@register_planner(L.Expand)
def _plan_expand(plan: L.Expand, conf: C.TpuConf) -> PhysicalExec:
    """Grouping sets: one projection list per set (reference:
    planner.py:250, GpuExpandExec.scala:66-102)."""
    from spark_rapids_tpu_torch.exec.expand import CpuExpandExec

    (child,) = _plan_children(plan, conf)
    return CpuExpandExec(plan.projections, plan.output_attrs, child)


def _estimate_rows(plan: L.LogicalPlan) -> Optional[int]:
    """Upper-bound row estimate for the broadcast decision, or None
    (reference: planner.py:289). Cached relations count exactly once
    materialised; an equi-join's output is not bounded by its inputs (an
    m:n key reaches l * r), so it estimates unknown and the runtime probe
    decides on the materialised bytes instead."""
    if isinstance(plan, L.LocalRelation):
        return sum(b.num_rows for part in plan.partitions for b in part)
    if isinstance(plan, L.RangeRelation):
        step = plan.step or 1
        return max(0, (plan.end - plan.start + step - 1) // step)
    if isinstance(plan, L.Limit):
        child = _estimate_rows(plan.children[0])
        return plan.n if child is None else min(plan.n, child)
    if isinstance(plan, (L.Project, L.Filter, L.Sort, L.Repartition,
                         L.WindowOp, L.Aggregate)):
        return _estimate_rows(plan.children[0])
    if isinstance(plan, L.Expand):
        child = _estimate_rows(plan.children[0])
        return None if child is None else child * max(
            len(plan.projections), 1)
    if isinstance(plan, L.Union):
        parts = [_estimate_rows(c) for c in plan.children]
        return None if any(p is None for p in parts) else sum(parts)
    if isinstance(plan, L.CacheRelation):
        from spark_rapids_tpu_torch.exec.cache import cached_row_count

        n = cached_row_count(plan)
        return n if n is not None else _estimate_rows(plan.children[0])
    if isinstance(plan, L.Join) and plan.join_type is L.JoinType.CROSS:
        left, right = (_estimate_rows(c) for c in plan.children)
        return None if left is None or right is None else left * right
    if isinstance(plan, L.Join) and plan.join_type in (
            L.JoinType.LEFT_SEMI, L.JoinType.LEFT_ANTI):
        # filtering joins never emit more than their left input
        return _estimate_rows(plan.children[0])
    return None


@register_planner(L.Join)
def _plan_join(plan: L.Join, conf: C.TpuConf) -> PhysicalExec:
    from spark_rapids_tpu_torch.columnar.dtypes import common_type
    from spark_rapids_tpu_torch.exec.join import (
        CpuBroadcastHashJoinExec,
        CpuNestedLoopJoinExec,
        CpuShuffledHashJoinExec,
    )
    from spark_rapids_tpu_torch.ops.cast import Cast
    from spark_rapids_tpu_torch.shuffle.exchange import (
        CpuShuffleExchangeExec,
        HashPartitioning,
    )

    left, right = _plan_children(plan, conf)
    jt = plan.join_type
    if jt is L.JoinType.CROSS or not plan.left_keys:
        # reference: planner.py:352-357
        if jt not in (L.JoinType.CROSS, L.JoinType.INNER):
            raise NotImplementedError(
                f"non-equi {jt.value} join is not supported")
        return CpuNestedLoopJoinExec([], [], L.JoinType.CROSS,
                                     plan.condition, left, right)
    if plan.condition is not None and jt is not L.JoinType.INNER:
        raise NotImplementedError(
            f"{jt.value} join with a non-equi residual condition")

    # co-partitioning and key equality need both key lists in one type
    left_keys, right_keys = [], []
    for lk, rk in zip(plan.left_keys, plan.right_keys):
        if lk.data_type != rk.data_type:
            ct = common_type(lk.data_type, rk.data_type)
            if ct is None:
                raise NotImplementedError(
                    f"join keys of types {lk.data_type}/{rk.data_type}")
            lk = lk if lk.data_type == ct else Cast(lk, ct)
            rk = rk if rk.data_type == ct else Cast(rk, ct)
        left_keys.append(lk)
        right_keys.append(rk)

    def est_bytes_of(side: L.LogicalPlan) -> Optional[int]:
        est = _estimate_rows(side)
        if est is None:
            return None
        return est * max(1, sum(a.data_type.itemsize for a in side.output))

    # the build side is the right (the left for a right outer join); a full
    # outer join never broadcasts (its unmatched-build tail would repeat)
    build_is_left = jt is L.JoinType.RIGHT_OUTER
    threshold = conf.get(C.BROADCAST_THRESHOLD)
    est_bytes = est_bytes_of(plan.children[0] if build_is_left
                             else plan.children[1])
    if jt is not L.JoinType.FULL_OUTER and est_bytes is not None and \
            est_bytes <= threshold:
        return CpuBroadcastHashJoinExec(left_keys, right_keys, jt,
                                        plan.condition, left, right)
    if jt is L.JoinType.INNER:
        # an INNER join can build on either side: when the right is too big
        # but the left fits, swap the children and broadcast, then restore
        # the column order with a projection (the static form of the
        # runtime probe's swap)
        left_bytes = est_bytes_of(plan.children[0])
        if left_bytes is not None and left_bytes <= threshold:
            swapped = CpuBroadcastHashJoinExec(
                right_keys, left_keys, jt, plan.condition, right, left)
            return B.CpuProjectExec(list(left.output) + list(right.output),
                                    swapped)
    n = conf.shuffle_partitions
    left_ex = CpuShuffleExchangeExec(HashPartitioning(left_keys, n), left)
    right_ex = CpuShuffleExchangeExec(HashPartitioning(right_keys, n), right)
    return CpuShuffledHashJoinExec(left_keys, right_keys, jt,
                                   plan.condition, left_ex, right_ex)
