"""Logical -> CPU physical planning (port of spark_rapids_tpu/plan/planner.py:
the LocalRelation :52, Project :63, Filter :146, cache, Aggregate
:192-247 and Sort :273 planners).

The CPU plan is the oracle engine; TpuOverrides (plan/overrides.py) then
replaces the supported nodes with device execs, as the reference replaces
Spark execs with Gpu execs. An aggregate plans as partial aggregate ->
hash exchange on the grouping keys (one partition without keys) -> final
aggregate. A global sort plans as range exchange -> per-partition sort.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Type

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


@register_planner(L.Project)
def _plan_project(plan: L.Project, conf: C.TpuConf) -> PhysicalExec:
    (child,) = _plan_children(plan, conf)
    return B.CpuProjectExec(plan.project_list, child)


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
    partial = CpuHashAggregateExec(plan.grouping, plan.agg_exprs, PARTIAL,
                                   child, specs)
    if plan.grouping:
        part = HashPartitioning(list(plan.grouping), conf.shuffle_partitions)
    else:
        part = SinglePartitioning()
    exchange = CpuShuffleExchangeExec(part, partial)
    return CpuHashAggregateExec(plan.grouping, plan.agg_exprs, FINAL,
                                exchange, specs)


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
