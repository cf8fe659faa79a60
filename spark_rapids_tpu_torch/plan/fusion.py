"""Whole-stage fusion pass, aggregate form (port of spark_rapids_tpu/plan/fusion.py:
`agg_stage_len` :60 and `fuse_stages` :139).

A partial TpuHashAggregate tops a stage together with the Filter/Project
chain below it: the aggregate's update folds that chain into its own
evaluation (exec/aggregate._collapse_scan_chain, gated on the same conf),
and this pass wraps aggregate + chain in a TpuFusedStageExec for plan
accounting and EXPLAIN. The scan-form stages (Filter/Project/Expand/Limit
chains without an aggregate) wait for the fused-stage kernel (ROADMAP B6).
A TpuExpandExec (rollup / cube) stops the chain below a partial aggregate:
the update folds no Expand, so the aggregate runs over each of Expand's
output batches on its own.

Conf: rapids.tpu.sql.fusion.enabled, rapids.tpu.sql.fusion.maxOps.
"""

from __future__ import annotations

import itertools

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.base import PhysicalExec
from spark_rapids_tpu_torch.exec.fused import TpuFusedStageExec


def _agg_chain_member(node: PhysicalExec) -> bool:
    """What the update's chain collapse walks through: projects, filters
    and best-effort TargetSize coalesces."""
    from spark_rapids_tpu_torch.exec.transitions import TpuCoalesceBatchesExec

    if isinstance(node, TpuCoalesceBatchesExec):
        return node.goal.target_bytes() is not None
    return isinstance(node, (B.TpuFilterExec, B.TpuProjectExec)) and \
        all(e.deterministic for e in node.node_expressions())


def agg_stage_len(node: PhysicalExec, max_ops: int) -> int:
    """Chain length (aggregate included) of an aggregate-form stage rooted
    at `node`, or 0 when the node heads no fusable stage."""
    from spark_rapids_tpu_torch.exec.aggregate import (
        PARTIAL,
        TpuHashAggregateExec,
    )

    if not isinstance(node, TpuHashAggregateExec) or node.mode != PARTIAL:
        return 0
    exprs = list(node.key_exprs) + [e for _, e, _ in node._update_ops()]
    if not all(e.deterministic for e in exprs):
        return 0
    n_ops = 1
    real_members = 0
    cur = node.children[0]
    while n_ops < max_ops and _agg_chain_member(cur):
        if isinstance(cur, (B.TpuFilterExec, B.TpuProjectExec)):
            real_members += 1
        n_ops += 1
        cur = cur.children[0]
    return n_ops if real_members else 0


def _rebuild_chain(top: PhysicalExec, n_ops: int,
                   new_input: PhysicalExec) -> PhysicalExec:
    if n_ops == 0:
        return new_input
    child = _rebuild_chain(top.children[0], n_ops - 1, new_input)
    if child is top.children[0]:
        return top
    return top.with_children([child])


def _chain_input(top: PhysicalExec, n_ops: int) -> PhysicalExec:
    node = top
    for _ in range(n_ops):
        node = node.children[0]
    return node


def fuse_stages(plan: PhysicalExec, conf: C.TpuConf) -> PhysicalExec:
    if not conf.get(C.FUSION_ENABLED):
        return plan
    max_ops = conf.get(C.FUSION_MAX_OPS)
    counter = itertools.count(1)

    def walk(node: PhysicalExec) -> PhysicalExec:
        n_ops = agg_stage_len(node, max_ops)
        if n_ops:
            below = _chain_input(node, n_ops)
            new_top = _rebuild_chain(node, n_ops, walk(below))
            return TpuFusedStageExec(next(counter), new_top, n_ops)
        new_children = [walk(c) for c in node.children]
        if new_children and any(
                a is not b for a, b in zip(new_children, node.children)):
            node = node.with_children(new_children)
        return node

    return walk(plan)


def count_fused_stages(plan: PhysicalExec) -> int:
    return len(plan.collect_nodes(lambda n: isinstance(n, TpuFusedStageExec)))
