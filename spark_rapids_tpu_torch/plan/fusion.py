"""Whole-stage fusion pass (port of spark_rapids_tpu/plan/fusion.py:
`_scan_member` :43, `agg_stage_len` :60, `_scan_stage_len` :89 and
`fuse_stages` :139).

Runs on the final physical plan and wraps maximal chains of pipelined
device operators in a TpuFusedStageExec (exec/fused.py), so each stage
runs as one K48 stage program a batch (ops/program.py) instead of one
program and one intermediate batch an operator:

- aggregate form: a partial TpuHashAggregate tops the stage with the
  Filter / Project chain below it; the aggregate's update folds that chain
  into its own program (exec/aggregate._collapse_scan_chain, gated on the
  same conf). A TpuExpandExec (rollup / cube) stops the chain below a
  partial aggregate: the update folds no Expand.
- scan form: TpuFilter / TpuProject / TpuExpand / TpuLocalLimit chains of
  two or more operators with deterministic, non-ANSI, non-input-file
  expressions, at most one Expand and one LocalLimit each.

Anything else ends a stage: exchanges, joins, sorts, windows, transitions,
coalesces, scans, caches and the merge side of aggregates.

Conf: rapids.tpu.sql.fusion.enabled, rapids.tpu.sql.fusion.maxOps. With
fusion off every Filter and Project still runs as its own K48 program.
"""

from __future__ import annotations

import itertools

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.base import PhysicalExec
from spark_rapids_tpu_torch.exec.fused import (
    TpuFusedStageExec,
    exprs_fusable,
    is_fusable_scan_node,
)


def _scan_member(node: PhysicalExec) -> bool:
    return is_fusable_scan_node(node) and \
        exprs_fusable(node.node_expressions())


def _agg_chain_member(node: PhysicalExec) -> bool:
    """What the update's chain collapse walks through: projects, filters
    and best-effort TargetSize coalesces."""
    from spark_rapids_tpu_torch.exec.transitions import TpuCoalesceBatchesExec

    if isinstance(node, TpuCoalesceBatchesExec):
        return node.goal.target_bytes() is not None
    return isinstance(node, (B.TpuFilterExec, B.TpuProjectExec)) and \
        exprs_fusable(node.node_expressions())


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
    if not exprs_fusable(exprs):
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


def _scan_stage_len(node: PhysicalExec, max_ops: int) -> int:
    """Chain length of a scan-form stage rooted at `node` (0: none)."""
    from spark_rapids_tpu_torch.exec.expand import TpuExpandExec

    n_ops = n_expand = n_limit = 0
    cur = node
    while n_ops < max_ops and _scan_member(cur):
        if isinstance(cur, TpuExpandExec):
            if n_expand:
                break
            n_expand += 1
        if isinstance(cur, B.TpuLocalLimitExec):
            if n_limit:
                break
            n_limit += 1
        n_ops += 1
        cur = cur.children[0]
    return n_ops if n_ops >= 2 else 0


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
        n_ops = agg_stage_len(node, max_ops) or \
            _scan_stage_len(node, max_ops)
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
