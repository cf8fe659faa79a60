"""Whole-stage fused executor (port of spark_rapids_tpu/exec/fused.py:
TpuFusedStageExec :112, the scan form's program :298-359 and execute
:361-595).

One `TpuFusedStageExec` owns a chain of pipelined device operators (the
plan/fusion.py pass builds it) and keeps the original chain as its child,
so EXPLAIN renders the members with `*(N)` markers. Two forms:

- aggregate form: a partial aggregate tops the stage; its update folds
  the Filter / Project chain below it into its own K48 program
  (exec/aggregate.py:_UpdateStage), so execute() delegates to it.
- scan form: a Filter / Project / Expand / LocalLimit chain. The chain's
  filters and projections compose into one set of expressions over the
  stage's input (a projection's outputs substituted into the operators
  above it), one set an Expand variant, and each runs as one K48 launch a
  batch (ops/program.py:StagePlan): the filters' keep mask is carried
  through and one compaction (K31) at stage exit replaces the per-filter
  compactions. A LocalLimit takes the first `remaining` rows of that
  compaction, and an Expand over filtered rows takes the compacted rows:
  operators above either compose into the next program.

Encoded inputs keep their codes through the stage wherever the composed
expressions use them bare or in code-space predicates (the reference's
`_ord_stays_encoded` :196 and `_enc_ops_for` :239; here the composed
expressions plan through columnar/encoded.py:plan_exprs, as a projection
does), and anything else decodes at the stage boundary.

A one-variant stage without a limit whose members are all filters and
projections replays a failed batch on the CPU engine, member by member
(the reference's `cpu_replayable` :389-396, :537), counted as a CPU
fallback like any other.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.base import (
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)
from spark_rapids_tpu_torch.ops.base import (
    Alias,
    AttributeReference,
    Expression,
)


def is_fusable_scan_node(node: PhysicalExec) -> bool:
    """Pipelined device operators whose semantics survive a deferred live
    mask (reference :65)."""
    from spark_rapids_tpu_torch.exec.expand import TpuExpandExec

    return isinstance(node, (B.TpuFilterExec, B.TpuProjectExec,
                             TpuExpandExec, B.TpuLocalLimitExec))


def exprs_fusable(exprs: Sequence[Expression]) -> bool:
    """Expressions a fused stage may defer behind a live mask
    (reference :74): deterministic, no ANSI op, no input-file context."""
    def bad(x) -> bool:
        return bool(getattr(x, "ansi", False) or
                    getattr(x, "disable_coalesce_until_input", False))

    return all(e.deterministic and not e.collect(bad) for e in exprs)


class _Segment:
    """Composed filters and per-variant outputs over a segment's input
    attributes: substitute(project) rewrites the outputs; a filter adds
    its condition over the current outputs."""

    def __init__(self, attrs: Sequence[AttributeReference]):
        self.in_attrs = list(attrs)
        self.out_attrs = list(attrs)
        # per variant: the current expression of each output position
        self.outs: List[List[Expression]] = [list(attrs)]
        self.filters: List[List[Expression]] = [[]]

    def _sub(self, variant: int, e: Expression) -> Expression:
        mapping = {a.expr_id: x for a, x in zip(self.out_attrs,
                                                self.outs[variant])}

        def fn(x: Expression) -> Expression:
            if isinstance(x, AttributeReference) and x.expr_id in mapping:
                got = mapping[x.expr_id]
                return got.child if isinstance(got, Alias) else got
            return x

        return e.transform_up(fn)

    def add_filter(self, cond: Expression) -> None:
        for v in range(len(self.outs)):
            self.filters[v].append(self._sub(v, cond))

    def add_projections(self, lists: Sequence[Sequence[Expression]],
                        out_attrs: Sequence[AttributeReference]) -> None:
        """A Project (one list) or an Expand (one list a variant)."""
        outs, filters = [], []
        for v in range(len(self.outs)):
            for p in lists:
                outs.append([self._sub(v, e) for e in p])
                filters.append(list(self.filters[v]))
        self.outs, self.filters = outs, filters
        self.out_attrs = list(out_attrs)

    def bound(self):
        """Per variant: (bound outputs named as the segment's output,
        bound filters)."""
        from spark_rapids_tpu_torch.ops.bind import bind_all

        out = []
        for outs, filters in zip(self.outs, self.filters):
            named = [x if isinstance(x, Alias) and x.name == a.name and
                     x.expr_id == a.expr_id else
                     Alias(x.child if isinstance(x, Alias) else x, a.name,
                           a.expr_id)
                     for x, a in zip(outs, self.out_attrs)]
            out.append((bind_all(named, self.in_attrs),
                        bind_all(filters, self.in_attrs)))
        return out


class _SegmentRunner:
    """One segment's K48 program per variant over device batches; encoded
    inputs plan per dictionary signature as a projection does."""

    def __init__(self, seg: _Segment):
        from spark_rapids_tpu_torch.ops.eval import StageCache

        self.stages = [StageCache(*self._builders(v, outs, filters))
                       for v, (outs, filters) in enumerate(seg.bound())]

    @staticmethod
    def _builders(v: int, outs, filters):
        from spark_rapids_tpu_torch.columnar import encoded as E
        from spark_rapids_tpu_torch.ops.program import StagePlan

        exprs, nf = list(filters) + list(outs), len(filters)

        def stage(plan):
            got = plan.exprs if plan is not None else exprs
            return StagePlan(got[nf:], got[:nf], variant=v)

        return (lambda b: E.plan_exprs(exprs, b, keep_bare=True)), stage

    def run(self, v: int, batch, partition_id: int, row_start: int,
            sync: bool):
        from spark_rapids_tpu_torch.columnar.batch import compact_batch
        from spark_rapids_tpu_torch.ops.eval import stage_context

        plan, stage = self.stages[v].get(batch)
        batch, ctx = stage_context(plan, batch, partition_id, row_start)
        out, keep = stage.run_batch(batch, ctx)
        if keep is not None:
            out = compact_batch(out, keep, sync)
        return out


class TpuFusedStageExec(TpuExec):
    def __init__(self, stage_id: int, top: PhysicalExec, n_ops: int):
        super().__init__(top)
        self.stage_id = stage_id
        self.n_ops = n_ops
        self.members: List[PhysicalExec] = []
        node = top
        for _ in range(n_ops):
            self.members.append(node)
            node = node.children[0]
        self.input_node = node
        from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec

        self.agg_form = isinstance(top, TpuHashAggregateExec)
        if not self.agg_form:
            self._build_scan_segments()

    @property
    def output(self):
        return self.children[0].output

    def with_children(self, new_children):
        return TpuFusedStageExec(self.stage_id, new_children[0], self.n_ops)

    def node_name(self):
        inner = "->".join(type(m).__name__.replace("Tpu", "").replace(
            "Exec", "") for m in reversed(self.members))
        return f"TpuFusedStage({self.stage_id})[{inner}]"

    # -- scan form ------------------------------------------------------------
    def _build_scan_segments(self) -> None:
        """Bottom-up: compose the members into segments (reference
        _build_scan_ops :149). A LocalLimit ends a segment, and so does
        an Expand over filtered rows: its variants then share one
        compaction of the rows below it (the reference's `_live_shared`),
        instead of each filtering and compacting again."""
        from spark_rapids_tpu_torch.exec.expand import TpuExpandExec

        segs = [_Segment(self.input_node.output)]
        # the cut below each segment after the first: "limit" or "expand"
        self._cuts: List[str] = []
        self._limit: Optional[int] = None
        for node in reversed(self.members):
            seg = segs[-1]
            if isinstance(node, B.TpuFilterExec):
                seg.add_filter(node.condition)
            elif isinstance(node, B.TpuProjectExec):
                seg.add_projections([node.project_list], node.output)
            elif isinstance(node, TpuExpandExec):
                if any(seg.filters):
                    segs.append(_Segment(seg.out_attrs))
                    self._cuts.append("expand")
                segs[-1].add_projections(node.projections, node.output)
            elif isinstance(node, B.TpuLocalLimitExec):
                self._limit = node.limit
                segs.append(_Segment(seg.out_attrs))
                self._cuts.append("limit")
            else:  # pragma: no cover - the fusion pass builds only these
                raise AssertionError(f"unfusable {type(node).__name__}")
        self._segments = segs
        self._cpu_replayable = self._limit is None and all(
            isinstance(m, (B.TpuFilterExec, B.TpuProjectExec))
            for m in self.members)

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        if self.agg_form:
            agg_pb = self.children[0].execute(ctx)
            return PartitionedBatches(
                agg_pb.num_partitions,
                lambda p: count_output(self.metrics, agg_pb.iterator(p)))
        from spark_rapids_tpu_torch import conf as C
        from spark_rapids_tpu_torch.columnar.batch import ensure_compact
        from spark_rapids_tpu_torch.engine import retry as R
        from spark_rapids_tpu_torch.ops.eval import cpu_filter, cpu_project

        child_pb = self.input_node.execute(ctx)
        runners = [_SegmentRunner(s) for s in self._segments]
        sync = self._limit is not None or \
            ctx.conf.get(C.FILTER_COMPACT_SYNC) != "never"
        members = list(reversed(self.members))
        cuts = self._cuts

        def factory(pidx: int) -> Iterator:
            def cpu_replay(hb, off: int):
                for m in members:
                    if isinstance(m, B.TpuFilterExec):
                        hb = cpu_filter(m._bound, hb, partition_id=pidx,
                                        row_start=off)
                    else:
                        hb = cpu_project(m._bound, hb, partition_id=pidx,
                                         row_start=off)
                return hb

            # the members are deterministic (exprs_fusable), so no output
            # depends on a batch's first row: row offsets stay 0
            remaining = [self._limit]

            def through(k: int, batch) -> Iterator:
                """Segment k's outputs over a batch, through the segments
                above it; a limit cut keeps the first `remaining` rows."""
                runner = runners[k]
                for v in range(len(runner.stages)):
                    out = R.with_retry(
                        lambda: runner.run(v, batch, pidx, 0, sync),
                        site="fused")
                    if k == len(runners) - 1:
                        yield out
                        continue
                    if cuts[k] == "limit":
                        if remaining[0] <= 0:
                            return
                        n = out.host_rows()
                        if n > remaining[0]:
                            out = B.slice_head(out, remaining[0])
                            n = remaining[0]
                        remaining[0] -= n
                        if n == 0:
                            continue
                    yield from through(k + 1, out)

            for batch in child_pb.iterator(pidx):
                if remaining[0] is not None and remaining[0] <= 0:
                    break
                batch = ensure_compact(batch)
                if self._cpu_replayable:
                    yield from R.device_op_with_fallback(
                        lambda b, o: R.with_retry(
                            lambda: runners[0].run(0, b, pidx, o, sync),
                            site="fused"),
                        batch, cpu_replay, site="fused")
                    continue
                yield from through(0, batch)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))
