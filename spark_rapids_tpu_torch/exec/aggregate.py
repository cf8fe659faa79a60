"""Hash aggregate execs (port of spark_rapids_tpu/exec/aggregate.py, PARTIAL,
FINAL and COMPLETE modes; reference: aggregate.scala).

Device design, as in the reference: group-by = sort the rows by key (K1),
number the groups (K2), reduce every aggregate column per group (K3) — all
three hand-written CUDA kernels in exec/rowkeys.py. The update side folds
the Filter/Project chain below it into its evaluation (`_collapse_scan_chain`,
the aggregate half of whole-stage fusion), so filtered rows become a live
mask instead of a compaction. Each batch is aggregated, then merged into
the running result (concat + merge), the reference's incremental loop
(aggregate.scala:338-396).

Output assembly: `_assemble` reads the group count (one host sync, the
reference's marked point aggregate.py:432) and gathers the group keys at
their representative rows into a batch of bucket_capacity(groups) lanes;
`_assemble_traced` keeps the count on the card and the input capacity
(the sync-free 'lazy' form, chosen by rapids.tpu.engine.aggCompactSync=never
when the output fits the exchange's zero-copy piece cap).

Slice 2 adds STRING group keys (grouped on K5's hash words, assembled by
K7 gathers at the representative rows), Average, and the keyless global
aggregate on the device: every live row is in group 0 (no sort,
`rowkeys.keyless_group_info`), K3 reduces it, and an empty input emits the
one default row (reference: aggregate.py:845-856, :923-938).

Slice 6 adds first / last (K3) and the holistic exact percentile: the
planner exchanges raw rows into one COMPLETE aggregate (update, then the
final projection, no merge), which takes each partition as a single batch
(`children_coalesce_goal`, reference :284-294); its `pct:<p>` buffers are
K19 reductions, several fractions of one input sharing one sort. The
update evaluates each distinct input expression once.

Slice 8 adds encoded (dictionary) columns (reference :493-820,
columnar/encoded.py): the update plans each batch's dictionaries
(`plan_agg_update`): a bare encoded grouping key groups on its codes, a
bare min / max input reduces the ranks of its sorted dictionary, filters
and inputs that only test an encoded column against literals run on codes,
and every other use decodes the column first. Code-valued outputs (keys,
min / max buffers) leave as encoded columns, so the exchange and the merge
move codes (the merge re-encodes min / max buffers to rank space after a
concat has unioned their dictionaries) and the value is gathered at the
sink. min / max over a plain STRING input pick each group's winning row
with K47 (exec/rowkeys.py), then K7 gathers it.

Slice 15 adds BOOL min / max and `any` to K3 (bool lanes), and rollup /
cube: their Expand feeds this aggregate, which groups on the null-filled
keys and the grouping id.

Every update, merge and finalize runs under engine/retry.with_retry
(sites agg.update, agg.merge, agg.finalize, as the reference :796, :658,
:490): a CUDA OOM spills the device store and runs the step again; the
reference does not bisect an aggregate's input, and neither does the port.

Slice 17 adds the run-aware update (reference :680-720, columnar/runs.py):
under rapids.tpu.sql.runAware.enabled, an update batch whose keys, inputs
and folded filters read only columns with scan run tables becomes one row
per merged run (`collapse_update`), sum(e) becomes sum(e * __run_len) and
count(e) a sum of run lengths, and the rewritten inputs compile into the
K48 program of a stage cache of their own; K1-K3 then group and reduce the
runs. The rows collapsed away are `runCollapsedRows`, on the query and on
this node. Left out so far (ROADMAP.md): buffer donation.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    HostColumnarBatch,
    HostColumnVector,
    bucket_capacity,
    concat_batches,
    ensure_compact,
    gather_batch,
    gather_string_col,
)
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar import runs as RUNS
from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch
from spark_rapids_tpu_torch.engine.retry import with_retry
from spark_rapids_tpu_torch.exec import rowkeys as RK
from spark_rapids_tpu_torch.exec.base import (
    CpuExec,
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)
from spark_rapids_tpu_torch.ops.aggregates import AggregateFunction
from spark_rapids_tpu_torch.ops.base import (
    Alias,
    AttributeReference,
    Expression,
    to_attribute,
)
from spark_rapids_tpu_torch.ops.bind import bind_all
from spark_rapids_tpu_torch.ops.eval import (
    DeviceProjector,
    StageCache,
    cpu_project,
    stage_context,
)
from spark_rapids_tpu_torch.ops.values import ColV, EvalContext
from spark_rapids_tpu_torch.utils import metrics as M

PARTIAL = "partial"
FINAL = "final"
COMPLETE = "complete"

# Max device bytes of an un-compacted partial output for the sync-free lazy
# form (shared with the exchange's zero-copy slicer; reference:
# shuffle/exchange.py:73).
LAZY_PIECE_CAP_BYTES = 4 << 20


class AggSpec(NamedTuple):
    """One distinct aggregate function instance and its buffer slots."""

    func: AggregateFunction
    buffers: List[AttributeReference]


def build_agg_specs(agg_exprs: Sequence[Expression]) -> List[AggSpec]:
    specs: List[AggSpec] = []
    seen: Dict[str, AggSpec] = {}
    for e in agg_exprs:
        for f in e.collect(lambda n: isinstance(n, AggregateFunction)):
            fp = f.fingerprint()
            if fp not in seen:
                spec = AggSpec(f, list(f.buffer_attrs()))
                seen[fp] = spec
                specs.append(spec)
    return specs


def rewrite_result_exprs(agg_exprs: Sequence[Expression],
                         specs: List[AggSpec]) -> List[Expression]:
    """Aggregate functions -> their evaluate_expression over the buffers
    (the reference's final projection)."""
    by_fp = {s.func.fingerprint(): s for s in specs}

    def rewrite(node: Expression) -> Expression:
        if isinstance(node, AggregateFunction):
            spec = by_fp[node.fingerprint()]
            return node.evaluate_expression(spec.buffers)
        return node

    return [e.transform_up(rewrite) for e in agg_exprs]


def _key_exprs_for(grouping: Sequence[AttributeReference],
                   agg_exprs: Sequence[Expression]) -> List[Expression]:
    out: List[Expression] = []
    for g in grouping:
        found: Expression = g
        for e in agg_exprs:
            if isinstance(e, (Alias, AttributeReference)) and \
                    to_attribute(e).expr_id == g.expr_id:
                found = e
                break
        out.append(found)
    return out


class _HashAggregateBase(PhysicalExec):
    """Shared schema/structure for the CPU and device hash aggregate."""

    def __init__(self, grouping: List[AttributeReference],
                 agg_exprs: List[Expression], mode: str,
                 child: PhysicalExec,
                 specs: Optional[List[AggSpec]] = None):
        super().__init__(child)
        self.grouping = list(grouping)
        self.agg_exprs = list(agg_exprs)
        self.mode = mode
        self.specs = specs if specs is not None else build_agg_specs(agg_exprs)
        self.key_exprs = _key_exprs_for(self.grouping, self.agg_exprs)

    @property
    def buffer_attrs(self) -> List[AttributeReference]:
        return [b for s in self.specs for b in s.buffers]

    @property
    def output(self) -> List[AttributeReference]:
        if self.mode == PARTIAL:
            return list(self.grouping) + self.buffer_attrs
        return [to_attribute(e) for e in self.agg_exprs]

    def node_expressions(self):
        return list(self.key_exprs) + list(self.agg_exprs)

    def with_children(self, new_children):
        return type(self)(self.grouping, self.agg_exprs, self.mode,
                          new_children[0], self.specs)

    def node_name(self):
        return f"{type(self).__name__}({self.mode})"

    @property
    def _inter_attrs(self) -> List[AttributeReference]:
        return list(self.grouping) + self.buffer_attrs

    def _update_ops(self) -> List[Tuple[str, Expression, DataType]]:
        out = []
        for spec in self.specs:
            for (_name, op, expr), battr in zip(spec.func.update_aggs(),
                                                spec.buffers):
                out.append((op, expr, battr.data_type))
        return out

    def _merge_ops(self) -> List[Tuple[str, DataType]]:
        out = []
        for spec in self.specs:
            for (_name, op), battr in zip(spec.func.merge_aggs(),
                                          spec.buffers):
                out.append((op, battr.data_type))
        return out


def _default_row_values(specs: List[AggSpec]) -> List[Any]:
    vals: List[Any] = []
    for spec in specs:
        vals.extend(spec.func.initial_buffer_values())
    return vals


# ===========================================================================
# Device exec
# ===========================================================================
def _collapse_scan_chain(child: PhysicalExec, exprs: List[Expression],
                         max_nodes: Optional[int] = None):
    """Fold a TpuFilter/TpuProject/TpuCoalesceBatches chain below the
    aggregate into its update: project lists substitute into the
    aggregate's expressions, filter conditions become row masks evaluated
    with them (reference: aggregate.py:200). Returns (scan child, rewritten
    exprs, filter conditions)."""
    from spark_rapids_tpu_torch.exec import basic as B
    from spark_rapids_tpu_torch.exec.transitions import TpuCoalesceBatchesExec

    filters: List[Expression] = []
    exprs = list(exprs)
    node = child
    walked = 0
    while max_nodes is None or walked < max_nodes:
        walked += 1
        if isinstance(node, B.TpuProjectExec):
            mapping: Dict[int, Expression] = {}
            for e in node.project_list:
                attr = to_attribute(e)
                mapping[attr.expr_id] = e.child if isinstance(e, Alias) else e

            def sub(x: Expression) -> Expression:
                if isinstance(x, AttributeReference) and \
                        x.expr_id in mapping:
                    return mapping[x.expr_id]
                return x

            exprs = [e.transform_up(sub) for e in exprs]
            filters = [f.transform_up(sub) for f in filters]
            node = node.children[0]
        elif isinstance(node, B.TpuFilterExec):
            filters.append(node.condition)
            node = node.children[0]
        elif isinstance(node, TpuCoalesceBatchesExec):
            if node.goal.target_bytes() is None:
                break
            node = node.children[0]
        else:
            break
    if any(not e.deterministic for e in exprs + filters):
        return child, list(exprs), []
    return node, exprs, filters


def _group_info(key_cols: List[ColV], live, capacity: int) -> RK.GroupInfo:
    proxies = [RK.key_proxy(cv) for cv in key_cols]
    return RK.group_ids_masked(proxies, live, capacity)


def _row_width(dt: DataType) -> int:
    """Device bytes a row of one column takes, for the lazy-piece cap (a
    string counts its offset and a few bytes)."""
    return 12 if dt is DataType.STRING else to_torch(dt).itemsize


class _UpdateStage:
    """The K48 program of an update: the folded filters keep rows, the
    keys and each distinct input are its outputs (the reference folds them
    into B6's stage program, exec/aggregate.py:296)."""

    def __init__(self, keys, inputs, filters):
        from spark_rapids_tpu_torch.ops.program import StagePlan

        self.n_keys = len(keys)
        self.in_of: List[int] = []
        distinct: List[Expression] = []
        seen: Dict[Any, int] = {}
        for i, e in enumerate(inputs):
            key = e.fingerprint() if e.deterministic else i
            if key not in seen:
                seen[key] = len(distinct)
                distinct.append(e)
            self.in_of.append(seen[key])
        self.plan = StagePlan(list(keys) + distinct, filters)


def _update(ctx: EvalContext, stage: _UpdateStage, op_names):
    """Evaluate keys, inputs and folded filters (one K48 launch); group
    and reduce."""
    capacity = ctx.capacity
    outs, keep = stage.plan.run(ctx)
    live = keep if keep is not None else ctx.row_mask()
    key_cols = outs[:stage.n_keys]
    # one masked validity per distinct input; the percentiles of one
    # input share one K19 sort
    inputs = {k: (cv if cv.offsets is not None else cv.data,
                  cv.validity & live)
              for k, cv in enumerate(outs[stage.n_keys:])}
    in_of, pct, rest = stage.in_of, {}, []
    for i, op in enumerate(op_names):
        if op.startswith("pct:"):
            pct.setdefault(in_of[i], []).append(i)
        else:
            rest.append(i)
    gi = _group_info(key_cols, live, capacity)
    bufs: List[Any] = [None] * len(op_names)
    _reduce_into(bufs, [(i, op_names[i], *inputs[in_of[i]]) for i in rest],
                 gi, capacity)
    for key, idxs in pct.items():
        got = RK.segment_percentile(*inputs[key], gi.gid, capacity,
                                    [float(op_names[i][4:]) for i in idxs])
        for i, r in zip(idxs, got):
            bufs[i] = r
    return key_cols, bufs, gi


def _merge(cols, num_rows, capacity, device, n_keys, op_names):
    ctx = EvalContext(True, cols, num_rows, capacity, device=device)
    key_cols = cols[:n_keys]
    live = ctx.row_mask()
    gi = _group_info(key_cols, live, capacity)
    bufs: List[Any] = [None] * len(op_names)
    _reduce_into(bufs, [(i, op, cv, cv.validity & live) for i, (op, cv) in
                        enumerate(zip(op_names, cols[n_keys:]))], gi,
                 capacity)
    return key_cols, bufs, gi


def _reduce_into(bufs, specs, gi: RK.GroupInfo, capacity: int) -> None:
    """bufs[i] = the reduction of each (i, op, data or ColV, validity):
    K3 for all but min / max over a STRING column (K47 and K7)."""
    plain = []
    for i, op, data, valid in specs:
        if isinstance(data, ColV) and data.offsets is not None:
            if op in ("min", "max"):
                bufs[i] = _string_minmax(op, data, valid, gi, capacity)
                continue
            # count over a STRING column reads its validity only
            data = valid
        plain.append((i, op, data.data if isinstance(data, ColV)
                      else data, valid))
    got = RK.segment_reduce_many([(op, d, v) for _, op, d, v in plain], gi,
                                 capacity)
    for (i, _, _, _), r in zip(plain, got):
        bufs[i] = r


def _string_minmax(op: str, cv: ColV, valid, gi: RK.GroupInfo,
                   capacity: int) -> ColumnVector:
    """min / max of a STRING column per group, as a string column whose
    lane g holds group g's result: K47 picks each group's winning row
    (reference: update :336-341 and merge :404, segment_arg_extreme_string),
    then K7 gathers it."""
    if op not in ("min", "max"):
        raise NotImplementedError(f"device {op} over a STRING column")
    rows = RK.segment_arg_extreme_string(cv.offsets, cv.data, valid, gi,
                                         capacity, want_min=(op == "min"))
    src = ColumnVector(DataType.STRING, cv.data, cv.validity, cv.offsets,
                       cv.max_len)
    return gather_string_col(src, rows, capacity, rows < capacity)


def _storage(data, dt: DataType):
    want = to_torch(dt)
    return data if data.dtype == want else data.to(want)


def _key_column(cv: ColV, dt: DataType, d=None) -> ColumnVector:
    """An evaluated key as a column; codes under dictionary `d` stay
    encoded."""
    if d is not None:
        return E.DictionaryColumn(d.value_dtype, cv.data, cv.validity, d)
    if cv.offsets is not None:
        return ColumnVector(dt, cv.data, cv.validity, cv.offsets, cv.max_len)
    return ColumnVector(dt, _storage(cv.data, dt), cv.validity)


def _buffer_column(buf, attr, d, n_lanes: int, slot) -> ColumnVector:
    """A reduced buffer's first n_lanes group slots as a column, NULL past
    the groups; ranks under dictionary `d` stay encoded, a string buffer
    (min / max of a plain STRING) narrows its offsets."""
    if isinstance(buf, ColumnVector):
        offsets = buf.offsets[:n_lanes + 1]
        return ColumnVector(DataType.STRING, buf.data,
                            buf.validity[:n_lanes] & slot, offsets,
                            buf.max_len)
    data, valid = buf
    v = valid[:n_lanes] & slot
    d_ = data[:n_lanes]
    if d is None:
        d_ = _storage(d_, attr.data_type)
    d_ = torch.where(v, d_, torch.zeros((), dtype=d_.dtype,
                                        device=d_.device))
    if d is not None:
        return E.DictionaryColumn(d.value_dtype, d_, v, d)
    return ColumnVector(attr.data_type, d_, v)


def _assemble_traced(key_cols, bufs, gi, capacity: int, attrs,
                     dicts) -> ColumnarBatch:
    """Group slots at the input capacity with the count left on the card
    (reference: aggregate.py:894); string keys are K7 gathers at the
    representative rows. dicts: output position -> dictionary of a
    code-valued column."""
    dev = gi.order.device
    slot = torch.arange(capacity, device=dev) < gi.num_groups
    rep = gi.rep_rows.long()
    cols = []
    for k, (cv, attr) in enumerate(zip(key_cols, attrs)):
        if cv.offsets is not None:
            cols.append(gather_string_col(_key_column(cv, attr.data_type),
                                          gi.rep_rows, capacity, slot,
                                          unique=True))
            continue
        valid = slot & cv.validity[rep]
        data = torch.where(valid, cv.data[rep], torch.zeros(
            (), dtype=cv.data.dtype, device=dev))
        cols.append(_key_column(ColV(attr.data_type, data, valid),
                                attr.data_type, dicts.get(k)))
    n_keys = len(key_cols)
    for j, (buf, attr) in enumerate(zip(bufs, attrs[n_keys:])):
        cols.append(_buffer_column(buf, attr, dicts.get(n_keys + j),
                                   capacity, slot))
    return ColumnarBatch(cols, gi.num_groups)


def _assemble(key_cols, bufs, gi, capacity: int, attrs,
              dicts) -> ColumnarBatch:
    """Compacted group slots (reference: aggregate.py:424 with
    _finalize_kernel :870)."""
    # host sync: the group count sizes the assembled batch (the reference's
    # marked sync point, aggregate.py:432)
    n_groups = int(gi.num_groups.item())
    n_keys = len(key_cols)
    key_batch = ColumnarBatch(
        [_key_column(cv, a.data_type, dicts.get(k))
         for k, (cv, a) in enumerate(zip(key_cols, attrs[:n_keys]))],
        capacity)
    cols = list(gather_batch(key_batch, gi.rep_rows, n_groups,
                             unique_indices=True).columns)
    out_cap = bucket_capacity(max(n_groups, 1))
    dev = gi.order.device
    slot = torch.arange(out_cap, device=dev) < n_groups
    for j, (buf, attr) in enumerate(zip(bufs, attrs[n_keys:])):
        cols.append(_buffer_column(buf, attr, dicts.get(n_keys + j),
                                   out_cap, slot))
    return ColumnarBatch(cols, n_groups)


def _holistic(specs: List[AggSpec]) -> bool:
    return any(getattr(s.func, "holistic", False) for s in specs)


class TpuHashAggregateExec(_HashAggregateBase, TpuExec):
    placement = "tpu"

    @property
    def children_coalesce_goal(self):
        if self.mode == COMPLETE and _holistic(self.specs):
            # holistic buffers cannot merge: the whole partition arrives
            # as ONE batch, so exactly one update runs (reference :284)
            from spark_rapids_tpu_torch.exec.transitions import (
                RequireSingleBatch,
            )

            return [RequireSingleBatch()]
        return [None]

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        do_update = self.mode in (PARTIAL, COMPLETE)
        child = self.children[0]
        key_exprs = self.key_exprs
        ops = self._update_ops()
        input_exprs = [e for _, e, _ in ops]
        op_names = [op for op, _, _ in ops]
        filters: List[Expression] = []
        stage_len = 0
        if do_update and ctx.conf.get(C.FUSION_ENABLED):
            from spark_rapids_tpu_torch.plan.fusion import agg_stage_len

            stage_len = agg_stage_len(self, ctx.conf.get(C.FUSION_MAX_OPS))
        if stage_len > 1:
            n_in = len(key_exprs)
            scan, rewritten, new_filters = _collapse_scan_chain(
                child, list(key_exprs) + list(input_exprs),
                max_nodes=stage_len - 1)
            if scan is not child:
                child = scan
                key_exprs = rewritten[:n_in]
                input_exprs = rewritten[n_in:]
                filters = new_filters
        child_pb = child.execute(ctx)
        child_attrs = child.output
        if do_update:
            bound_keys = bind_all(key_exprs, child_attrs)
            bound_inputs = bind_all(input_exprs, child_attrs)
            bound_filters = bind_all(filters, child_attrs)
        n_keys = len(self.grouping)
        merge_ops = [op for op, _ in self._merge_ops()]
        attrs = self._inter_attrs
        device = ctx.device
        inter_width = sum(_row_width(a.data_type) + 1 for a in attrs)
        lazy_policy = ctx.conf.get(C.AGG_COMPACT_SYNC) == "never"

        def assemble(out, capacity: int, allow_lazy: bool,
                     dicts) -> ColumnarBatch:
            k, b, gi = out
            if allow_lazy and lazy_policy and \
                    capacity * inter_width <= LAZY_PIECE_CAP_BYTES:
                return _assemble_traced(k, b, gi, capacity, attrs, dicts)
            return _assemble(k, b, gi, capacity, attrs, dicts)

        minmax_bufs = [n_keys + j for j, op in enumerate(merge_ops)
                       if op in ("min", "max")]

        def merge(batch: ColumnarBatch) -> ColumnarBatch:
            # encoded keys merge on their codes; min / max buffers on the
            # ranks of their (possibly unioned) dictionary
            batch = E.batch_to_rank_space(batch, minmax_bufs)
            enc = E.encoded_ordinals(batch)
            out = _merge(E.eval_columns(batch, enc), batch.num_rows,
                         batch.capacity, device, n_keys, merge_ops)
            return assemble(out, batch.capacity, True, {
                i: batch.columns[i].dictionary for i in enc})

        def stage_cache(inputs, ops) -> StageCache:
            return StageCache(
                lambda b: E.plan_agg_update(b, bound_keys, inputs,
                                            bound_filters, ops),
                lambda p: _UpdateStage(p.keys, p.inputs, p.filters)
                if p is not None else _UpdateStage(bound_keys, inputs,
                                                    bound_filters))

        def update(batch: ColumnarBatch, form) -> ColumnarBatch:
            stages, ops = form
            plan, stage = stages.get(batch)
            batch, ectx = stage_context(plan, batch)
            out = _update(ectx, stage, ops)
            dicts = plan.out_dicts if plan is not None else {}
            return assemble(out, batch.capacity, True, dicts)

        row_form = (stage_cache(bound_inputs, op_names), op_names) \
            if do_update else None
        # the run-aware update (columnar/runs.py): a batch whose read
        # columns all carry scan run tables aggregates one row per merged
        # run through its own stage cache, so the run and row programs
        # never share a cache slot
        run_form = None
        if do_update and ctx.conf.get(C.RUN_AWARE_ENABLED) and \
                RUNS.run_form_ok(bound_inputs, op_names):
            run_inputs, run_ops = RUNS.run_form(
                bound_inputs, op_names, len(child_attrs) + 1)
            run_form = (stage_cache(run_inputs, run_ops), run_ops)
        run_fraction = ctx.conf.get(C.RUN_AWARE_MAX_RUN_FRACTION)

        def agg_partition(pidx: int):
            running: Optional[ColumnarBatch] = None
            for batch in child_pb.iterator(pidx):
                if batch.rows_on_host and batch.num_rows == 0:
                    continue
                batch = ensure_compact(batch)
                if do_update:
                    form = row_form
                    cu = RUNS.collapse_update(
                        batch, bound_keys, bound_inputs, bound_filters,
                        run_fraction) if run_form is not None else None
                    if cu is not None:
                        batch, collapsed = cu
                        form = run_form
                        M.record_run_collapsed_rows(collapsed)
                        M.add_node_metric(self.metrics,
                                          M.RUN_COLLAPSED_ROWS, collapsed)
                    local = with_retry(lambda: update(batch, form),
                                       site="agg.update")
                    running = local if running is None else with_retry(
                        lambda: merge(concat_batches([running, local])),
                        site="agg.merge")
                else:
                    running = with_retry(
                        lambda: merge(batch if running is None else
                                      concat_batches([running, batch])),
                        site="agg.merge")
            yield from self._emit(running, pidx, device)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, agg_partition(p)))

    def _emit(self, running: Optional[ColumnarBatch], pidx: int, device):
        if self.mode == PARTIAL:
            if running is not None:
                yield running
            return
        if running is not None and not self.grouping and \
                running.host_rows() == 0:
            # the empty ungrouped reduction emits the default row; a
            # device-count batch needs this one scalar read to know
            running = None
        if running is None:
            if not self.grouping and pidx == 0:
                running = _default_row_batch_host(
                    self.specs, self._inter_attrs).to_device(device)
            else:
                return
        rewritten = rewrite_result_exprs(self.agg_exprs, self.specs)
        projector = DeviceProjector(bind_all(rewritten, self._inter_attrs))
        yield with_retry(lambda: projector.project(running),
                         site="agg.finalize")


# ===========================================================================
# CPU oracle exec
# ===========================================================================
def _canonical_key(dtype: DataType, value, valid: bool):
    if not valid:
        return None
    if dtype in (DataType.FLOAT32, DataType.FLOAT64):
        f = float(value)
        if f != f:
            return ("NaN",)
        if f == 0.0:
            return 0.0
        return f
    if dtype is DataType.STRING:
        return str(value)
    if dtype is DataType.BOOL:
        return bool(value)
    return int(value)


def _is_nan(v) -> bool:
    try:
        return v != v
    except TypeError:
        return False


def _min_sql(a, b):
    # NaN is greater than any value (Spark float ordering)
    if _is_nan(a):
        return b
    if _is_nan(b):
        return a
    return a if a <= b else b


def _max_sql(a, b):
    if _is_nan(a):
        return a
    if _is_nan(b):
        return b
    return a if a >= b else b


class _HostAcc:
    """Per-group per-buffer accumulator with SQL null semantics."""

    __slots__ = ("op", "value", "valid", "seen")

    def __init__(self, op: str):
        self.op = op
        self.value = None
        self.valid = False
        self.seen = False  # first / last including nulls

    def add(self, v, valid: bool):
        op = self.op
        if op.startswith("pct:"):
            if valid:
                if self.value is None:
                    self.value = []
                self.value.append(float(v))
            return
        if op == "unmergeable":
            raise AssertionError(
                "holistic aggregate reached a merge stage — the planner "
                "must run it complete-mode")
        if op == "count":
            if self.value is None:
                self.value = 0
            if valid:
                self.value += 1
            self.valid = True
            return
        if op in ("first", "last"):
            if op == "first" and self.seen:
                return
            self.value, self.valid, self.seen = v, valid, True
            return
        if op in ("first_ignore_nulls", "last_ignore_nulls"):
            if not valid:
                return
            if op.startswith("first") and self.seen:
                return
            self.value, self.valid, self.seen = v, True, True
            return
        if not valid:
            return
        if not self.valid:
            self.value, self.valid = v, True
            return
        if op == "sum":
            s = self.value + v
            if isinstance(s, int):
                # wrap to signed 64-bit like the device's int64 arithmetic
                s = ((s + (1 << 63)) % (1 << 64)) - (1 << 63)
            self.value = s
        elif op == "min":
            self.value = _min_sql(self.value, v)
        elif op == "max":
            self.value = _max_sql(self.value, v)
        elif op == "any":
            self.value = bool(self.value) or bool(v)
        else:
            raise ValueError(f"unknown op {op}")

    def result(self):
        if self.op == "count":
            return (self.value or 0), True
        if self.op.startswith("pct:"):
            # the reference's host percentile (aggregate.py:1024)
            if not self.value:
                return None, False
            p = float(self.op[4:])
            vals = np.sort(np.asarray(self.value, dtype=np.float64))
            q = p * (len(vals) - 1)
            k = int(np.floor(q))
            frac = q - k
            hi = min(k + 1, len(vals) - 1) if frac > 0 else k
            return float(vals[k] * (1 - frac) + vals[hi] * frac), True
        return self.value, self.valid


class CpuHashAggregateExec(_HashAggregateBase, CpuExec):
    placement = "cpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        child_attrs = self.children[0].output

        def agg_partition(pidx: int):
            groups: Dict[tuple, List[_HostAcc]] = {}
            key_rows: Dict[tuple, tuple] = {}
            order: List[tuple] = []
            do_update = self.mode in (PARTIAL, COMPLETE)
            ops = [op for op, _, _ in self._update_ops()] if do_update else \
                [op for op, _ in self._merge_ops()]
            n_keys = len(self.grouping)
            key_dtypes = [g.data_type for g in self.grouping]
            bound_update = bind_all(
                self.key_exprs + [e for _, e, _ in self._update_ops()],
                child_attrs) if do_update else None
            evs = [cpu_project(bound_update, batch, partition_id=pidx)
                   if do_update else batch
                   for batch in child_pb.iterator(pidx)
                   if batch.num_rows]
            fast = _fast_groups(evs, n_keys, key_dtypes, ops)
            vec = None if fast is not None else \
                _vector_groups(evs, n_keys, key_dtypes, ops)
            for ev in ([] if fast is not None or vec is not None else evs):
                kcols = ev.columns[:n_keys]
                vcols = ev.columns[n_keys:]
                for i in range(ev.num_rows):
                    key = tuple(
                        _canonical_key(key_dtypes[c], kcols[c].data[i],
                                       bool(kcols[c].validity[i]))
                        for c in range(n_keys))
                    accs = groups.get(key)
                    if accs is None:
                        accs = [_HostAcc(op) for op in ops]
                        groups[key] = accs
                        order.append(key)
                        key_rows[key] = tuple(
                            (kcols[c].data[i], bool(kcols[c].validity[i]))
                            for c in range(n_keys))
                    for acc, col in zip(accs, vcols):
                        v = col.data[i]
                        if isinstance(v, np.generic):
                            v = v.item()
                        acc.add(v, bool(col.validity[i]))
            if fast is not None:
                inter = self._fast_inter_batch(*fast)
            elif vec is not None:
                inter = self._vector_inter_batch(*vec)
            else:
                inter = self._build_inter_batch(order, key_rows, groups,
                                                pidx)
            if inter is None:
                return
            if self.mode == PARTIAL:
                yield inter
                return
            rewritten = rewrite_result_exprs(self.agg_exprs, self.specs)
            yield cpu_project(bind_all(rewritten, self._inter_attrs), inter,
                              partition_id=pidx)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, agg_partition(p)))

    def _fast_inter_batch(self, key_cols, buf_data, buf_valid):
        """_build_inter_batch for _fast_groups' group-major arrays
        (reference: aggregate.py:1214); invalid slots are zeroed before
        the dtype cast."""
        n = len(key_cols[0]) if key_cols else len(buf_data[0])
        cols: List[HostColumnVector] = []
        for c, attr in enumerate(self.grouping):
            cols.append(HostColumnVector(
                attr.data_type,
                key_cols[c].astype(attr.data_type.to_np(), copy=False),
                np.ones(n, dtype=bool)))
        for b, battr in enumerate(self.buffer_attrs):
            valid = buf_valid[b]
            data = np.where(valid, buf_data[b], 0).astype(
                battr.data_type.to_np(), copy=False)
            cols.append(HostColumnVector(battr.data_type, data, valid))
        return HostColumnarBatch(cols, n)

    def _vector_inter_batch(self, key_data, key_valid, buf_data,
                            buf_valid):
        """_build_inter_batch for _vector_groups' arrays: NULL keys and
        buffers hold 0 ("" for STRING)."""
        cols: List[HostColumnVector] = []
        for attrs, datas, valids in ((self.grouping, key_data, key_valid),
                                     (self.buffer_attrs, buf_data,
                                      buf_valid)):
            for attr, d, v in zip(attrs, datas, valids):
                if attr.data_type is DataType.STRING:
                    data = np.where(v, d, "").astype(object)
                else:
                    data = np.zeros(len(v), dtype=attr.data_type.to_np())
                    data[v] = d[v]
                cols.append(HostColumnVector(attr.data_type, data, v))
        return HostColumnarBatch(cols, len(buf_valid[0]) if buf_valid
                                 else len(key_valid[0]))

    def _build_inter_batch(self, order, key_rows, groups, pidx):
        if not order:
            if self.mode == PARTIAL or self.grouping or pidx != 0:
                return None
            return _default_row_batch_host(self.specs, self._inter_attrs)
        n = len(order)
        cols: List[HostColumnVector] = []
        for c, attr in enumerate(self.grouping):
            npdt = attr.data_type.to_np()
            data = np.zeros(n, dtype=npdt)
            validity = np.zeros(n, dtype=bool)
            for i, key in enumerate(order):
                v, valid = key_rows[key][c]
                validity[i] = valid
                if valid:
                    data[i] = v
                elif attr.data_type is DataType.STRING:
                    data[i] = ""
            cols.append(HostColumnVector(attr.data_type, data, validity))
        for b, battr in enumerate(self.buffer_attrs):
            npdt = battr.data_type.to_np()
            data = np.zeros(n, dtype=npdt)
            if battr.data_type is DataType.STRING:
                data[:] = ""
            validity = np.zeros(n, dtype=bool)
            for i, key in enumerate(order):
                v, valid = groups[key][b].result()
                validity[i] = valid
                if valid and v is not None:
                    data[i] = v
            cols.append(HostColumnVector(battr.data_type, data, validity))
        return HostColumnarBatch(cols, n)


_FAST_OPS = frozenset(("sum", "count", "min", "max"))


def _fast_groups(evs, n_keys: int, key_dtypes, ops):
    """Vectorised group-by of the CPU engine's common shape, or None
    (reference: aggregate.py:1064): integer / bool keys without NULLs,
    sum / count / min / max only, no NaN among valid float values. Returns
    group-major (key columns, buffer data, buffer validity). int64 sums
    wrap per addition as _HostAcc's do; float sums add in row order
    (np.add.at is unbuffered); groups come out in key order."""
    if not evs or not ops or any(op not in _FAST_OPS for op in ops):
        return None
    if len(evs[0].columns) != n_keys + len(ops):
        return None
    if any(dt in (DataType.FLOAT32, DataType.FLOAT64, DataType.STRING)
           for dt in key_dtypes):
        return None

    def cat(cidx, what):
        return np.concatenate([np.asarray(getattr(ev.columns[cidx], what))
                               for ev in evs])

    kdata = []
    for c in range(n_keys):
        if not cat(c, "validity").all():
            return None
        kd = cat(c, "data")
        if kd.dtype.kind not in "iub":
            return None
        kdata.append(kd)
    vdata, vvalid = [], []
    for j, op in enumerate(ops):
        d = cat(n_keys + j, "data")
        v = cat(n_keys + j, "validity").astype(bool, copy=False)
        if op != "count":
            if d.dtype.kind == "f":
                if np.isnan(d[v]).any():
                    return None
            elif d.dtype.kind not in "iu":
                return None
        vdata.append(d)
        vvalid.append(v)
    total = sum(ev.num_rows for ev in evs)
    if n_keys == 0:
        n_groups = 1
        inv = np.zeros(total, dtype=np.intp)
        key_cols = []
    elif n_keys == 1:
        uniq, inv = np.unique(kdata[0], return_inverse=True)
        n_groups = len(uniq)
        key_cols = [uniq]
    else:
        mat = np.stack([k.astype(np.int64, copy=False) for k in kdata],
                       axis=1)
        uniq, inv = np.unique(mat, axis=0, return_inverse=True)
        inv = inv.ravel()
        n_groups = len(uniq)
        key_cols = [uniq[:, c] for c in range(n_keys)]
    buf_data, buf_valid = [], []
    for op, d, v in zip(ops, vdata, vvalid):
        nvalid = np.bincount(inv, weights=v.astype(np.float64),
                             minlength=n_groups).astype(np.int64)
        if op == "count":
            buf_data.append(nvalid)
            buf_valid.append(np.ones(n_groups, dtype=bool))
            continue
        is_float = d.dtype.kind == "f"
        dv = d[v].astype(np.float64 if is_float else np.int64, copy=False)
        iv = inv[v]
        if op == "sum":
            out = np.zeros(n_groups, dtype=dv.dtype)
            np.add.at(out, iv, dv)
        elif op == "min":
            out = np.full(n_groups, np.inf) if is_float else \
                np.full(n_groups, np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(out, iv, dv)
        else:
            out = np.full(n_groups, -np.inf) if is_float else \
                np.full(n_groups, np.iinfo(np.int64).min, dtype=np.int64)
            np.maximum.at(out, iv, dv)
        buf_data.append(out)
        buf_valid.append(nvalid > 0)
    return key_cols, buf_data, buf_valid


_VECTOR_OPS = frozenset(("sum", "count", "min", "max", "any", "first",
                         "last", "first_ignore_nulls", "last_ignore_nulls"))


def _factorize(data, valid, dtype: DataType):
    """(codes, cardinality): per row 0 for NULL, else 1 + the rank of its
    value among the column's distinct values in SQL order (floats: -0.0
    equals 0.0, every NaN one value above the rest; strings in code-point
    order)."""
    if dtype is DataType.STRING:
        seen: Dict[Any, int] = {}
        first = np.fromiter((seen.setdefault(x, len(seen)) if ok else 0
                             for x, ok in zip(data, valid)), np.int64,
                            len(data))
        ranked = sorted(seen, key=str)
        rank = np.empty(max(len(seen), 1), np.int64)
        for r, x in enumerate(ranked):
            rank[seen[x]] = r
        return np.where(valid, 1 + rank[first], 0), len(seen) + 1
    x = np.asarray(data)
    if x.dtype.kind == "f":
        x = np.where(x == 0, 0.0, x.astype(np.float64))
    x = np.where(valid, x, np.zeros((), x.dtype))
    uniq, inv = np.unique(x, return_inverse=True)
    return np.where(valid, 1 + inv.ravel(), 0), len(uniq) + 1


def _vector_groups(evs, n_keys: int, key_dtypes, ops):
    """The row loop of the CPU engine's group-by, vectorised, or None
    (percentiles, or a column numpy cannot hold): groups in first-seen
    order with each key's first row, and every buffer as _HostAcc computes
    it: counts, sums added in row order (floats in f64 from -0.0, the
    first value's own sign; integers wrapping), min / max of the SQL order
    (NaN greatest) at the first row that reaches it, first / last rows,
    any. Returns (key data, key validity, buffer data, buffer validity),
    each an array a group."""
    if not evs or any(op not in _VECTOR_OPS for op in ops):
        return None
    if len(evs[0].columns) != n_keys + len(ops):
        return None

    def cat(cidx, what):
        return np.concatenate([np.asarray(getattr(ev.columns[cidx], what))
                               for ev in evs])

    total = sum(ev.num_rows for ev in evs)
    rows = np.arange(total)
    gkey, n_codes = np.zeros(total, np.int64), 1
    kdata, kvalid = [], []
    for c in range(n_keys):
        d, v = cat(c, "data"), cat(c, "validity").astype(bool, copy=False)
        if d.dtype.kind not in "iufbO":
            return None
        kdata.append(d)
        kvalid.append(v)
        codes, card = _factorize(d, v, key_dtypes[c])
        if c == 0:
            gkey, n_codes = codes, card
        else:
            gkey = np.unique(gkey * card + codes,
                             return_inverse=True)[1].ravel()
            n_codes = int(gkey.max()) + 1
    # groups in first-seen order: each code's first row, then a sort of
    # the codes present by it
    first = np.full(n_codes, total, np.int64)
    np.minimum.at(first, gkey, rows)
    present = np.nonzero(first < total)[0]
    by_first = present[np.argsort(first[present], kind="stable")]
    rank = np.empty(n_codes, np.int64)
    rank[by_first] = np.arange(len(by_first))
    gid = rank[gkey]
    first_rows = first[by_first]
    n_groups = len(first_rows)
    key_data = [d[first_rows] for d in kdata]
    key_valid = [v[first_rows] for v in kvalid]
    buf_data, buf_valid = [], []
    for j, op in enumerate(ops):
        d = cat(n_keys + j, "data")
        v = cat(n_keys + j, "validity").astype(bool, copy=False)
        if d.dtype.kind not in "iufbO" or (d.dtype.kind == "O" and op in (
                "sum", "any")):
            return None
        nvalid = np.bincount(gid[v], minlength=n_groups)
        has = nvalid > 0
        if op == "count":
            buf_data.append(nvalid.astype(np.int64))
            buf_valid.append(np.ones(n_groups, dtype=bool))
            continue
        if op == "sum":
            if d.dtype.kind == "f":
                out = np.full(n_groups, -0.0)
                np.add.at(out, gid[v], d[v].astype(np.float64))
            else:
                out = np.zeros(n_groups, np.int64)
                np.add.at(out, gid[v], d[v].astype(np.int64))
            buf_data.append(out)
            buf_valid.append(has)
            continue
        if op == "any":
            buf_data.append(np.bincount(gid[v], weights=d[v] != 0,
                                        minlength=n_groups) > 0)
            buf_valid.append(has)
            continue
        if op in ("min", "max"):
            codes, card = _factorize(d, v, DataType.STRING
                                     if d.dtype.kind == "O" else None)
            key = codes if op == "min" else card - codes
            best = np.full(n_groups, card + 1, np.int64)
            np.minimum.at(best, gid[v], key[v])
            reach = v & (key == best[gid])
            pick = np.full(n_groups, total, np.int64)
            np.minimum.at(pick, gid[reach], rows[reach])
        elif op in ("first", "last"):
            pick = first_rows if op == "first" else np.zeros(n_groups,
                                                             np.int64)
            if op == "last":
                np.maximum.at(pick, gid, rows)
        else:
            pick = np.full(n_groups, total if op.startswith("first")
                           else -1, np.int64)
            (np.minimum if op.startswith("first") else np.maximum).at(
                pick, gid[v], rows[v])
        ok = (pick >= 0) & (pick < total)
        safe = np.where(ok, pick, 0)
        buf_data.append(d[safe])
        buf_valid.append(ok & (v[safe] if op in ("first", "last") else has))
    return key_data, key_valid, buf_data, buf_valid


def _default_row_batch_host(specs, inter_attrs) -> HostColumnarBatch:
    """One row of initial buffer values: the empty ungrouped reduction
    (reference: aggregate.scala:406-419)."""
    vals = _default_row_values(specs)
    cols = []
    for battr, v in zip(inter_attrs, vals):
        data = np.zeros(1, dtype=battr.data_type.to_np())
        if v is not None and battr.data_type is not DataType.STRING:
            data[0] = v
        cols.append(HostColumnVector(battr.data_type, data,
                                     np.array([v is not None])))
    return HostColumnarBatch(cols, 1)
