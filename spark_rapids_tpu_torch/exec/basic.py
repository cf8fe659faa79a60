"""Basic physical operators (port of spark_rapids_tpu/exec/basic.py: the host
scan, range :79, project, filter, union :296, the limits and partition
coalescing;
reference:
basicPhysicalOperators.scala — GpuProjectExec :34-95, GpuFilterExec
:96-177, GpuCoalesceExec :201-240 — and limit.scala:39-123).

Project and filter run each batch through engine/retry's
device_op_with_fallback, as the reference (:152, :248): a CUDA OOM spills
and runs again, an OOM that persists bisects the batch, and a batch the
device cannot finish runs through the CPU engine."""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    HostColumnarBatch,
    HostColumnVector,
    bucket_capacity,
    ensure_compact,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.engine import retry as R
from spark_rapids_tpu_torch.exec.base import (
    CpuExec,
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
    rows_of,
)
from spark_rapids_tpu_torch.ops.base import AttributeReference, Expression, to_attribute
from spark_rapids_tpu_torch.ops.bind import bind_all, bind_references
from spark_rapids_tpu_torch.ops.eval import (
    DeviceFilter,
    DeviceProjector,
    cpu_filter,
    cpu_project,
)


class HostScanExec(CpuExec):
    """Scan of pre-partitioned host batches (LocalTableScan analog)."""

    def __init__(self, schema: List[AttributeReference],
                 partitions: List[List[HostColumnarBatch]]):
        super().__init__()
        self._schema = schema
        self._partitions = partitions

    @property
    def output(self):
        return self._schema

    def with_children(self, new_children):
        assert not new_children
        return self

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        parts = self._partitions
        return PartitionedBatches(
            len(parts), lambda p: count_output(self.metrics, iter(parts[p])))

    def node_name(self):
        return f"HostScan[{len(self._partitions)} parts]"


class RangeExec(CpuExec):
    """session.range: int64 ids split across partitions, made on the host
    (reference: exec/basic.py:79); a device plan uploads its batches."""

    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 out_attr: Optional[AttributeReference] = None):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.num_parts = max(1, num_partitions)
        self._attr = out_attr or AttributeReference("id", DataType.INT64,
                                                    False)

    @property
    def output(self):
        return [self._attr]

    def with_children(self, new_children):
        assert not new_children
        return self

    def node_name(self):
        return f"Range[{self.start}, {self.end}, {self.step}; " \
            f"{self.num_parts} parts]"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        total = max(0, -(-(self.end - self.start) // self.step))
        per = -(-total // self.num_parts) if total else 0

        def factory(pidx: int) -> Iterator[HostColumnarBatch]:
            lo = pidx * per
            hi = min(total, (pidx + 1) * per)
            if hi <= lo:
                return iter(())
            ids = np.arange(self.start + self.step * lo,
                            self.start + self.step * hi, self.step,
                            dtype=np.int64)
            col = HostColumnVector(DataType.INT64, ids,
                                   np.ones(len(ids), dtype=bool))
            return count_output(self.metrics,
                                iter([HostColumnarBatch([col], len(ids))]))

        return PartitionedBatches(self.num_parts, factory)


def _positional(exprs) -> bool:
    """Expressions whose values follow a row's position in its partition
    (the nondeterministic ones: rand, monotonically_increasing_id)."""
    return not all(e.deterministic for e in exprs)


class TpuProjectExec(TpuExec):
    def __init__(self, project_list: Sequence[Expression], child: PhysicalExec):
        super().__init__(child)
        self.project_list = list(project_list)
        self._bound = bind_all(self.project_list, child.output)
        self._projector = DeviceProjector(self._bound)

    @property
    def output(self):
        return [to_attribute(e) for e in self.project_list]

    def node_expressions(self):
        return list(self.project_list)

    def with_children(self, new_children):
        return TpuProjectExec(self.project_list, new_children[0])

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        projector = self._projector
        bound = self._bound

        positional = _positional(self.project_list)

        def factory(pidx: int) -> Iterator:
            row_start = 0
            for batch in child_pb.iterator(pidx):
                # spill + retry around the projection, bisection of the
                # batch, then the CPU engine (reference :152); `off` is a
                # split piece's first row in the batch, row_start the
                # batch's in its partition (read only for rand and
                # monotonically_increasing_id, whose values follow it)
                yield from R.device_op_with_fallback(
                    lambda b, off: R.with_retry(
                        lambda: projector.project(
                            b, partition_id=pidx, row_start=row_start + off),
                        site="project"),
                    batch,
                    lambda hb, off: cpu_project(bound, hb, partition_id=pidx,
                                                row_start=row_start + off),
                    site="project")
                if positional:
                    row_start += rows_of(batch)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


class CpuProjectExec(CpuExec):
    def __init__(self, project_list: Sequence[Expression], child: PhysicalExec):
        super().__init__(child)
        self.project_list = list(project_list)
        self._bound = bind_all(self.project_list, child.output)

    def node_expressions(self):
        return list(self.project_list)

    @property
    def output(self):
        return [to_attribute(e) for e in self.project_list]

    def with_children(self, new_children):
        return CpuProjectExec(self.project_list, new_children[0])

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        bound = self._bound

        def factory(pidx: int) -> Iterator:
            row_start = 0
            for batch in child_pb.iterator(pidx):
                yield cpu_project(bound, batch, partition_id=pidx,
                                  row_start=row_start)
                row_start += batch.num_rows

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


class TpuFilterExec(TpuExec):
    def __init__(self, condition: Expression, child: PhysicalExec):
        super().__init__(child)
        self.condition = condition
        self._bound = bind_references(condition, child.output)
        self._filter = DeviceFilter(self._bound)

    @property
    def output(self):
        return self.children[0].output

    def node_expressions(self):
        return [self.condition]

    def with_children(self, new_children):
        return TpuFilterExec(self.condition, new_children[0])

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        filt = self._filter
        # the compaction's row-count read: a local card's sync costs
        # microseconds, so 'auto' syncs and shrinks the capacity; 'never'
        # keeps the count on the card (reference: exec/basic.py:221-235)
        sync = ctx.conf.get(C.FILTER_COMPACT_SYNC) != "never"
        bound = self._bound

        positional = _positional([self.condition])

        def factory(pidx: int) -> Iterator:
            row_start = 0
            for batch in child_pb.iterator(pidx):
                yield from R.device_op_with_fallback(
                    lambda b, off: R.with_retry(
                        lambda: filt.apply(b, partition_id=pidx,
                                           row_start=row_start + off,
                                           sync=sync),
                        site="filter"),
                    batch,
                    lambda hb, off: cpu_filter(bound, hb, partition_id=pidx,
                                               row_start=row_start + off),
                    site="filter")
                if positional:
                    row_start += rows_of(batch)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


class CpuFilterExec(CpuExec):
    def __init__(self, condition: Expression, child: PhysicalExec):
        super().__init__(child)
        self.condition = condition
        self._bound = bind_references(condition, child.output)

    @property
    def output(self):
        return self.children[0].output

    def node_expressions(self):
        return [self.condition]

    def with_children(self, new_children):
        return CpuFilterExec(self.condition, new_children[0])

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        bound = self._bound

        def factory(pidx: int) -> Iterator:
            row_start = 0
            for batch in child_pb.iterator(pidx):
                yield cpu_filter(bound, batch, partition_id=pidx,
                                 row_start=row_start)
                row_start += batch.num_rows

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


# ---------------------------------------------------------------------------
# Union (reference: exec/basic.py:296)
# ---------------------------------------------------------------------------
class _UnionBase(PhysicalExec):
    """Union-all: the children's partition lists one after another, no
    shuffle (reference: GpuUnionExec, basicPhysicalOperators.scala)."""

    @property
    def output(self):
        return self.children[0].output

    def with_children(self, new_children):
        return type(self)(*new_children)

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pbs = [c.execute(ctx) for c in self.children]
        spans = []
        offset = 0
        for pb in child_pbs:
            spans.append((offset, pb))
            offset += pb.num_partitions

        def factory(pidx: int) -> Iterator:
            for off, pb in spans:
                if off <= pidx < off + pb.num_partitions:
                    return count_output(self.metrics, pb.iterator(pidx - off))
            raise IndexError(pidx)

        return PartitionedBatches(offset, factory)


class TpuUnionExec(_UnionBase, TpuExec):
    placement = "tpu"


class CpuUnionExec(_UnionBase, CpuExec):
    placement = "cpu"


# ---------------------------------------------------------------------------
# Limits (reference: exec/basic.py:337-438, limit.scala:39-123)
# ---------------------------------------------------------------------------
def _limited(it: Iterator, limit: int, slicer) -> Iterator:
    remaining = limit
    for b in it:
        if remaining <= 0:
            break
        n = rows_of(b)
        if n <= remaining:
            remaining -= n
            yield b
        else:
            yield slicer(b, remaining)
            remaining = 0


def _slice_host(b: HostColumnarBatch, n: int) -> HostColumnarBatch:
    return b.slice(0, n)


def slice_head(b: ColumnarBatch, n: int) -> ColumnarBatch:
    """The first n rows of a device batch, with no kernel: fixed columns
    narrow to the new capacity with the rows past n cleared; a string
    column keeps its bytes and narrows its offsets (the rows past n become
    empty NULLs). Reference: slice_batch_host (batch.py:1696), a gather."""
    b = ensure_compact(b)
    cap = bucket_capacity(max(n, 1))
    cols = []
    for c in b.columns:
        validity = c.validity[:cap].clone()
        validity[n:] = False
        if c.offsets is not None:
            offsets = c.offsets[:cap + 1].clone()
            offsets[n + 1:] = offsets[n]
            cols.append(ColumnVector(c.dtype, c.data, validity, offsets,
                                     c.max_len))
        else:
            data = c.data[:cap].clone()
            data[n:] = 0
            cols.append(c.with_data(data, validity))
    return ColumnarBatch(cols, n)


class _LocalLimitBase(PhysicalExec):
    """Per-partition limit (reference: exec/basic.py:358, :380)."""

    def __init__(self, limit: int, child: PhysicalExec):
        super().__init__(child)
        self.limit = limit

    @property
    def output(self):
        return self.children[0].output

    def with_children(self, new_children):
        return type(self)(self.limit, new_children[0])

    def node_name(self):
        return f"{type(self).__name__}({self.limit})"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        return self._limit(self.children[0].execute(ctx))

    def _limit(self, child_pb: PartitionedBatches) -> PartitionedBatches:
        limit = self.limit
        slicer = slice_head if self.placement == "tpu" else _slice_host
        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, _limited(
                child_pb.iterator(p), limit, slicer)))


class TpuLocalLimitExec(_LocalLimitBase, TpuExec):
    placement = "tpu"


class CpuLocalLimitExec(_LocalLimitBase, CpuExec):
    placement = "cpu"


class _GlobalLimitBase(_LocalLimitBase):
    """Global limit over one input partition (the planner puts a
    CoalescePartitionsExec(1) below it; reference: exec/basic.py:402)."""

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        if child_pb.num_partitions != 1:
            raise ValueError("a global limit needs a single partition")
        return self._limit(child_pb)


class TpuGlobalLimitExec(_GlobalLimitBase, TpuExec):
    placement = "tpu"


class CpuGlobalLimitExec(_GlobalLimitBase, CpuExec):
    placement = "cpu"


class CoalescePartitionsExec(PhysicalExec):
    """Merge input partitions into `num_partitions` by chaining their
    iterators, without a shuffle (reference: exec/basic.py:441). It takes
    its child's placement and passes batches through untouched."""

    def __init__(self, num_partitions: int, child: PhysicalExec):
        super().__init__(child)
        self.num_partitions = max(1, num_partitions)
        self.placement = child.placement

    @property
    def output(self):
        return self.children[0].output

    def with_children(self, new_children):
        return CoalescePartitionsExec(self.num_partitions, new_children[0])

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        n_in = child_pb.num_partitions
        n_out = min(self.num_partitions, max(1, n_in))

        def factory(pidx: int) -> Iterator:
            return count_output(self.metrics, itertools.chain.from_iterable(
                child_pb.iterator(i) for i in range(pidx, n_in, n_out)))

        return PartitionedBatches(n_out, factory)
