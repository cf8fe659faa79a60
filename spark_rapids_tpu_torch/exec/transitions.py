"""Host/device boundary and batch-coalescing operators (port of
spark_rapids_tpu/exec/transitions.py).

Reference parity: HostToDeviceExec <- HostColumnarToGpu (grouped upload),
DeviceToHostExec <- GpuColumnarToRowExec / GpuBringBackToHost (grouped
download), the CoalesceGoal algebra and the accumulate-until-target
iterator of GpuCoalesceBatches.scala:90-362.

An upload acquires the task's semaphore permit, makes room under the
device budget and runs under with_retry (site transfer.upload); the
download runs under with_retry (site transfer.download), as the reference
(:123, :160-174).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import (
    HostColumnarBatch,
    HostColumnVector,
    concat_batches,
    to_host_many,
)
from spark_rapids_tpu_torch.engine.retry import with_retry
from spark_rapids_tpu_torch.exec.base import (
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)
from spark_rapids_tpu_torch.memory.semaphore import acquire_for_task


class CoalesceGoal:
    def max_combine(self, other: "CoalesceGoal") -> "CoalesceGoal":
        a, b = self.target_bytes(), other.target_bytes()
        if a is None or b is None:
            return RequireSingleBatch()
        return TargetSize(max(a, b))

    def target_bytes(self) -> Optional[int]:
        raise NotImplementedError


class TargetSize(CoalesceGoal):
    def __init__(self, bytes_: int):
        self.bytes = bytes_

    def target_bytes(self):
        return self.bytes

    def __repr__(self):
        return f"TargetSize({self.bytes})"


class RequireSingleBatch(CoalesceGoal):
    def target_bytes(self):
        return None

    def __repr__(self):
        return "RequireSingleBatch"


class HostToDeviceExec(TpuExec):
    """Upload host batches to the session's device (grouped, pinned)."""

    def __init__(self, child: PhysicalExec):
        super().__init__(child)

    @property
    def output(self):
        return self.children[0].output

    def with_children(self, new_children):
        return HostToDeviceExec(new_children[0])

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        device = ctx.device

        def factory(pidx: int) -> Iterator:
            for hb in child_pb.iterator(pidx):
                acquire_for_task()
                ctx.spill.watermark.ensure_headroom(
                    hb.estimated_size_bytes())
                yield with_retry(lambda: hb.to_device(device),
                                 site="transfer.upload")

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


class DeviceToHostExec(PhysicalExec):
    """Download a partition's device batches with one grouped transfer."""

    placement = "cpu"

    def __init__(self, child: PhysicalExec):
        super().__init__(child)

    @property
    def output(self):
        return self.children[0].output

    def with_children(self, new_children):
        return DeviceToHostExec(new_children[0])

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)

        def factory(pidx: int) -> Iterator:
            run = list(child_pb.iterator(pidx))
            yield from with_retry(lambda: to_host_many(run),
                                  site="transfer.download")

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


def _coalesce_iter(it: Iterator, goal: CoalesceGoal, concat,
                   size_of) -> Iterator:
    """Accumulate until the target size (reference:
    AbstractGpuCoalesceIterator, GpuCoalesceBatches.scala:147-362)."""
    target = goal.target_bytes()
    pending: List = []
    pending_bytes = 0
    for b in it:
        if target is not None and pending and \
                pending_bytes + size_of(b) > target:
            yield concat(pending)
            pending, pending_bytes = [], 0
        pending.append(b)
        pending_bytes += size_of(b)
    if pending:
        yield concat(pending)


def _concat_host(batches: List[HostColumnarBatch]) -> HostColumnarBatch:
    if len(batches) == 1:
        return batches[0]
    cols = []
    for ci in range(batches[0].num_columns):
        dt = batches[0].columns[ci].dtype
        cols.append(HostColumnVector(
            dt, np.concatenate([b.columns[ci].data[:b.num_rows]
                                for b in batches]),
            np.concatenate([b.columns[ci].validity[:b.num_rows]
                            for b in batches])))
    return HostColumnarBatch(cols, sum(b.num_rows for b in batches))


class TpuCoalesceBatchesExec(TpuExec):
    """Reference: GpuCoalesceBatches exec."""

    def __init__(self, goal: CoalesceGoal, child: PhysicalExec):
        super().__init__(child)
        self.goal = goal

    @property
    def output(self):
        return self.children[0].output

    def with_children(self, new_children):
        return TpuCoalesceBatchesExec(self.goal, new_children[0])

    def node_name(self):
        return f"TpuCoalesceBatches({self.goal!r})"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        goal = self.goal
        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, _coalesce_iter(
                child_pb.iterator(p), goal, concat_batches,
                lambda b: b.device_memory_size())))


class CpuCoalesceBatchesExec(PhysicalExec):
    placement = "cpu"

    def __init__(self, goal: CoalesceGoal, child: PhysicalExec):
        super().__init__(child)
        self.goal = goal

    @property
    def output(self):
        return self.children[0].output

    def with_children(self, new_children):
        return CpuCoalesceBatchesExec(self.goal, new_children[0])

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        goal = self.goal
        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, _coalesce_iter(
                child_pb.iterator(p), goal, _concat_host,
                lambda b: b.estimated_size_bytes())))
