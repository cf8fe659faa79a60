"""Basic physical operators (port of spark_rapids_tpu/exec/basic.py: the host
scan, project and filter; reference: basicPhysicalOperators.scala —
GpuProjectExec :34-95, GpuFilterExec :96-177)."""

from __future__ import annotations

from typing import Iterator, List, Sequence

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
from spark_rapids_tpu_torch.exec.base import (
    CpuExec,
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
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


class TpuProjectExec(TpuExec):
    def __init__(self, project_list: Sequence[Expression], child: PhysicalExec):
        super().__init__(child)
        self.project_list = list(project_list)
        self._projector = DeviceProjector(bind_all(self.project_list,
                                                   child.output))

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

        def factory(pidx: int) -> Iterator:
            for batch in child_pb.iterator(pidx):
                yield projector.project(batch, partition_id=pidx)

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
            for batch in child_pb.iterator(pidx):
                yield cpu_project(bound, batch, partition_id=pidx)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


class TpuFilterExec(TpuExec):
    def __init__(self, condition: Expression, child: PhysicalExec):
        super().__init__(child)
        self.condition = condition
        self._filter = DeviceFilter(bind_references(condition, child.output))

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

        def factory(pidx: int) -> Iterator:
            for batch in child_pb.iterator(pidx):
                yield filt.apply(batch, partition_id=pidx, sync=sync)

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
            for batch in child_pb.iterator(pidx):
                yield cpu_filter(bound, batch, partition_id=pidx)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))
