"""Physical execution layer base (port of spark_rapids_tpu/exec/base.py).

Reference parity: GpuExec.scala — `TpuExec` is the device path over
`ColumnarBatch`, `CpuExec` the numpy oracle path over `HostColumnarBatch`;
`coalesce_after` / `children_coalesce_goal` are consumed by transition
insertion (plan/transition_overrides.py).

Execution model: `PartitionedBatches` (the RDD analog) is a partition count
plus a per-partition iterator factory. Operators compose lazily, exchanges
materialize. The port runs partition tasks one after another on the
session's thread (the per-operator host-loop executor); the reference's
threaded scheduler and admission semaphore are later queue items.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.ops.base import AttributeReference

NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"


class PartitionedBatches:
    """num_partitions + per-partition batch-iterator factory."""

    __slots__ = ("num_partitions", "_factory")

    def __init__(self, num_partitions: int,
                 factory: Callable[[int], Iterator]):
        self.num_partitions = num_partitions
        self._factory = factory

    def iterator(self, pidx: int) -> Iterator:
        return self._factory(pidx)


class ExecContext:
    """Carried through execute(): the session conf, device and spill
    framework (memory/spill.py)."""

    __slots__ = ("conf", "device", "spill")

    def __init__(self, conf, device, spill):
        self.conf = conf
        self.device = device
        self.spill = spill


class PhysicalExec:
    """Base physical operator node."""

    placement: str = "tpu"

    def __init__(self, *children: "PhysicalExec"):
        self.children: Tuple[PhysicalExec, ...] = children
        self.metrics: Dict[str, int] = {NUM_OUTPUT_ROWS: 0,
                                        NUM_OUTPUT_BATCHES: 0}

    @property
    def output(self) -> List[AttributeReference]:
        raise NotImplementedError(type(self).__name__)

    @property
    def coalesce_after(self) -> bool:
        return False

    def node_expressions(self) -> List:
        return []

    @property
    def children_coalesce_goal(self) -> List[Optional[object]]:
        return [None] * len(self.children)

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        raise NotImplementedError(type(self).__name__)

    def with_children(self, new_children: Sequence["PhysicalExec"]) -> "PhysicalExec":
        raise NotImplementedError(type(self).__name__)

    def transform_up(self, fn) -> "PhysicalExec":
        new_children = [c.transform_up(fn) for c in self.children]
        node = self
        if new_children and any(a is not b for a, b in
                                zip(new_children, self.children)):
            node = self.with_children(new_children)
        return fn(node)

    def foreach(self, fn) -> None:
        fn(self)
        for c in self.children:
            c.foreach(fn)

    def collect_nodes(self, pred) -> List["PhysicalExec"]:
        out = [self] if pred(self) else []
        for c in self.children:
            out.extend(c.collect_nodes(pred))
        return out

    def node_name(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.node_name()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def __repr__(self):
        return self.node_name()


class TpuExec(PhysicalExec):
    """Device-path operator (reference: GpuExec trait). The name keeps the
    reference's, so one conf key set drives both packages."""

    placement = "tpu"


class CpuExec(PhysicalExec):
    """Host oracle-path operator (the 'stayed on CPU' fallback engine)."""

    placement = "cpu"


def rows_of(batch) -> int:
    """A batch's row count on the host (a device count is read back)."""
    host_rows = getattr(batch, "host_rows", None)
    return host_rows() if host_rows is not None else batch.num_rows


def count_output(metrics: Dict[str, int], it: Iterator) -> Iterator:
    """Count output batches, and rows whose count is on the host (a metric
    read never forces a device sync)."""
    for b in it:
        if isinstance(b.num_rows, int):
            metrics[NUM_OUTPUT_ROWS] += b.num_rows
        metrics[NUM_OUTPUT_BATCHES] += 1
        yield b
