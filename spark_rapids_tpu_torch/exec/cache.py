"""Cached (in-memory) relation execs (port of spark_rapids_tpu/exec/cache.py).

The first execution materializes each partition's batches, later executions
serve them as stored: device batches on the card for the device exec, host
batches for the CPU engine. The cache is keyed weakly by the logical
CacheRelation node, so dropping the DataFrame frees the device copies
(reference: the accelerated InMemoryTableScan, HostColumnarToGpu.scala).
"""

from __future__ import annotations

import threading
import weakref
from typing import List

from spark_rapids_tpu_torch.exec.base import (
    CpuExec,
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)
from spark_rapids_tpu_torch.ops.base import AttributeReference

_LOCK = threading.Lock()
_DEVICE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_HOST_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def invalidate(logical_node) -> None:
    with _LOCK:
        _DEVICE_CACHE.pop(logical_node, None)
        _HOST_CACHE.pop(logical_node, None)


def cached_row_count(logical_node):
    """Rows of a cached relation once materialised, else None (the
    planner's statistics: reference exec/cache.py:37). A device row count
    not yet read back gives None rather than a sync."""
    with _LOCK:
        parts = _DEVICE_CACHE.get(logical_node)
        if parts is None:
            parts = _HOST_CACHE.get(logical_node)
    if parts is None:
        return None
    total = 0
    for part in parts:
        for b in part:
            if not isinstance(b.num_rows, int):
                return None
            total += b.num_rows
    return total


class _CachedScanBase(PhysicalExec):
    def __init__(self, logical_node, child: PhysicalExec):
        super().__init__(child)
        self.logical_node = logical_node

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output

    def with_children(self, new_children):
        return type(self)(self.logical_node, new_children[0])

    def _store(self):
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        store = self._store()
        with _LOCK:
            cached = store.get(self.logical_node)
        if cached is None:
            child_pb = self.children[0].execute(ctx)
            parts = []
            for pidx in range(child_pb.num_partitions):
                parts.append([b for b in child_pb.iterator(pidx)
                              if b.num_rows != 0])
            with _LOCK:
                cached = store.setdefault(self.logical_node, parts)
        return PartitionedBatches(
            len(cached), lambda p: count_output(self.metrics, iter(cached[p])))


class TpuCachedScanExec(_CachedScanBase, TpuExec):
    placement = "tpu"

    def _store(self):
        return _DEVICE_CACHE


class CpuCachedScanExec(_CachedScanBase, CpuExec):
    placement = "cpu"

    def _store(self):
        return _HOST_CACHE
