"""Cached (in-memory) relation execs (port of spark_rapids_tpu/exec/cache.py).

The first execution materializes each partition's batches, later executions
serve them as stored: device batches on the card for the device exec, host
batches for the CPU engine. The cache is keyed weakly by the logical
CacheRelation node, so dropping the DataFrame frees the device copies
(reference: the accelerated InMemoryTableScan, HostColumnarToGpu.scala).

Device entries are spillable (reference :101, :159-185): each batch is
registered with the session's spill framework (memory/spill.py), which may
move it to the host or to disk under the device budget, and
`get_device_batch` brings it back when the scan serves it. Each entry
keeps the framework that registered it.
"""

from __future__ import annotations

import threading
import weakref
from typing import List, Tuple

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
        dropped = _DEVICE_CACHE.pop(logical_node, None)
        _HOST_CACHE.pop(logical_node, None)
    if dropped:
        _free_buffers([e for part in dropped for e in part])


def _free_buffers(entries: List[Tuple]) -> None:
    """Free (framework, buffer) cache entries from whatever tier holds
    them (reference: _free_buffers :102)."""
    for fw, buf in entries:
        fw.free(buf)


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
            # a device entry is a (framework, SpillableBuffer) pair
            n = b[1].num_rows if isinstance(b, tuple) else b.num_rows
            if not isinstance(n, int):
                return None
            total += n
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
    """Device cache whose entries are spillable buffers (reference
    :159-185)."""

    placement = "tpu"

    def _store(self):
        return _DEVICE_CACHE

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        with _LOCK:
            cached = _DEVICE_CACHE.get(self.logical_node)
        if cached is None:
            fw = ctx.spill
            child_pb = self.children[0].execute(ctx)
            parts = [[(fw, fw.add_device_batch(b))
                      for b in child_pb.iterator(pidx) if b.num_rows != 0]
                     for pidx in range(child_pb.num_partitions)]
            with _LOCK:
                cached = _DEVICE_CACHE.setdefault(self.logical_node, parts)
                if cached is parts:
                    # free the buffers when the cache key dies
                    weakref.finalize(self.logical_node, _free_buffers,
                                     [e for part in parts for e in part])
            if cached is not parts:
                _free_buffers([e for part in parts for e in part])

        def gen(pidx: int):
            for fw, buf in cached[pidx]:
                yield fw.get_device_batch(buf)

        return PartitionedBatches(
            len(cached), lambda p: count_output(self.metrics, gen(p)))


class CpuCachedScanExec(_CachedScanBase, CpuExec):
    placement = "cpu"

    def _store(self):
        return _HOST_CACHE
