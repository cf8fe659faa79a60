"""Shuffle exchange execs, in-process tier (port of spark_rapids_tpu/shuffle/exchange.py).

The map side computes a partition id per row on the card and splits each
batch into per-target pieces that stay on the card; the reduce side streams
its pieces in map order (reference: GpuShuffleExchangeExec.scala:122-243,
with the device-resident shuffle of RapidsShuffleInternalManager promoted to
the default, as in the reference).

Two slicers (reference: the slicer at exchange.py:787-813):
- small batches (at most LAZY_PIECE_CAP_BYTES, e.g. a partial aggregate's
  output) split into zero-copy views: the same columns under a pid == target
  live mask, counts left on the card (`_device_slices_lazy`, :1337);
- larger batches are routed once: a stable grouping of row indices by
  target plus per-target counts (`route_plan`, the route half of kernel K4,
  replacing `_route_plan` :1315), one count read per batch, and the reduce
  side gathers all its slices of a bucket together (`_device_slices_routed`
  :1415, `_assemble_routed` :1433).

The hash half of K4 lives in ops/hashing.py. Left out of this slice
(ROADMAP.md): range and round-robin partitioning, the serialized tier, the
ICI/collective tier, adaptive coalescing, fetch-failure remapping, strings.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    HostColumnarBatch,
    HostColumnVector,
    bucket_capacity,
    ensure_compact,
)
from spark_rapids_tpu_torch.exec.base import (
    CpuExec,
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)
from spark_rapids_tpu_torch.exec.aggregate import LAZY_PIECE_CAP_BYTES
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.ops.base import AttributeReference, Expression
from spark_rapids_tpu_torch.ops.bind import bind_all
from spark_rapids_tpu_torch.ops.eval import (
    cpu_project,
    device_eval_context,
    eval_as_col,
    host_to_colv,
)

# routed slices of one reduce bucket assembled per gather
_ROUTED_GROUP = 16


class Partitioning:
    num_partitions: int

    def describe(self) -> str:
        return type(self).__name__


class SinglePartitioning(Partitioning):
    def __init__(self):
        self.num_partitions = 1


class HashPartitioning(Partitioning):
    def __init__(self, exprs: Sequence[Expression], num_partitions: int):
        self.exprs = list(exprs)
        self.num_partitions = num_partitions

    def describe(self):
        return f"HashPartitioning({self.exprs!r}, {self.num_partitions})"


class _ExchangeBase(PhysicalExec):
    def __init__(self, partitioning: Partitioning, child: PhysicalExec):
        super().__init__(child)
        self.partitioning = partitioning

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output

    def with_children(self, new_children):
        return type(self)(self.partitioning, new_children[0])

    @property
    def coalesce_after(self) -> bool:
        # reduce-side pieces are small; coalesce them back up (reference:
        # GpuShuffleExchangeExec coalesceAfter=true)
        return True

    def node_expressions(self):
        p = self.partitioning
        return list(p.exprs) if isinstance(p, HashPartitioning) else []

    def node_name(self):
        return f"{type(self).__name__}({self.partitioning.describe()})"

    def _materialize(self, ctx: ExecContext, map_fn) -> PartitionedBatches:
        """Run the map side over every child partition; regroup its pieces
        into reduce buckets in map order."""
        child_pb = self.children[0].execute(ctx)
        n_out = self.partitioning.num_partitions
        buckets: List[List[Any]] = [[] for _ in range(n_out)]
        for pidx in range(child_pb.num_partitions):
            for batch in child_pb.iterator(pidx):
                if isinstance(batch.num_rows, int) and batch.num_rows == 0:
                    continue
                for target, piece in map_fn(pidx, batch):
                    buckets[target].append(piece)

        def piece_gen(pidx: int):
            routed: List[_RoutedSlice] = []
            for piece in buckets[pidx]:
                if isinstance(piece, _RoutedSlice):
                    routed.append(piece)
                    if len(routed) >= _ROUTED_GROUP:
                        yield _assemble_routed(routed)
                        routed = []
                    continue
                if routed:
                    yield _assemble_routed(routed)
                    routed = []
                yield piece
            if routed:
                yield _assemble_routed(routed)

        return PartitionedBatches(
            n_out, lambda p: count_output(self.metrics, piece_gen(p)))


# ===========================================================================
# CPU exchange
# ===========================================================================
def _host_slices(batch: HostColumnarBatch, ids: np.ndarray, n: int):
    out = []
    for t in range(n):
        mask = ids == t
        if not mask.any():
            continue
        cols = [HostColumnVector(c.dtype, c.data[mask], c.validity[mask])
                for c in batch.columns]
        out.append((t, HostColumnarBatch(cols, int(mask.sum()))))
    return out


class CpuShuffleExchangeExec(_ExchangeBase, CpuExec):
    placement = "cpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        p = self.partitioning
        if isinstance(p, SinglePartitioning):
            return self._materialize(ctx, lambda pidx, b: [(0, b)])
        n = p.num_partitions
        bound = bind_all(p.exprs, self.children[0].output)

        def hash_map(pidx: int, batch: HostColumnarBatch):
            ev = cpu_project(bound, batch, partition_id=pidx)
            ids = H.host_partition_ids([host_to_colv(c) for c in ev.columns],
                                       n)
            return _host_slices(batch, ids, n)

        return self._materialize(ctx, hash_map)


# ===========================================================================
# Device exchange
# ===========================================================================
def route_plan_plain(ids, n: int):
    """(order, counts): row indices stably grouped by id, rows per id over
    n + 1 buckets (pads last)."""
    order = torch.sort(ids, stable=True).indices.to(torch.int32)
    counts = torch.bincount(ids.clamp(0, n).long(), minlength=n + 1)
    return order, counts.to(torch.int32)


def route_plan(ids, n: int):
    """K4, route half (replaces exchange.py:_route_plan): CPU tensors run
    the plain version, CUDA tensors the kernel."""
    if ids.device.type == "cpu":
        return route_plan_plain(ids, n)
    ids = ids.contiguous()
    CB.require_cuda(ids)
    lib = CB.library("hash_partition")
    if n + 1 > lib.srt_hash_max_buckets():
        raise ValueError(f"{n} partitions exceed the device route kernel's "
                         "bucket limit")
    cap = int(ids.shape[0])
    scratch = torch.empty(int(lib.srt_route_plan_scratch_bytes(cap)),
                          dtype=torch.uint8, device=ids.device)
    order = torch.empty(cap, dtype=torch.int32, device=ids.device)
    counts = torch.empty(n + 1, dtype=torch.int32, device=ids.device)
    rc = lib.srt_route_plan(ids.data_ptr(), cap, n, order.data_ptr(),
                            counts.data_ptr(), scratch.data_ptr(),
                            scratch.numel(), CB.stream_of(ids))
    CB.count_launch("route_plan")
    CB.check(lib, rc, "route_plan")
    return order, counts


def _device_slices_lazy(batch: ColumnarBatch, ids, counts, n: int):
    """Zero-copy split: each piece is the same batch under a pid == target
    live mask; no gather, no count read."""
    return [(t, ColumnarBatch(batch.columns, counts[t], live=ids == t))
            for t in range(n)]


class _RoutedSlice:
    """One target's rows of a routed map batch: order[start:start+count]
    indexes the shared source batch; the reduce side assembles a bucket's
    slices with one gather per column (reference: exchange.py:1379)."""

    __slots__ = ("batch", "order", "start", "count")

    def __init__(self, batch: ColumnarBatch, order, start: int, count: int):
        self.batch = batch
        self.order = order
        self.start = start
        self.count = count

    @property
    def num_rows(self) -> int:
        return self.count


def _device_slices_routed(batch: ColumnarBatch, ids, n: int):
    """Route once, read the n + 1 counts once, emit range views."""
    order, counts_dev = route_plan(ids, n)
    # host sync: the one counts read per routed batch (reference:
    # exchange.py:1422)
    counts = counts_dev.cpu().numpy()
    out = []
    offset = 0
    for t in range(n):
        c = int(counts[t])
        if c:
            out.append((t, _RoutedSlice(batch, order, offset, c)))
        offset += c
    return out


def _assemble_routed(slices: Sequence[_RoutedSlice]) -> ColumnarBatch:
    """Concatenate routed slices (possibly of different map batches) into
    one compact batch."""
    total = sum(s.count for s in slices)
    cap = bucket_capacity(max(total, 1))
    idxs = [s.order[s.start:s.start + s.count].long() for s in slices]
    cols = []
    for ci, c0 in enumerate(slices[0].batch.columns):
        data = torch.zeros(cap, dtype=c0.data.dtype, device=c0.data.device)
        valid = torch.zeros(cap, dtype=torch.bool, device=c0.data.device)
        off = 0
        for s, idx in zip(slices, idxs):
            col = s.batch.columns[ci]
            data[off:off + s.count] = col.data[idx]
            valid[off:off + s.count] = col.validity[idx]
            off += s.count
        cols.append(ColumnVector(c0.dtype, data, valid))
    return ColumnarBatch(cols, total)


class TpuShuffleExchangeExec(_ExchangeBase, TpuExec):
    placement = "tpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        p = self.partitioning
        if isinstance(p, SinglePartitioning):
            return self._materialize(ctx, lambda pidx, b: [(0, b)])
        n = p.num_partitions
        bound = bind_all(p.exprs, self.children[0].output)

        def hash_map(pidx: int, batch: ColumnarBatch):
            batch = ensure_compact(batch)
            ectx = device_eval_context(batch, pidx)
            keys = [eval_as_col(ectx, e) for e in bound]
            ids, counts = H.partition_ids(keys, ectx.row_mask(), n)
            if batch.device_memory_size() <= LAZY_PIECE_CAP_BYTES:
                return _device_slices_lazy(batch, ids, counts, n)
            return _device_slices_routed(batch, ids, n)

        return self._materialize(ctx, hash_map)
