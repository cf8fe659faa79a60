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

Range partitioning (slice 2; reference: `_execute_range` :680 on the CPU
engine, :908 on the device): every map batch is staged first. On the
device, fixed-width keys become order words on the card (the reference's
`_build_order_keys_kernel` :1260, here torch ops over the key proxies) and
download in one transfer per batch; STRING keys download their values.
The host packs each row's keys into one byte string whose order is the SQL
order, picks the n - 1 bounds from the sorted rows and bins every row with
a searchsorted; the batch then routes through K4's route half. String
pieces of both tiers are gathered by K7 (columnar/batch.py): lazy pieces
when the reduce side compacts them, routed pieces in `_assemble_routed`
(the reference's `_routed_string_plan` :1567 / `_routed_string_bytes`
:1593).

Encoded columns (columnar/encoded.py; reference :420, :470, :799-980,
:1048-1056) slice and route as fixed int32 lanes; routed slices of
different dictionaries align on assembly. A bare encoded hash key hashes
in K4's code mode, through its dictionary's word table, so its ids equal
the expanded values' ids; a computed key decodes the columns it reads. A
bare encoded range key downloads its codes, which the host maps to ranks
over the union of the dictionaries met (`union_rank_tables`), so the
bounds are taken over ranks; a position where encoded and plain pieces
meet compares the decoded values.

Round-robin partitioning (slice 15; reference :98, :652, :815-823):
`repartition(n)` sends row r of map partition pidx to (r + pidx) % n. On
the card K45 `round_robin_route` (csrc/hash_partition.cu, replacing
`_jit_rr_ids` :1141 and the `_route_plan` after it) writes the ids and the
counts and, for a batch past the lazy cap, the stable route order in the
same launch, by arithmetic instead of a sort. The routed tier's fixed
columns are assembled by K46 `assemble_routed_fixed` (csrc/compact_gather.cu,
replacing `_slice_indices` :1324 and the fixed columns of
`_assemble_routed` :1433): one launch for every fixed column of every slice
of a reduce group. An explicit partition count pins the exchange
(`allow_adaptive` False, reference :1637); nothing in the port adapts
partition counts yet.

The serialized tier (slice 17; reference :177-290, :362-481; conf
rapids.tpu.shuffle.serialize.enabled): each map batch's pieces download in
one grouped transfer (`to_host_many(..., keep_encoded=True)` under
with_retry at transfer.download), one batch behind the routing, and
serialize to TPB1 bytes (columnar/serde.py); an encoded column ships its
codes with a dictionary pruned to the codes present (code 12). The bytes
live in the session's host spill store at OUTPUT_FOR_READ, demote to disk
past its budget and are freed with their piece. Past the zero-copy cap the
slicer keeps the per-target contiguous split (one materialized piece per
target). The reduce side decodes a piece where it is served; a lost read
(an injected shuffle.fetch loss or a spilled file that cannot be read)
runs the piece's map partition again, up to `_FETCH_REMAP_ATTEMPTS` times
(`fetchRetries`), then FetchFailedError surfaces. Range exchanges do not
serialize, as in the reference.

The hash half of K4 lives in ops/hashing.py. Left out so far (ROADMAP.md):
the ICI/collective tier, adaptive coalescing.
"""

from __future__ import annotations

import bisect
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar import serde
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    HostColumnarBatch,
    HostColumnVector,
    bucket_capacity,
    ensure_compact,
    gather_string_col,
    strings_end_to_end,
    to_host_many,
)
from spark_rapids_tpu_torch.engine.retry import FetchFailedError, with_retry
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
from spark_rapids_tpu_torch.exec import rowkeys as RK
from spark_rapids_tpu_torch.ops.base import (
    AttributeReference,
    Expression,
    SortOrder,
)
from spark_rapids_tpu_torch.ops.bind import bind_all
from spark_rapids_tpu_torch.ops.eval import cpu_project, host_to_colv
from spark_rapids_tpu_torch.ops.values import ColV
from spark_rapids_tpu_torch.utils import faultinject as FI
from spark_rapids_tpu_torch.utils import metrics as M

# routed slices of one reduce bucket assembled per gather, and the most
# string bytes their source batches may hold together (a column's sources
# lie end to end under int32 offsets)
_ROUTED_GROUP = 16
_ROUTED_STRING_BYTES = 1 << 30

# in-place re-executions of a map partition for one lost serialized piece
# before FetchFailedError surfaces (reference :80)
_FETCH_REMAP_ATTEMPTS = 6


def _string_bytes(batch) -> int:
    """The largest string byte buffer of a batch's columns."""
    return max([int(c.data.shape[0]) for c in batch.columns
                if c.offsets is not None] or [0])


class Partitioning:
    num_partitions: int

    def describe(self) -> str:
        return type(self).__name__


class SinglePartitioning(Partitioning):
    def __init__(self):
        self.num_partitions = 1


class RoundRobinPartitioning(Partitioning):
    """Reference: exchange.py:98."""

    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions


class HashPartitioning(Partitioning):
    def __init__(self, exprs: Sequence[Expression], num_partitions: int):
        self.exprs = list(exprs)
        self.num_partitions = num_partitions

    def describe(self):
        return f"HashPartitioning({self.exprs!r}, {self.num_partitions})"


class RangePartitioning(Partitioning):
    """Reference: exchange.py:117."""

    def __init__(self, orders: Sequence[SortOrder], num_partitions: int):
        self.orders = list(orders)
        self.num_partitions = num_partitions

    def describe(self):
        return f"RangePartitioning({self.orders!r}, {self.num_partitions})"


class _ExchangeBase(PhysicalExec):
    def __init__(self, partitioning: Partitioning, child: PhysicalExec,
                 allow_adaptive: bool = True):
        super().__init__(child)
        self.partitioning = partitioning
        # False for an explicit repartition(n): its fan-out is the user's
        # (reference :139); carried through every rebuild
        self.allow_adaptive = allow_adaptive
        self._pre_pb: Optional[PartitionedBatches] = None

    def set_pre_executed(self, pb: PartitionedBatches) -> None:
        """Hand this exchange its already materialised input: a join's
        runtime broadcast probe ran the child (reference: exchange.py:164)."""
        self._pre_pb = pb

    def _child_pb(self, ctx: ExecContext) -> PartitionedBatches:
        """The exchange's input: a pre-executed one exactly once, else the
        child's execution, so the child never runs twice."""
        if self._pre_pb is not None:
            pb, self._pre_pb = self._pre_pb, None
            return pb
        return self.children[0].execute(ctx)

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output

    def with_children(self, new_children):
        return type(self)(self.partitioning, new_children[0],
                          self.allow_adaptive)

    @property
    def coalesce_after(self) -> bool:
        # reduce-side pieces are small; coalesce them back up (reference:
        # GpuShuffleExchangeExec coalesceAfter=true)
        return True

    def node_expressions(self):
        p = self.partitioning
        if isinstance(p, HashPartitioning):
            return list(p.exprs)
        if isinstance(p, RangePartitioning):
            return [o.child for o in p.orders]
        return []

    def node_name(self):
        return f"{type(self).__name__}({self.partitioning.describe()})"

    def _materialize(self, ctx: ExecContext, map_fn) -> PartitionedBatches:
        """Run the map side over every child partition; regroup its pieces
        into reduce buckets in map order, each with its provenance (map
        partition, index in that map's list for the target), so a lost
        serialized piece can run its map partition again."""
        child_pb = self._child_pb(ctx)
        n_out = self.partitioning.num_partitions
        serialize = ctx.conf.get(C.SHUFFLE_SERIALIZE)
        fw = ctx.spill

        def run_map(pidx: int) -> List[List[Any]]:
            buckets: List[List[Any]] = [[] for _ in range(n_out)]

            def emit(routed) -> None:
                if serialize:
                    routed = _encode_pieces_grouped(routed, fw)
                for target, piece in routed:
                    buckets[target].append(piece)

            # serialized: a batch's download and encode run after the
            # next batch's routing has been queued on the card
            prev = None
            for batch in child_pb.iterator(pidx):
                if isinstance(batch.num_rows, int) and batch.num_rows == 0:
                    continue
                routed = list(map_fn(pidx, batch))
                if not serialize:
                    emit(routed)
                    continue
                if prev is not None:
                    emit(prev)
                prev = routed
            if prev is not None:
                emit(prev)
            return buckets

        buckets: List[List[Any]] = [[] for _ in range(n_out)]
        sources: List[List[Any]] = [[] for _ in range(n_out)]
        for m in range(child_pb.num_partitions):
            for t, pieces in enumerate(run_map(m)):
                for k, piece in enumerate(pieces):
                    buckets[t].append(piece)
                    sources[t].append((m, k))
        return self._serve(n_out, buckets, (sources, run_map),
                           ctx.device if self.placement == "tpu" else None)

    def _serve(self, n_out: int, buckets, lineage=None,
               device=None) -> PartitionedBatches:
        """Reduce side: each bucket's pieces in map order, routed slices
        assembled in groups, serialized pieces decoded onto `device` (host
        batches for the CPU engine, device None), a lost one after its map
        partition ran again (lineage: (provenance, run_map))."""

        def decode_with_remap(piece: "_SerializedPiece", t: int, j: int):
            attempts = 0
            while True:
                try:
                    return piece.decode(device)
                except FetchFailedError:
                    if attempts >= _FETCH_REMAP_ATTEMPTS:
                        raise
                    attempts += 1
                    M.record_fetch_retry()
                    M.add_node_metric(self.metrics, M.FETCH_RETRIES, 1)
                    sources, run_map = lineage
                    m, k = sources[t][j]
                    fresh = run_map(m)[t]
                    if k >= len(fresh):
                        raise
                    piece = fresh[k]

        def piece_gen(pidx: int):
            routed: List[_RoutedSlice] = []
            sources: dict = {}   # id(source batch) -> its string bytes
            for j, piece in enumerate(buckets[pidx]):
                if isinstance(piece, _RoutedSlice):
                    key = id(piece.batch)
                    if key not in sources:
                        nbytes = _string_bytes(piece.batch)
                        # a column's sources lie end to end in one K7
                        # gather, whose offsets are int32
                        if routed and sum(sources.values()) + nbytes >= \
                                _ROUTED_STRING_BYTES:
                            yield _assemble_routed(routed)
                            routed, sources = [], {}
                        sources[key] = nbytes
                    routed.append(piece)
                    if len(routed) >= _ROUTED_GROUP:
                        yield _assemble_routed(routed)
                        routed, sources = [], {}
                    continue
                if routed:
                    yield _assemble_routed(routed)
                    routed, sources = [], {}
                if isinstance(piece, _SerializedPiece):
                    piece = decode_with_remap(piece, pidx, j)
                yield piece
            if routed:
                yield _assemble_routed(routed)

        return PartitionedBatches(
            n_out, lambda p: count_output(self.metrics, piece_gen(p)))


# ===========================================================================
# Serialized tier (reference :362-481)
# ===========================================================================
class _SerializedPiece:
    """One shuffle piece as TPB1 bytes (reference :362; the length-prefixed
    host stream of GpuColumnarBatchSerializer.scala:37-245): in the spill
    framework's host store when there is one (it may demote to disk), and
    freed with the piece."""

    def __init__(self, data=None, buf=None, fw=None):
        self._data = data
        self._buf = buf
        self._fw = fw

    def decode(self, device):
        """The piece as a batch on `device`, or as a host batch for the CPU
        engine (device None). A read that fails raises FetchFailedError."""
        FI.maybe_inject("shuffle.fetch")
        try:
            data = self._data if self._data is not None else \
                self._fw.read_bytes(self._buf)
        except (OSError, KeyError, RuntimeError) as e:
            raise FetchFailedError(f"shuffle piece unavailable: {e}") from e
        if device is None:
            return serde.deserialize_batch(data)
        if self._fw is not None:
            self._fw.watermark.ensure_headroom(len(data))
        return serde.deserialize_to_device(data, device)

    def __del__(self):
        if self._buf is not None and self._fw is not None:
            try:
                self._fw.free(self._buf)
            except Exception:  # noqa: BLE001 - a finalizer must not raise
                pass


def _serialize_host_piece(host: HostColumnarBatch, fw) -> _SerializedPiece:
    """TPB1 bytes of a host piece, registered in the host spill store at
    OUTPUT_FOR_READ when there is a framework (reference :426). serde's
    serialize_batch is looked up at each call."""
    from spark_rapids_tpu_torch.memory.spill import SpillPriorities

    data = serde.serialize_batch(host)
    if fw is not None:
        return _SerializedPiece(buf=fw.add_host_bytes(
            data, SpillPriorities.OUTPUT_FOR_READ), fw=fw)
    return _SerializedPiece(data=data)


def _encode_pieces_grouped(routed, fw):
    """One map batch's (target, piece) list serialized, its device pieces
    downloaded in ONE grouped transfer (reference :439). A routed slice is
    assembled into a batch of its own here, which is the per-target
    contiguous split past the zero-copy cap (reference :785-800). Encoded
    columns stay codes with their dictionary, each piece pruned to the
    codes it holds; STRING columns stay UTF-8 bytes (no Python string is
    made)."""
    dev_at, dev = [], []
    for j, (_t, piece) in enumerate(routed):
        if isinstance(piece, _RoutedSlice):
            piece = piece.to_batch()
        if isinstance(piece, ColumnarBatch):
            dev_at.append(j)
            dev.append(ensure_compact(piece))
    hosts = dict(zip(dev_at, with_retry(
        lambda: to_host_many(dev, keep_encoded=True),
        site="transfer.download"))) if dev else {}
    return [(t, _serialize_host_piece(hosts.get(j, piece), fw))
            for j, (t, piece) in enumerate(routed)]


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


# ---------------------------------------------------------------------------
# Range keys (reference: exchange.py:485-647)
# ---------------------------------------------------------------------------
def _order_key(v, o: SortOrder):
    """Sortable python key matching SQL null/NaN ordering for one column:
    (null_rank, nan_rank, value). Nulls rank 0 (first) or 2 (last); NaN is
    strictly greater than every number including +inf (reference:
    exchange.py:504)."""
    if isinstance(v, np.generic):
        v = v.item()
    if v is None:
        return (0 if o.nulls_first else 2, 0, 0)
    if isinstance(v, float) and v != v:
        return (1, 1 if o.ascending else -1, 0)
    if isinstance(v, str):
        return (1, 0, _InvertedStr(v) if not o.ascending else v)
    if isinstance(v, bool):
        v = int(v)
    return (1, 0, -v if not o.ascending else v)


class _InvertedStr:
    __slots__ = ("s",)

    def __init__(self, s):
        self.s = s

    def __lt__(self, other):
        return other.s < self.s

    def __eq__(self, other):
        return self.s == other.s

    def __le__(self, other):
        return other.s <= self.s


def _key_levels(keys, orders, widths) -> List[np.ndarray]:
    """Per key a null-rank level (u8) and a value level whose unsigned
    bytewise order is the SQL order of that key (reference:
    _fixed_key_levels_np :551, _string_key_levels_np :563). keys[i] is
    ("bits", (u64 order words, null flags)) or ("str", (offsets, bytes,
    validity))."""
    levels = []
    for (kind, payload), o, width in zip(keys, orders, widths):
        if kind == "bits":
            u, nf = payload
            if not o.ascending:
                u = ~u
            value = np.where(nf, np.uint64(0), u).astype(">u8").view(
                np.uint8).reshape(-1, 8)
        else:
            offsets, raw, valid = payload
            nf = ~valid
            rows = len(valid)
            starts = offsets[:-1].astype(np.int64)
            lens = offsets[1:].astype(np.int64) - starts
            k = np.arange(width)[None, :]
            mask = k < lens[:, None]
            value = np.zeros((rows, width), np.uint8)
            value[mask] = raw[(starts[:, None] + k)[mask]]
            if not o.ascending:
                value = ~value
            value[nf] = 0
        levels.append(np.where(nf, np.uint8(0 if o.nulls_first else 2),
                               np.uint8(1))[:, None])
        levels.append(value)
    return levels


def _pack_key_rows(levels: List[np.ndarray]) -> np.ndarray:
    """Concatenate per-key levels into one 'S{w}' column whose bytewise
    comparison is the composite lexicographic order (reference:
    exchange.py:580)."""
    m = np.ascontiguousarray(np.concatenate(levels, axis=1))
    return m.view(f"S{m.shape[1]}").ravel()


def _packed_bounds(packed_all: np.ndarray, n: int) -> Optional[np.ndarray]:
    """n - 1 split points over all packed rows (reference:
    exchange.py:635; the full sort is vectorised and exact)."""
    cnt = packed_all.shape[0]
    if cnt == 0:
        return None
    s = np.sort(packed_all)
    return s[[min(cnt - 1, (b * cnt) // n) for b in range(1, n)]]


def _sample_bounds_host(key_cols: List[np.ndarray], orders: List[SortOrder],
                        n_parts: int):
    """Range bounds from the key rows of the CPU engine: rows of raw key
    values at the n_parts - 1 split points (reference: exchange.py:485)."""
    if not key_cols or len(key_cols[0]) == 0:
        return None
    n = len(key_cols[0])
    decorated = [
        (tuple(_order_key(c[i], o) for c, o in zip(key_cols, orders)), i)
        for i in range(n)
    ]
    decorated.sort(key=lambda t: t[0])
    order_idx = [i for _, i in decorated]
    bounds_rows = [order_idx[min(n - 1, (b * n) // n_parts)]
                   for b in range(1, n_parts)]
    return [tuple(c[i] for c in key_cols) for i in bounds_rows]


def _range_ids_host(key_cols: List[List[Any]], bounds, orders) -> np.ndarray:
    """Reference: exchange.py:732."""
    nrows = len(key_cols[0]) if key_cols else 0
    ids = np.zeros(nrows, dtype=np.int32)
    if bounds is None:
        return ids
    bound_keys = [tuple(_order_key(v, o) for v, o in zip(b, orders))
                  for b in bounds]
    for i in range(nrows):
        row = tuple(_order_key(kc[i], o) for kc, o in zip(key_cols, orders))
        ids[i] = bisect.bisect_right(bound_keys, row)
    return ids


class CpuShuffleExchangeExec(_ExchangeBase, CpuExec):
    placement = "cpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        p = self.partitioning
        if isinstance(p, SinglePartitioning):
            return self._materialize(ctx, lambda pidx, b: [(0, b)])
        if isinstance(p, RangePartitioning):
            return self._execute_range(ctx, p)
        n = p.num_partitions
        if isinstance(p, RoundRobinPartitioning):
            def rr_map(pidx: int, batch: HostColumnarBatch):
                ids = (np.arange(batch.num_rows) + pidx) % n
                return _host_slices(batch, ids, n)
            return self._materialize(ctx, rr_map)
        bound = bind_all(p.exprs, self.children[0].output)

        def hash_map(pidx: int, batch: HostColumnarBatch):
            ev = cpu_project(bound, batch, partition_id=pidx)
            ids = H.host_partition_ids([host_to_colv(c) for c in ev.columns],
                                       n)
            return _host_slices(batch, ids, n)

        return self._materialize(ctx, hash_map)

    def _execute_range(self, ctx: ExecContext,
                       p: RangePartitioning) -> PartitionedBatches:
        """Reference: exchange.py:680 — python order keys, sampled bounds,
        a bisect per row."""
        child_pb = self._child_pb(ctx)
        bound = bind_all([o.child for o in p.orders], self.children[0].output)
        n = p.num_partitions
        staged = []
        for pidx in range(child_pb.num_partitions):
            for batch in child_pb.iterator(pidx):
                if batch.num_rows == 0:
                    continue
                ev = cpu_project(bound, batch, partition_id=pidx)
                staged.append((batch, [c.to_pylist() for c in ev.columns]))
        all_keys: List[List[Any]] = [[] for _ in p.orders]
        for _, keys in staged:
            for i, k in enumerate(keys):
                all_keys[i].extend(k)
        bounds = _sample_bounds_host(
            [np.array(k, dtype=object) for k in all_keys], p.orders, n)
        buckets: List[List[Any]] = [[] for _ in range(n)]
        for batch, keys in staged:
            ids = _range_ids_host(keys, bounds, p.orders)
            for t, piece in _host_slices(batch, ids, n):
                buckets[t].append(piece)
        return self._serve(n, buckets)


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
    cap = int(ids.shape[0])
    scratch = torch.empty(int(lib.srt_route_plan_scratch_bytes(cap, n)),
                          dtype=torch.uint8, device=ids.device)
    order = torch.empty(cap, dtype=torch.int32, device=ids.device)
    counts = torch.empty(n + 1, dtype=torch.int32, device=ids.device)
    rc = lib.srt_route_plan(ids.data_ptr(), cap, n, order.data_ptr(),
                            counts.data_ptr(), scratch.data_ptr(),
                            scratch.numel(), CB.stream_of(ids))
    CB.count_launch("route_plan")
    CB.check(lib, rc, "route_plan")
    return order, counts


def rr_ids_plain(pidx: int, num_rows, capacity: int, n: int, device):
    """Round-robin ids (reference: exchange.py:_jit_rr_ids): (r + pidx) % n
    for the live rows r < num_rows, n for the pads."""
    lane = torch.arange(capacity, dtype=torch.int64, device=device)
    ids = (lane + pidx) % n
    return torch.where(lane < num_rows, ids,
                       torch.full((), n, dtype=torch.int64,
                                  device=device)).to(torch.int32)


def round_robin_route_plain(pidx: int, num_rows, capacity: int, n: int,
                            device, route: bool = True):
    """(ids, order or None, counts [n + 1]): the ids, then the route plan
    of them (exchange.py:_jit_rr_ids, then _route_plan)."""
    ids = rr_ids_plain(pidx, num_rows, capacity, n, device)
    order, counts = route_plan_plain(ids, n)
    return ids, (order if route else None), counts


def round_robin_route(pidx: int, num_rows, capacity: int, n: int, device,
                      route: bool = True):
    """K45: round_robin_route_plain's outputs in one launch; num_rows is an
    int or a 0-dim int32 tensor on the card (read there, no sync). A CPU
    device runs the plain version, a CUDA device the kernel."""
    device = torch.device(device)
    if device.type == "cpu":
        return round_robin_route_plain(pidx, num_rows, capacity, n, device,
                                       route)
    rows_dev = None
    rows_host = 0
    if isinstance(num_rows, torch.Tensor):
        rows_dev = num_rows.reshape(()).to(torch.int32)
        CB.require_cuda(rows_dev)
    else:
        rows_host = int(num_rows)
    ids = torch.empty(capacity, dtype=torch.int32, device=device)
    order = torch.empty(capacity, dtype=torch.int32, device=device) \
        if route else None
    counts = torch.empty(n + 1, dtype=torch.int32, device=device)
    lib = CB.library("hash_partition")
    rc = lib.srt_round_robin_route(
        capacity, int(pidx), n, rows_host,
        rows_dev.data_ptr() if rows_dev is not None else None,
        ids.data_ptr(), order.data_ptr() if route else None,
        counts.data_ptr(), CB.stream_of(ids))
    CB.count_launch("round_robin_route")
    CB.check(lib, rc, "round_robin_route")
    return ids, order, counts


def _device_slices_lazy(batch: ColumnarBatch, ids, counts, n: int):
    """Zero-copy split: each piece is the same batch under a pid == target
    live mask; no gather, no count read."""
    return [(t, ColumnarBatch(batch.columns, counts[t], live=ids == t))
            for t in range(n)]


def _piece_bytes(piece) -> int:
    """Device or host bytes of one batch (reference: exchange.py:348); a
    zero-copy live-masked view counts 0 (its source is counted where it is
    owned)."""
    if isinstance(piece, ColumnarBatch):
        return 0 if piece.live is not None else piece.device_memory_size()
    return piece.estimated_size_bytes()


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

    def to_batch(self) -> ColumnarBatch:
        """The slice's rows as a compact batch of their own."""
        return _assemble_routed([self])


def _device_slices_routed(batch: ColumnarBatch, ids, n: int):
    """Route once, read the n + 1 counts once, emit range views."""
    return _routed_views(batch, *route_plan(ids, n), n)


def _routed_views(batch: ColumnarBatch, order, counts_dev, n: int):
    """One target's range of the route order per non-empty target."""
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


def assemble_routed_fixed_plain(slices, columns, cap_out: int):
    """[(data, validity) [cap_out]] per column: slice p's rows
    order[start:start + count] of its own sources, laid end to end; data 0
    where the row is NULL, lanes past the rows zero and invalid
    (reference: _slice_indices :1324 with _assemble_routed :1433).
    slices: [(order, start, count)]; columns: per column, per slice its
    source (data, validity)."""
    outs = []
    for per_slice in columns:
        d0, _ = per_slice[0]
        data = torch.zeros(cap_out, dtype=d0.dtype, device=d0.device)
        valid = torch.zeros(cap_out, dtype=torch.bool, device=d0.device)
        off = 0
        for (order, start, count), (d, v) in zip(slices, per_slice):
            idx = order[start:start + count].long()
            valid[off:off + count] = v[idx]
            data[off:off + count] = d[idx]
            off += count
        outs.append((torch.where(valid, data, torch.zeros(
            (), dtype=data.dtype, device=data.device)), valid))
    return outs


def assemble_routed_fixed(slices, columns, cap_out: int):
    """K46: assemble_routed_fixed_plain's outputs for every column in one
    launch. CPU tensors run the plain version, CUDA tensors the kernel."""
    if not columns or slices[0][0].device.type == "cpu":
        return assemble_routed_fixed_plain(slices, columns, cap_out)
    from spark_rapids_tpu_torch.columnar.batch import _device_words

    orders = [o.contiguous() for o, _, _ in slices]
    datas = [[d.contiguous() for d, _ in per] for per in columns]
    valids = [[v.contiguous() for _, v in per] for per in columns]
    CB.require_cuda(*orders, *[t for per in datas + valids for t in per])
    dev = orders[0].device
    out_at = [0]
    for _, _, count in slices:
        out_at.append(out_at[-1] + int(count))
    n_p, n_c = len(slices), len(columns)
    out_d = [torch.empty(cap_out, dtype=per[0].dtype, device=dev)
             for per in datas]
    out_v = [torch.empty(cap_out, dtype=torch.bool, device=dev)
             for _ in columns]
    table = _device_words(
        out_at + [o.data_ptr() for o in orders]
        + [int(st) for _, st, _ in slices]
        + [datas[c][p].data_ptr() for p in range(n_p) for c in range(n_c)]
        + [valids[c][p].data_ptr() for p in range(n_p) for c in range(n_c)]
        + [o.data_ptr() for o in out_d] + [o.data_ptr() for o in out_v]
        + [per[0].element_size() for per in datas], dev)
    lib = CB.library("compact_gather")
    rc = lib.srt_assemble_routed_fixed(table.data_ptr(), n_p, n_c, cap_out,
                                       CB.stream_of(table))
    CB.count_launch("assemble_routed_fixed")
    CB.check(lib, rc, "assemble_routed_fixed")
    return list(zip(out_d, out_v))


def _assemble_routed(slices: Sequence[_RoutedSlice]) -> ColumnarBatch:
    """Concatenate routed slices (possibly of different map batches) into
    one compact batch. Every fixed column goes through one K46 launch; a
    string column is one K7 gather over the slices' source columns laid
    end to end (reference: `_routed_string_plan` :1567 and
    `_routed_string_bytes` :1593)."""
    total = sum(s.count for s in slices)
    cap = bucket_capacity(max(total, 1))
    sources: List[ColumnarBatch] = []
    for s in slices:
        if all(s.batch is not b for b in sources):
            sources.append(s.batch)
    aligned = _aligned_source_columns(sources)
    cols: List[Any] = []
    fixed: List[int] = []
    for ci in range(len(sources[0].columns)):
        c0 = aligned[id(sources[0])][ci]
        if c0.offsets is not None:
            src, bases = strings_end_to_end([aligned[id(b)][ci]
                                             for b in sources])
            at = {id(b): base for b, base in zip(sources, bases)}
            idx = torch.zeros(cap, dtype=torch.int32, device=c0.data.device)
            off = 0
            for s in slices:
                idx[off:off + s.count] = \
                    s.order[s.start:s.start + s.count] + at[id(s.batch)]
                off += s.count
            cols.append(gather_string_col(src, idx, total, unique=True))
            continue
        fixed.append(ci)
        cols.append(None)
    if fixed:
        outs = assemble_routed_fixed(
            [(s.order, s.start, s.count) for s in slices],
            [[(aligned[id(s.batch)][ci].data,
               aligned[id(s.batch)][ci].validity) for s in slices]
             for ci in fixed], cap)
        for ci, (data, valid) in zip(fixed, outs):
            cols[ci] = aligned[id(sources[0])][ci].with_data(data, valid)
    return ColumnarBatch(cols, total)


def _aligned_source_columns(sources: Sequence[ColumnarBatch]):
    """{id(batch): columns} of the routed sources with each encoded
    position on one dictionary (or decoded where encoded and plain
    sources meet)."""
    if len(sources) == 1:
        return {id(sources[0]): sources[0].columns}
    from spark_rapids_tpu_torch.columnar.batch import _align_encoded_pieces

    return {id(b): a.columns for b, a in
            zip(sources, _align_encoded_pieces(sources))}


def _order_bits(c: ColV, n: int):
    """(u64 order words, null flags) of a fixed-width key, as int64."""
    proxy = RK.key_proxy(c)
    words = proxy.arrays
    u = words[0] if len(words) == 1 else (words[0] << 32) | words[1]
    return u[:n], proxy.null_flag[:n].to(torch.int64)


def _device_order_keys(batch: ColumnarBatch, bound, pidx: int):
    """Host range keys of one device batch: fixed-width keys as unsigned
    64-bit order words with null flags, computed on the card and downloaded
    in one transfer (a bare encoded key's codes and validity ride in the
    same transfer: ("codes", (codes, validity, dictionary))); STRING keys
    as their downloaded (offsets, bytes, validity), and their widest byte
    length."""
    n = batch.host_rows()
    cols = E.key_columns(batch, bound, pidx)
    fixed = []
    for c in cols:
        if E.is_encoded(c):
            fixed += [c.data[:n].to(torch.int64),
                      c.validity[:n].to(torch.int64)]
        elif not c.is_string:
            fixed += list(_order_bits(c, n))
    got = iter(torch.stack(fixed).cpu().numpy()) if fixed else iter(())
    keys, widths = [], []
    for c in cols:
        if E.is_encoded(c):
            codes = next(got)
            keys.append(("codes", (codes, next(got).astype(bool),
                                   c.dictionary)))
            widths.append(1)
        elif c.is_string:
            offsets = c.offsets[:n + 1].cpu().numpy()
            keys.append(("str", (offsets, c.data.cpu().numpy(),
                                 c.validity[:n].cpu().numpy())))
            widths.append(int(np.diff(offsets).max()))
        else:
            u = next(got).view(np.uint64)
            keys.append(("bits", (u, next(got).astype(bool))))
            widths.append(1)
    return keys, widths


def _resolve_code_keys(staged, n_keys: int) -> None:
    """Replace each staged ("codes", ...) range key in place: by its ranks
    over the union of the position's dictionaries, as order bits, when
    every piece of the position is encoded; by its decoded values where
    encoded and plain pieces meet."""
    for k in range(n_keys):
        entries = [keys[k] for _, keys, _ in staged]
        coded = [e for e in entries if e[0] == "codes"]
        if not coded:
            continue
        if len(coded) == len(entries):
            ranks = E.union_rank_tables([e[1][2] for e in coded])
        for _, keys, widths in staged:
            kind, payload = keys[k]
            if kind != "codes":
                continue
            codes, valid, d = payload
            if len(coded) == len(entries):
                table = ranks[d.did]
                r = table[np.clip(codes, 0, max(len(table) - 1, 0))] \
                    if len(table) else np.zeros(len(codes), np.int32)
                u = np.where(valid, r.astype(np.int64), 0).view(np.uint64)
                keys[k] = ("bits", (u, ~valid))
                continue
            values = E.materialize_host_values(codes, valid, d)
            if d.is_fixed:
                c = ColV(d.value_dtype, torch.from_numpy(values),
                         torch.from_numpy(valid))
                u, nf = (t.numpy() for t in _order_bits(c, len(codes)))
                keys[k] = ("bits", (u.view(np.uint64), nf.astype(bool)))
            else:
                from spark_rapids_tpu_torch.columnar.strings import (
                    encode_utf8,
                )

                offsets, raw = encode_utf8(values, valid)
                keys[k] = ("str", (offsets, raw, valid))
                widths[k] = int(np.diff(offsets).max()) if len(codes) else 1


class TpuShuffleExchangeExec(_ExchangeBase, TpuExec):
    placement = "tpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        p = self.partitioning
        if isinstance(p, SinglePartitioning):
            return self._materialize(ctx, lambda pidx, b: [(0, b)])
        if isinstance(p, RangePartitioning):
            return self._execute_range(ctx)
        n = p.num_partitions
        if isinstance(p, RoundRobinPartitioning):
            def rr_map(pidx: int, batch: ColumnarBatch):
                # the slicer as for a hash exchange: zero-copy views under
                # the cap, else K45's route order in the same launch
                batch = ensure_compact(batch)
                lazy = batch.device_memory_size() <= LAZY_PIECE_CAP_BYTES
                ids, order, counts = round_robin_route(
                    pidx, batch.num_rows, batch.capacity, n, batch.device,
                    route=not lazy)
                if lazy:
                    return _device_slices_lazy(batch, ids, counts, n)
                return _routed_views(batch, order, counts, n)
            return self._materialize(ctx, rr_map)
        bound = bind_all(p.exprs, self.children[0].output)

        def hash_map(pidx: int, batch: ColumnarBatch):
            batch = ensure_compact(batch)
            keys = [E.code_key(c) if E.is_encoded(c) else c
                    for c in E.key_columns(batch, bound, pidx)]
            ids, counts = H.partition_ids(keys, batch.live_mask(), n)
            if batch.device_memory_size() <= LAZY_PIECE_CAP_BYTES:
                return _device_slices_lazy(batch, ids, counts, n)
            return _device_slices_routed(batch, ids, n)

        return self._materialize(ctx, hash_map)

    def _execute_range(self, ctx: ExecContext) -> PartitionedBatches:
        """Reference: exchange.py:908 — stage every map batch with its host
        range keys, pick the bounds over all rows, bin each batch's rows
        and route them with K4."""
        p = self.partitioning
        n = p.num_partitions
        child_pb = self._child_pb(ctx)
        bound = bind_all([o.child for o in p.orders],
                         self.children[0].output)
        staged = []
        for pidx in range(child_pb.num_partitions):
            for batch in child_pb.iterator(pidx):
                batch = ensure_compact(batch)
                if batch.host_rows() == 0:
                    continue
                staged.append((batch, *_device_order_keys(batch, bound,
                                                          pidx)))
        _resolve_code_keys(staged, len(p.orders))
        # one byte width per string key across all batches, so every
        # packed row compares in the same space
        widths = [max([w[i] for _, _, w in staged] or [1])
                  for i in range(len(p.orders))]
        packed = [_pack_key_rows(_key_levels(keys, p.orders, widths))
                  for _, keys, _ in staged]
        bounds = _packed_bounds(np.concatenate(packed) if packed else
                                np.empty((0,), dtype="S1"), n)
        buckets: List[List[Any]] = [[] for _ in range(n)]
        for (batch, _, _), rows in zip(staged, packed):
            lanes = np.full(batch.capacity, n, dtype=np.int32)
            lanes[:len(rows)] = 0 if bounds is None else \
                np.searchsorted(bounds, rows, side="right")
            ids = torch.from_numpy(lanes).to(batch.device)
            for target, piece in _device_slices_routed(batch, ids, n):
                buckets[target].append(piece)
        return self._serve(n, buckets)


def plan_repartition_exchange(plan, child: PhysicalExec,
                              conf) -> PhysicalExec:
    """The exchange of repartition(n[, cols]) (reference: exchange.py:1637):
    hash on the columns, round robin without them; an explicit count is
    never adaptively merged."""
    n = plan.num_partitions or conf.shuffle_partitions
    if plan.partition_exprs:
        part = HashPartitioning(plan.partition_exprs, n)
    else:
        part = RoundRobinPartitioning(n)
    ex = CpuShuffleExchangeExec(part, child)
    if plan.num_partitions is not None:
        ex.allow_adaptive = False
    return ex
