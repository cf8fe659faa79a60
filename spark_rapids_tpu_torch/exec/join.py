"""Hash equi-join execs (port of spark_rapids_tpu/exec/join.py; reference:
GpuHashJoin.scala, GpuShuffledHashJoinExec.scala,
GpuBroadcastHashJoinExec.scala).

- `_JoinBase` (:90): keys, join type, residual condition, build side (the
  right child, the left for RIGHT OUTER, or the side a runtime swap picks).
- `TpuShuffledHashJoinExec` (:707): both inputs hash-exchanged on their
  keys, the build side of each partition coalesced to one batch; before
  it shuffles, `runtime_broadcast_probe` (:609) materialises the build
  input and demotes the join to a broadcast when it fits
  autoBroadcastJoinThreshold (an INNER join may swap its build side).
- `TpuBroadcastHashJoinExec` (:754): the build side collected once and
  shared by every stream partition.
- The CPU engine (`CpuShuffledHashJoinExec` :877, `CpuBroadcastHashJoinExec`
  :1013): the same semantics in numpy, vectorised (keys factorised with
  np.unique, matches expanded with np.repeat).

The device join is three hand-written CUDA kernels (csrc/hash_join.cu)
that replace the reference's `union_key_proxies` (:150), `traced_join_plan`
(:172) and `_expand_full` (:554):

- K9 `join_build` builds an open-addressing hash table over the build
  rows' key proxy words once per build side (once per query for a
  broadcast, once per partition for a shuffled join), with per-slot counts
  and starts; K1 sorts the build rows by slot (stable) into the build order;
- K10 `join_probe` looks each stream row up: match count, start, output
  rows by join mode, output offsets (scan), matched build slots;
- K11 `join_expand` writes each stream row's (stream index, build index)
  pairs at its offset, -1 for an unmatched outer row.

Keys are the B1 proxy words of exec/rowkeys.py (`key_proxy`), so equality
is the reference's: -0.0 equals 0.0, NaN equals NaN, and STRING keys
compare as their K5 words (h1, h2, length). Rows with a NULL key never
match. The plain versions (CPU tensors, and the card reference of
chip_smoke.py) run the reference's union plan in torch: dense group ids
over the union of both sides, a stable argsort of the build side by group,
counts, a cumsum and the expansion. Both give the same offsets, stream and
build indices and build-matched flags, bit for bit.

Dictionary-key joins (slice 8; reference :328-427, columnar/encoded.py): a
key position whose build and stream keys are both bare encoded columns
compares int32 codes: the build side keeps its codes, each stream batch's
codes remap into the build dictionary through K24 with fill -1, so a
value the build side lacks matches nothing. A position encoded on one side
only, or a key expression over an encoded column, compares values (the
column decodes for the key alone). A build side keeps one K9 table per
mix of code and value positions its stream batches need; a FULL OUTER
join compares values everywhere, so its one table tracks the matched
build rows. Pass-through encoded columns stay encoded in the emit.

Per stream batch there is one host sync, the read of the output row count
(reference :457), which sizes the gathers; the reference's depth-1
pipeline (:483-520) is not kept: the count is read right after the probe.
The probe and the emit of each stream batch run under
engine/retry.with_retry (site join, as reference :495-518): both are pure
over (stream batch, build side), so a CUDA OOM spills and runs them
again; the build side is device state, so nothing bisects.
Waiting for later queue items: the serialized broadcast (:783-792), the
coordinated
adaptive coalescing of both inputs (`coalesce_join_inputs` :681; the port
reads adaptive coalescing as off, so a shuffled join takes its inputs as
the exchanges give them).

The nested-loop join (`TpuNestedLoopJoinExec` :803, `CpuNestedLoopJoinExec`
:1017) runs CROSS joins and INNER joins without equi keys: a product of
index gathers and a filter, no kernel of its own.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    HostColumnarBatch,
    HostColumnVector,
    bucket_capacity,
    concat_batches,
    ensure_compact,
    gather_batch,
)
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
    rows_of,
)
from spark_rapids_tpu_torch.exec.transitions import RequireSingleBatch
from spark_rapids_tpu_torch.ops.base import AttributeReference, Expression
from spark_rapids_tpu_torch.ops.bind import bind_all, bind_references
from spark_rapids_tpu_torch.ops.eval import (
    DeviceFilter,
    col_to_colv,
    cpu_filter,
    cpu_project,
)
from spark_rapids_tpu_torch.ops.values import ColV
from spark_rapids_tpu_torch.plan.logical import JoinType, join_output

RUNTIME_BROADCASTS = "runtimeBroadcastJoins"
_MODES = {"inner": 0, "outer": 1, "semi": 2, "anti": 3}
_I32_MAX = (1 << 31) - 1


class _JoinBase(PhysicalExec):
    """Equi-join base. The build side is the right child except for RIGHT
    OUTER (which builds left and streams right, keeping the stream side's
    rows), or the side a runtime broadcast swap chose."""

    def __init__(self, left_keys: List[Expression],
                 right_keys: List[Expression], join_type: JoinType,
                 condition: Optional[Expression],
                 left: PhysicalExec, right: PhysicalExec):
        super().__init__(left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.condition = condition
        self.metrics[RUNTIME_BROADCASTS] = 0
        # set by runtime_broadcast_probe when an INNER join swaps its build
        # side because the planned one exceeded the broadcast threshold
        self._runtime_build_left: Optional[bool] = None

    @property
    def build_left(self) -> bool:
        if self._runtime_build_left is not None:
            return self._runtime_build_left
        return self.join_type is JoinType.RIGHT_OUTER

    @property
    def output(self) -> List[AttributeReference]:
        return join_output(self.join_type, self.children[0].output,
                           self.children[1].output)

    def node_expressions(self):
        out = list(self.left_keys) + list(self.right_keys)
        if self.condition is not None:
            out.append(self.condition)
        return out

    def with_children(self, new_children):
        return type(self)(self.left_keys, self.right_keys, self.join_type,
                          self.condition, *new_children)

    def node_name(self):
        return (f"{type(self).__name__}({self.join_type.value}, "
                f"keys={len(self.left_keys)})")

    @property
    def _stream_mode(self) -> str:
        """OUTER keeps the unmatched stream rows."""
        jt = self.join_type
        if jt is JoinType.INNER:
            return "inner"
        if jt in (JoinType.LEFT_OUTER, JoinType.RIGHT_OUTER,
                  JoinType.FULL_OUTER):
            return "outer"
        if jt is JoinType.LEFT_SEMI:
            return "semi"
        return "anti"

    def _sides(self):
        """(stream child, build child, stream keys, build keys)."""
        if self.build_left:
            return 1, 0, self.right_keys, self.left_keys
        return 0, 1, self.left_keys, self.right_keys

    def _joined_attrs(self) -> List[AttributeReference]:
        return self.children[0].output + self.children[1].output


# ===========================================================================
# K9-K11: the hash join kernels and their plain versions
# ===========================================================================
def join_words(cols, live):
    """(key words int64 [W, cap] with values in [0, 2^32), ok bool [cap])
    of evaluated key columns: the B1 proxy words of every key, and the
    rows that may match (live, no NULL key)."""
    proxies = [RK.key_proxy(c) for c in cols]
    words = torch.stack([w for p in proxies for w in p.arrays])
    ok = live.clone()
    for p in proxies:
        ok &= ~p.null_flag
    return words, ok


class JoinTable:
    """One build side, ready to probe. On the card: K9's table, slots,
    counts and starts, K1's build order and the matched slots of every
    probe so far. On the CPU: the words and flags the plain union plan
    needs, and the matched build rows so far."""

    __slots__ = ("words", "ok", "table", "slot_of", "counts", "starts",
                 "b_order", "slot_matched", "matched")

    def __init__(self, words, ok):
        self.words = words
        self.ok = ok
        self.table = self.slot_of = self.counts = self.starts = None
        self.b_order = self.slot_matched = self.matched = None


class JoinProbe(NamedTuple):
    """One stream batch probed: offsets int32 [s_cap + 1], total (host
    int), match count and start per stream row (int32), and the build order
    the starts index."""

    offsets: torch.Tensor
    total: int
    match_cnt: torch.Tensor
    start: torch.Tensor
    b_order: torch.Tensor


def join_build(words, ok) -> JoinTable:
    """K9: the hash table of a build side (int64 words [W, b_cap], ok bool
    [b_cap]). CPU tensors keep the inputs for the plain plan; CUDA tensors
    launch K9, then K1 orders the build rows by slot."""
    t = JoinTable(words, ok)
    if ok.device.type == "cpu":
        t.matched = torch.zeros_like(ok)
        return t
    w32 = RK._u32_to_i32(words).contiguous()
    ok = ok.contiguous()
    CB.require_cuda(w32, ok)
    n_words, n = int(w32.shape[0]), int(w32.shape[1])
    size = max(16, 1 << (2 * n - 1).bit_length())  # power of two >= 2n
    dev = ok.device
    lib = CB.library("hash_join")
    scratch = torch.empty(int(lib.srt_join_build_scratch_bytes(size)),
                          dtype=torch.uint8, device=dev)
    t.words = w32
    t.table = torch.empty(size, dtype=torch.int32, device=dev)
    t.slot_of = torch.empty(n, dtype=torch.int32, device=dev)
    t.counts = torch.empty(size, dtype=torch.int32, device=dev)
    t.starts = torch.empty(size, dtype=torch.int32, device=dev)
    t.slot_matched = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    rc = lib.srt_join_build(
        w32.data_ptr(), n_words, n, ok.data_ptr(), size, t.table.data_ptr(),
        t.slot_of.data_ptr(), t.counts.data_ptr(), t.starts.data_ptr(),
        scratch.data_ptr(), scratch.numel(), CB.stream_of(ok))
    CB.count_launch("join_build")
    CB.check(lib, rc, "join_build")
    t.b_order = RK.radix_sort_pairs(t.slot_of.long()[None, :])
    return t


def join_plan_plain(s_words, s_live, s_ok, b_words, b_ok, mode: str):
    """The reference's traced_join_plan over the union of both sides
    (stream rows at [0, s_cap), build rows after): (offsets, total, b_order,
    start, match_cnt, b_matched)."""
    s_cap, b_cap = int(s_ok.shape[0]), int(b_ok.shape[0])
    cap = s_cap + b_cap
    dev = s_ok.device
    valid = torch.cat([s_ok, b_ok])
    words = torch.cat([(~valid).to(torch.int64)[None, :],
                       torch.cat([s_words, b_words], dim=1)])
    order = RK.radix_sort_pairs_plain(words)
    gid = RK.group_ids_plain(words, order, valid)[0].long()
    s_gid, b_gid = gid[:s_cap], gid[s_cap:]
    capt = torch.full((), cap, dtype=torch.int64, device=dev)
    b_key = torch.where(b_ok, b_gid, capt)
    b_order = torch.sort(b_key, stable=True).indices.to(torch.int32)
    b_cnt = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    b_cnt.index_add_(0, b_key, torch.ones(b_cap, dtype=torch.int32,
                                          device=dev))
    b_cnt = b_cnt[:cap]
    b_start = torch.cumsum(b_cnt, 0, dtype=torch.int32) - b_cnt
    s_safe = torch.where(s_ok, s_gid, capt - 1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    match_cnt = torch.where(s_ok, b_cnt[s_safe], zero)
    if mode == "inner":
        out_cnt = torch.where(s_live, match_cnt, zero)
    elif mode == "outer":
        out_cnt = torch.where(s_live, match_cnt.clamp(min=1), zero)
    elif mode == "semi":
        out_cnt = (s_live & (match_cnt > 0)).to(torch.int32)
    else:
        out_cnt = (s_live & (match_cnt == 0)).to(torch.int32)
    offsets = torch.zeros(s_cap + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(out_cnt, 0)
    total = int(offsets[-1])
    s_cnt = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    s_cnt.index_add_(0, torch.where(s_ok, s_gid, capt),
                     torch.ones(s_cap, dtype=torch.int32, device=dev))
    b_matched = b_ok & (s_cnt[torch.where(b_ok, b_gid, capt - 1)] > 0)
    return (offsets.to(torch.int32), total, b_order, b_start[s_safe],
            match_cnt, b_matched)


def join_probe(table: JoinTable, s_words, s_live, s_ok,
               mode: str) -> JoinProbe:
    """K10: one stream batch against a build table; marks the matched
    build rows. CPU tensors run the plain union plan, CUDA tensors the
    kernel. Reads the output total back (the one sync of a stream batch)
    and raises when it passes int32."""
    if s_ok.device.type == "cpu":
        offsets, total, b_order, start, match_cnt, b_matched = \
            join_plan_plain(s_words, s_live, s_ok, table.words, table.ok,
                            mode)
        table.matched |= b_matched
        if total > _I32_MAX:
            raise ValueError(f"join batch emits {total} rows, over int32")
        return JoinProbe(offsets, total, match_cnt, start, b_order)
    w32 = RK._u32_to_i32(s_words).contiguous()
    s_live = s_live.contiguous()
    s_ok = s_ok.contiguous()
    CB.require_cuda(w32, s_live, s_ok, table.words)
    n_words, n = int(w32.shape[0]), int(w32.shape[1])
    if n_words != int(table.words.shape[0]):
        raise ValueError("stream and build key words differ in number")
    dev = s_ok.device
    lib = CB.library("hash_join")
    scratch = torch.empty(int(lib.srt_join_probe_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    match_cnt = torch.empty(n, dtype=torch.int32, device=dev)
    start = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    rc = lib.srt_join_probe(
        w32.data_ptr(), n_words, n, s_live.data_ptr(), s_ok.data_ptr(),
        table.words.data_ptr(), int(table.words.shape[1]),
        table.table.data_ptr(), int(table.table.shape[0]),
        table.counts.data_ptr(), table.starts.data_ptr(), _MODES[mode],
        match_cnt.data_ptr(), start.data_ptr(), offsets.data_ptr(),
        table.slot_matched.data_ptr(), total.data_ptr(), scratch.data_ptr(),
        scratch.numel(), CB.stream_of(s_ok))
    CB.count_launch("join_probe")
    CB.check(lib, rc, "join_probe")
    # host sync: the output size sizes the gathers (reference :457)
    n_out = int(total.item())
    if n_out > _I32_MAX:
        raise ValueError(f"join batch emits {n_out} rows, over int32")
    return JoinProbe(offsets, n_out, match_cnt, start, table.b_order)


def build_matched(table: JoinTable):
    """bool [b_cap]: build rows some probe so far matched."""
    if table.slot_matched is None:
        return table.matched
    return table.slot_matched[table.slot_of.long()]


def join_expand_plain(offsets, match_cnt, start, b_order, out_cap: int):
    """The reference's _expand_full: (s_idx, b_idx) int32 [out_cap]."""
    dev = offsets.device
    s_cap = int(match_cnt.shape[0])
    b_cap = max(int(b_order.shape[0]), 1)
    pos = torch.arange(out_cap, dtype=torch.int64, device=dev)
    offs = offsets.long()
    s_row = torch.searchsorted(offs[1:], pos, right=True).clamp(0, s_cap - 1)
    k = pos - offs[s_row]
    has_match = match_cnt[s_row] > 0
    b_pos = (start[s_row].long() + k).clamp(0, b_cap - 1)
    neg = torch.full((), -1, dtype=torch.int64, device=dev)
    b_row = torch.where(has_match, b_order[b_pos].long(), neg) \
        if b_order.numel() else neg.expand(out_cap)
    live = pos < offs[-1]
    return (torch.where(live, s_row, torch.zeros_like(s_row)).to(torch.int32),
            torch.where(live, b_row, neg).to(torch.int32))


def join_expand(probe: JoinProbe, out_cap: int):
    """K11: (s_idx, b_idx) int32 [out_cap] of a probed stream batch; lanes
    past the total hold 0 / -1. CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if probe.offsets.device.type == "cpu":
        return join_expand_plain(probe.offsets, probe.match_cnt, probe.start,
                                 probe.b_order, out_cap)
    CB.require_cuda(probe.offsets, probe.match_cnt, probe.start,
                    probe.b_order)
    dev = probe.offsets.device
    s_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    b_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    lib = CB.library("hash_join")
    rc = lib.srt_join_expand(
        probe.offsets.data_ptr(), probe.match_cnt.data_ptr(),
        probe.start.data_ptr(), probe.b_order.data_ptr(),
        int(probe.match_cnt.shape[0]), s_idx.data_ptr(), b_idx.data_ptr(),
        out_cap, CB.stream_of(s_idx))
    CB.count_launch("join_expand")
    CB.check(lib, rc, "join_expand")
    return s_idx, b_idx


# ===========================================================================
# device join execution
# ===========================================================================
def _codes_colv(cv) -> ColV:
    return ColV(DataType.INT32, cv.data, cv.validity)


def _value_colv(c) -> ColV:
    return col_to_colv(E.materialize(c)) if E.is_encoded(c) else c


class BuildSide:
    """A build batch with its key columns (encoded, or evaluated ColVs)
    and its K9 tables, one per mix of code / value key positions."""

    __slots__ = ("batch", "keys", "values_only", "tables", "_values")

    def __init__(self, batch: ColumnarBatch, keys, values_only: bool):
        self.batch = batch
        self.keys = keys
        self.values_only = values_only
        self.tables = {}
        self._values = {}

    def codes_at(self, k: int) -> bool:
        return not self.values_only and E.is_encoded(self.keys[k])

    def table(self, mode) -> JoinTable:
        got = self.tables.get(mode)
        if got is None:
            cols = []
            for k, (c, code) in enumerate(zip(self.keys, mode)):
                if code:
                    cols.append(_codes_colv(c))
                    continue
                if k not in self._values:
                    self._values[k] = _value_colv(c)
                cols.append(self._values[k])
            got = self.tables[mode] = join_build(
                *join_words(cols, self.batch.live_mask()))
        return got

    def matched(self):
        """bool [b_cap]: build rows some probe so far matched."""
        out = None
        for t in self.tables.values():
            m = build_matched(t)
            out = m if out is None else out | m
        return out if out is not None else \
            torch.zeros_like(self.batch.live_mask())


class _DeviceJoiner:
    """Bound key expressions of both sides: builds a side's table (K9) and
    probes stream batches against it (K10)."""

    def __init__(self, stream_keys, build_keys, stream_attrs, build_attrs,
                 mode: str, values_only: bool = False):
        self.bound_stream = bind_all(stream_keys, stream_attrs)
        self.bound_build = bind_all(build_keys, build_attrs)
        self.mode = mode
        self.values_only = values_only

    def build(self, build: ColumnarBatch) -> BuildSide:
        side = BuildSide(build, E.key_columns(build, self.bound_build),
                         self.values_only)
        # the table of the common case, every encoded build key in codes
        side.table(tuple(side.codes_at(k) for k in range(len(side.keys))))
        return side

    def probe(self, stream: ColumnarBatch, side: BuildSide) -> JoinProbe:
        cols, mode = [], []
        for k, c in enumerate(E.key_columns(stream, self.bound_stream)):
            code = side.codes_at(k) and E.is_encoded(c)
            mode.append(code)
            if code:
                cols.append(ColV(DataType.INT32, E.remapped_join_codes(
                    c, side.keys[k].dictionary), c.validity))
            else:
                cols.append(_value_colv(c))
        words, ok = join_words(cols, stream.live_mask())
        return join_probe(side.table(tuple(mode)), words,
                          stream.live_mask(), ok, self.mode)


class _TpuJoinMixin:
    """Shared device join loop of the shuffled and broadcast execs
    (reference: _TpuJoinMixin._join_stream :312-544)."""

    def _joiner(self) -> _DeviceJoiner:
        s, b, s_keys, b_keys = self._sides()
        return _DeviceJoiner(s_keys, b_keys, self.children[s].output,
                             self.children[b].output, self._stream_mode,
                             self.join_type is JoinType.FULL_OUTER)

    def _join_stream(self, stream_iter: Iterator, build: ColumnarBatch,
                     emit_build_tail: bool,
                     joiner: Optional[_DeviceJoiner] = None,
                     table: Optional[BuildSide] = None) -> Iterator:
        build_left = self.build_left
        mode = self._stream_mode
        if joiner is None:
            joiner = self._joiner()
        if table is None:
            table = joiner.build(build)
        emit_build_cols = mode in ("inner", "outer")
        cond_filter = None
        if self.condition is not None:
            cond_filter = DeviceFilter(bind_references(
                self.condition, self._joined_attrs()))
        for stream_batch in stream_iter:
            stream_batch = ensure_compact(stream_batch)
            if stream_batch.host_rows() == 0:
                continue
            probe = with_retry(lambda: joiner.probe(stream_batch, table),
                               site="join")
            if probe.total == 0:
                continue
            joined = with_retry(lambda: _emit_joined(
                stream_batch, build, probe, emit_build_cols, build_left,
                cond_filter), site="join")
            del probe
            yield joined
        if emit_build_tail and build.host_rows() > 0:
            # full outer: the unmatched build rows with NULL stream columns
            # (host sync once per partition, at the end of the stream)
            unmatched = ~table.matched() & build.live_mask()
            rows = torch.nonzero(unmatched).flatten()
            n_out = int(rows.shape[0])
            if n_out == 0:
                return
            b_out = gather_batch(build, rows, n_out, unique_indices=True)
            # full outer always builds right and streams left
            cols = (_null_batch(self.children[0].output, n_out,
                                build.device).columns + b_out.columns)
            yield ColumnarBatch(cols, n_out)


def _emit_joined(stream_batch: ColumnarBatch, build: ColumnarBatch, probe,
                 emit_build_cols: bool, build_left: bool,
                 cond_filter) -> ColumnarBatch:
    """One stream batch's joined rows: K11 expands the probe's matches,
    K32 (and K7 for strings) gathers both sides."""
    n_out = probe.total
    s_idx, b_idx = join_expand(probe, bucket_capacity(n_out))
    s_out = gather_batch(stream_batch, s_idx, n_out)
    if emit_build_cols:
        # negative (unmatched) indices gather NULL rows
        b_out = gather_batch(build, b_idx, n_out)
        cols = (b_out.columns + s_out.columns) if build_left \
            else (s_out.columns + b_out.columns)
        joined = ColumnarBatch(cols, n_out)
    else:
        joined = s_out
    if cond_filter is not None:
        joined = cond_filter.apply(joined)
    return joined


def _null_batch(attrs: List[AttributeReference], n_rows: int,
                device) -> ColumnarBatch:
    """All-NULL columns of `n_rows` rows (reference :570)."""
    cap = bucket_capacity(max(n_rows, 1))
    cols = []
    for a in attrs:
        validity = torch.zeros(cap, dtype=torch.bool, device=device)
        if a.data_type is DataType.STRING:
            cols.append(ColumnVector(
                a.data_type, torch.zeros(8, dtype=torch.uint8, device=device),
                validity, torch.zeros(cap + 1, dtype=torch.int32,
                                      device=device), 1))
        else:
            cols.append(ColumnVector(a.data_type, torch.zeros(
                cap, dtype=to_torch(a.data_type), device=device), validity))
    return ColumnarBatch(cols, n_rows)


def _one_build_batch(batches, attrs, device) -> ColumnarBatch:
    if not batches:
        return _null_batch(attrs, 0, device)
    return batches[0] if len(batches) == 1 else concat_batches(batches)


def _unwrap_to_exchange(node):
    """The planned shuffle exchange feeding a join input, through batch
    coalesces; None when the input has another shape (reference :594)."""
    from spark_rapids_tpu_torch.exec.transitions import (
        CpuCoalesceBatchesExec,
        TpuCoalesceBatchesExec,
    )
    from spark_rapids_tpu_torch.shuffle.exchange import _ExchangeBase

    cur = node
    while isinstance(cur, (TpuCoalesceBatchesExec, CpuCoalesceBatchesExec)):
        cur = cur.children[0]
    return cur if isinstance(cur, _ExchangeBase) else None


def _replay(parts) -> PartitionedBatches:
    return PartitionedBatches(len(parts), lambda p: iter(parts[p]))


def runtime_broadcast_probe(node: _JoinBase, ctx: ExecContext):
    """Runtime re-planning of a shuffled join (reference :609-678, the role
    Spark AQE's join strategy switch plays). The join materialises its
    build input BEFORE the exchange; when the bytes fit
    autoBroadcastJoinThreshold both exchanges are skipped and the join
    streams the other input as it is. An INNER join whose planned build
    side is too big tries the other side and swaps when that one fits.

    Returns None to go on with the planned shuffle (a materialised input
    is handed back to its exchange with set_pre_executed, so no child runs
    twice), or (build batches, stream PartitionedBatches)."""
    if node.join_type is JoinType.FULL_OUTER:
        return None
    if not ctx.conf.get(C.RUNTIME_BROADCAST):
        return None
    from spark_rapids_tpu_torch.shuffle.exchange import _piece_bytes

    bidx = 0 if node.build_left else 1
    bex = _unwrap_to_exchange(node.children[bidx])
    sex = _unwrap_to_exchange(node.children[1 - bidx])
    if bex is None or sex is None:
        return None

    def materialize(pb):
        parts = [list(pb.iterator(p)) for p in range(pb.num_partitions)]
        batches = [b for part in parts for b in part if rows_of(b) > 0]
        return parts, batches, sum(_piece_bytes(b) for b in batches)

    threshold = ctx.conf.get(C.BROADCAST_THRESHOLD)
    parts, batches, total = materialize(bex.children[0].execute(ctx))
    if total <= threshold:
        node.metrics[RUNTIME_BROADCASTS] += 1
        return batches, sex.children[0].execute(ctx)
    if node.join_type is JoinType.INNER:
        # an INNER join can build on either side: both inputs sit above
        # their exchanges, so both are materialised for the fallback anyway
        sparts, sbatches, stotal = materialize(sex.children[0].execute(ctx))
        if stotal <= threshold:
            node.metrics[RUNTIME_BROADCASTS] += 1
            node._runtime_build_left = (1 - bidx) == 0
            return sbatches, _replay(parts)
        sex.set_pre_executed(_replay(sparts))
    # too big: replay the materialised input through the planned exchange
    bex.set_pre_executed(_replay(parts))
    return None


class TpuShuffledHashJoinExec(_JoinBase, _TpuJoinMixin, TpuExec):
    placement = "tpu"

    @property
    def children_coalesce_goal(self):
        if self.build_left:
            return [RequireSingleBatch(), None]
        return [None, RequireSingleBatch()]

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        rb = runtime_broadcast_probe(self, ctx)
        if rb is not None:
            build_batches, stream_pb = rb
            _, b, _, _ = self._sides()
            bc = _one_build_batch(build_batches, self.children[b].output,
                                  ctx.device)
            joiner = self._joiner()
            table = joiner.build(bc)

            def bfactory(pidx: int):
                return count_output(self.metrics, self._join_stream(
                    stream_pb.iterator(pidx), bc, False, joiner, table))

            return PartitionedBatches(stream_pb.num_partitions, bfactory)
        left_pb = self.children[0].execute(ctx)
        right_pb = self.children[1].execute(ctx)
        build_pb = left_pb if self.build_left else right_pb
        stream_pb = right_pb if self.build_left else left_pb
        emit_tail = self.join_type is JoinType.FULL_OUTER
        _, b, _, _ = self._sides()
        build_attrs = self.children[b].output

        def factory(pidx: int):
            builds = [x for x in build_pb.iterator(pidx) if x.host_rows() > 0]
            build = _one_build_batch(builds, build_attrs, ctx.device)
            return count_output(self.metrics, self._join_stream(
                stream_pb.iterator(pidx), build, emit_tail))

        return PartitionedBatches(stream_pb.num_partitions, factory)


class TpuBroadcastHashJoinExec(_JoinBase, _TpuJoinMixin, TpuExec):
    """The build side materialised once (all partitions concatenated) and
    its table built once, shared by every stream partition (reference:
    GpuBroadcastHashJoinExec + GpuBroadcastExchangeExec)."""

    placement = "tpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        if self.join_type is JoinType.FULL_OUTER:
            # the unmatched-build tail would repeat per stream partition;
            # the planner never broadcasts a full outer join
            raise NotImplementedError(
                "full outer join cannot use the broadcast path")
        s, b, _, _ = self._sides()
        build_pb = self.children[b].execute(ctx)
        stream_pb = self.children[s].execute(ctx)
        batches = [x for p in range(build_pb.num_partitions)
                   for x in build_pb.iterator(p) if x.host_rows() > 0]
        build = _one_build_batch(batches, self.children[b].output,
                                 ctx.device)
        joiner = self._joiner()
        table = joiner.build(build)

        def factory(pidx: int):
            return count_output(self.metrics, self._join_stream(
                stream_pb.iterator(pidx), build, False, joiner, table))

        return PartitionedBatches(stream_pb.num_partitions, factory)


class TpuNestedLoopJoinExec(_JoinBase, TpuExec):
    """Cross product with an optional condition (reference :803-855;
    GpuCartesianProductExec / GpuBroadcastNestedLoopJoinExec). The right
    side is materialised once as one batch; per stream batch, output row
    `pos` pairs stream row pos // nb with build row pos % nb (both sides
    gathered: torch for fixed columns, K7 for strings), then the condition
    filters. The positions are int64: the reference's int32 arange would
    wrap past 2^31 output rows."""

    placement = "tpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        left_pb = self.children[0].execute(ctx)
        right_pb = self.children[1].execute(ctx)
        batches = [b for p in range(right_pb.num_partitions)
                   for b in right_pb.iterator(p) if b.host_rows() > 0]
        build = _one_build_batch(batches, self.children[1].output,
                                 ctx.device)
        nb = build.host_rows()
        cond_filter = None
        if self.condition is not None:
            cond_filter = DeviceFilter(bind_references(
                self.condition, self._joined_attrs()))

        def gen(pidx: int):
            for sb in left_pb.iterator(pidx):
                sb = ensure_compact(sb)
                ns = sb.host_rows()
                if ns == 0 or nb == 0:
                    continue
                n_out = ns * nb
                pos = torch.arange(bucket_capacity(n_out),
                                   dtype=torch.int64, device=ctx.device)
                s_out = gather_batch(sb, pos // nb, n_out)
                b_out = gather_batch(build, pos % nb, n_out)
                joined = ColumnarBatch(s_out.columns + b_out.columns, n_out)
                if cond_filter is not None:
                    joined = cond_filter.apply(joined)
                yield joined

        return PartitionedBatches(
            left_pb.num_partitions,
            lambda p: count_output(self.metrics, gen(p)))


# ===========================================================================
# CPU engine (numpy)
# ===========================================================================
def _host_key_codes(dtype: DataType, data, valid):
    """Per-row integer codes of one host key column whose equality is the
    join's (reference: _host_key :862): floats with -0.0 == 0.0 and every
    NaN equal; strings by value."""
    if dtype in (DataType.FLOAT32, DataType.FLOAT64):
        f = np.asarray(data, dtype=np.float64)
        nan = np.isnan(f)
        f = np.where(nan | (f == 0.0), 0.0, f)
        return [nan.astype(np.int64), np.unique(f, return_inverse=True)[1]]
    if dtype is DataType.STRING:
        vals = np.where(valid, np.asarray(data, dtype=object), "")
        return [np.unique(vals.astype(object), return_inverse=True)[1]]
    return [np.asarray(data).astype(np.int64)]


def _host_match_ids(s_cols, b_cols, types):
    """(stream ids, stream ok, build ids, build ok): one integer id per
    distinct key tuple over both sides; rows with a NULL key are not ok."""
    ns = len(s_cols[0].data) if s_cols else 0
    codes = []
    s_ok = np.ones(ns, dtype=bool)
    b_ok = np.ones(len(b_cols[0].data) if b_cols else 0, dtype=bool)
    for sc, bc, dt in zip(s_cols, b_cols, types):
        s_ok &= np.asarray(sc.validity, dtype=bool)
        b_ok &= np.asarray(bc.validity, dtype=bool)
        data = np.concatenate([np.asarray(sc.data, dtype=object)
                               if dt is DataType.STRING else sc.data,
                               np.asarray(bc.data, dtype=object)
                               if dt is DataType.STRING else bc.data])
        valid = np.concatenate([sc.validity, bc.validity])
        codes += [c.reshape(-1) for c in _host_key_codes(dt, data, valid)]
    ids = np.unique(np.stack(codes, axis=1), axis=0,
                    return_inverse=True)[1].reshape(-1)
    return ids[:ns], s_ok, ids[ns:], b_ok


def _host_join_indices(s_ids, s_ok, b_ids, b_ok, mode: str):
    """(s_idx, b_idx, matched build rows) of one stream batch: stream rows
    in order, each key's build rows in ascending row order, -1 for an
    unmatched outer or anti row, the first match for a semi row."""
    n_ids = int(max(s_ids.max(initial=-1), b_ids.max(initial=-1))) + 1
    counts = np.bincount(b_ids[b_ok], minlength=n_ids)
    b_order = np.nonzero(b_ok)[0][np.argsort(b_ids[b_ok], kind="stable")]
    starts = np.cumsum(counts) - counts
    cnt = np.where(s_ok, counts[s_ids] if n_ids else 0, 0)
    if mode == "inner":
        out = cnt
    elif mode == "outer":
        out = np.maximum(cnt, 1)
    elif mode == "semi":
        out = (cnt > 0).astype(np.int64)
    else:
        out = (cnt == 0).astype(np.int64)
    s_idx = np.repeat(np.arange(len(s_ids)), out)
    k = np.arange(len(s_idx)) - np.repeat(np.cumsum(out) - out, out)
    has = cnt[s_idx] > 0
    pos = starts[s_ids[s_idx]] + k if len(s_idx) else k
    b_idx = np.where(has, b_order[np.where(has, pos, 0)] if len(b_order)
                     else -1, -1)
    hit = np.zeros(n_ids, dtype=bool)
    hit[s_ids[s_ok & (cnt > 0)]] = True
    return s_idx, b_idx, b_ok & hit[b_ids] if n_ids else b_ok & False


class CpuShuffledHashJoinExec(_JoinBase, CpuExec):
    placement = "cpu"

    broadcast = False

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        if self.broadcast and self.join_type is JoinType.FULL_OUTER:
            raise NotImplementedError(
                "full outer join cannot use the broadcast path")
        if not self.broadcast:
            rb = runtime_broadcast_probe(self, ctx)
            if rb is not None:
                build_batches, stream_pb = rb
                return PartitionedBatches(
                    stream_pb.num_partitions,
                    lambda p: count_output(self.metrics, self._join_partition(
                        p, stream_pb.iterator(p), build_batches)))
        left_pb = self.children[0].execute(ctx)
        right_pb = self.children[1].execute(ctx)
        build_pb = left_pb if self.build_left else right_pb
        stream_pb = right_pb if self.build_left else left_pb
        all_build = None
        if self.broadcast:
            all_build = [b for p in range(build_pb.num_partitions)
                         for b in build_pb.iterator(p) if b.num_rows > 0]

        def factory(pidx: int):
            builds = all_build if all_build is not None else \
                [b for b in build_pb.iterator(pidx) if b.num_rows > 0]
            return count_output(self.metrics, self._join_partition(
                pidx, stream_pb.iterator(pidx), builds))

        return PartitionedBatches(stream_pb.num_partitions, factory)

    def _join_partition(self, pidx, stream_iter, builds):
        s, b, stream_keys, build_keys = self._sides()
        stream_attrs = self.children[s].output
        build_attrs = self.children[b].output
        mode = self._stream_mode
        emit_build = mode in ("inner", "outer")
        build_batch = _concat_host(builds, build_attrs)
        bkeys = cpu_project(bind_all(build_keys, build_attrs), build_batch,
                            partition_id=pidx).columns
        types = [k.data_type for k in build_keys]
        b_matched = np.zeros(build_batch.num_rows, dtype=bool)
        bound_skeys = bind_all(stream_keys, stream_attrs)
        cond = None
        if self.condition is not None and mode == "inner":
            cond = bind_references(self.condition, self._joined_attrs())
        for sb in stream_iter:
            if sb.num_rows == 0:
                continue
            skeys = cpu_project(bound_skeys, sb, partition_id=pidx).columns
            s_ids, s_ok, b_ids, b_ok = _host_match_ids(skeys, bkeys, types)
            s_idx, b_idx, hit = _host_join_indices(s_ids, s_ok, b_ids, b_ok,
                                                   mode)
            b_matched |= hit
            if not len(s_idx):
                continue
            out = self._emit_host(sb, build_batch, s_idx, b_idx, emit_build,
                                  stream_attrs, build_attrs)
            if cond is not None:
                out = cpu_filter(cond, out)
            yield out
        if self.join_type is JoinType.FULL_OUTER:
            rows = np.nonzero(~b_matched)[0]
            if len(rows):
                yield self._emit_host(None, build_batch,
                                      np.full(len(rows), -1), rows, True,
                                      stream_attrs, build_attrs)

    def _emit_host(self, sb, build_batch, s_idx, b_idx, emit_build,
                   stream_attrs, build_attrs):
        s_cols = _host_gather(sb, stream_attrs, s_idx)
        if not emit_build:
            return HostColumnarBatch(s_cols, len(s_idx))
        b_cols = _host_gather(build_batch, build_attrs, b_idx)
        cols = (b_cols + s_cols) if self.build_left else (s_cols + b_cols)
        return HostColumnarBatch(cols, len(s_idx))


class CpuBroadcastHashJoinExec(CpuShuffledHashJoinExec):
    broadcast = True


class CpuNestedLoopJoinExec(_JoinBase, CpuExec):
    """The CPU engine's cross product (reference :1017), vectorised: the
    right side concatenated once, each stream batch's product gathered
    with np.repeat / np.tile, then the condition."""

    placement = "cpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        left_pb = self.children[0].execute(ctx)
        right_pb = self.children[1].execute(ctx)
        left_attrs = self.children[0].output
        right_attrs = self.children[1].output
        build = _concat_host([b for p in range(right_pb.num_partitions)
                              for b in right_pb.iterator(p)
                              if b.num_rows > 0], right_attrs)
        cond = None
        if self.condition is not None:
            cond = bind_references(self.condition, self._joined_attrs())

        def gen(pidx: int):
            for sb in left_pb.iterator(pidx):
                if sb.num_rows == 0 or build.num_rows == 0:
                    continue
                s_idx = np.repeat(np.arange(sb.num_rows), build.num_rows)
                b_idx = np.tile(np.arange(build.num_rows), sb.num_rows)
                out = HostColumnarBatch(
                    _host_gather(sb, left_attrs, s_idx) +
                    _host_gather(build, right_attrs, b_idx), len(s_idx))
                if cond is not None:
                    out = cpu_filter(cond, out)
                yield out

        return PartitionedBatches(
            left_pb.num_partitions,
            lambda p: count_output(self.metrics, gen(p)))


def _concat_host(batches: List[HostColumnarBatch],
                 attrs: List[AttributeReference]) -> HostColumnarBatch:
    """Reference :1057."""
    if not batches:
        return HostColumnarBatch([
            HostColumnVector(a.data_type, np.zeros(0, dtype=object)
                             if a.data_type is DataType.STRING else
                             np.zeros(0, dtype=a.data_type.to_np()),
                             np.zeros(0, dtype=bool)) for a in attrs], 0)
    if len(batches) == 1:
        return batches[0]
    cols = []
    for c in range(batches[0].num_columns):
        cols.append(HostColumnVector(
            batches[0].columns[c].dtype,
            np.concatenate([b.columns[c].data[:b.num_rows]
                            for b in batches]),
            np.concatenate([b.columns[c].validity[:b.num_rows]
                            for b in batches])))
    return HostColumnarBatch(cols, sum(b.num_rows for b in batches))


def _host_gather(batch: Optional[HostColumnarBatch],
                 attrs: List[AttributeReference],
                 idx) -> List[HostColumnVector]:
    """Rows `idx` of a host batch; -1 (or no batch) gives a NULL row
    (reference :1079, vectorised)."""
    idx = np.asarray(idx, dtype=np.int64)
    n = len(idx)
    take = idx >= 0
    safe = np.where(take, idx, 0)
    out = []
    for c, a in enumerate(attrs):
        is_str = a.data_type is DataType.STRING
        if batch is None or batch.num_rows == 0:
            data = np.full(n, "", dtype=object) if is_str else \
                np.zeros(n, dtype=a.data_type.to_np())
            out.append(HostColumnVector(a.data_type, data,
                                        np.zeros(n, dtype=bool)))
            continue
        src = batch.columns[c]
        validity = take & np.asarray(src.validity, dtype=bool)[safe]
        data = np.asarray(src.data)[safe]
        if is_str:
            data = np.where(validity, data, "").astype(object)
        else:
            data = np.where(validity, data, np.zeros((), dtype=data.dtype))
        out.append(HostColumnVector(a.data_type, data, validity))
    return out
