"""Window execs (port of spark_rapids_tpu/exec/window.py: TpuWindowExec
:166-338 and CpuWindowExec :630-916; reference: GpuWindowExec.scala and
GpuWindowExpression.scala).

Every window expression of one exec shares one (partition_by, order_by);
the planner splits differing specs into chained execs. A batch is one whole
task partition (RequireSingleBatch after a hash exchange on the partition
keys, or one partition without them).

The reference's one jitted program (`_build_kernel` :166, jit :309) becomes
the sort kernel K1 and three hand-written kernels, each beside its plain
PyTorch version in this module:

- K1 `radix_sort_pairs` sorts the reference's operands (:222-240) as key
  words: [pad | partition null flag, partition words..., order null flag
  (flipped for NULLS FIRST), order words (inverted when descending)...].
  Keys go through `key_proxy` as in the reference, so a STRING order key
  orders by its hash words there too (ROADMAP.md section 3).
- K14 `window_segments` (csrc/window_segments.cu) replaces :241-287: the
  partition and peer boundaries in sorted order, the partition id, each
  row's partition and peer-group bounds, its peer-group id, and for a
  single integer-kind ORDER BY key its sorted (negated when descending)
  values with the non-null span of each partition.
- K15 `window_rank_offset` (csrc/window_rank_offset.cu) replaces
  `_eval_window_fn` (:413-448) and the scatter back to input order
  (:297-306): row_number, rank, dense_rank, ntile, lag and lead.
- K16 `window_frame_agg` (csrc/window_frame_agg.cu) replaces
  `_frame_bounds`, `_bsearch`, `_rmq` and `_eval_window_agg` (:457-624):
  sum / count / avg as prefix-sum differences ps[hi + 1] - ps[lo], min /
  max over the whole partition, running (a segmented scan, extended over
  the peers of a RANGE frame) or over any frame, first / last, then the
  scatter back to input order.

Encoded columns (slice 17; reference `_encoded_plan` :313-365 and its use
in `execute` :370-405): a dictionary column referenced only bare in the
partition-by or the order-by stays encoded and goes to rank space (K24
through its sorted dictionary, `batch_to_rank_space`), and the keys bind
to its int32 rank codes (the retyped attributes of reference :166-178):
codes of a sorted dictionary cluster and order as the values do, so K1
sorts plain int32 words and no string word is made. Window-function
inputs, computed spec expressions and the order column of a finite RANGE
frame (whose bounds do arithmetic on values) decode through K23 first.
Each batch kept in rank space counts one `orderPreservingSorts`. A STRING
order key in rank space orders by value, while a decoded one orders by its
hash words as above: both packages give different rank() and
row_number() results with encoding on and off (ROADMAP.md section 3).

Sorted-domain conventions: live rows sort before the pads, so a sorted
position is live iff it is below the row count. At pad positions the
partition id and every bound are `cap`, the non-null span (cap, -1) and
the sorted key 0; outputs are NULL with data 0 wherever they are not valid
(the reference leaves whatever its gathers produced there). A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
its kernel or raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    HostColumnarBatch,
    HostColumnVector,
    ensure_compact,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.exec import rowkeys as RK
from spark_rapids_tpu_torch.exec.base import (
    CpuExec,
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)
from spark_rapids_tpu_torch.exec.transitions import RequireSingleBatch
from spark_rapids_tpu_torch.ops.aggregates import (
    AggregateFunction,
    Average,
    Count,
    Max,
    Min,
    Sum,
)
from spark_rapids_tpu_torch.ops.base import (
    AttributeReference,
    BoundReference,
    Expression,
    to_attribute,
)
from spark_rapids_tpu_torch.ops.bind import bind_all, bind_sort_orders
from spark_rapids_tpu_torch.ops.eval import (
    cpu_project,
    device_eval_context,
    eval_as_col,
)
from spark_rapids_tpu_torch.ops.values import EvalContext
from spark_rapids_tpu_torch.ops.window import (
    UNBOUNDED,
    DenseRank,
    Lag,
    Lead,
    NTile,
    Rank,
    RowNumber,
    WindowExpression,
    WindowFrame,
    WindowSpec,
)
from spark_rapids_tpu_torch.utils import metrics as M

# integer-kind ORDER BY types of a bounded RANGE frame (reference :272)
RANGE_KEY_TYPES = (DataType.INT8, DataType.INT16, DataType.INT32,
                   DataType.INT64, DataType.DATE, DataType.TIMESTAMP)


class _WindowBase(PhysicalExec):
    """All window_exprs share one (partition_by, order_by) (reference
    :77)."""

    def __init__(self, window_exprs: List[Expression], child: PhysicalExec):
        super().__init__(child)
        self.window_exprs = list(window_exprs)  # Alias(WindowExpression)

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output + [
            to_attribute(e) for e in self.window_exprs]

    def with_children(self, new_children):
        return type(self)(self.window_exprs, new_children[0])

    def node_expressions(self):
        return list(self.window_exprs)

    @property
    def children_coalesce_goal(self):
        return [RequireSingleBatch()]

    def node_name(self):
        return f"{type(self).__name__}({len(self.window_exprs)} exprs)"

    def _spec(self) -> WindowSpec:
        return _unwrap(self.window_exprs[0]).spec

    def _bound(self, rank_ords=frozenset()):
        """(partition exprs, sort orders, window exprs, function inputs)
        bound against the child's output; the columns at `rank_ords` bind
        as their int32 rank codes."""
        attrs = [AttributeReference(a.name, DataType.INT32, a.nullable,
                                    a.expr_id) if i in rank_ords else a
                 for i, a in enumerate(self.children[0].output)]
        spec = self._spec()
        wexprs = [_unwrap(e) for e in self.window_exprs]
        inputs = []
        for w in wexprs:
            ch = w.function.children()
            inputs.append(bind_all([ch[0]], attrs)[0] if ch else None)
        return (bind_all(spec.partition_by, attrs),
                bind_sort_orders(spec.order_by, attrs), wexprs, inputs)


def _unwrap(e: Expression) -> WindowExpression:
    w = e.collect(lambda n: isinstance(n, WindowExpression))
    if len(w) != 1:
        raise ValueError(f"expected one window expression in {e!r}")
    return w[0]


# ===========================================================================
# K14: window_segments
# ===========================================================================
class WindowSegments(NamedTuple):
    """Sorted-domain structure of one window batch (int32 [cap] unless
    noted)."""

    live_s: Any        # bool: the sorted position holds a live row
    pgid: Any          # partition id; cap at pads
    start: Any         # first sorted position of the row's partition
    end: Any           # last sorted position of the row's partition
    peer_start: Any    # first position of the row's peer group
    peer_end: Any      # last position of the row's peer group
    peer_id: Any       # peer-group id (dense_rank's prefix count - 1)
    key_s: Any = None     # int64: the range key (negated when descending)
    kvalid: Any = None    # bool: the range key is not NULL
    nn_start: Any = None  # first non-null key position of the partition
    nn_end: Any = None    # last non-null key position of the partition


def _run_tables(change, live_s, cap: int):
    """(id, first position, last position) per sorted row of the runs that
    `change` starts; cap at pads."""
    dev = change.device
    pos = torch.arange(cap, dtype=torch.int32, device=dev)
    capt = torch.full((), cap, dtype=torch.int32, device=dev)
    rid = torch.where(live_s, torch.cumsum(change.to(torch.int32), 0,
                                           dtype=torch.int32) - 1, capt)
    nxt_change = torch.ones(cap, dtype=torch.bool, device=dev)
    nxt_change[:-1] = change[1:] | ~live_s[1:]
    is_end = nxt_change & live_s
    first = torch.full((cap + 1,), cap, dtype=torch.int32, device=dev)
    last = torch.full((cap + 1,), cap, dtype=torch.int32, device=dev)
    first.scatter_(0, torch.where(change, rid, capt).long(), pos)
    last.scatter_(0, torch.where(is_end, rid, capt).long(), pos)
    first[cap] = cap
    last[cap] = cap
    return rid, first[rid.long()], last[rid.long()]


def window_segments_plain(words, perm, live, n_part_words: int,
                          range_key=None) -> WindowSegments:
    """The plain version of K14 (reference :241-287). words: int64
    [n_words, cap] in input order (values in [0, 2^32)); perm: K1's int32
    permutation; live: bool [cap] in input order; the first n_part_words
    words are the partition keys'. range_key: (int64 data, bool validity,
    descending) of the single integer-kind ORDER BY key, in input order."""
    cap = int(perm.shape[0])
    dev = perm.device
    p = perm.long()
    live_s = live[p]
    ws = words[:, p]
    part_diff = torch.zeros(cap, dtype=torch.bool, device=dev)
    part_diff[0] = True
    peer_diff = part_diff.clone()
    if cap > 1:
        if n_part_words:
            part_diff[1:] |= (ws[:n_part_words, 1:] !=
                              ws[:n_part_words, :-1]).any(0)
        peer_diff[1:] |= (ws[:, 1:] != ws[:, :-1]).any(0)
    part_change = part_diff & live_s
    peer_change = (peer_diff | part_diff) & live_s
    pgid, start, end = _run_tables(part_change, live_s, cap)
    peer_id, peer_start, peer_end = _run_tables(peer_change, live_s, cap)
    if range_key is None:
        return WindowSegments(live_s, pgid, start, end, peer_start,
                              peer_end, peer_id)
    data, validity, descending = range_key
    key = data[p].to(torch.int64)
    kvalid = validity[p] & live_s
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    key_s = torch.where(kvalid, -key if descending else key, zero)
    pos = torch.arange(cap, dtype=torch.int32, device=dev)
    capt = torch.full((), cap, dtype=torch.int32, device=dev)
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    seg = torch.where(live_s, pgid, capt).long()
    lo = torch.full((cap + 1,), cap, dtype=torch.int32, device=dev)
    hi = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    lo.scatter_reduce_(0, seg, torch.where(kvalid, pos, capt), "amin")
    hi.scatter_reduce_(0, seg, torch.where(kvalid, pos, neg1), "amax")
    nn_start = torch.where(live_s, lo[seg], capt)
    nn_end = torch.where(live_s, hi[seg], neg1)
    return WindowSegments(live_s, pgid, start, end, peer_start, peer_end,
                          peer_id, key_s, kvalid, nn_start, nn_end)


def window_segments(words, perm, live, n_part_words: int,
                    range_key=None) -> WindowSegments:
    """K14: CPU tensors run the plain version, CUDA tensors the kernel."""
    if perm.device.type == "cpu":
        return window_segments_plain(words, perm, live, n_part_words,
                                     range_key)
    w32 = RK._u32_to_i32(words).contiguous()
    live = live.contiguous()
    CB.require_cuda(w32, perm, live)
    n_words, cap = int(w32.shape[0]), int(w32.shape[1])
    dev = perm.device
    lib = CB.library("window_segments")
    scratch = torch.empty(int(lib.srt_window_segments_scratch_bytes(cap)),
                          dtype=torch.uint8, device=dev)

    def i32():
        return torch.empty(cap, dtype=torch.int32, device=dev)

    live_s = torch.empty(cap, dtype=torch.bool, device=dev)
    pgid, start, end = i32(), i32(), i32()
    peer_start, peer_end, peer_id = i32(), i32(), i32()
    key_s = kvalid = nn_start = nn_end = None
    rk_data = rk_valid = 0
    desc = 0
    if range_key is not None:
        data, validity, descending = range_key
        data = data.to(torch.int64).contiguous()
        validity = validity.contiguous()
        CB.require_cuda(data, validity)
        rk_data, rk_valid, desc = data.data_ptr(), validity.data_ptr(), \
            int(bool(descending))
        key_s = torch.empty(cap, dtype=torch.int64, device=dev)
        kvalid = torch.empty(cap, dtype=torch.bool, device=dev)
        nn_start, nn_end = i32(), i32()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    rc = lib.srt_window_segments(
        w32.data_ptr(), n_words, n_part_words, cap, perm.data_ptr(),
        live.data_ptr(), rk_data, rk_valid, desc, live_s.data_ptr(),
        pgid.data_ptr(), start.data_ptr(), end.data_ptr(),
        peer_start.data_ptr(), peer_end.data_ptr(), peer_id.data_ptr(),
        ptr(key_s), ptr(kvalid), ptr(nn_start), ptr(nn_end),
        scratch.data_ptr(), scratch.numel(), CB.stream_of(perm))
    CB.count_launch("window_segments")
    CB.check(lib, rc, "window_segments")
    return WindowSegments(live_s, pgid, start, end, peer_start, peer_end,
                          peer_id, key_s, kvalid, nn_start, nn_end)


# ===========================================================================
# K15: window_rank_offset
# ===========================================================================
_RANK_KINDS = {"row_number": 0, "rank": 1, "dense_rank": 2, "ntile": 3,
               "shift": 4}


def _scatter_out(perm, data_s, valid_s, live_s):
    """Sorted-domain results back to input order, NULL lanes zeroed."""
    valid = valid_s & live_s
    data = torch.where(valid, data_s,
                       torch.zeros((), dtype=data_s.dtype,
                                   device=data_s.device))
    p = perm.long()
    out = torch.empty_like(data)
    outv = torch.empty_like(valid)
    out[p] = data
    outv[p] = valid
    return out, outv


def _default_tensor(default, dtype, dev):
    """A lag / lead default as a 0-dim tensor of the value dtype (0 for
    none), as the reference's `_default_of` (:451) makes it."""
    if default is None:
        return torch.zeros((), dtype=dtype, device=dev)
    return torch.tensor(default, dtype=dtype, device=dev)


def window_rank_offset_plain(seg: WindowSegments, perm, kind: str, n: int = 0,
                             offset: int = 0, values=None, validity=None,
                             default=None):
    """The plain version of K15 (reference :413-448 and the scatter
    :297-306): (data, valid) in input order; int32 for the ranking kinds,
    the values' dtype for a shift (lag: offset < 0, lead: offset > 0)."""
    cap = int(perm.shape[0])
    dev = perm.device
    pos = torch.arange(cap, dtype=torch.int32, device=dev)
    live_s = seg.live_s
    start = seg.start.clamp(max=cap - 1)
    if kind == "row_number":
        data = pos - seg.start + 1
    elif kind == "rank":
        data = seg.peer_start - seg.start + 1
    elif kind == "dense_rank":
        data = seg.peer_id - seg.peer_id[start.long()] + 1
    elif kind == "ntile":
        cnt = (seg.end - seg.start + 1).to(torch.int64)
        rel = (pos - seg.start).to(torch.int64)
        data = (rel * n // cnt.clamp(min=1) + 1).to(torch.int32)
    elif kind == "shift":
        p = perm.long()
        vs = values[p]
        valid_in = validity[p]
        j = pos.to(torch.int64) + offset
        in_seg = (j >= seg.start) & (j <= seg.end)
        safe = j.clamp(0, cap - 1)
        data = torch.where(in_seg, vs[safe],
                           _default_tensor(default, vs.dtype, dev))
        valid = torch.where(in_seg, valid_in[safe],
                            torch.full((), default is not None,
                                       dtype=torch.bool, device=dev))
        return _scatter_out(perm, data, valid, live_s)
    else:
        raise ValueError(f"unknown window function kind {kind!r}")
    return _scatter_out(perm, data.to(torch.int32),
                        torch.ones(cap, dtype=torch.bool, device=dev),
                        live_s)


def _bits_of_default(default, dtype) -> int:
    """The bit pattern of a default in the values' dtype, as int64."""
    t = _default_tensor(default, dtype, torch.device("cpu")).reshape(1)
    size = t.element_size()
    raw = t.view(torch.uint8).numpy().tobytes() + b"\0" * (8 - size)
    return int(np.frombuffer(raw, dtype=np.int64)[0])


def window_rank_offset(seg: WindowSegments, perm, kind: str, n: int = 0,
                       offset: int = 0, values=None, validity=None,
                       default=None):
    """K15: CPU tensors run the plain version, CUDA tensors the kernel."""
    if perm.device.type == "cpu":
        return window_rank_offset_plain(seg, perm, kind, n, offset, values,
                                        validity, default)
    cap = int(perm.shape[0])
    dev = perm.device
    CB.require_cuda(perm, seg.start, seg.end, seg.peer_start, seg.peer_id)
    if kind == "shift":
        values = values.contiguous()
        validity = validity.contiguous()
        CB.require_cuda(values, validity)
        out = torch.empty(cap, dtype=values.dtype, device=dev)
        elem = values.element_size()
        vptr, vvalid = values.data_ptr(), validity.data_ptr()
        bits = _bits_of_default(default, values.dtype)
    else:
        out = torch.empty(cap, dtype=torch.int32, device=dev)
        elem, vptr, vvalid, bits = 4, 0, 0, 0
    outv = torch.empty(cap, dtype=torch.bool, device=dev)
    lib = CB.library("window_rank_offset")
    rc = lib.srt_window_rank_offset(
        _RANK_KINDS[kind], cap, perm.data_ptr(), seg.live_s.data_ptr(),
        seg.start.data_ptr(), seg.end.data_ptr(),
        seg.peer_start.data_ptr(), seg.peer_id.data_ptr(), n, offset,
        vptr, vvalid, elem, bits, int(default is not None),
        out.data_ptr(), outv.data_ptr(), CB.stream_of(perm))
    CB.count_launch("window_rank_offset")
    CB.check(lib, rc, "window_rank_offset")
    return out, outv


# ===========================================================================
# K16: window_frame_agg
# ===========================================================================
_AGG_FUNCS = {"sum": 0, "count": 1, "avg": 2, "min": 3, "max": 4,
              "first": 5, "last": 6}
_FRAME_MODES = {"rows": 0, "range": 1}
_VALUE_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
                 torch.float64: 3, torch.int8: 4, torch.int16: 5,
                 torch.bool: 6}
# min / max methods: whole partition, running, any frame
_MM_WHOLE, _MM_RUNNING, _MM_FRAME = 0, 1, 2
_NONE = -(1 << 62)  # an unbounded frame side on the C interface


def _bsearch(keys, target, lo0, hi0, side: str):
    """Per-row binary search (reference :457): the smallest index in
    [lo0, hi0 + 1] whose key is >= target ('left') or > target
    ('right')."""
    cap = keys.shape[0]
    lo = lo0.to(torch.int64)
    hi = hi0.to(torch.int64) + 1
    steps = max(1, int(np.ceil(np.log2(max(cap, 2)))) + 1)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        vm = keys[mid.clamp(0, cap - 1)]
        go_right = (vm < target) if side == "left" else (vm <= target)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def frame_bounds_plain(frame: WindowFrame, seg: WindowSegments, cap: int):
    """Frame [lo, hi] per sorted row, int64, clamped to the partition
    (reference `_frame_bounds` :475)."""
    dev = seg.start.device
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    start, end = seg.start.to(torch.int64), seg.end.to(torch.int64)
    if frame.frame_type == "range":
        lo_b, hi_b = frame.lower, frame.upper
        pstart = seg.peer_start.to(torch.int64)
        pend = seg.peer_end.to(torch.int64)
        if lo_b in (UNBOUNDED, 0) and hi_b in (UNBOUNDED, 0):
            return (start if lo_b is UNBOUNDED else pstart,
                    end if hi_b is UNBOUNDED else pend)
        if seg.key_s is None:
            raise NotImplementedError(
                "bounded range frame requires exactly ONE integer-kind "
                "ORDER BY column")
        key_s = seg.key_s
        if lo_b is UNBOUNDED:
            lo = start
        elif lo_b == 0:
            lo = pstart
        else:
            lo = _bsearch(key_s, key_s + lo_b, seg.nn_start, seg.nn_end,
                          "left")
        if hi_b is UNBOUNDED:
            hi = end
        elif hi_b == 0:
            hi = pend
        else:
            hi = _bsearch(key_s, key_s + hi_b, seg.nn_start, seg.nn_end,
                          "right") - 1
        return (torch.where(seg.kvalid, lo, pstart),
                torch.where(seg.kvalid, hi, pend))
    lo = start if frame.lower is UNBOUNDED else \
        torch.maximum(start, pos + frame.lower)
    hi = end if frame.upper is UNBOUNDED else \
        torch.minimum(end, pos + frame.upper)
    return lo, hi


def _prefix(x):
    """[0, x0, x0 + x1, ...]: the exclusive-then-total prefix sum."""
    out = torch.zeros(x.shape[0] + 1, dtype=x.dtype, device=x.device)
    out[1:] = torch.cumsum(x, 0, dtype=x.dtype)
    return out


def _order_key64(vs):
    """int64 keys ordered as the values (floats through their order bits,
    NaN largest) and the inverse map."""
    if vs.is_floating_point():
        return RK._float_order_bits(vs), \
            (lambda k: RK._float_from_order_bits(k, vs.dtype))
    return vs.to(torch.int64), (lambda k: k.to(vs.dtype))


def _worst(vs, is_min: bool):
    if vs.dtype == torch.float64:
        return RK._I64_MAX if is_min else RK._I64_MIN
    if vs.dtype == torch.float32:
        return RK.M32 if is_min else 0
    info = torch.iinfo(torch.int32 if vs.dtype == torch.bool else vs.dtype)
    if vs.dtype == torch.bool:
        return 1 if is_min else 0
    return info.max if is_min else info.min


def _seg_scan_plain(op, gid, vals):
    """Segmented inclusive min / max scan along the sorted rows."""
    out = vals.clone()
    cap = vals.shape[0]
    step = 1
    while step < cap:
        same = gid[step:] == gid[:-step]
        out_new = out.clone()
        out_new[step:] = torch.where(same, op(out[step:], out[:-step]),
                                     out[step:])
        out = out_new
        step <<= 1
    return out


def _rmq_plain(masked, lo, hi, op, worst, cap: int):
    """Range min / max over [lo, hi] by a sparse table (reference :523)."""
    dev = masked.device
    levels_n = max(1, int(np.ceil(np.log2(max(cap, 2)))) + 1)
    levels = [masked]
    cur = masked
    for k in range(1, levels_n):
        shift = 1 << (k - 1)
        shifted = torch.cat([cur[shift:], torch.full(
            (min(shift, cap),), worst, dtype=cur.dtype, device=dev)])[:cap]
        cur = op(cur, shifted)
        levels.append(cur)
    table = torch.stack(levels)
    w = (hi - lo + 1).clamp(min=1)
    k = torch.zeros_like(w)
    for j in range(1, levels_n):
        k = k + (w >= (1 << j)).to(w.dtype)
    p2 = torch.ones_like(k) << k
    a = table[k, lo.clamp(0, cap - 1)]
    b = table[k, (hi - p2 + 1).clamp(0, cap - 1)]
    return op(a, b)


def window_frame_agg_plain(seg: WindowSegments, perm, func: str,
                           frame: WindowFrame, values, validity,
                           out_dtype: torch.dtype):
    """The plain version of K16 (reference :549-624): (data, valid) in
    input order."""
    cap = int(perm.shape[0])
    dev = perm.device
    p = perm.long()
    vs = values[p]
    valid_s = validity[p] & seg.live_s
    lo, hi = frame_bounds_plain(frame, seg, cap)
    empty = hi < lo
    lo_c = lo.clamp(0, cap)
    hi1_c = (hi + 1).clamp(0, cap)
    pc = _prefix(valid_s.to(torch.int64))
    cnt = torch.where(empty, torch.zeros((), dtype=torch.int64, device=dev),
                      pc[hi1_c] - pc[lo_c])
    zero_out = torch.zeros((), dtype=out_dtype, device=dev)
    if func == "count":
        data_s, ok = cnt, torch.ones(cap, dtype=torch.bool, device=dev)
    elif func in ("sum", "avg"):
        # the sum accumulates at the result's storage dtype (reference
        # :573), an average divides it as float32 or float64
        acc = out_dtype
        contrib = torch.where(valid_s, vs.to(acc),
                              torch.zeros((), dtype=acc, device=dev))
        ps = _prefix(contrib)
        s = ps[hi1_c] - ps[lo_c]
        ok = cnt > 0
        if func == "sum":
            data_s = s
        else:
            fdt = torch.float32 if acc == torch.float32 else torch.float64
            data_s = s.to(fdt) / cnt.clamp(min=1).to(fdt)
    elif func in ("min", "max"):
        is_min = func == "min"
        key, back = _order_key64(vs)
        worst = _worst(vs, is_min)
        masked = torch.where(valid_s, key, torch.full(
            (), worst, dtype=torch.int64, device=dev))
        op = torch.minimum if is_min else torch.maximum
        method = _minmax_method(frame)
        gid = torch.where(seg.live_s, seg.pgid, torch.full(
            (), cap, dtype=torch.int32, device=dev))
        if method == _MM_FRAME:
            red = _rmq_plain(masked, lo, hi, op, worst, cap)
        else:
            scan = _seg_scan_plain(op, gid, masked)
            if method == _MM_WHOLE:
                at = seg.end
            elif frame.frame_type == "range":
                at = seg.peer_end
            else:
                at = torch.arange(cap, dtype=torch.int32, device=dev)
            red = scan[at.clamp(0, cap - 1).long()]
        ok = cnt > 0
        data_s = back(torch.where(ok, red, torch.zeros(
            (), dtype=torch.int64, device=dev)))
    elif func in ("first", "last"):
        sel = (lo if func == "first" else hi).clamp(0, cap - 1)
        data_s = vs[sel]
        ok = valid_s[sel] & ~empty
    else:
        raise ValueError(f"unknown window aggregate {func!r}")
    data_s = data_s.to(out_dtype)
    return _scatter_out(perm, torch.where(ok, data_s, zero_out), ok,
                        seg.live_s)


def _minmax_method(frame: WindowFrame) -> int:
    if frame.is_unbounded_both:
        return _MM_WHOLE
    if frame.is_unbounded_to_current:
        return _MM_RUNNING
    return _MM_FRAME


def _bound_arg(b) -> int:
    return _NONE if b is UNBOUNDED else int(b)


def window_frame_agg(seg: WindowSegments, perm, func: str,
                     frame: WindowFrame, values, validity,
                     out_dtype: torch.dtype):
    """K16: CPU tensors run the plain version, CUDA tensors the kernel."""
    if perm.device.type == "cpu":
        return window_frame_agg_plain(seg, perm, func, frame, values,
                                      validity, out_dtype)
    cap = int(perm.shape[0])
    dev = perm.device
    values = values.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(perm, values, validity, seg.start)
    if values.dtype not in _VALUE_DTYPES or \
            out_dtype not in _VALUE_DTYPES:
        raise TypeError(f"window aggregate over {values.dtype} -> "
                        f"{out_dtype} has no kernel")
    bounded_range = frame.frame_type == "range" and not (
        frame.lower in (UNBOUNDED, 0) and frame.upper in (UNBOUNDED, 0))
    if bounded_range and seg.key_s is None:
        raise NotImplementedError(
            "bounded range frame requires exactly ONE integer-kind ORDER BY "
            "column")
    out = torch.empty(cap, dtype=out_dtype, device=dev)
    outv = torch.empty(cap, dtype=torch.bool, device=dev)
    lib = CB.library("window_frame_agg")
    scratch = torch.empty(
        int(lib.srt_window_frame_agg_scratch_bytes(cap)), dtype=torch.uint8,
        device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    rc = lib.srt_window_frame_agg(
        _AGG_FUNCS[func], _FRAME_MODES[frame.frame_type],
        _bound_arg(frame.lower), _bound_arg(frame.upper),
        _minmax_method(frame), cap, perm.data_ptr(),
        seg.live_s.data_ptr(), seg.start.data_ptr(),
        seg.end.data_ptr(), seg.peer_start.data_ptr(),
        seg.peer_end.data_ptr(), ptr(seg.key_s), ptr(seg.kvalid),
        ptr(seg.nn_start), ptr(seg.nn_end), values.data_ptr(),
        validity.data_ptr(), _VALUE_DTYPES[values.dtype],
        _VALUE_DTYPES[out_dtype], out.data_ptr(), outv.data_ptr(),
        scratch.data_ptr(), scratch.numel(), CB.stream_of(perm))
    CB.count_launch("window_frame_agg")
    CB.check(lib, rc, "window_frame_agg")
    return out, outv


# ===========================================================================
# Device exec
# ===========================================================================
def _window_words(part_proxies, order_proxies, orders, live):
    """int64 [n_words, cap] sort words of the reference's operands
    (:222-240) and the count of leading partition words. A partition key
    may be an equality-only proxy (any consistent cluster order works)."""
    pad = (~live).to(torch.int64)
    words = []
    entries = [(p, None) for p in part_proxies] + \
        [(p, (o.ascending, o.nulls_first))
         for p, o in zip(order_proxies, orders)]
    n_part = 0
    for i, (p, direction) in enumerate(entries):
        nf = p.null_flag.to(torch.int64)
        arrays = list(p.arrays)
        if direction is not None:
            ascending, nulls_first = direction
            if nulls_first:
                nf = 1 - nf
            if not ascending:
                arrays = [RK._invert_order(a) for a in arrays]
        words.append(pad * 2 + nf if i == 0 else nf)
        words.extend(arrays)
        if direction is None:
            n_part = len(words)
    if not words:
        words = [pad]
    return torch.stack(words), n_part


def _function_kind(f):
    if isinstance(f, RowNumber):
        return "row_number"
    if isinstance(f, Rank):
        return "rank"
    if isinstance(f, DenseRank):
        return "dense_rank"
    if isinstance(f, NTile):
        return "ntile"
    if isinstance(f, (Lag, Lead)):
        return "shift"
    if isinstance(f, Sum):
        return "sum"
    if isinstance(f, Count):
        return "count"
    if isinstance(f, Average):
        return "avg"
    if isinstance(f, Min):
        return "min"
    if isinstance(f, Max):
        return "max"
    raise NotImplementedError(f"window function {type(f).__name__}")


def window_columns(batch: ColumnarBatch, bound_part, bound_orders, wexprs,
                   bound_inputs) -> List[ColumnVector]:
    """The window output columns of one compact device batch: K1 sorts,
    K14 lays out the partitions, K15 / K16 evaluate each function. An
    encoded column left in the batch reads as its int32 codes."""
    enc = E.encoded_ordinals(batch)
    ctx = EvalContext(True, E.eval_columns(batch, enc), batch.num_rows,
                      batch.capacity, device=batch.device) if enc else \
        device_eval_context(batch)
    cap = ctx.capacity
    live = ctx.row_mask()
    part_cols = [eval_as_col(ctx, e) for e in bound_part]
    order_cols = [eval_as_col(ctx, o.child) for o in bound_orders]
    words, n_part = _window_words(
        [RK.key_proxy(c) for c in part_cols],
        [RK.key_proxy(c) for c in order_cols], bound_orders, live)
    perm = RK.radix_sort_pairs(words)
    range_key = None
    if len(order_cols) == 1 and order_cols[0].dtype in RANGE_KEY_TYPES:
        oc = order_cols[0]
        range_key = (oc.data, oc.validity, not bound_orders[0].ascending)
    seg = window_segments(words, perm, live, n_part, range_key)
    outs = []
    for w, b in zip(wexprs, bound_inputs):
        f = w.function
        kind = _function_kind(f)
        out_dt = to_torch(w.data_type)
        if kind in _RANK_KINDS:
            if kind == "shift":
                v = eval_as_col(ctx, b)
                k = f.offset if isinstance(f, Lead) else -f.offset
                data, valid = window_rank_offset(
                    seg, perm, kind, offset=k, values=v.data,
                    validity=v.validity, default=f.default)
            else:
                data, valid = window_rank_offset(
                    seg, perm, kind, n=getattr(f, "n", 0))
        else:
            v = eval_as_col(ctx, b)
            data, valid = window_frame_agg(seg, perm, kind, w.spec.frame,
                                           v.data, v.validity, out_dt)
        if data.dtype != out_dt:
            data = data.to(out_dt)
        outs.append(ColumnVector(w.data_type, data, valid))
    return outs


class TpuWindowExec(_WindowBase, TpuExec):
    placement = "tpu"

    def _encoded_plan(self, batch: ColumnarBatch, bound) -> tuple:
        """(rank_ords, mat_ords) of one batch (reference :313): encoded
        columns used only as bare partition-by / order-by references stay
        codes in rank space; function inputs, computed spec expressions
        and a finite RANGE frame's order column decode."""
        enc = set(E.encoded_ordinals(batch))
        if not enc:
            return frozenset(), ()
        bound_part, bound_orders, wexprs, inputs = bound

        def bare(e):
            return e.ordinal if isinstance(e, BoundReference) and \
                e.ordinal in enc else None

        def refs(e):
            return {r.ordinal for r in e.collect(
                lambda x: isinstance(x, BoundReference))} & enc

        finite_range = any(
            w.spec.frame.frame_type == "range"
            and (w.spec.frame.lower not in (UNBOUNDED, 0)
                 or w.spec.frame.upper not in (UNBOUNDED, 0))
            for w in wexprs)
        rank, mat = set(), set()
        for e in bound_part:
            o = bare(e)
            if o is not None:
                rank.add(o)
            else:
                mat.update(refs(e))
        for so in bound_orders:
            o = bare(so.child)
            if o is not None:
                (mat if finite_range else rank).add(o)
            else:
                mat.update(refs(so.child))
        for b in inputs:
            if b is not None:
                mat.update(refs(b))
        return frozenset(rank - mat), tuple(sorted(mat))

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        plain = self._bound()
        by_rank = {frozenset(): plain}

        def window_partition(pidx: int):
            for batch in child_pb.iterator(pidx):
                n = batch.host_rows()
                if n == 0:
                    continue
                batch = ensure_compact(batch)
                rank_ords, mat_ords = self._encoded_plan(batch, plain)
                batch = E.batch_with_materialized(batch, mat_ords)
                if rank_ords:
                    batch = E.batch_to_rank_space(batch, rank_ords)
                    M.record_order_preserving_sort()
                    M.add_node_metric(self.metrics,
                                      M.ORDER_PRESERVING_SORTS, 1)
                if rank_ords not in by_rank:
                    by_rank[rank_ords] = self._bound(rank_ords)
                outs = window_columns(batch, *by_rank[rank_ords])
                yield ColumnarBatch(list(batch.columns) + outs, n)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, window_partition(p)))


# ===========================================================================
# CPU oracle (reference :630-916)
# ===========================================================================
class CpuWindowExec(_WindowBase, CpuExec):
    placement = "cpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        from spark_rapids_tpu_torch.shuffle.exchange import _order_key

        child_pb = self.children[0].execute(ctx)
        bound_part, bound_orders, wexprs, bound_inputs = self._bound()

        def window_partition(pidx: int):
            for batch in child_pb.iterator(pidx):
                if batch.num_rows == 0:
                    continue
                n = batch.num_rows
                evald = cpu_project(
                    bound_part + [o.child for o in bound_orders] +
                    [b for b in bound_inputs if b is not None],
                    batch, partition_id=pidx)
                np_ = len(bound_part)
                no = len(bound_orders)
                pcols = evald.columns[:np_]
                ocols = evald.columns[np_:np_ + no]
                icols_iter = iter(evald.columns[np_ + no:])
                icols = [next(icols_iter) if b is not None else None
                         for b in bound_inputs]

                def pkey(i):
                    return tuple(
                        (None if not c.validity[i] else _canon(c.data[i]))
                        for c in pcols)

                def okey(i):
                    return tuple(
                        _order_key(None if not c.validity[i]
                                   else _as_py(c.data[i]), o)
                        for c, o in zip(ocols, bound_orders))

                oval = None
                if len(bound_orders) == 1 and ocols:
                    dt = ocols[0].dtype
                    if dt not in (DataType.STRING, DataType.BOOL) and \
                            not dt.is_decimal:
                        oc = ocols[0]
                        sign = 1 if bound_orders[0].ascending else -1

                        def oval(r, _c=oc, _s=sign):
                            if not _c.validity[r]:
                                return None
                            v = _as_py(_c.data[r])
                            if isinstance(v, float) and v != v:
                                return None
                            return _s * v

                groups: Dict[tuple, List[int]] = {}
                order_seen: List[tuple] = []
                for i in range(n):
                    k = pkey(i)
                    if k not in groups:
                        order_seen.append(k)
                    groups.setdefault(k, []).append(i)
                results = [[None] * n for _ in wexprs]
                for k in order_seen:
                    rows = sorted(groups[k], key=okey)
                    for wi, (w, icol) in enumerate(zip(wexprs, icols)):
                        vals = _cpu_window_rows(w, rows, okey, icol, oval)
                        for r, v in zip(rows, vals):
                            results[wi][r] = v
                new_cols = list(batch.columns)
                for w, res in zip(wexprs, results):
                    npdt = w.data_type.to_np()
                    data = np.zeros(n, dtype=npdt)
                    validity = np.zeros(n, dtype=bool)
                    for i, v in enumerate(res):
                        if v is not None:
                            data[i] = v
                            validity[i] = True
                    new_cols.append(
                        HostColumnVector(w.data_type, data, validity))
                yield HostColumnarBatch(new_cols, n)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, window_partition(p)))


def _canon(v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float):
        if v != v:
            return ("NaN",)
        return 0.0 if v == 0.0 else v
    return v


def _as_py(v):
    return v.item() if isinstance(v, np.generic) else v


def _cpu_window_rows(w: WindowExpression, rows: List[int], okey, icol,
                     oval=None):
    """One window expression over one sorted partition (reference
    :806)."""
    f = w.function
    frame = w.spec.frame
    n = len(rows)
    okeys = [okey(r) for r in rows]
    okvals = [oval(r) for r in rows] if oval is not None else None

    def in_vals():
        return [(_as_py(icol.data[r]) if icol.validity[r] else None)
                for r in rows]

    if isinstance(f, RowNumber):
        return list(range(1, n + 1))
    if isinstance(f, Rank):
        out = []
        for i in range(n):
            first = i
            while first > 0 and okeys[first - 1] == okeys[i]:
                first -= 1
            out.append(first + 1)
        return out
    if isinstance(f, DenseRank):
        out = []
        rank = 0
        for i in range(n):
            if i == 0 or okeys[i] != okeys[i - 1]:
                rank += 1
            out.append(rank)
        return out
    if isinstance(f, NTile):
        return [i * f.n // max(n, 1) + 1 for i in range(n)]
    if isinstance(f, (Lag, Lead)):
        vals = in_vals()
        k = f.offset if isinstance(f, Lead) else -f.offset
        return [vals[i + k] if 0 <= i + k < n else f.default
                for i in range(n)]
    if isinstance(f, AggregateFunction):
        vals = in_vals()
        out = []
        for i in range(n):
            if frame.frame_type == "range":
                window = _cpu_range_window(frame, i, n, vals, okeys, okvals)
            else:
                lo = 0 if frame.lower is UNBOUNDED else max(0, i + frame.lower)
                hi = n - 1 if frame.upper is UNBOUNDED else \
                    min(n - 1, i + frame.upper)
                window = [vals[j] for j in range(lo, hi + 1)] \
                    if hi >= lo else []
            out.append(_reduce_window(f, window))
        return out
    raise NotImplementedError(type(f).__name__)


def _cpu_range_window(frame, i: int, n: int, vals, okeys, okvals):
    """RANGE frame of row i (reference :860): value distance over the one
    numeric order key; a NULL-keyed row frames its (null) peer group."""
    lo_b, hi_b = frame.lower, frame.upper
    if lo_b is UNBOUNDED and hi_b is UNBOUNDED:
        return list(vals)
    finite = (lo_b is not UNBOUNDED and lo_b != 0) or \
        (hi_b is not UNBOUNDED and hi_b != 0)
    if not finite:
        lo = 0
        if lo_b == 0:
            lo = i
            while lo > 0 and okeys[lo - 1] == okeys[i]:
                lo -= 1
        hi = n - 1
        if hi_b == 0:
            hi = i
            while hi + 1 < n and okeys[hi + 1] == okeys[i]:
                hi += 1
        return [vals[j] for j in range(lo, hi + 1)]
    if okvals is None:
        raise NotImplementedError(
            "bounded range frame requires exactly ONE numeric ORDER BY "
            "column")
    ki = okvals[i]
    if ki is None:
        return [vals[j] for j in range(n) if okeys[j] == okeys[i]]
    if lo_b is UNBOUNDED:
        lo = 0
    elif lo_b == 0:
        lo = i
        while lo > 0 and okeys[lo - 1] == okeys[i]:
            lo -= 1
    else:
        lo = None
        for j in range(n):
            if okvals[j] is not None and okvals[j] >= ki + lo_b:
                lo = j
                break
        if lo is None:
            return []
    if hi_b is UNBOUNDED:
        hi = n - 1
    elif hi_b == 0:
        hi = i
        while hi + 1 < n and okeys[hi + 1] == okeys[i]:
            hi += 1
    else:
        hi = None
        for j in range(n - 1, -1, -1):
            if okvals[j] is not None and okvals[j] <= ki + hi_b:
                hi = j
                break
        if hi is None:
            return []
    return [vals[j] for j in range(lo, hi + 1)] if hi >= lo else []


def _reduce_window(f: AggregateFunction, window: List):
    nn = [v for v in window if v is not None]
    if isinstance(f, Count):
        return len(nn)
    if not nn:
        return None
    if isinstance(f, Sum):
        s = 0
        for v in nn:
            s += v
        if isinstance(s, int):
            s = ((s + (1 << 63)) % (1 << 64)) - (1 << 63)
        return s
    if isinstance(f, Min):
        out = nn[0]
        for v in nn[1:]:
            out = v if _lt(v, out) else out
        return out
    if isinstance(f, Max):
        out = nn[0]
        for v in nn[1:]:
            out = v if _lt(out, v) else out
        return out
    if isinstance(f, Average):
        return float(sum(float(v) for v in nn)) / len(nn)
    raise NotImplementedError(type(f).__name__)


def _lt(a, b):
    # NaN greater than everything (Spark float ordering)
    if isinstance(a, float) and a != a:
        return False
    if isinstance(b, float) and b != b:
        return True
    return a < b
