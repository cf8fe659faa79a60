"""Row-key kernels of the group-by: sort, dense group ids, segment reductions.

Port of spark_rapids_tpu/exec/rowkeys.py. This module holds six of the
port's hand-written CUDA kernels, each beside its plain PyTorch version:

- K1 `radix_sort_pairs` (csrc/radix_sort.cu) replaces `_multi_key_sort`
  (rowkeys.py:220) as `group_sort_permutation_masked` (:258) reaches it:
  `sort_words` builds the operands, K1 sorts them;
- K2 `group_ids` (csrc/group_ids.cu) replaces `group_ids_masked` (:309)
  with `_neighbor_differs` (:269);
- K3 `segment_reduce` (csrc/segment_reduce.cu) replaces `segment_reduce`
  (:434) with `_sorted_group_totals` / `_sorted_segment_reduce` (:371-431),
  its `any` and BOOL min / max lanes (:528-616) and its first / last
  branch (:641-672);
- K47 `segment_arg_extreme_string` (csrc/string_arg_extreme.cu) replaces
  `segment_arg_extreme_string` (:177) with `_string_chunk_keys` (:142):
  each group's row of its smallest / largest non-null string;
- K19 `segment_percentile` (csrc/segment_percentile.cu) replaces its
  `pct:<p>` branch (:480-523): K1 sorts (group, null flag, value order
  bits), K19 finds each group's valid run and interpolates;
- K6 `string_order_words` (csrc/string_order.cu) replaces
  `string_order_proxy` (:108) with `_string_chunk_keys` (:142): the order
  words of a STRING sort key.

A STRING group key groups on K5's hash words plus its length
(`key_proxy`, reference :91-93; ops/hashing.py holds K5). `sort_words` takes
per-key `(ascending, nulls_first)` directions (`sort_permutation`, :231): a
descending word is 0xFFFFFFFF - w (the reference's bitwise NOT,
`_invert_order` :214), a NULLS FIRST flag word is 1 - null.

A wrapper given CPU tensors runs the plain version (the CPU tests use it);
given CUDA tensors it launches the kernel or raises — there is no fallback.

Key words. The reference sorts once over [pad flag, null flag, key proxy...]
with one lax.sort. Here every operand becomes one or two uint32 words, most
significant first, held in int64 tensors with values in [0, 2^32) (torch has
no unsigned arithmetic): int64 -> (high word with the sign bit flipped, low
word); narrower integers -> value + 2^31; floats -> order bits, where -0.0
equals 0.0 and all NaNs are one value above +inf; a null lane's data word is
0. The pad flag and the first key's null flag share the first word. Sorting
the words lexicographically and stably gives the reference's permutation
exactly, so group ids, representative rows and output order all match.

The TPU-only two-lane int64 cumsum (`_cumsum_wrap_lanes`, rowkeys.py:359) is
not ported: the card sums int64 natively.
"""

from __future__ import annotations

import ctypes
from typing import Any, List, NamedTuple, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.values import ColV

M32 = 0xFFFFFFFF
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_LOW63 = _I64_MAX
_I32_MAX = (1 << 31) - 1


class KeyProxy(NamedTuple):
    """Order-preserving uint32 words (int64 tensors) of one key column."""

    arrays: Tuple[Any, ...]
    null_flag: Any  # bool tensor, True where SQL NULL
    orderable: bool


def _canonical_float(data):
    """-0.0 -> 0.0 and every NaN -> the canonical quiet NaN."""
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    f = torch.where(data == 0, zero, data)
    return torch.where(torch.isnan(f),
                       torch.full((), float("nan"), dtype=data.dtype,
                                  device=data.device), f)


def _float_order_bits(data):
    """Total-order key of a float tensor as int64 (reference:
    rowkeys.py:62). float32 -> the uint32 order bits (in [0, 2^32));
    float64 -> the uint64 order bits with the top bit flipped, which orders
    the same as a signed int64."""
    f = _canonical_float(data)
    if data.dtype == torch.float64:
        bits = f.view(torch.int64)
        return torch.where(bits < 0, bits ^ _LOW63, bits)
    bits = f.to(torch.float32).view(torch.int32).to(torch.int64) & M32
    return torch.where(bits >= (1 << 31), (~bits) & M32, bits | (1 << 31))


def _float_from_order_bits(key, dtype):
    """Inverse of _float_order_bits (modulo -0.0/NaN canonicalization)."""
    if dtype == torch.float64:
        return torch.where(key < 0, key ^ _LOW63, key).view(torch.float64)
    bits = torch.where(key >= (1 << 31), key ^ (1 << 31), (~key) & M32)
    return _u32_to_i32(bits).view(torch.float32)


def _u32_to_i32(w):
    """int64 values in [0, 2^32) -> the int32 tensor of the same bits."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def key_proxy(col: ColV) -> KeyProxy:
    """Null lanes are canonicalized so all SQL NULLs compare equal whatever
    data the producing kernel left behind (reference: rowkeys.py:83)."""
    dt = col.dtype
    data, valid = col.data, col.validity
    zero = torch.zeros((), dtype=torch.int64, device=data.device)
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        key = _float_order_bits(data)
        if data.dtype == torch.float64:
            # signed-comparable key back to the uint64 order bits' words
            u = key ^ _I64_MIN
            words = (((u >> 32) & M32), u & M32)
        else:
            words = (key,)
        return KeyProxy(tuple(torch.where(valid, w, zero) for w in words),
                        ~valid, True)
    if dt is DataType.STRING:
        from spark_rapids_tpu_torch.ops.hashing import string_hash_words

        words = string_hash_words(col.offsets, col.data, valid)
        return KeyProxy(tuple(words), ~valid, False)
    x = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                             device=data.device))
    if dt is DataType.BOOL:
        return KeyProxy((x.to(torch.int64),), ~valid, True)
    x = x.to(torch.int64)
    if data.dtype == torch.int64:
        hi = ((x >> 32) & M32) ^ (1 << 31)
        return KeyProxy((hi, x & M32), ~valid, True)
    return KeyProxy((x + (1 << 31),), ~valid, True)


# ---------------------------------------------------------------------------
# K6: string order words
# ---------------------------------------------------------------------------
def string_chunks_needed(col) -> int:
    """Pow2-bucketed count of 8-byte chunks covering the column's longest
    string (reference: rowkeys.py:155), from its host-known max_len bound,
    so the sort needs no device sync."""
    chunks = max(1, -(-int(col.max_len) // 8))
    return 1 << (chunks - 1).bit_length()


def string_chunk_words(col) -> int:
    """uint32 chunk words of a string sort key: 1 for max_len <= 4, 2 for
    <= 8 (the reference's uint32 chunks), else two per uint64 chunk."""
    if col.max_len <= 4:
        return 1
    if col.max_len <= 8:
        return 2
    return 2 * string_chunks_needed(col)


def string_order_words_plain(offsets, data, validity, n_chunk_words: int):
    """int64 [n_chunk_words + 1, n]: big-endian chunks, then the byte
    length; 0 at NULL rows (reference: string_order_proxy with
    strings.py:_chunk_u32 up to two words, else _chunk_u64 split into its
    high and low words)."""
    from spark_rapids_tpu_torch.columnar.strings import _chunk_u32, _chunk_u64

    starts = offsets[:-1].long()
    zero = torch.zeros((), dtype=torch.int64, device=starts.device)
    lens = torch.where(validity, (offsets[1:] - offsets[:-1]).long(), zero)
    if n_chunk_words <= 2:
        words = [_chunk_u32(data, starts + 4 * k, (lens - 4 * k).clamp(min=0))
                 for k in range(n_chunk_words)]
    else:
        words = [w for c in range(n_chunk_words // 2)
                 for w in _chunk_u64(data, starts + 8 * c,
                                     (lens - 8 * c).clamp(min=0))]
    words.append(lens)
    return torch.stack(words)


def string_order_words(offsets, data, validity, n_chunk_words: int):
    """K6: the order words of a string column (values in [0, 2^32) in
    int64). CPU tensors run the plain version, CUDA tensors the kernel."""
    if validity.device.type == "cpu":
        return string_order_words_plain(offsets, data, validity,
                                        n_chunk_words)
    offsets = offsets.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(offsets, data, validity)
    n = int(validity.shape[0])
    words = torch.empty((n_chunk_words + 1, n), dtype=torch.int32,
                        device=validity.device)
    lib = CB.library("string_order")
    rc = lib.srt_string_order_words(
        offsets.data_ptr(), data.data_ptr(), validity.data_ptr(), n,
        n_chunk_words, words.data_ptr(), CB.stream_of(words))
    CB.count_launch("string_order_words")
    CB.check(lib, rc, "string_order_words")
    return words.long() & M32


def string_order_proxy(col: ColV) -> KeyProxy:
    """ORDERABLE string proxy (reference: rowkeys.py:108): K6's chunk
    words and length, exact because the chunks cover max_len."""
    words = string_order_words(col.offsets, col.data, col.validity,
                               string_chunk_words(col))
    return KeyProxy(tuple(words), ~col.validity, True)


def _invert_order(w):
    """Order-reversing transform of a uint32 word (reference:
    rowkeys.py:214 applies bitwise NOT at each operand's width; NOT of
    every word of a key reverses its lexicographic order the same way)."""
    return M32 - w


def sort_words(proxies: Sequence[KeyProxy], valid_mask, directions=None):
    """[n_words, capacity] int64 words of a sort, most significant first:
    (pad << 1 | null word of key 0), key 0's words, null word of key 1, key
    1's words, ... — the reference's operand order (rowkeys.py:231, :262).
    `directions[i] = (ascending, nulls_first)`; None (the group sort)
    keeps every word as is, with the null flag as the null word."""
    pad = (~valid_mask).to(torch.int64)
    if not proxies:
        return pad[None, :]
    words = []
    for i, p in enumerate(proxies):
        nf = p.null_flag.to(torch.int64)
        arrays = list(p.arrays)
        if directions is not None:
            ascending, nulls_first = directions[i]
            assert p.orderable, "sort on an equality-only key proxy"
            if nulls_first:
                nf = 1 - nf
            if not ascending:
                arrays = [_invert_order(a) for a in arrays]
        words.append(pad * 2 + nf if i == 0 else nf)
        words.extend(arrays)
    return torch.stack(words)


def sort_permutation(proxies: Sequence[KeyProxy], directions, num_rows,
                     capacity: int):
    """Stable lexicographic sort permutation (int32 [capacity]) with
    per-key (ascending, nulls_first); pads last (reference:
    rowkeys.py:231). K1 sorts the direction words."""
    dev = proxies[0].null_flag.device
    valid = torch.arange(capacity, device=dev) < num_rows
    return radix_sort_pairs(sort_words(proxies, valid, directions))


# ---------------------------------------------------------------------------
# K1: stable lexicographic sort
# ---------------------------------------------------------------------------
def radix_sort_pairs_plain(words):
    """Stable lexicographic permutation by repeated stable argsort, least
    significant word first."""
    n = words.shape[1]
    perm = torch.arange(n, device=words.device)
    for w in range(words.shape[0] - 1, -1, -1):
        idx = torch.sort(words[w][perm], stable=True).indices
        perm = perm[idx]
    return perm.to(torch.int32)


def radix_sort_pairs(words):
    """int32 [capacity]: the stable lexicographic order of the rows of an
    int64 [n_words, capacity] word matrix (values in [0, 2^32))."""
    if words.device.type == "cpu":
        return radix_sort_pairs_plain(words)
    w32 = _u32_to_i32(words).contiguous()
    CB.require_cuda(w32)
    n_words, n = int(w32.shape[0]), int(w32.shape[1])
    lib = CB.library("radix_sort")
    scratch = torch.empty(int(lib.srt_radix_sort_scratch_bytes(n_words, n)),
                          dtype=torch.uint8, device=w32.device)
    perm = torch.empty(n, dtype=torch.int32, device=w32.device)
    rc = lib.srt_radix_sort_pairs(
        w32.data_ptr(), n_words, n, perm.data_ptr(), scratch.data_ptr(),
        scratch.numel(), CB.stream_of(w32))
    CB.count_launch("radix_sort_pairs")
    CB.check(lib, rc, "radix_sort_pairs")
    return perm


# ---------------------------------------------------------------------------
# K2: dense group ids
# ---------------------------------------------------------------------------
class GroupInfo(NamedTuple):
    """Everything a segment reduction needs (reference: rowkeys.py:282)."""

    gid: Any         # int32 [capacity]; group id per row; pads -> capacity
    num_groups: Any  # int32 0-dim device tensor
    rep_rows: Any    # int32 [capacity]; first sorted member of each group
    order: Any = None       # int32 [capacity]; the group-sort permutation
    gid_sorted: Any = None  # int32 [capacity]; group id per sorted position
    seg_ends: Any = None    # int32 [capacity]; last sorted position per group


def group_ids_plain(words, order, valid_mask):
    n = order.shape[0]
    dev = order.device
    o = order.long()
    valid_sorted = valid_mask[o]
    ws = words[:, o]
    diff = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        diff[1:] = (ws[:, 1:] != ws[:, :-1]).any(0)
    boundary = diff & valid_sorted
    incl = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32)
    cap = torch.full((), n, dtype=torch.int32, device=dev)
    gid_sorted = torch.where(valid_sorted, incl - 1, cap)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    gid[o] = gid_sorted
    num_groups = boundary.sum(dtype=torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    rep = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    rep.scatter_(0, torch.where(boundary, gid_sorted, cap).long(),
                 order.to(torch.int32))
    nxt = torch.cat([gid_sorted[1:], cap.reshape(1)])
    is_end = (gid_sorted != nxt) & (gid_sorted < n)
    ends = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    ends.scatter_(0, torch.where(is_end, gid_sorted, cap).long(), pos)
    return gid, gid_sorted, rep[:n], ends[:n], num_groups


def group_ids(words, order, valid_mask):
    """(gid, gid_sorted, rep_rows, seg_ends, num_groups) from the sort's
    words and permutation."""
    if order.device.type == "cpu":
        return group_ids_plain(words, order, valid_mask)
    w32 = _u32_to_i32(words).contiguous()
    valid = valid_mask.contiguous()
    CB.require_cuda(w32, order, valid)
    n_words, n = int(w32.shape[0]), int(w32.shape[1])
    dev = order.device
    lib = CB.library("group_ids")
    scratch = torch.empty(int(lib.srt_group_ids_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    gid_sorted = torch.empty(n, dtype=torch.int32, device=dev)
    rep = torch.empty(n, dtype=torch.int32, device=dev)
    ends = torch.empty(n, dtype=torch.int32, device=dev)
    num_groups = torch.zeros((), dtype=torch.int32, device=dev)
    rc = lib.srt_group_ids(
        w32.data_ptr(), n_words, n, order.data_ptr(), valid.data_ptr(),
        gid.data_ptr(), gid_sorted.data_ptr(), rep.data_ptr(),
        ends.data_ptr(), num_groups.data_ptr(), scratch.data_ptr(),
        scratch.numel(), CB.stream_of(order))
    CB.count_launch("group_ids")
    CB.check(lib, rc, "group_ids")
    return gid, gid_sorted, rep, ends, num_groups


def keyless_group_info(valid_mask, capacity: int) -> GroupInfo:
    """The one group of an aggregate without keys (reference:
    aggregate.py:923-928): gid 0 for every live row, num_groups =
    min(live rows, 1), no sort. The identity order with every position in
    group 0 lets K3 reduce it; dead rows are masked out of its inputs."""
    dev = valid_mask.device
    cap = torch.full((), capacity, dtype=torch.int32, device=dev)
    gid = torch.where(valid_mask, torch.zeros((), dtype=torch.int32,
                                              device=dev), cap)
    num_groups = torch.clamp(valid_mask.sum(dtype=torch.int32), max=1)
    zeros = torch.zeros(capacity, dtype=torch.int32, device=dev)
    seg_ends = zeros.clone()
    seg_ends[0] = capacity - 1
    order = torch.arange(capacity, dtype=torch.int32, device=dev)
    return GroupInfo(gid, num_groups, zeros, order, zeros, seg_ends)


def group_ids_masked(proxies: Sequence[KeyProxy], valid_mask,
                     capacity: int) -> GroupInfo:
    """Dense group ids of the rows under valid_mask (reference:
    rowkeys.py:309)."""
    if not proxies:
        return keyless_group_info(valid_mask, capacity)
    words = sort_words(proxies, valid_mask)
    order = radix_sort_pairs(words)
    gid, gid_sorted, rep, ends, num_groups = group_ids(words, order,
                                                       valid_mask)
    return GroupInfo(gid, num_groups, rep, order, gid_sorted, ends)


# ---------------------------------------------------------------------------
# K3: segment reductions
# ---------------------------------------------------------------------------
_OPS = {"count": 0, "sum": 1, "min": 2, "max": 3, "first": 4, "last": 5,
        "first_ignore_nulls": 6, "last_ignore_nulls": 7, "any": 8}
_SELECT_OPS = ("first", "last", "first_ignore_nulls", "last_ignore_nulls")
_DTS = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3,
        torch.bool: 4}


class _SegCol(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("acc", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("out_valid", ctypes.c_void_p), ("nonnull", ctypes.c_void_p),
                ("head", ctypes.c_void_p), ("tail", ctypes.c_void_p),
                ("op", ctypes.c_int32), ("dtype", ctypes.c_int32)]


def _int_ident(dtype, op):
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _reduce_input(op, data):
    """Kernel-side dtype of an aggregate input: sums of any integer type
    accumulate in int64 (SQL sum over integral is LONG); narrow integer
    min/max ride int32 lanes and convert back."""
    if op == "count" or op in _SELECT_OPS:
        return data
    if op == "any":
        # the per-group OR of each row's truth (reference: astype(bool))
        return data if data.dtype == torch.bool else data != 0
    if data.dtype == torch.bool:
        if op == "sum":
            raise TypeError("boolean sum is not a device reduction")
        return data
    if data.dtype in (torch.int8, torch.int16, torch.uint8):
        return data.to(torch.int64 if op == "sum" else torch.int32)
    if op == "sum" and data.dtype == torch.int32:
        return data.to(torch.int64)
    return data


def _select_plain(op, data, validity, gid, capacity: int):
    """first / last: the value and validity at each group's least / greatest
    row position, over its valid rows only for _ignore_nulls (reference:
    rowkeys.py:657-671)."""
    dev = validity.device
    consider = gid < capacity
    if op.endswith("ignore_nulls"):
        consider = consider & validity
    pos = torch.arange(gid.shape[0], dtype=torch.int64, device=dev)
    seg = torch.where(consider, gid, torch.full((), capacity,
                                                dtype=torch.int64,
                                                device=dev))
    if op.startswith("first"):
        sel = torch.full((capacity + 1,), capacity, dtype=torch.int64,
                         device=dev)
        sel.scatter_reduce_(0, seg, torch.where(consider, pos, capacity),
                            "amin")
    else:
        sel = torch.full((capacity + 1,), -1, dtype=torch.int64, device=dev)
        sel.scatter_reduce_(0, seg, torch.where(consider, pos, -1), "amax")
    sel = sel[:capacity]
    has = (sel >= 0) & (sel < capacity)
    safe = sel.clamp(0, capacity - 1)
    out = torch.where(has, data[safe], torch.zeros((), dtype=data.dtype,
                                                   device=dev))
    return out, has & validity[safe]


def segment_reduce_plain(op, data, validity, gi: GroupInfo, capacity: int):
    """One reduction by scatter over group ids (the CPU path and the card
    reference of K3)."""
    dev = validity.device
    gid = gi.gid.long()
    if op in _SELECT_OPS:
        return _select_plain(op, data, validity, gid, capacity)
    vmask = validity & (gid < capacity)
    seg = torch.where(vmask, gid, torch.full((), capacity, dtype=torch.int64,
                                             device=dev))
    nonnull = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    nonnull.index_add_(0, seg, torch.ones_like(seg))
    nonnull = nonnull[:capacity]
    if op == "count":
        return nonnull, torch.ones(capacity, dtype=torch.bool, device=dev)
    outv = nonnull > 0
    x = _reduce_input(op, data)
    if op == "sum":
        vals = torch.where(vmask, x, torch.zeros((), dtype=x.dtype,
                                                 device=dev))
        out = torch.zeros(capacity + 1, dtype=x.dtype, device=dev)
        out.index_add_(0, seg, vals)
        out = out[:capacity]
    elif x.dtype == torch.bool:
        # bool lanes as 0 / 1: min is AND, max and any are OR
        ident = 1 if op == "min" else 0
        red = torch.full((capacity + 1,), ident, dtype=torch.int32,
                         device=dev)
        red.scatter_reduce_(0, seg, torch.where(
            vmask, x.to(torch.int32), torch.full((), ident,
                                                 dtype=torch.int32,
                                                 device=dev)),
            "amin" if op == "min" else "amax")
        out = red[:capacity] != 0
    elif x.is_floating_point():
        key = _float_order_bits(x)
        if x.dtype == torch.float64:
            ident = _I64_MAX if op == "min" else _I64_MIN
        else:
            ident = M32 if op == "min" else 0
        red = torch.full((capacity + 1,), ident, dtype=torch.int64,
                         device=dev)
        red.scatter_reduce_(0, seg, torch.where(vmask, key, ident),
                            "amin" if op == "min" else "amax")
        out = _float_from_order_bits(
            torch.where(outv, red[:capacity], torch.zeros(
                (), dtype=torch.int64, device=dev)), x.dtype)
    else:
        ident = _int_ident(x.dtype, op)
        red = torch.full((capacity + 1,), ident, dtype=x.dtype, device=dev)
        red.scatter_reduce_(0, seg, torch.where(
            vmask, x, torch.full((), ident, dtype=x.dtype, device=dev)),
            "amin" if op == "min" else "amax")
        out = red[:capacity]
    out = torch.where(outv, out, torch.zeros((), dtype=out.dtype,
                                             device=dev))
    if op not in ("sum", "any") and out.dtype != data.dtype:
        out = out.to(data.dtype)
    return out, outv


def _segment_reduce_k3(specs, gi: GroupInfo, capacity: int):
    """K3 over the non-percentile specs (one launch for up to its column
    limit)."""
    if gi.order.device.type == "cpu":
        return [segment_reduce_plain(op, d, v, gi, capacity)
                for op, d, v in specs]
    lib = CB.library("segment_reduce")
    if len(specs) > lib.srt_segment_reduce_max_cols():
        half = len(specs) // 2
        return _segment_reduce_k3(specs[:half], gi, capacity) + \
            _segment_reduce_k3(specs[half:], gi, capacity)
    dev = gi.order.device
    chunks = -(-capacity // lib.srt_segment_reduce_chunk())
    descs = (_SegCol * len(specs))()
    keep: List[Any] = []  # tensors referenced by descriptors
    results = []
    for k, (op, data, validity) in enumerate(specs):
        x = _reduce_input(op, data).contiguous()
        valid = validity.contiguous()
        CB.require_cuda(x, valid, gi.order)
        d = descs[k]
        d.op = _OPS[op]
        d.data = x.data_ptr()
        d.valid = valid.data_ptr()
        out_valid = torch.empty(capacity, dtype=torch.bool, device=dev)
        nonnull = torch.zeros(capacity, dtype=torch.int32, device=dev)
        if op in _SELECT_OPS:
            acc = torch.full((capacity,), _I32_MAX if op.startswith("first")
                             else -1, dtype=torch.int32, device=dev)
            out = torch.empty(capacity, dtype=x.dtype, device=dev)
            d.dtype = x.element_size()
        elif op == "count" or (op == "sum" and not x.is_floating_point()):
            acc = out = torch.zeros(capacity, dtype=torch.int64, device=dev)
            d.dtype = _DTS.get(x.dtype, 1)
        elif op == "sum":
            acc = out = torch.zeros(capacity, dtype=x.dtype, device=dev)
            head = torch.empty(chunks, dtype=x.dtype, device=dev)
            tail = torch.empty(chunks, dtype=x.dtype, device=dev)
            d.head, d.tail = head.data_ptr(), tail.data_ptr()
            keep += [head, tail]
            d.dtype = _DTS[x.dtype]
        elif x.dtype == torch.bool:
            # bool lanes reduce in an int32 accumulator (min: AND, from 1)
            acc = torch.full((capacity,), 1 if op == "min" else 0,
                             dtype=torch.int32, device=dev)
            out = torch.empty(capacity, dtype=torch.bool, device=dev)
            d.dtype = _DTS[x.dtype]
        elif x.is_floating_point():
            bits = torch.int64 if x.dtype == torch.float64 else torch.int32
            acc = torch.full((capacity,), -1 if op == "min" else 0,
                             dtype=bits, device=dev)
            out = torch.empty(capacity, dtype=x.dtype, device=dev)
            d.dtype = _DTS[x.dtype]
        else:
            acc = out = torch.full((capacity,), _int_ident(x.dtype, op),
                                   dtype=x.dtype, device=dev)
            d.dtype = _DTS[x.dtype]
        d.acc, d.out = acc.data_ptr(), out.data_ptr()
        d.out_valid, d.nonnull = out_valid.data_ptr(), nonnull.data_ptr()
        keep += [x, valid, acc, out, out_valid, nonnull]
        results.append((op, data.dtype, out, out_valid))
    rc = lib.srt_segment_reduce(
        ctypes.addressof(descs), len(specs), capacity, gi.order.data_ptr(),
        gi.gid_sorted.data_ptr(), gi.seg_ends.data_ptr(),
        gi.num_groups.data_ptr(), CB.stream_of(gi.order))
    CB.count_launch("segment_reduce")
    CB.check(lib, rc, "segment_reduce")
    return [(out.to(dt) if op in ("min", "max") and out.dtype != dt else out,
             ov) for op, dt, out, ov in results]


def segment_reduce_many(specs, gi: GroupInfo, capacity: int):
    """Reduce several (op, data, validity) columns per group with SQL null
    semantics; returns [(out [capacity], out_valid [capacity])]. Slot g
    holds group g; all-null groups are NULL with 0 data, count is never
    NULL, slots at or above num_groups are 0. count / sum / min / max /
    first / last go to K3; each `pct:<p>` op to K19 on its own (a caller
    with several fractions of one input calls segment_percentile once
    with all of them, sharing the sort)."""
    if not specs:
        return []
    out: List[Any] = [None] * len(specs)
    rest = []
    for i, (op, data, validity) in enumerate(specs):
        if op == "unmergeable":
            raise AssertionError(
                "holistic aggregate reached a merge stage — the planner "
                "must run it complete-mode over a single batch")
        if op.startswith("pct:"):
            out[i] = segment_percentile(data, validity, gi.gid, capacity,
                                        [float(op[4:])])[0]
        else:
            rest.append(i)
    if rest:
        for i, r in zip(rest, _segment_reduce_k3([specs[i] for i in rest],
                                                 gi, capacity)):
            out[i] = r
    return out


def segment_reduce(op: str, data, validity, gid, num_rows, capacity: int):
    """Reference signature (rowkeys.py:434): one reduction over a
    GroupInfo with sort fields."""
    if not isinstance(gid, GroupInfo) or gid.order is None:
        raise NotImplementedError("segment_reduce needs a GroupInfo with "
                                  "its sort fields")
    return segment_reduce_many([(op, data, validity)], gid, capacity)[0]


# ---------------------------------------------------------------------------
# K47: string arg-extreme
# ---------------------------------------------------------------------------
def segment_arg_extreme_string_plain(offsets, data, validity, gid,
                                     capacity: int, want_min: bool):
    """int32 [capacity]: per group, the row of its smallest (want_min) or
    largest non-null string, ties to the lowest row, `capacity` for a group
    without one (reference: rowkeys.py:177): the candidate rows are refined
    by each big-endian 8-byte chunk word (as two uint32 halves), then by
    the length, then the lowest row wins."""
    from spark_rapids_tpu_torch.columnar.strings import _chunk_u64

    dev = validity.device
    n = int(gid.shape[0])
    gid = gid.long()
    mask = validity[:n] & (gid < capacity)
    starts = offsets[:n].long()
    lens = (offsets[1:n + 1] - offsets[:n]).long()
    longest = int(torch.where(mask, lens, 0).max()) if n else 0
    keys = []
    for c in range(max(1, -(-longest // 8))):
        keys += list(_chunk_u64(data, starts + 8 * c,
                                (lens - 8 * c).clamp(min=0)))
    keys.append(lens)
    safe = gid.clamp(0, capacity - 1)
    top, bot = (1 << 32), -1
    for key in keys:
        seg = torch.where(mask, gid, capacity)
        best = torch.full((capacity + 1,), top if want_min else bot,
                          dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, seg, torch.where(mask, key, best[capacity]),
                             "amin" if want_min else "amax")
        mask = mask & (key == best[safe])
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    sel = torch.full((capacity + 1,), capacity, dtype=torch.int64,
                     device=dev)
    sel.scatter_reduce_(0, torch.where(mask, gid, capacity),
                        torch.where(mask, pos, capacity), "amin")
    return sel[:capacity].to(torch.int32)


def segment_arg_extreme_string(offsets, data, validity, gi: GroupInfo,
                               capacity: int, want_min: bool):
    """K47: segment_arg_extreme_string_plain's rows in two launches over
    the group-by's sorted order (csrc/string_arg_extreme.cu). CPU tensors
    run the plain version, CUDA tensors the kernel."""
    if validity.device.type == "cpu":
        return segment_arg_extreme_string_plain(offsets, data, validity,
                                                gi.gid, capacity, want_min)
    offsets = offsets.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(offsets, data, validity, gi.order, gi.gid_sorted,
                    gi.seg_ends, gi.num_groups)
    dev = validity.device
    lib = CB.library("string_arg_extreme")
    chunks = max(1, -(-capacity // lib.srt_arg_extreme_chunk()))
    out = torch.empty(capacity, dtype=torch.int32, device=dev)
    head = torch.empty(chunks, dtype=torch.int32, device=dev)
    tail = torch.empty(chunks, dtype=torch.int32, device=dev)
    rc = lib.srt_segment_arg_extreme_string(
        offsets.data_ptr(), data.data_ptr(), validity.data_ptr(), capacity,
        gi.order.data_ptr(), gi.gid_sorted.data_ptr(),
        gi.seg_ends.data_ptr(), gi.num_groups.data_ptr(), int(want_min),
        out.data_ptr(), head.data_ptr(), tail.data_ptr(),
        CB.stream_of(out))
    CB.count_launch("segment_arg_extreme_string")
    CB.check(lib, rc, "segment_arg_extreme_string")
    return out


# ---------------------------------------------------------------------------
# K19: exact percentiles
# ---------------------------------------------------------------------------
def percentile_sort_words(data, validity, gid, capacity: int):
    """[3, capacity] int64 words of the percentile sort (reference:
    rowkeys.py:486-491, lax.sort over (gid with pads at capacity, ~valid,
    value order bits)): gid * 2 + null flag, then the float64 order bits'
    high and low words (0 at NULL rows, which sort after the group's
    values in row order either way)."""
    gid = gid.long()
    in_group = gid < capacity
    vmask = validity & in_group
    g = torch.where(in_group, gid, torch.full((), capacity,
                                              dtype=torch.int64,
                                              device=gid.device))
    proxy = key_proxy(ColV(DataType.FLOAT64, data.to(torch.float64), vmask))
    return torch.stack([g * 2 + (~vmask).to(torch.int64), *proxy.arrays])


def segment_percentile_plain(data, validity, gid, capacity: int, ps,
                             order=None):
    """[(out float64 [capacity], valid [capacity])] per fraction p: linear
    interpolation at rank p * (cnt - 1) over each group's sorted valid
    values, as the reference computes it (rowkeys.py:492-522; every product
    rounded on its own)."""
    dev = validity.device
    gid = gid.long()
    in_group = gid < capacity
    vmask = validity & in_group
    if order is None:
        order = radix_sort_pairs_plain(percentile_sort_words(
            data, validity, gid, capacity))
    o = order.long()
    big = torch.full((), capacity, dtype=torch.int64, device=dev)
    seg = torch.where(vmask[o], gid[o], big)
    cnt = torch.bincount(seg, minlength=capacity + 1)[:capacity]
    pos = torch.arange(capacity, dtype=torch.int64, device=dev)
    starts = torch.full((capacity + 1,), capacity, dtype=torch.int64,
                        device=dev)
    starts.scatter_reduce_(0, seg, pos, "amin")
    outv = cnt > 0
    starts = torch.where(outv, starts[:capacity], torch.zeros(
        (), dtype=torch.int64, device=dev))
    c1 = torch.clamp(cnt - 1, min=0).to(torch.float64)
    sv = data.to(torch.float64)[o]
    outs = []
    for p in ps:
        q = p * c1
        fl = torch.floor(q)
        frac = q - fl
        lo = torch.clamp(starts + fl.long(), 0, capacity - 1)
        hi = torch.clamp(lo + (frac > 0).long(), 0, capacity - 1)
        val = sv[lo] * (1 - frac) + sv[hi] * frac
        outs.append((torch.where(outv, val, torch.zeros(
            (), dtype=torch.float64, device=dev)), outv))
    return outs


def segment_percentile(data, validity, gid, capacity: int, ps):
    """K19 (replaces segment_reduce's "pct:<p>", rowkeys.py:480): K1 sorts
    the percentile words, then two launches find each group's valid run
    and interpolate every fraction in `ps`. CPU tensors run the plain
    version, CUDA tensors the kernels."""
    if validity.device.type == "cpu":
        return segment_percentile_plain(data, validity, gid, capacity, ps)
    order = radix_sort_pairs(percentile_sort_words(data, validity, gid,
                                                   capacity))
    return percentile_from_order(order, data, validity, gid, capacity, ps)


def percentile_from_order(order, data, validity, gid, capacity: int, ps):
    """K19's two launches over the permutation of the percentile sort."""
    x = data.to(torch.float64).contiguous()
    valid = (validity & (gid.long() < capacity)).contiguous()
    g32 = gid.to(torch.int32).contiguous()
    CB.require_cuda(order, g32, valid, x)
    lib = CB.library("segment_percentile")
    limit = lib.srt_segment_percentile_max_fractions()
    if len(ps) > limit:
        return percentile_from_order(order, data, validity, gid, capacity,
                                     ps[:limit]) + \
            percentile_from_order(order, data, validity, gid, capacity,
                                  ps[limit:])
    dev = order.device
    starts = torch.empty(capacity, dtype=torch.int32, device=dev)
    ends = torch.empty(capacity, dtype=torch.int32, device=dev)
    outs = [(torch.empty(capacity, dtype=torch.float64, device=dev),
             torch.empty(capacity, dtype=torch.bool, device=dev))
            for _ in ps]
    nf = len(ps)
    c_ps = (ctypes.c_double * nf)(*[float(p) for p in ps])
    c_out = (ctypes.c_void_p * nf)(*[o.data_ptr() for o, _ in outs])
    c_valid = (ctypes.c_void_p * nf)(*[v.data_ptr() for _, v in outs])
    rc = lib.srt_segment_percentile(
        order.data_ptr(), g32.data_ptr(), valid.data_ptr(), x.data_ptr(),
        capacity, starts.data_ptr(), ends.data_ptr(), c_ps, c_out, c_valid,
        nf, CB.stream_of(order))
    CB.count_launch("segment_percentile")
    CB.check(lib, rc, "segment_percentile")
    return outs
