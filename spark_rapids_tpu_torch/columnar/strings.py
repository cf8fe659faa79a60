"""String column helpers (port of the parts of spark_rapids_tpu/columnar/strings.py
that slices 2-4 need, plus the host <-> UTF-8 conversions of the port).

Layout of a device STRING column (as in the reference, batch.py:148-188):
uint8 bytes, int32 offsets [capacity + 1] and bool validity [capacity]; row
i is bytes[offsets[i]:offsets[i + 1]], a NULL row has length 0, and lanes
past the row count repeat the last offset. `max_len` is a host-known power
of two bounding every row's byte length.

- `_chunk_u32` / `_chunk_u64` (reference :104 / :92): big-endian byte
  chunks of each row at an offset, zero past the row's end. They are the
  plain form of kernel K6 (exec/rowkeys.py:string_order_words) and of the
  comparison below.
- `StrView` / `as_view` / `plan_byte_cap` (reference :36 / :50 / :79): a
  string operand as per-row byte spans; a literal is one span aliased by
  every row (stride-0 starts and lengths, no per-row copy).
- K8 `string_compare` (csrc/string_compare.cu) replaces `string_cmp3`
  (:118), `string_equal` (:143) and `string_compare` (:151): a
  lexicographic compare of unsigned bytes, a prefix sorting first. Its
  plain version is the reference's chunk loop (8-byte big-endian chunks,
  compared as two uint32 words in int64, then the lengths). The CPU
  engine compares the decoded Python strings (`_host_cmp`, :158):
  code-point order is UTF-8 byte order.
- K12 `string_search` (csrc/string_search.cu) replaces `starts_with`
  (:353), `ends_with` (:365), `contains` (:377) and the searches of
  `like_match` (:428, with `classify_like` :450): a thread per row
  against a literal needle. Its plain version is the reference's prefix
  and suffix byte gathers and, for CONTAINS, a match at each position of
  the row's own bytes.
- K13 `substring_plan` (csrc/substring.cu) replaces the plan of
  `substring_utf8` (:284): each row's result span, which K7 copies.
- `string_select` / `string_coalesce` (:200 / :220, with
  `build_from_plan` :177): K7 over the sources laid end to end, as
  concat does; a literal is a one-row source.
- `encode_utf8` / `decode_utf8`: the host conversion between object arrays
  of str and (offsets, bytes), vectorised in row chunks through numpy's
  fixed-width strings — no per-row Python loop. numpy's fixed-width
  strings drop trailing NUL characters, so the rows that lost some (their
  fixed-width length is short of their length) convert one by one.

- K17 `string_chars` (csrc/string_chars.cu) replaces `utf8_char_lengths`
  (:260) and `locate` (:542, with `_match_starts` :484): per row the count
  of non-continuation bytes, and the 1-based character position of a
  literal needle's first match at or after a start character. Its plain
  version is the reference's cumsum formulation.

- B15's rest (csrc/string_transform.cu): K37 `case_map` replaces
  `upper_ascii` (:270), `lower_ascii` (:277) and `initcap_ascii` (:620);
  K38 `span_plan` the plans of `trim_spaces` (:397) and `substring_index`
  (:571), in K13's layout, which K7's span entry copies; K39
  `string_replace` replaces `replace_literal` (:499); K40 `string_concat`
  replaces `concat2` (:323) and `concat_ws` (:642). Their plain versions
  are the reference's formulations (searchsorted row ids, segmented sums,
  scatters); the kernels walk each row's own bytes. An output's max_len
  bounds its rows: the sort words read max_len bytes (exec/rowkeys.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.values import ColV, ScalarV

_ROWS_PER_CHUNK = 1 << 20


def len_bucket(n: int) -> int:
    """Power-of-two bound of a byte length (min 1), as the reference's
    `len_bucket` (batch.py:227)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# plain chunk extraction (the K6 plain version's building block)
# ---------------------------------------------------------------------------
def _chunk_be(data, start, remaining, width: int):
    """Up to `width` bytes per row at `start` as a big-endian integer in an
    int64 tensor, zero-padded past the row end."""
    k = torch.arange(width, device=data.device)
    idx = start.long()[:, None] + k[None, :]
    in_range = k[None, :] < remaining.long()[:, None]
    cap = max(int(data.shape[0]), 1)
    safe = idx.clamp(0, cap - 1)
    b = torch.where(in_range, data[safe].long() if data.numel() else
                    torch.zeros_like(safe), torch.zeros((), dtype=torch.int64,
                                                        device=data.device))
    out = torch.zeros(b.shape[0], dtype=torch.int64, device=data.device)
    for j in range(width):
        out = (out << 8) | b[:, j]
    return out


def _chunk_u32(data, start, remaining):
    """4 bytes per row as a big-endian uint32 (int64 values in [0, 2^32))."""
    return _chunk_be(data, start, remaining, 4)


def _chunk_u64(data, start, remaining):
    """8 bytes per row as big-endian (hi, lo) uint32 words: the reference's
    uint64 chunk split into the two words kernel K1 sorts on."""
    hi = _chunk_be(data, start, remaining, 4)
    lo = _chunk_be(data, start + 4, (remaining - 4).clamp(min=0), 4)
    return hi, lo


# ---------------------------------------------------------------------------
# string operands (reference :36-88)
# ---------------------------------------------------------------------------
class StrView(NamedTuple):
    """A string operand as per-row byte spans into one flat buffer; unlike
    offsets, spans may alias (a literal's rows all point at its bytes)."""

    data: torch.Tensor      # uint8 [byte_cap]
    starts: torch.Tensor    # int32 [cap] (stride 0 for a literal)
    lens: torch.Tensor      # int32 [cap] (stride 0 for a literal)
    validity: torch.Tensor  # bool [cap]


def lengths_of(col):
    return col.offsets[1:] - col.offsets[:-1]


def _literal_bytes(s: ScalarV) -> bytes:
    return b"" if s.is_null else s.value.encode("utf-8")


def as_view(ctx, v) -> StrView:
    """Reference :50. A scalar is one span, aliased by every row through
    stride-0 starts and lengths (no per-row copy)."""
    cap = ctx.capacity
    if isinstance(v, ScalarV):
        raw = _literal_bytes(v)
        buf = np.zeros(max(8, len(raw)), dtype=np.uint8)
        buf[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        dev = ctx.device
        one = torch.zeros(1, dtype=torch.int32, device=dev)
        return StrView(torch.from_numpy(buf).to(dev), one.expand(cap),
                       torch.full((1,), len(raw), dtype=torch.int32,
                                  device=dev).expand(cap),
                       torch.full((1,), not v.is_null, dtype=torch.bool,
                                  device=dev).expand(cap))
    return StrView(v.data, v.offsets[:-1], lengths_of(v), v.validity)


def plan_byte_cap(ctx, v) -> int:
    """Output-byte bound one operand contributes (reference :79): a column
    at most its buffer, a scalar its bytes in every row."""
    if isinstance(v, ScalarV):
        return max(8, ctx.capacity * len(_literal_bytes(v)))
    return int(v.data.shape[0])


# ---------------------------------------------------------------------------
# K8: string comparison (reference :118-172)
# ---------------------------------------------------------------------------
_CMP_OPS = {"eq": 0, "lt": 1, "le": 2, "gt": 3, "ge": 4}


def _cmp_result(c, op: str):
    """Bool result of a three-way compare (int tensor of -1/0/1)."""
    return {"eq": c == 0, "lt": c < 0, "le": c <= 0, "gt": c > 0,
            "ge": c >= 0}[op]


def string_cmp3_plain(l: StrView, r: StrView):
    """Three-way lexicographic compare (int8 -1/0/1) of two views: the
    reference's loop over 8-byte big-endian chunks, each chunk compared as
    its high and then its low uint32 word (int64 values; torch has no
    unsigned 64-bit compare), ties broken by length. A row stops at its
    first differing chunk, as the reference's carried result does."""
    ll, rl = l.lens.long(), r.lens.long()
    longest = torch.maximum(ll, rl)
    result = torch.zeros(ll.shape, dtype=torch.int8, device=ll.device)
    pos = 0
    while bool(((result == 0) & (pos < longest)).any()):
        lh, llo = _chunk_u64(l.data, l.starts + pos, (ll - pos).clamp(min=0))
        rh, rlo = _chunk_u64(r.data, r.starts + pos, (rl - pos).clamp(min=0))
        cmp = torch.where(lh != rh, torch.sign(lh - rh),
                          torch.sign(llo - rlo)).to(torch.int8)
        result = torch.where(result == 0, cmp, result)
        pos += 8
    return torch.where(result == 0, torch.sign(ll - rl).to(torch.int8),
                       result)


def string_compare_plain(l: StrView, r: StrView, op: str):
    """bool [cap]: `l op r` where both rows are valid, False elsewhere."""
    if op == "eq":
        out = (l.lens == r.lens) & (string_cmp3_plain(l, r) == 0)
    else:
        out = _cmp_result(string_cmp3_plain(l, r), op)
    return out & l.validity & r.validity


def _stride(t: torch.Tensor) -> int:
    """0 for a view aliased by every row, 1 for a contiguous column."""
    if t.numel() > 1 and t.stride(0) == 0:
        return 0
    if not t.is_contiguous():
        raise ValueError("string view arrays must be contiguous or stride 0")
    return 1


def string_compare_views(l: StrView, r: StrView, op: str):
    """K8 (replaces string_cmp3 / string_equal / string_compare): bool [cap],
    `l op r` on rows where both are valid, False elsewhere. CPU tensors run
    the plain version, CUDA tensors the kernel."""
    if l.lens.device.type == "cpu":
        return string_compare_plain(l, r, op)
    n = int(l.lens.shape[0])
    parts = []
    for v in (l, r):
        CB.require_cuda(v.data)
        parts.append([v.data.data_ptr()])
        for t in (v.starts, v.lens, v.validity):
            if t.device != v.data.device or t.shape[0] != n:
                raise ValueError("string views must share one device and "
                                 "row count")
            parts[-1] += [t.data_ptr(), _stride(t)]
    out = torch.empty(n, dtype=torch.bool, device=l.lens.device)
    lib = CB.library("string_compare")
    rc = lib.srt_string_compare(*parts[0], *parts[1], n, _CMP_OPS[op],
                                out.data_ptr(), CB.stream_of(out))
    CB.count_launch("string_compare")
    CB.check(lib, rc, "string_compare")
    return out


def string_compare(ctx, lv, rv, op: str):
    """Reference :151 (and `string_equal` :143, op "eq"): the device engine
    through K8, the CPU engine over the decoded strings."""
    if not ctx.is_device:
        return _host_cmp(ctx, lv, rv, op)
    return string_compare_views(as_view(ctx, lv), as_view(ctx, rv), op)


def _host_cmp(ctx, lv, rv, op: str):
    """Reference :158, vectorised: numpy's comparison loops over object
    arrays of str (Python's code-point order, which is UTF-8 byte order)."""
    def side(v):
        if isinstance(v, ScalarV):
            return np.array("" if v.is_null else v.value, dtype=object)
        return np.asarray(v.data, dtype=object)

    f = {"eq": np.equal, "lt": np.less, "le": np.less_equal,
         "gt": np.greater, "ge": np.greater_equal}[op]
    out = f(side(lv), side(rv))
    return np.broadcast_to(np.asarray(out, dtype=bool),
                           (ctx.capacity,)).copy()


# ---------------------------------------------------------------------------
# host conversion (vectorised)
# ---------------------------------------------------------------------------
def _to_fixed_bytes(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Object array of str -> (numpy 'S' array of UTF-8 bytes, characters
    each row kept in numpy's fixed-width form: short of the row's length
    where trailing NULs were dropped)."""
    try:
        fixed = values.astype("S")  # ASCII: one C loop
        return fixed, np.char.str_len(fixed).astype(np.int64)
    except UnicodeEncodeError:
        wide = values.astype("U")
        return (np.char.encode(wide, "utf-8"),
                np.char.str_len(wide).astype(np.int64))


def _fixed_rows(values: np.ndarray):
    """(byte matrix [n, width], byte lengths, rows that lost trailing NULs
    and their UTF-8 bytes) of an object array of str."""
    n = len(values)
    fixed, kept = _to_fixed_bytes(values)
    width = fixed.dtype.itemsize
    lens = np.char.str_len(fixed).astype(np.int64) if width else \
        np.zeros(n, np.int64)
    mat = fixed.view(np.uint8).reshape(n, width) if width else \
        np.zeros((n, 0), np.uint8)
    chars = np.fromiter(map(len, values), dtype=np.int64, count=n)
    lost = np.nonzero(kept != chars)[0]
    encoded = [values[i].encode("utf-8") for i in lost]
    for i, e in zip(lost, encoded):
        lens[i] = len(e)
    return mat, lens, lost, encoded


def _gather_rows(mat, lens, lost, encoded, offsets) -> np.ndarray:
    """The bytes of rows laid end to end at `offsets` (int64 [n + 1])."""
    width = mat.shape[1]
    keep = np.arange(width)[None, :] < lens[:, None]
    if not len(lost):
        return mat[keep]
    keep[lost] = False
    out = np.empty(int(offsets[-1] - offsets[0]), np.uint8)
    dest = (offsets[:-1, None] - offsets[0] + np.arange(width)[None, :])
    out[dest[keep]] = mat[keep]
    for i, e in zip(lost, encoded):
        at = int(offsets[i] - offsets[0])
        out[at:at + len(e)] = np.frombuffer(e, np.uint8)
    return out


def encode_utf8(data: np.ndarray, validity: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets int32 [n + 1], bytes uint8) of a host string column; NULL
    rows have length 0."""
    n = len(data)
    offsets = np.zeros(n + 1, dtype=np.int64)
    chunks = []
    for lo in range(0, n, _ROWS_PER_CHUNK):
        hi = min(n, lo + _ROWS_PER_CHUNK)
        chunk = np.asarray(data[lo:hi], dtype=object)
        valid = np.asarray(validity[lo:hi], dtype=bool)
        if not valid.all():
            chunk = np.where(valid, chunk, "")
        rows = _fixed_rows(chunk)
        offsets[lo + 1:hi + 1] = rows[1]
        chunks.append((lo, hi, rows))
    np.cumsum(offsets, out=offsets)
    if offsets[-1] >= (1 << 31):
        raise ValueError("a string column holds more than 2 GiB of bytes")
    parts = [_gather_rows(*rows, offsets[lo:hi + 1])
             for lo, hi, rows in chunks]
    raw = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return offsets.astype(np.int32), raw


def encode_pool(pool: Sequence[str], codes: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(object values, offsets, bytes) of `pool[codes]` without a per-row
    loop: the pool encodes once (value by value: it is small), rows gather
    its byte matrix."""
    pool_obj = np.array(list(pool), dtype=object)
    encoded = [v.encode("utf-8") for v in pool]
    plens = np.array([len(e) for e in encoded], dtype=np.int64)
    width = max(int(plens.max()) if len(plens) else 0, 1)
    pmat = np.zeros((len(pool), width), np.uint8)
    for i, e in enumerate(encoded):
        pmat[i, :len(e)] = np.frombuffer(e, np.uint8)
    codes = np.asarray(codes)
    lens = plens[codes]
    offsets = np.zeros(len(codes) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    parts = []
    keep = np.arange(width)[None, :]
    for lo in range(0, len(codes), _ROWS_PER_CHUNK):
        c = codes[lo:lo + _ROWS_PER_CHUNK]
        parts.append(pmat[c][keep < plens[c][:, None]])
    raw = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return pool_obj[codes], offsets.astype(np.int32), raw


def decode_utf8(offsets: np.ndarray, raw: np.ndarray, validity: np.ndarray,
                n: int) -> np.ndarray:
    """Object array of str for rows [0, n) of (offsets, bytes); NULL rows
    hold "" (invalid UTF-8 decodes with replacement characters, as the
    reference's download does)."""
    out = np.empty(n, dtype=object)
    offsets = np.asarray(offsets[:n + 1], dtype=np.int64)
    for lo in range(0, n, _ROWS_PER_CHUNK):
        hi = min(n, lo + _ROWS_PER_CHUNK)
        starts = offsets[lo:hi]
        lens = offsets[lo + 1:hi + 1] - starts
        width = int(lens.max()) if hi > lo else 0
        if width == 0:
            out[lo:hi] = ""
            continue
        k = np.arange(width)[None, :]
        mask = k < lens[:, None]
        mat = np.zeros((hi - lo, width), np.uint8)
        mat[mask] = raw[(starts[:, None] + k)[mask]]
        fixed = mat.view(f"S{width}").ravel()
        try:
            strs = fixed.astype("U")  # ASCII
        except UnicodeDecodeError:
            strs = np.char.decode(fixed, "utf-8", "replace")
        out[lo:hi] = strs.astype(object)
        # numpy drops trailing NUL bytes: those rows decode one by one
        ends = starts + lens - 1
        for i in np.nonzero((lens > 0) & (raw[np.maximum(ends, 0)] == 0))[0]:
            s0 = int(starts[i])
            out[lo + i] = bytes(raw[s0:s0 + int(lens[i])]).decode(
                "utf-8", "replace")
    valid = np.asarray(validity[:n], dtype=bool)
    if not valid.all():
        out[~valid] = ""
    return out


# ---------------------------------------------------------------------------
# K12: search for a literal needle (reference :353-475)
# ---------------------------------------------------------------------------
_SEARCH_MODES = {"prefix": 0, "suffix": 1, "contains": 2,
                 "prefix_suffix": 3}


def _byte_at(data, pos):
    """data[pos] as int64, clamped into the buffer as the reference's
    gathers clamp (a zero-size buffer reads as zeros)."""
    if not data.numel():
        return torch.zeros_like(pos)
    return data[pos.clamp(0, int(data.shape[0]) - 1)].long()


def _match_at(data, at, needle: bytes):
    """bool [cap]: the bytes at `at` spell `needle` (no length check)."""
    ok = torch.ones(at.shape, dtype=torch.bool, device=at.device)
    for k, b in enumerate(needle):
        ok &= _byte_at(data, at + k) == b
    return ok


def string_search_plain(offsets, data, needle: bytes, mode: str,
                        split: int = 0):
    """bool [cap] per row of (offsets [cap + 1], bytes): PREFIX / SUFFIX is
    the reference's `starts_with` / `ends_with` (a length check, then one
    clamped byte gather per needle byte), PREFIX_SUFFIX both halves of
    `needle` split at `split` plus len >= |needle| (`like_match`'s 'a%b'),
    CONTAINS a match at some position of the row's own bytes, true for
    every row when the needle is empty (reference :381)."""
    starts = offsets[:-1].long()
    lens = (offsets[1:] - offsets[:-1]).long()
    n = len(needle)
    if mode == "prefix":
        return (lens >= n) & _match_at(data, starts, needle)
    if mode == "suffix":
        return (lens >= n) & _match_at(data, starts + lens - n, needle)
    if mode == "prefix_suffix":
        pre, suf = needle[:split], needle[split:]
        return (lens >= n) & _match_at(data, starts, pre) & \
            _match_at(data, starts + lens - len(suf), suf)
    if n == 0:
        return torch.ones(lens.shape, dtype=torch.bool, device=lens.device)
    hit = torch.zeros(lens.shape, dtype=torch.bool, device=lens.device)
    longest = int(lens.max()) if lens.numel() else 0
    for p in range(longest - n + 1):
        hit |= (lens >= p + n) & _match_at(data, starts + p, needle)
    return hit


def string_search(offsets, data, needle: bytes, mode: str, split: int = 0):
    """K12 (csrc/string_search.cu; replaces `starts_with` :353, `ends_with`
    :365, `contains` :377 and `like_match`'s searches :428): bool [cap] per
    row of a string column for a literal needle. NULL rows have length 0;
    their NULL result is the expression layer's, as in the reference. CPU
    tensors run the plain version, CUDA tensors the kernel."""
    if offsets.device.type == "cpu":
        return string_search_plain(offsets, data, needle, mode, split)
    offsets = offsets.contiguous()
    CB.require_cuda(offsets, data)
    n = int(offsets.shape[0]) - 1
    dev = offsets.device
    nb = torch.frombuffer(bytearray(needle or b"\0"), dtype=torch.uint8)
    nd = nb.to(dev, non_blocking=False)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    lib = CB.library("string_search")
    rc = lib.srt_string_search(offsets.data_ptr(), data.data_ptr(), n,
                               nd.data_ptr(), len(needle), split,
                               _SEARCH_MODES[mode], out.data_ptr(),
                               CB.stream_of(out))
    CB.count_launch("string_search")
    CB.check(lib, rc, "string_search")
    return out


def starts_with(ctx, col, needle: str):
    """Reference :353 (device engine)."""
    return string_search(col.offsets, col.data, needle.encode(), "prefix")


def ends_with(ctx, col, needle: str):
    """Reference :365 (device engine)."""
    return string_search(col.offsets, col.data, needle.encode(), "suffix")


def contains(ctx, col, needle: str):
    """Reference :377 (device engine)."""
    return string_search(col.offsets, col.data, needle.encode(),
                         "contains")


def like_match(ctx, col, pattern: str):
    """SQL LIKE for `classify_like`'s subset (reference :428): exact (K8),
    'a%', '%a', '%a%' and 'a%b' (K12). Any other pattern raises, as in the
    reference, whose rule table lets every LIKE onto the device."""
    kind, parts = classify_like(pattern)
    if kind == "exact":
        return string_compare(ctx, col, ScalarV(col.dtype, parts[0]), "eq")
    if kind == "prefix_suffix":
        pre, suf = (p.encode() for p in parts)
        return string_search(col.offsets, col.data, pre + suf,
                             "prefix_suffix", len(pre))
    if kind in ("prefix", "suffix", "contains"):
        return string_search(col.offsets, col.data, parts[0].encode(), kind)
    raise ValueError(f"unsupported LIKE pattern {pattern!r}")


def classify_like(pattern: str):
    """Reference :450: the pattern's kind and literal parts;
    ('unsupported', ()) for '_', escapes and inner '%' runs other than
    one."""
    if "_" in pattern or "\\" in pattern:
        return "unsupported", ()
    if "%" not in pattern:
        return "exact", (pattern,)
    inner = pattern.strip("%")
    if "%" in inner:
        segs = inner.split("%")
        if len(segs) == 2 and not pattern.startswith("%") and \
                not pattern.endswith("%"):
            return "prefix_suffix", tuple(segs)
        return "unsupported", ()
    if pattern.startswith("%") and pattern.endswith("%"):
        return "contains", (inner,)
    if pattern.endswith("%"):
        return "prefix", (inner,)
    return "suffix", (inner,)


# ---------------------------------------------------------------------------
# K13: SUBSTRING's byte plan (reference :284-320); K7 copies the bytes
# ---------------------------------------------------------------------------
def _wrap32(x):
    """int64 values wrapped to int32, as the reference's int32 arithmetic
    wraps (`pos + len` past 2^31 - 1, and the character index then)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def substring_plan_plain(offsets, data, validity, pos, length):
    """(spans int32 [2 cap + 1], span validity [2 cap]) of Spark SUBSTRING
    over code points, in the reference's formulation: a character starts
    at every byte with (b & 0xC0) != 0x80; char k of a row is the k-th
    character start after the one holding the row's first byte, clipped to
    the row; a negative pos counts from the end and clamps at 0, pos 0
    acts as 1, a negative length gives the empty string, a pos past the
    end the empty string. Row i's bytes are spans[2i]:spans[2i + 1]; odd
    spans lie between rows and are never taken."""
    cap = int(validity.shape[0])
    dev = validity.device
    byte_cap = max(int(data.shape[0]), 1)
    buf = data if data.numel() else torch.zeros(1, dtype=torch.uint8,
                                                device=dev)
    starts = offsets[:-1].long()
    ends = offsets[1:].long()
    lens = ends - starts
    is_start = (buf & 0xC0) != 0x80
    csum = torch.cumsum(is_start.long(), 0)
    starts_cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            csum])
    nchars = starts_cum[ends] - starts_cum[starts]
    first_char = torch.where(lens > 0, (csum - 1)[starts.clamp(0, byte_cap
                                                               - 1)],
                             torch.zeros((), dtype=torch.int64, device=dev))
    p = pos.long().expand(cap)
    want = length.long().expand(cap).clamp(min=0)
    p0 = torch.where(p < 0, _wrap32(nchars + p).clamp(min=0),
                     _wrap32(p - 1).clamp(min=0))
    lo = torch.minimum(p0, nchars)
    hi = torch.minimum(_wrap32(p0 + want), nchars)
    char_starts = torch.full((byte_cap,), byte_cap, dtype=torch.int64,
                             device=dev)
    nz = torch.nonzero(is_start).flatten()
    char_starts[:nz.shape[0]] = nz

    def char_to_byte(k):
        g = _wrap32(first_char + k)
        b = char_starts[g.clamp(0, byte_cap - 1)]
        b = torch.where(g >= byte_cap, ends, b)
        return torch.minimum(torch.maximum(b, starts), ends)

    b_start = char_to_byte(lo)
    b_end = torch.maximum(char_to_byte(hi), b_start)
    spans = torch.zeros(2 * cap + 1, dtype=torch.int32, device=dev)
    spans[0:2 * cap:2] = b_start.to(torch.int32)
    spans[1:2 * cap:2] = b_end.to(torch.int32)
    spans[2 * cap] = offsets[cap]
    span_valid = torch.zeros(2 * cap, dtype=torch.bool, device=dev)
    span_valid[0::2] = validity
    return spans, span_valid


def _rows_arg(x, cap: int, dev):
    """A per-row int32 argument: a column, or a scalar as a stride-0 view."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32).contiguous()
    return torch.full((1,), int(x), dtype=torch.int32,
                      device=dev).expand(cap)


def substring_plan(offsets, data, validity, pos, length):
    """K13 (csrc/substring.cu; replaces the plan half of `substring_utf8`
    :284): the spans of `substring_plan_plain`, a thread per row. `pos` and
    `length` are int32 [cap] columns or stride-0 views. CPU tensors run the
    plain version, CUDA tensors the kernel."""
    if validity.device.type == "cpu":
        return substring_plan_plain(offsets, data, validity, pos, length)
    offsets = offsets.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(offsets, data, validity)
    cap = int(validity.shape[0])
    dev = validity.device
    args = []
    for t in (pos, length):
        if t.device != dev or t.shape[0] != cap or t.dtype != torch.int32:
            raise ValueError("substring arguments must be int32 [cap] on "
                             "the column's device")
        args += [t.data_ptr(), _stride(t)]
    spans = torch.empty(2 * cap + 1, dtype=torch.int32, device=dev)
    span_valid = torch.empty(2 * cap, dtype=torch.bool, device=dev)
    lib = CB.library("substring")
    rc = lib.srt_substring_plan(offsets.data_ptr(), data.data_ptr(),
                                validity.data_ptr(), cap, *args,
                                spans.data_ptr(),
                                span_valid.data_ptr(), CB.stream_of(spans))
    CB.count_launch("substring_plan")
    CB.check(lib, rc, "substring_plan")
    return spans, span_valid


def substring_utf8(ctx, col, pos, length):
    """Reference :284 (device engine): K13 plans each row's byte span, K7
    copies the spans under new offsets (its source offsets are the spans,
    row i at index 2i). The validity is the source's; the bytes fit in the
    source's buffer."""
    from spark_rapids_tpu_torch.columnar.batch import (
        bucket_capacity,
        gather_strings,
    )

    cap = int(col.validity.shape[0])
    dev = col.validity.device
    spans, span_valid = substring_plan(
        col.offsets, col.data, col.validity, _rows_arg(pos, cap, dev),
        _rows_arg(length, cap, dev))
    idx = torch.arange(0, 2 * cap, 2, dtype=torch.int32, device=dev)
    bound = min(cap * (col.max_len or 1), int(col.data.shape[0]))
    offs, data, valid = gather_strings(spans, col.data, span_valid, idx,
                                       cap, None,
                                       bucket_capacity(max(bound, 1)))
    return ColV(col.dtype, data, valid, offs, col.max_len)


# ---------------------------------------------------------------------------
# select / coalesce over strings (reference :200 / :220): K7 over the
# sources laid end to end
# ---------------------------------------------------------------------------
def _string_source(ctx, v):
    """(a device string column, whether it holds one row per lane): a
    column as it is, a scalar as a one-row column every lane indexes."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnVector

    if isinstance(v, ScalarV):
        view = as_view(ctx, v)
        n = len(_literal_bytes(v))
        return ColumnVector(
            DataType.STRING, view.data, view.validity[:1].contiguous(),
            torch.tensor([0, n], dtype=torch.int32, device=ctx.device),
            len_bucket(n)), False
    return ColumnVector(DataType.STRING, v.data, v.validity, v.offsets,
                        v.max_len), True


def _gather_from_sources(ctx, vals, choice):
    """Lane i takes the row of source `choice[i]` (its own lane for a
    column, row 0 for a scalar), through one K7 gather over the sources
    laid end to end; lanes past the rows are NULL."""
    from spark_rapids_tpu_torch.columnar.batch import (
        gather_string_col,
        strings_end_to_end,
    )

    cap = ctx.capacity
    dev = ctx.device
    sources = [_string_source(ctx, v) for v in vals]
    src, bases = strings_end_to_end([c for c, _ in sources])
    lane = torch.arange(cap, dtype=torch.int64, device=dev)
    idx = torch.zeros(cap, dtype=torch.int64, device=dev)
    for k, ((_, per_lane), base) in enumerate(zip(sources, bases)):
        idx = torch.where(choice == k, base + lane if per_lane else
                          torch.full((), base, dtype=torch.int64,
                                     device=dev), idx)
    out = gather_string_col(src, idx, cap, ctx.row_mask())
    return ColV(out.dtype, out.data, out.validity, out.offsets, out.max_len)


def _host_col(ctx, v):
    """(object data, validity) of a host operand (reference :240)."""
    if isinstance(v, ScalarV):
        return (np.full((ctx.capacity,), "" if v.is_null else v.value,
                        dtype=object),
                np.full((ctx.capacity,), not v.is_null, dtype=bool))
    return v.data, v.validity


def string_select(ctx, pred_true, then_v, else_v):
    """where(pred, then, else) over strings (reference :200)."""
    if not ctx.is_device:
        t, e = _host_col(ctx, then_v), _host_col(ctx, else_v)
        return ColV(DataType.STRING, np.where(pred_true, t[0], e[0]),
                    np.where(pred_true, t[1], e[1]))
    choice = torch.where(pred_true, 0, 1)
    return _gather_from_sources(ctx, [then_v, else_v], choice)


def string_coalesce(ctx, vals):
    """The first non-NULL of several strings (reference :220)."""
    if not ctx.is_device:
        cols = [_host_col(ctx, v) for v in vals]
        data, valid = cols[-1][0].copy(), cols[-1][1].copy()
        for d, va in reversed(cols[:-1]):
            data = np.where(va, d, data)
            valid = va | valid
        return ColV(DataType.STRING, data, valid)
    views = [as_view(ctx, v) for v in vals]
    choice = torch.full((ctx.capacity,), len(vals) - 1, dtype=torch.int64,
                        device=ctx.device)
    for k in range(len(vals) - 2, -1, -1):
        choice = torch.where(views[k].validity, k, choice)
    return _gather_from_sources(ctx, vals, choice)


# ---------------------------------------------------------------------------
# K17: character counts and locate (reference :260, :484, :542)
# ---------------------------------------------------------------------------
def _char_starts_cum(data):
    """int32 [byte_cap + 1]: non-continuation bytes before each position."""
    is_start = (data & 0xC0) != 0x80
    out = torch.zeros(int(data.shape[0]) + 1, dtype=torch.int32,
                      device=data.device)
    out[1:] = torch.cumsum(is_start.to(torch.int32), 0, dtype=torch.int32)
    return out


def utf8_char_lengths_plain(offsets, data):
    """int32 [cap]: characters a row, the count of bytes that are not
    UTF-8 continuation bytes (reference :260)."""
    cum = _char_starts_cum(data)
    return cum[offsets[1:].long()] - cum[offsets[:-1].long()]


def locate_plain(offsets, data, needle: bytes, start: int):
    """int32 [cap]: 1-based character position of the first match of
    `needle` whose character position is at least start - 1, inside its
    own row; 0 when there is none or start < 1; for an empty needle
    `start` when start <= characters + 1 (reference :542)."""
    cap = int(offsets.shape[0]) - 1
    dev = offsets.device
    if start < 1:
        return torch.zeros(cap, dtype=torch.int32, device=dev)
    if not needle:
        chars = utf8_char_lengths_plain(offsets, data)
        return torch.where(start <= chars + 1,
                           torch.full((), start, dtype=torch.int32,
                                      device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev))
    byte_cap = int(data.shape[0])
    m, row, pos = _match_starts_plain(offsets, data, needle)
    row_start = offsets[:-1].long()[row]
    cum = _char_starts_cum(data)
    char_pos = cum[pos] - cum[row_start.clamp(max=max(byte_cap - 1, 0))]
    cand = m & (char_pos >= start - 1)
    inf = 1 << 30
    first = torch.full((cap,), inf, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, row, torch.where(
        cand, char_pos, torch.full((), inf, dtype=torch.int32, device=dev)),
        "amin")
    return torch.where(first < inf, first + 1,
                       torch.zeros((), dtype=torch.int32, device=dev))


def _string_chars(offsets, data, needle: bytes, start: int, mode: int):
    offsets = offsets.contiguous()
    CB.require_cuda(offsets, data)
    n = int(offsets.shape[0]) - 1
    dev = offsets.device
    nb = torch.frombuffer(bytearray(needle or b"\0"), dtype=torch.uint8)
    nd = nb.to(dev, non_blocking=False)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    lib = CB.library("string_chars")
    rc = lib.srt_string_chars(offsets.data_ptr(), data.data_ptr(), n,
                              nd.data_ptr(), len(needle), start, mode,
                              out.data_ptr(), CB.stream_of(out))
    CB.count_launch("string_chars")
    CB.check(lib, rc, "string_chars")
    return out


def utf8_char_lengths(offsets, data):
    """K17's count entry point: CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if offsets.device.type == "cpu":
        return utf8_char_lengths_plain(offsets, data)
    return _string_chars(offsets, data, b"", 0, 0)


def locate(offsets, data, needle: bytes, start: int):
    """K17's locate entry point: CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if offsets.device.type == "cpu":
        return locate_plain(offsets, data, needle, start)
    return _string_chars(offsets, data, needle, start, 1)


# ---------------------------------------------------------------------------
# B15's rest (reference :270-701): K37 case maps, K38 span plans (K7's
# span entry copies the spans), K39 replace, K40 concat
# ---------------------------------------------------------------------------
def has_border(s: bytes) -> bool:
    """True when some proper prefix of s equals a suffix ('aa', 'aba';
    reference :473). A borderless needle cannot overlap itself, so its
    matches never overlap and any scan that skips past a match finds them
    all: the precondition of K38's substring_index and K39."""
    return any(s[:k] == s[-k:] for k in range(1, len(s)))


def _needle_bytes(needle: str) -> bytes:
    """UTF-8 bytes of a literal needle (reference :349)."""
    return needle.encode("utf-8")


def _require_borderless(needle: bytes, what: str) -> None:
    if len(needle) > 1 and has_border(needle):
        raise ValueError(f"{what} needs a self-overlap-free needle, not "
                         f"{needle!r} (the plan rewrite keeps such needles "
                         "on the CPU engine)")


def _row_of_bytes(offsets, byte_cap: int):
    """(row int64 [byte_cap], position) of each byte: the row whose span
    holds it (clamped to the last row past the total), as the reference's
    searchsorted (:403)."""
    cap = int(offsets.shape[0]) - 1
    pos = torch.arange(byte_cap, device=offsets.device)
    row = torch.searchsorted(offsets[1:].long(), pos, right=True)
    return row.clamp(0, max(cap - 1, 0)), pos


# -- K37: case maps (reference :270, :277, :620) ------------------------------
_CASE_MODES = {"upper": 0, "lower": 1, "initcap": 2}


def case_map_plain(offsets, data, mode: str):
    """uint8 [byte_cap]: the ASCII case map of every row byte (bytes at or
    past offsets[-1] are 0; non-ASCII bytes pass through). upper / lower:
    the reference's bytewise where. initcap: a byte starts a word when it
    is its row's first byte or the byte before it is 0x20; a word's first
    letter is uppercased, its others lowercased. Row starts are marked at
    the offsets that lie inside the bytes (the reference scatters its
    clipped offsets[:-1], :631, which marks the buffer's last byte when it
    is exactly full and trailing rows are empty)."""
    d = data.long()
    byte_cap = int(data.shape[0])
    total = int(offsets[-1]) if offsets.numel() else 0
    is_lower = (d >= ord("a")) & (d <= ord("z"))
    is_upper = (d >= ord("A")) & (d <= ord("Z"))
    if mode == "upper":
        out = torch.where(is_lower, d - 32, d)
    elif mode == "lower":
        out = torch.where(is_upper, d + 32, d)
    else:
        prev = torch.full_like(d, ord(" "))
        prev[1:] = d[:-1]
        new_word = prev == ord(" ")
        starts = offsets[:-1].long()
        new_word[starts[starts < total]] = True
        out = torch.where(new_word & is_lower, d - 32,
                          torch.where(~new_word & is_upper, d + 32, d))
    inside = torch.arange(byte_cap, device=data.device) < total
    return torch.where(inside, out, torch.zeros((), dtype=torch.int64,
                                                device=data.device)
                       ).to(torch.uint8)


def case_map(offsets, data, mode: str):
    """K37 (csrc/string_transform.cu; replaces `upper_ascii` :270,
    `lower_ascii` :277 and `initcap_ascii` :620): `case_map_plain`'s bytes.
    The offsets, validity and max_len are the input's. CPU tensors run the
    plain version, CUDA tensors the kernel."""
    if offsets.device.type == "cpu":
        return case_map_plain(offsets, data, mode)
    offsets = offsets.contiguous()
    CB.require_cuda(offsets, data)
    byte_cap = int(data.shape[0])
    out = torch.empty(byte_cap, dtype=torch.uint8, device=data.device)
    vec = int(data.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = CB.library("string_transform")
    rc = lib.srt_string_case_map(offsets.data_ptr(),
                                 int(offsets.shape[0]) - 1, data.data_ptr(),
                                 out.data_ptr(), byte_cap, _CASE_MODES[mode],
                                 vec, CB.stream_of(out))
    CB.count_launch("string_case_map")
    CB.check(lib, rc, "string_case_map")
    return out


def _case_col(col, mode: str):
    return ColV(DataType.STRING, case_map(col.offsets, col.data, mode),
                col.validity, col.offsets, col.max_len)


def upper_ascii(col):
    """Reference :270 (device engine): K37."""
    return _case_col(col, "upper")


def lower_ascii(col):
    """Reference :277 (device engine): K37."""
    return _case_col(col, "lower")


def initcap_ascii(ctx, col):
    """Reference :620 (device engine): K37."""
    return _case_col(col, "initcap")


# -- K38: trim and substring_index spans (reference :397, :571) ---------------
_SPAN_MODES = {"both": 0, "left": 1, "right": 2, "index": 3}


def _k13_layout(b_start, b_end, offsets, validity):
    """Spans in K13's layout: row i at spans[2i]:spans[2i + 1], the total
    at spans[2 cap], the row's validity at 2i."""
    cap = int(validity.shape[0])
    dev = validity.device
    spans = torch.zeros(2 * cap + 1, dtype=torch.int32, device=dev)
    spans[0:2 * cap:2] = b_start.to(torch.int32)
    spans[1:2 * cap:2] = b_end.to(torch.int32)
    spans[2 * cap] = offsets[cap]
    span_valid = torch.zeros(2 * cap, dtype=torch.bool, device=dev)
    span_valid[0::2] = validity
    return spans, span_valid


def _trim_plan(offsets, data, side: str):
    """(new start, new end) per row, the reference's segmented formulation
    (:397): the first and last non-space byte of each row; an all-space
    (or empty) row becomes empty at its end (both, left) or start
    (right)."""
    cap = int(offsets.shape[0]) - 1
    byte_cap = int(data.shape[0])
    starts, ends = offsets[:-1].long(), offsets[1:].long()
    row, pos = _row_of_bytes(offsets, byte_cap)
    nonspace = (data != ord(" ")) & (pos >= starts[row]) & (pos < ends[row])
    first = torch.full((cap,), byte_cap, dtype=torch.int64,
                       device=data.device)
    first.scatter_reduce_(0, row, torch.where(nonspace, pos, byte_cap),
                          "amin")
    last = torch.full((cap,), -1, dtype=torch.int64, device=data.device)
    last.scatter_reduce_(0, row, torch.where(nonspace, pos, -1), "amax")
    all_space = first >= byte_cap
    new_start = torch.where(all_space, ends, first) \
        if side in ("both", "left") else starts
    new_end = torch.where(all_space, new_start, last + 1) \
        if side in ("both", "right") else ends
    return new_start, new_start + (new_end - new_start).clamp(min=0)


def _match_starts_plain(offsets, data, needle: bytes):
    """(match bool [byte_cap], row, position): where the needle's bytes
    start inside their row (reference `_match_starts` :484)."""
    byte_cap = int(data.shape[0])
    row, pos = _row_of_bytes(offsets, byte_cap)
    m = torch.ones(byte_cap, dtype=torch.bool, device=data.device)
    for k, b in enumerate(needle):
        m &= data[(pos + k).clamp(max=byte_cap - 1)] == b
    fits = (pos >= offsets[:-1].long()[row]) & \
        (pos + len(needle) <= offsets[1:].long()[row])
    return m & fits, row, pos


def _index_plan(offsets, data, delim: bytes, count: int):
    """(new start, new end) per row of substring_index, the reference's
    formulation (:571): each match's 0-based rank in its row by byte
    order; the bytes before the count-th match (count > 0) or after the
    |count|-th from the end (count < 0); the whole row when it has fewer
    matches; empty for count 0 or an empty delimiter."""
    cap = int(offsets.shape[0]) - 1
    dev = data.device
    starts, ends = offsets[:-1].long(), offsets[1:].long()
    lens = ends - starts
    if count == 0 or not delim or not data.numel():
        return starts, starts
    m, row, pos = _match_starts_plain(offsets, data, delim)
    mi = m.long()
    excl = torch.cumsum(mi, 0) - mi
    base = torch.where(lens > 0, excl[starts.clamp(max=int(data.shape[0]) -
                                                   1)], 0)
    rank = excl - base[row]
    total = torch.zeros(cap, dtype=torch.int64, device=dev)
    total.index_add_(0, row, mi)
    inf = 1 << 40
    k = abs(count)
    want = (count - 1) if count > 0 else (total - k)[row]
    bpos = torch.full((cap,), inf, dtype=torch.int64, device=dev)
    bpos.scatter_reduce_(0, row, torch.where(m & (rank == want), pos, inf),
                         "amin")
    if count > 0:
        start_rel = torch.zeros_like(lens)
        out_len = torch.where(total >= k, bpos - starts, lens)
    else:
        start_rel = torch.where(total >= k, bpos - starts + len(delim), 0)
        out_len = lens - start_rel
    out_len = torch.minimum(out_len.clamp(min=0), lens)
    return starts + start_rel, starts + start_rel + out_len


def span_plan_plain(offsets, data, validity, mode: str, delim: bytes = b"",
                    count: int = 0):
    """(spans int32 [2 cap + 1], span validity [2 cap]) in K13's layout of
    TRIM / LTRIM / RTRIM of 0x20 (mode both / left / right; reference
    `trim_spaces` :397) or substring_index(delim, count) (mode index;
    reference :571). The validity is the input's."""
    if mode == "index":
        b_start, b_end = _index_plan(offsets, data, delim, count)
    else:
        b_start, b_end = _trim_plan(offsets, data, mode)
    return _k13_layout(b_start, b_end, offsets, validity)


def span_plan(offsets, data, validity, mode: str, delim: bytes = b"",
              count: int = 0):
    """K38 (csrc/string_transform.cu; replaces the plans of `trim_spaces`
    :397 and `substring_index` :571): `span_plan_plain`'s spans, a thread
    per row. substring_index's delimiter must be one byte or borderless.
    CPU tensors run the plain version, CUDA tensors the kernel."""
    if mode == "index":
        _require_borderless(delim, "substring_index")
    if validity.device.type == "cpu":
        return span_plan_plain(offsets, data, validity, mode, delim, count)
    offsets = offsets.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(offsets, data, validity)
    cap = int(validity.shape[0])
    dev = validity.device
    nd = torch.frombuffer(bytearray(delim or b"\0"),
                          dtype=torch.uint8).to(dev)
    spans = torch.empty(2 * cap + 1, dtype=torch.int32, device=dev)
    span_valid = torch.empty(2 * cap, dtype=torch.bool, device=dev)
    lib = CB.library("string_transform")
    rc = lib.srt_string_span_plan(offsets.data_ptr(), data.data_ptr(),
                                  validity.data_ptr(), cap,
                                  _SPAN_MODES[mode], nd.data_ptr(),
                                  len(delim), int(count), spans.data_ptr(),
                                  span_valid.data_ptr(), CB.stream_of(spans))
    CB.count_launch("string_span_plan")
    CB.check(lib, rc, "string_span_plan")
    return spans, span_valid


def _copy_spans(col, spans, span_valid):
    """K7's span entry copies K13-layout spans of `col` under new offsets;
    the bytes fit in the source's buffer and every row keeps within the
    source's max_len."""
    from spark_rapids_tpu_torch.columnar.batch import (
        bucket_capacity,
        gather_string_spans,
    )

    cap = int(col.validity.shape[0])
    starts = spans[0:2 * cap:2]
    bound = min(cap * (col.max_len or 1), int(col.data.shape[0]))
    offs, data, valid = gather_string_spans(
        col.data, starts.long(), spans[1:2 * cap:2] - starts,
        span_valid[0::2], cap, bucket_capacity(max(bound, 1)))
    return ColV(col.dtype, data, valid, offs, col.max_len)


def trim_spaces(ctx, col, side: str = "both"):
    """Reference :397 (device engine): K38 plans, K7's span entry
    copies."""
    return _copy_spans(col, *span_plan(col.offsets, col.data, col.validity,
                                       side))


def substring_index(ctx, col, delim: str, count: int):
    """Reference :571 (device engine): K38 plans, K7's span entry copies.
    The plan rewrite keeps a delimiter of more than one byte with a border on the
    CPU engine."""
    return _copy_spans(col, *span_plan(col.offsets, col.data, col.validity,
                                       "index", _needle_bytes(delim),
                                       count))


# -- K39: replace a literal (reference :499) ----------------------------------
def replace_plain(offsets, data, validity, find: bytes, repl: bytes):
    """(offsets int32 [cap + 1], bytes) of replacing every match of a
    non-empty borderless needle left to right, the reference's formulation
    (:499): per-row match counts, each byte's earlier matches in its row,
    pass-through bytes scattered to their shifted place, then the
    replacement's bytes at each match. The buffer holds exactly the output
    bytes (at least 8), zero past them."""
    f, r = len(find), len(repl)
    cap = int(validity.shape[0])
    dev = data.device
    byte_cap = int(data.shape[0])
    starts, ends = offsets[:-1].long(), offsets[1:].long()
    m, row, pos = _match_starts_plain(offsets, data, find)
    mi = m.long()
    excl = torch.cumsum(mi, 0) - mi
    prior = excl - excl[starts.clamp(max=max(byte_cap - 1, 0))][row]
    counts = torch.zeros(cap, dtype=torch.int64, device=dev)
    counts.index_add_(0, row, mi)
    out_len = torch.where(validity, ends - starts + counts * (r - f), 0)
    new_offsets = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    new_offsets[1:] = torch.cumsum(out_len, 0)
    total = int(new_offsets[-1])
    out_cap = max(total, 8)
    out = torch.zeros(out_cap + 1, dtype=torch.uint8, device=dev)
    covered = torch.zeros(byte_cap, dtype=torch.bool, device=dev)
    for k in range(f):
        covered[k:] |= m[:byte_cap - k]
    live = validity[row]
    in_row = (pos >= starts[row]) & (pos < ends[row]) & live
    out_pos = new_offsets[row] + (pos - starts[row]) + (r - f) * prior
    keep = in_row & ~covered
    out[torch.where(keep, out_pos, out_cap)] = data
    for k, b in enumerate(repl):
        out[torch.where(m & live, out_pos + k, out_cap)] = b
    return new_offsets.to(torch.int32), out[:out_cap]


def string_replace(offsets, data, validity, find: bytes, repl: bytes):
    """K39 (csrc/string_transform.cu; replaces `replace_literal` :499):
    `replace_plain`'s offsets and bytes. A count launch writes each row's
    output length and their exclusive scan; the total is read back once (a
    host read a call) to size the bytes, which a write launch fills. The
    needle must be non-empty and one byte or borderless. CPU tensors run
    the plain version, CUDA tensors the kernel."""
    if not find:
        raise ValueError("replace needs a non-empty search string")
    _require_borderless(find, "replace")
    if validity.device.type == "cpu":
        return replace_plain(offsets, data, validity, find, repl)
    offsets = offsets.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(offsets, data, validity)
    cap = int(validity.shape[0])
    dev = validity.device
    needles = torch.frombuffer(bytearray(find + repl),
                               dtype=torch.uint8).to(dev)
    lib = CB.library("string_transform")
    scratch = torch.empty(int(lib.srt_string_transform_scratch_bytes(cap)),
                          dtype=torch.uint8, device=dev)
    new_offsets = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    total_d = torch.empty(1, dtype=torch.int64, device=dev)
    stream = CB.stream_of(new_offsets)
    rc = lib.srt_string_replace_count(
        offsets.data_ptr(), data.data_ptr(), validity.data_ptr(), cap,
        needles.data_ptr(), len(find), len(repl), new_offsets.data_ptr(),
        total_d.data_ptr(), scratch.data_ptr(), scratch.numel(), stream)
    CB.count_launch("string_replace")
    CB.check(lib, rc, "string_replace count")
    total = int(total_d)  # the call's one host read
    if total >= (1 << 31):
        raise ValueError("replace's output passes 2 GiB of bytes")
    out = torch.empty(max(total, 8), dtype=torch.uint8, device=dev)
    rc = lib.srt_string_replace_write(
        offsets.data_ptr(), data.data_ptr(), validity.data_ptr(), cap,
        needles.data_ptr(), len(find), len(repl), new_offsets.data_ptr(),
        out.data_ptr(), out.numel(), stream)
    CB.check(lib, rc, "string_replace write")
    return new_offsets, out


def replace_literal(ctx, col, find: str, repl: str):
    """Reference :499 (device engine): K39. max_len grows by the
    replacement's extra bytes for every match a row can hold."""
    fb, rb = _needle_bytes(find), _needle_bytes(repl)
    offs, data = string_replace(col.offsets, col.data, col.validity, fb, rb)
    max_len = col.max_len or 1
    if len(rb) > len(fb):
        max_len = len_bucket(max_len + (max_len // len(fb)) *
                             (len(rb) - len(fb)))
    return ColV(DataType.STRING, data, col.validity, offs, max_len)


# -- K40: concat and concat_ws (reference :323, :642) -------------------------
def _sources_of(ctx, vals):
    """K40's sources: (offsets, bytes, validity, per-lane) of each operand,
    a scalar as a one-row column every lane reads (stride 0), as
    `_string_source` builds it; and the output's byte bound and max_len
    bound (sums over the operands)."""
    sources, byte_cap, max_len = [], 0, 0
    for v in vals:
        col, per_lane = _string_source(ctx, v)
        sources.append((col.offsets, col.data, col.validity, per_lane))
        byte_cap += plan_byte_cap(ctx, v)
        max_len += col.max_len or 1
    return sources, byte_cap, max_len


def concat_plain(sources, cap: int, sep, byte_cap: int):
    """(offsets int32 [cap + 1], bytes [byte_cap], validity [cap]) of
    joining each lane's pieces, the reference's piece table (`concat_ws`
    :642; `concat2` :323). sep None is concat: NULL when any piece is NULL.
    Otherwise concat_ws: never NULL; a NULL piece is left out, and sep goes
    before every piece that has a non-NULL piece before it."""
    dev = sources[0][2].device
    lane = torch.arange(cap, device=dev)
    views = []
    for offs, data, valid, per_lane in sources:
        at = lane if per_lane else torch.zeros_like(lane)
        start = offs.long()[at]
        views.append((data, start, offs.long()[at + 1] - start, valid[at]))
    slen = len(sep) if sep is not None else 0
    validity = torch.ones(cap, dtype=torch.bool, device=dev)
    if sep is None:
        for _, _, _, v in views:
            validity = validity & v
    any_before = torch.zeros(cap, dtype=torch.bool, device=dev)
    pieces = []  # (data, source start, sep length, piece length)
    for data, start, lens, v in views:
        keep = v & validity
        sl = torch.where(keep & any_before, slen, 0)
        pieces.append((data, start, sl, torch.where(keep, lens, 0)))
        any_before = any_before | keep
    out_len = torch.zeros(cap, dtype=torch.int64, device=dev)
    piece_off = []
    for _, _, sl, pl in pieces:
        piece_off.append(out_len)
        out_len = out_len + sl + pl
    offsets = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(out_len, 0)
    total = int(offsets[-1])
    if total > byte_cap:
        raise ValueError("concat's bytes pass their bound")
    out = torch.zeros(byte_cap, dtype=torch.uint8, device=dev)
    if total:
        pos = torch.arange(total, device=dev)
        row = torch.searchsorted(offsets[1:], pos, right=True)
        within = pos - offsets[row]
        sep_t = torch.tensor(list(sep or b"\0"), dtype=torch.uint8,
                             device=dev)
        res = torch.zeros(total, dtype=torch.uint8, device=dev)
        for (data, start, sl, pl), off in zip(pieces, piece_off):
            rel = within - off[row]
            s, p = sl[row], pl[row]
            in_sep = (rel >= 0) & (rel < s)
            in_val = (rel >= s) & (rel < s + p)
            if slen:
                res = torch.where(in_sep, sep_t[rel.clamp(0, slen - 1)], res)
            src = (start[row] + rel - s).clamp(0, max(int(data.shape[0]) -
                                                      1, 0))
            res = torch.where(in_val, data[src], res)
        out[:total] = res
    return offsets.to(torch.int32), out, validity


def string_concat(sources, cap: int, sep, byte_cap: int):
    """K40 (csrc/string_transform.cu; replaces `concat2` :323 and
    `concat_ws` :642): `concat_plain`'s offsets, bytes and validity. The J
    sources go to the card as a small table of (bytes, offsets, validity,
    stride) so no J is compiled in; a plan launch writes each lane's length
    and validity, a scan the offsets, a copy launch the bytes. byte_cap
    must bound the output (the operands' bound sum: no host read). CPU
    tensors run the plain version, CUDA tensors the kernel."""
    if sources[0][2].device.type == "cpu":
        return concat_plain(sources, cap, sep, byte_cap)
    if byte_cap >= (1 << 31):
        raise ValueError("concat's bytes may pass 2 GiB")
    dev = sources[0][2].device
    table = []
    for offs, data, valid, per_lane in sources:
        CB.require_cuda(offs, data, valid)
        table += [data.data_ptr(), offs.data_ptr(), valid.data_ptr(),
                  1 if per_lane else 0]
    desc = torch.tensor(table, dtype=torch.int64).to(dev)
    sep_d = torch.frombuffer(bytearray(sep or b"\0"),
                             dtype=torch.uint8).to(dev)
    lib = CB.library("string_transform")
    scratch = torch.empty(int(lib.srt_string_transform_scratch_bytes(cap)),
                          dtype=torch.uint8, device=dev)
    offsets = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    validity = torch.empty(cap, dtype=torch.bool, device=dev)
    out = torch.empty(max(byte_cap, 8), dtype=torch.uint8, device=dev)
    rc = lib.srt_string_concat(
        desc.data_ptr(), len(sources), cap, sep_d.data_ptr(),
        len(sep) if sep is not None else -1, offsets.data_ptr(),
        validity.data_ptr(), out.data_ptr(), out.numel(),
        scratch.data_ptr(), scratch.numel(), CB.stream_of(out))
    CB.count_launch("string_concat")
    CB.check(lib, rc, "string_concat")
    return offsets, out, validity


def concat2(ctx, lv, rv):
    """Reference :323 (device engine): K40, NULL when either side is NULL;
    max_len the sum of the sides'."""
    sources, byte_cap, max_len = _sources_of(ctx, [lv, rv])
    offs, data, valid = string_concat(sources, ctx.capacity, None,
                                      max(byte_cap, 8))
    return ColV(DataType.STRING, data, valid, offs, len_bucket(max_len))


def concat_ws(ctx, sep: str, vals):
    """Reference :642: join the non-NULL values with sep; never NULL (all
    NULL gives ''). Device engine: K40, max_len the sum of the members'
    plus the separators'; CPU engine: the reference's row loop."""
    if not ctx.is_device:
        cols = [_host_col(ctx, v) for v in vals]
        n = ctx.capacity
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = sep.join(str(d[i]) for d, va in cols if va[i])
        return ColV(DataType.STRING, out, np.ones((n,), dtype=bool))
    sb = _needle_bytes(sep)
    cap = ctx.capacity
    sources, byte_cap, max_len = _sources_of(ctx, vals)
    byte_cap += max(1, len(sb) * cap * max(len(vals) - 1, 0))
    offs, data, valid = string_concat(sources, cap, sb, max(byte_cap, 8))
    return ColV(DataType.STRING, data, valid, offs,
                len_bucket(max_len + len(sb) * (len(vals) - 1)))
