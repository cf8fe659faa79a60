"""String column helpers (port of the parts of spark_rapids_tpu/columnar/strings.py
that slices 2-3 need, plus the host <-> UTF-8 conversions of the port).

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
- `encode_utf8` / `decode_utf8`: the host conversion between object arrays
  of str and (offsets, bytes), vectorised in row chunks through numpy's
  fixed-width strings — no per-row Python loop. numpy's fixed-width
  strings drop trailing NUL characters, so the rows that lost some (their
  fixed-width length is short of their length) convert one by one.

The other string functions of the reference (B15) wait.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.ops.values import ScalarV

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
