"""String column helpers (port of the parts of spark_rapids_tpu/columnar/strings.py
that slice 2 needs, plus the host <-> UTF-8 conversions of the port).

Layout of a device STRING column (as in the reference, batch.py:148-188):
uint8 bytes, int32 offsets [capacity + 1] and bool validity [capacity]; row
i is bytes[offsets[i]:offsets[i + 1]], a NULL row has length 0, and lanes
past the row count repeat the last offset. `max_len` is a host-known power
of two bounding every row's byte length.

- `_chunk_u32` / `_chunk_u64` (reference :104 / :92): big-endian byte
  chunks of each row at an offset, zero past the row's end. They are the
  plain form of kernel K6 (exec/rowkeys.py:string_order_words).
- `encode_utf8` / `decode_utf8`: the host conversion between object arrays
  of str and (offsets, bytes), vectorised in row chunks through numpy's
  fixed-width byte strings — no per-row Python loop. numpy's fixed-width
  strings drop trailing NUL characters, so a value ending in U+0000 loses
  them on the way (ROADMAP.md section 3).

The string functions of the reference (B12 comparisons, B15) wait.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

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
# host conversion (vectorised)
# ---------------------------------------------------------------------------
def _to_fixed_bytes(values: np.ndarray) -> np.ndarray:
    """Object array of str -> numpy 'S' array of UTF-8 bytes."""
    try:
        return values.astype("S")  # ASCII: one C loop
    except UnicodeEncodeError:
        return np.char.encode(values.astype("U"), "utf-8")


def encode_utf8(data: np.ndarray, validity: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets int32 [n + 1], bytes uint8) of a host string column; NULL
    rows have length 0."""
    n = len(data)
    offsets = np.zeros(n + 1, dtype=np.int64)
    parts = []
    for lo in range(0, n, _ROWS_PER_CHUNK):
        hi = min(n, lo + _ROWS_PER_CHUNK)
        chunk = np.asarray(data[lo:hi], dtype=object)
        valid = np.asarray(validity[lo:hi], dtype=bool)
        if not valid.all():
            chunk = np.where(valid, chunk, "")
        fixed = _to_fixed_bytes(chunk)
        width = fixed.dtype.itemsize
        lens = np.char.str_len(fixed).astype(np.int64) if width else \
            np.zeros(hi - lo, np.int64)
        offsets[lo + 1:hi + 1] = lens
        if width and lens.any():
            mat = fixed.view(np.uint8).reshape(hi - lo, width)
            parts.append(mat[np.arange(width)[None, :] < lens[:, None]])
    np.cumsum(offsets, out=offsets)
    if offsets[-1] >= (1 << 31):
        raise ValueError("a string column holds more than 2 GiB of bytes")
    raw = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return offsets.astype(np.int32), raw


def encode_pool(pool: Sequence[str], codes: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(object values, offsets, bytes) of `pool[codes]` without a per-row
    loop: the pool encodes once, rows gather its byte matrix."""
    pool_obj = np.array(list(pool), dtype=object)
    fixed = _to_fixed_bytes(pool_obj)
    width = max(fixed.dtype.itemsize, 1)
    plens = np.char.str_len(fixed).astype(np.int64)
    pmat = np.zeros((len(pool), width), np.uint8)
    if fixed.dtype.itemsize:
        pmat[:] = fixed.view(np.uint8).reshape(len(pool), width)
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
    valid = np.asarray(validity[:n], dtype=bool)
    if not valid.all():
        out[~valid] = ""
    return out
