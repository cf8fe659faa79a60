"""Row hashing and partition ids (port of spark_rapids_tpu/ops/hashing.py).

Holds the hash half of the hand-written kernel K4 `hash_partition`
(csrc/hash_partition.cu), which replaces the reference's `hash_columns`
(hashing.py:215) and `partition_ids` (:228) as reached through
shuffle/exchange.py:_build_hash_ids (:1157). The route half lives in
shuffle/exchange.py (`route_plan`).

The hash is the reference's murmur3-style mix, bit for bit: seed 42, each
column decomposed into uint32 words (bool/int8/int16/int32: the low word of
the sign-extended value; int64: low word then high word; float/double: the
float32 bit pattern with -0.0 -> 0.0 and one canonical NaN), data words
zeroed at nulls, one null word per column (0 or the golden ratio), then
fmix32; the partition id is hash % n. Both engines of both packages
co-partition on it.

A STRING column hashes as three words (reference: `string_words` :168):
two polynomial hashes of its UTF-8 bytes and its byte length, computed by
the hand-written kernel K5 `string_hash_words` (csrc/string_hash.cu,
replacing `_string_words_device` :118); K4 then mixes the three words as one
column. The CPU engine encodes its object arrays to UTF-8 (vectorised) and
runs K5's plain version, so host and device plans co-partition bit for bit.

An encoded (dictionary) key hashes in K4's code mode (replacing
shuffle/exchange.py:_hash_ids_encoded :1181 and _build_hash_ids_enc
:1222): its words come from the dictionary's word table, gathered by code
(`CodeKey`; the table is built once per dictionary, columnar/encoded.py),
so the ids equal those of the expanded values bit for bit.

The plain versions run the uint32 arithmetic in int64 with explicit
`& 0xFFFFFFFF` masks: torch has no unsigned add, shift, multiply or
remainder. `>>` on int64 is arithmetic, so the high word is masked after
the shift. The CPU engine hashes through the same plain versions (numpy
columns convert to CPU tensors).
"""

from __future__ import annotations

import ctypes
from typing import Any, List, NamedTuple

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.values import ColV

M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_GOLDEN = 0x9E3779B9
HASH_SEED = 42  # Spark's default seed (reference: Murmur3Hash)


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _mix_h1(h, k1):
    k1 = (k1 * _C1) & M32
    k1 = _rotl32(k1, 15)
    k1 = (k1 * _C2) & M32
    h = _rotl32(h ^ k1, 13)
    return (h * 5 + 0xE6546B64) & M32


# ---------------------------------------------------------------------------
# K5: string hash words
# ---------------------------------------------------------------------------
def string_hash_words_plain(offsets, data, validity):
    """int64 [3, n] (h1, h2, length) by Horner's rule over the byte
    positions: h = h * base + byte mod 2^32 while the row has bytes left
    (the reference's power sums b[k] * base^(len-1-k), bit for bit)."""
    starts = offsets[:-1].long()
    lens = (offsets[1:] - offsets[:-1]).long()
    lens = torch.where(validity, lens, torch.zeros((), dtype=torch.int64,
                                                   device=lens.device))
    n = int(lens.shape[0])
    h1 = torch.zeros(n, dtype=torch.int64, device=lens.device)
    h2 = torch.zeros(n, dtype=torch.int64, device=lens.device)
    width = int(lens.max()) if n else 0
    top = max(int(data.shape[0]) - 1, 0)
    for k in range(width):
        live = lens > k
        b = data[(starts + k).clamp(0, top)].long() if data.numel() else \
            torch.zeros_like(starts)
        h1 = torch.where(live, (h1 * 31 + b) & M32, h1)
        h2 = torch.where(live, (h2 * 1000003 + b) & M32, h2)
    return torch.stack([h1, h2, lens])


def string_hash_words(offsets, data, validity):
    """K5 (replaces hashing.py:_string_words_device): int64 [3, n] words
    of a string column, 0 at NULL rows. CPU tensors run the plain version,
    CUDA tensors the kernel."""
    if validity.device.type == "cpu":
        return string_hash_words_plain(offsets, data, validity)
    return string_hash_words_u32(offsets, data, validity).long() & M32


def string_hash_words_u32(offsets, data, validity):
    """The kernel's int32 [3, n] output (the words' bits), as K4 takes it."""
    offsets = offsets.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(offsets, data, validity)
    n = int(validity.shape[0])
    words = torch.empty((3, n), dtype=torch.int32, device=validity.device)
    lib = CB.library("string_hash")
    rc = lib.srt_string_hash_words(offsets.data_ptr(), data.data_ptr(),
                                   validity.data_ptr(), n, words.data_ptr(),
                                   CB.stream_of(words))
    CB.count_launch("string_hash_words")
    CB.check(lib, rc, "string_hash_words")
    return words


def _string_words_host(data: np.ndarray, validity=None) -> List[Any]:
    """CPU-engine words of an object array of str (reference:
    hashing.py:101): vectorised UTF-8 encoding, then K5's plain version."""
    from spark_rapids_tpu_torch.columnar.strings import encode_utf8

    if validity is None:
        validity = np.ones(len(data), dtype=bool)
    offsets, raw = encode_utf8(data, validity)
    words = string_hash_words_plain(
        torch.from_numpy(offsets), torch.from_numpy(raw),
        torch.from_numpy(np.asarray(validity, dtype=bool)))
    return list(words)


def column_words(col: ColV) -> List[Any]:
    """uint32 words (int64 tensors) of one column (reference:
    hashing.py:77); null lanes are zeroed by hash_word_entries."""
    dt, data = col.dtype, col.data
    if dt is DataType.STRING:
        if getattr(col, "offsets", None) is not None:
            return list(string_hash_words(col.offsets, data, col.validity))
        return _string_words_host(data, col.validity)
    if dt is DataType.BOOL:
        return [data.to(torch.int64)]
    if dt in (DataType.INT8, DataType.INT16, DataType.INT32, DataType.DATE):
        return [data.to(torch.int64) & M32]
    if dt in (DataType.INT64, DataType.TIMESTAMP) or \
            getattr(dt, "is_decimal", False):
        x = data.to(torch.int64)
        return [x & M32, (x >> 32) & M32]
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        f = data.to(torch.float32)
        f = torch.where(f == 0, torch.zeros((), dtype=torch.float32,
                                            device=f.device), f)
        bits = f.view(torch.int32).to(torch.int64) & M32
        return [torch.where(torch.isnan(f),
                            torch.full((), 0x7FC00000, dtype=torch.int64,
                                       device=f.device), bits)]
    raise TypeError(f"cannot hash column of type {dt}")


def hash_word_entries(entries, seed: int = HASH_SEED):
    """Murmur3-style mix over (words, validity) entries -> int64 tensor of
    uint32 hash values (reference: hashing.py:192)."""
    h = None
    for words, validity in entries:
        zero = torch.zeros((), dtype=torch.int64, device=validity.device)
        nullw = torch.where(validity, zero,
                            torch.full((), _GOLDEN, dtype=torch.int64,
                                       device=validity.device))
        for w in [torch.where(validity, w, zero) for w in words] + [nullw]:
            if h is None:
                h = torch.full(w.shape, seed, dtype=torch.int64,
                               device=w.device)
            h = _mix_h1(h, w)
    assert h is not None, "hash needs at least one column"
    return _fmix32(h)


def hash_columns(cols: List[ColV], seed: int = HASH_SEED):
    """Row hash over several columns (reference: hashing.py:215)."""
    return hash_word_entries([(column_words(c), c.validity) for c in cols],
                             seed)


# ---------------------------------------------------------------------------
# K4, hash half: partition ids
# ---------------------------------------------------------------------------
_KINDS = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
          torch.int64: 4, torch.float32: 5, torch.float64: 6}
_STRING_WORDS = 7  # K5's uint32 words [3, n]
_CODES = 8         # int32 codes into a dictionary's word table
TABLE_INT32, TABLE_INT64, TABLE_STRING_WORDS = 3, 4, 7


class _HashCol(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("kind", ctypes.c_int32), ("table_kind", ctypes.c_int32),
                ("table", ctypes.c_void_p), ("table_n", ctypes.c_longlong)]


class CodeKey(NamedTuple):
    """An encoded key column for K4's code mode: int32 codes [rows] into a
    dictionary, their validity, and the dictionary's word table: its int32
    values (TABLE_INT32, a DATE dictionary), its int64 values (TABLE_INT64)
    or its K5 words [3, ndv] (TABLE_STRING_WORDS; int32 bits on the card,
    int64 words on the CPU)."""

    codes: Any
    validity: Any
    table: Any
    table_kind: int


def code_words_plain(key: CodeKey) -> List[Any]:
    """The words (int64 tensors) of an encoded key: the table's words
    gathered by code, the code clipped into the table (reference:
    _hash_ids_encoded's gather)."""
    t = key.table
    ndv = int(t.shape[-1])
    if ndv == 0:
        z = torch.zeros_like(key.codes, dtype=torch.int64)
        return {TABLE_INT32: [z], TABLE_INT64: [z, z]}.get(key.table_kind,
                                                           [z, z, z])
    idx = key.codes.long().clamp(0, ndv - 1)
    if key.table_kind == TABLE_INT32:
        return [t[idx].long() & M32]
    if key.table_kind == TABLE_INT64:
        x = t[idx].long()
        return [x & M32, (x >> 32) & M32]
    return [t[k][idx].long() & M32 for k in range(3)]


def _key_entry(c):
    if isinstance(c, CodeKey):
        return code_words_plain(c), c.validity
    return column_words(c), c.validity


def partition_ids_plain(cols: List[Any], live, num_partitions: int):
    """(ids int32 [rows], counts int32 [n + 1]): hash % n per live row, n
    elsewhere, and the rows per id. A CodeKey hashes its table's words."""
    h = hash_word_entries([_key_entry(c) for c in cols])
    ids = (h % num_partitions).to(torch.int32)
    if live is not None:
        ids = torch.where(live, ids, torch.full(
            (), num_partitions, dtype=torch.int32, device=ids.device))
    counts = torch.bincount(ids.long(), minlength=num_partitions + 1)
    return ids, counts.to(torch.int32)


def partition_ids(cols: List[Any], live, num_partitions: int):
    """Partition id per row and rows per id; pads (outside `live`) get id
    num_partitions. cols: ColV, or CodeKey for an encoded key (K4's code
    mode). CPU tensors run the plain version, CUDA tensors K4."""
    if cols[0].validity.device.type == "cpu":
        return partition_ids_plain(cols, live, num_partitions)
    lib = CB.library("hash_partition")
    n = int(cols[0].validity.shape[0])
    dev = cols[0].validity.device
    descs = (_HashCol * len(cols))()
    keep = []
    code_mode = False
    for k, c in enumerate(cols):
        valid = c.validity.contiguous()
        if isinstance(c, CodeKey):
            data = c.codes.to(torch.int32).contiguous()
            table = c.table.contiguous()
            CB.require_cuda(data, valid, table)
            descs[k].kind, descs[k].table_kind = _CODES, c.table_kind
            descs[k].table = table.data_ptr()
            descs[k].table_n = int(table.shape[-1])
            descs[k].data, descs[k].valid = data.data_ptr(), valid.data_ptr()
            keep += [data, valid, table]
            code_mode = True
            continue
        if c.dtype is DataType.STRING:
            data = string_hash_words_u32(c.offsets, c.data, valid)
            kind = _STRING_WORDS
        else:
            data = c.data.contiguous()
            kind = _KINDS[data.dtype]
        CB.require_cuda(data, valid)
        descs[k].data, descs[k].valid = data.data_ptr(), valid.data_ptr()
        descs[k].kind = kind
        keep += [data, valid]
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=dev)
    live = live.contiguous()
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(num_partitions + 1, dtype=torch.int32, device=dev)
    rc = lib.srt_hash_partition_ids(
        ctypes.addressof(descs), len(cols), n, live.data_ptr(),
        num_partitions, ids.data_ptr(), counts.data_ptr(),
        CB.stream_of(ids))
    CB.count_launch("hash_partition_codes" if code_mode else "hash_partition")
    CB.check(lib, rc, "hash_partition")
    return ids, counts


def host_partition_ids(cols: List[ColV], num_partitions: int) -> np.ndarray:
    """CPU-engine partition ids over numpy columns (the same hash)."""
    tcols = []
    for c in cols:
        valid = torch.from_numpy(np.asarray(c.validity, dtype=bool))
        data = c.data if c.dtype is DataType.STRING else \
            torch.from_numpy(np.ascontiguousarray(c.data))
        tcols.append(ColV(c.dtype, data, valid))
    ids, _ = partition_ids_plain(tcols, None, num_partitions)
    return ids.numpy()
