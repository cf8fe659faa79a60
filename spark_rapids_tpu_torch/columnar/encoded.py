"""Encoded columns: dictionary codes that stay codes on the card (port of
spark_rapids_tpu/columnar/encoded.py; design: docs/compressed-execution.md).

A Parquet dictionary chunk whose ndv / rows clears
rapids.tpu.sql.encoded.maxDictFraction leaves the scan as a
`DictionaryColumn`: int32 codes (0 under NULL), the ordinary validity, and
one content-interned `DeviceDictionary` (the SHA-1 of its byte table, so
the equal dictionaries of a file's row groups are one object). Operators
compute on the codes:

- equality, IN and IS NULL rewrite their literals into codes, comparisons
  against a literal into rank thresholds of the sorted dictionary
  (`count_lt_le`); an absent literal becomes code -1, which no row holds
  (`plan_filter`, `rewrite_condition`);
- group-by keys are codes, min / max reduce ranks (`plan_agg_update`);
- a dictionary-key join remaps the stream side's codes into the build
  dictionary (`join_remap`, K24 with fill -1: an absent value never
  matches);
- a hash exchange hashes a key's codes through its dictionary's word table
  (`DeviceDictionary.hash_table`, K4's code mode in ops/hashing.py), so
  pieces under other dictionaries, or plain pieces, land together;
- ORDER BY, range bounds and min / max run in rank space
  (`to_rank_space`, `union_rank_tables`).

Every other consumer decodes at its operator boundary through
`materialize()` (K23), the one path from codes back to values on the card;
ops/eval.py raises on an encoded column that reaches a value kernel. The
sink downloads codes and decodes them on the host
(`materialize_host_values`).

The kernels of this module (csrc/dict_encoded.cu), each beside its plain
version, which CPU tensors run:

- K23 `dict_materialize`, fixed mode (replaces `_materialize_fixed_kernel`
  :602) and string mode (replaces `_materialize_total` :608 and
  `_materialize_kernel` :614: spans by code, then K7's span entry);
- K24 `remap_codes` (replaces `_remap_kernel` :707, fill 0, and
  `_remap_join_kernel` :841, fill -1).

Elsewhere since slice 17: a scan column's run table (`runs`,
columnar/runs.py), the window's keys in rank space (exec/window.py) and
the serialized shuffle of codes with pruned dictionaries
(`HostDictionaryColumn`, shuffle/exchange.py, columnar/serde.py).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    HostColumnVector,
    bucket_capacity,
    gather_string_spans,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch
from spark_rapids_tpu_torch.columnar.strings import len_bucket

# the value types a Parquet dictionary chunk may stay encoded as besides
# STRING (rapids.tpu.sql.encoded.fixedDictionaries.enabled)
FIXED_DICT_DTYPES = (DataType.INT64, DataType.DATE, DataType.TIMESTAMP)

_DICT_CACHE_MAX = 256
_LOCK = threading.Lock()
_DICT_CACHE: "OrderedDict[str, DeviceDictionary]" = OrderedDict()
_NEXT_DID = [0]

# what the layer did, for tests and chip_smoke.py: columns the scan emitted
# encoded, device decodes (materialize), host decodes at the sink
_COUNTERS = {"encodedColumns": 0, "lateMaterializations": 0,
             "sinkMaterializations": 0}


def _count(name: str, k: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] += k


def counters() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0


def _device_key(device) -> str:
    return str(torch.device(device))


# ---------------------------------------------------------------------------
# DeviceDictionary
# ---------------------------------------------------------------------------
class DeviceDictionary:
    """One shared dictionary: `size` distinct values as a host byte table
    (uint8 bytes + int32 offsets: literal lookup, remaps, ranks, the sink)
    and per-device tables uploaded at first use (the materialize gathers
    and the hash word table). STRING values are UTF-8; fixed values (INT64,
    DATE, TIMESTAMP) are their little-endian bytes, so byte equality is
    value equality for every type. Immutable; built through the interning
    constructors only (reference :84-433)."""

    def __init__(self, host_bytes: np.ndarray, host_offsets: np.ndarray,
                 fingerprint: str, value_dtype: DataType):
        with _LOCK:
            _NEXT_DID[0] += 1
            self.did = _NEXT_DID[0]
        self.size = int(len(host_offsets) - 1)
        self.fingerprint = fingerprint
        self.host_bytes = host_bytes
        self.host_offsets = host_offsets
        self.host_lens = np.diff(host_offsets).astype(np.int32)
        self.max_len = len_bucket(int(self.host_lens.max()) if self.size
                                  else 1)
        self.value_dtype = value_dtype
        self._lock = threading.Lock()
        self._code_of: Optional[dict] = None
        self._host_values: Optional[np.ndarray] = None
        self._order = None       # (order rank -> code, rank code -> rank,
        #                           is_sorted)
        self._sorted: Optional[DeviceDictionary] = None
        self._remaps: Dict[int, Optional[np.ndarray]] = {}
        self._dev: Dict[tuple, torch.Tensor] = {}

    @property
    def is_fixed(self) -> bool:
        return self.value_dtype is not DataType.STRING

    # -- interning constructors ---------------------------------------------
    @staticmethod
    def from_byte_table(host_bytes: np.ndarray, host_offsets: np.ndarray,
                        value_dtype: DataType = DataType.STRING
                        ) -> "DeviceDictionary":
        """The interned dictionary of a byte table (the layout the Parquet
        dictionary page gives)."""
        host_offsets = np.ascontiguousarray(host_offsets, dtype=np.int32)
        total = int(host_offsets[-1]) if len(host_offsets) else 0
        host_bytes = np.ascontiguousarray(host_bytes[:total], dtype=np.uint8)
        h = hashlib.sha1()
        h.update(value_dtype.name.encode())
        h.update(host_offsets.tobytes())
        h.update(host_bytes.tobytes())
        fp = h.hexdigest()
        with _LOCK:
            got = _DICT_CACHE.get(fp)
            if got is not None:
                _DICT_CACHE.move_to_end(fp)
                return got
        d = DeviceDictionary(host_bytes, host_offsets, fp, value_dtype)
        with _LOCK:
            got = _DICT_CACHE.setdefault(fp, d)
            while len(_DICT_CACHE) > _DICT_CACHE_MAX:
                _DICT_CACHE.popitem(last=False)
            return got

    @staticmethod
    def from_fixed_values(values: np.ndarray,
                          value_dtype: DataType) -> "DeviceDictionary":
        npdt = value_dtype.to_np()
        values = np.ascontiguousarray(values, dtype=npdt)
        offsets = np.arange(len(values) + 1, dtype=np.int64) * npdt.itemsize
        if len(values) and int(offsets[-1]) > np.iinfo(np.int32).max:
            raise ValueError("fixed dictionary byte table exceeds int32")
        return DeviceDictionary.from_byte_table(
            values.view(np.uint8), offsets.astype(np.int32), value_dtype)

    @staticmethod
    def from_values(values: Sequence) -> "DeviceDictionary":
        """A STRING dictionary of python strings (or bytes)."""
        enc = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
               for v in values]
        offsets = np.zeros(len(enc) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in enc], out=offsets[1:])
        buf = np.frombuffer(b"".join(enc), dtype=np.uint8)
        return DeviceDictionary.from_byte_table(buf, offsets.astype(np.int32))

    # -- host views ----------------------------------------------------------
    def _fixed_keys(self) -> np.ndarray:
        """A fixed dictionary's values as signed integers of their width:
        integer equality is byte equality."""
        w = self.value_dtype.to_np().itemsize
        return self.host_bytes.view(np.dtype(f"<i{w}"))

    def _entries(self) -> List[bytes]:
        o = self.host_offsets
        raw = self.host_bytes.tobytes()
        return [raw[o[i]:o[i + 1]] for i in range(self.size)]

    def host_values(self) -> np.ndarray:
        """Decoded values: an object array of str (STRING) or the value
        type's array (cached)."""
        with self._lock:
            if self._host_values is None:
                if self.is_fixed:
                    self._host_values = self.host_bytes.view(
                        self.value_dtype.to_np()).copy()
                else:
                    out = np.empty(self.size, dtype=object)
                    for i, b in enumerate(self._entries()):
                        out[i] = b.decode("utf-8", errors="replace")
                    self._host_values = out
            return self._host_values

    def _value_key(self, value) -> bytes:
        if isinstance(value, str):
            return value.encode("utf-8")
        if self.is_fixed and isinstance(value, (int, np.integer)):
            return self.value_dtype.to_np().type(value).tobytes()
        return bytes(value)

    def code_of(self, value) -> int:
        """The code of a literal value, -1 when absent (a code no row
        holds)."""
        with self._lock:
            if self._code_of is None:
                self._code_of = {b: i for i, b in enumerate(self._entries())}
            table = self._code_of
        return table.get(self._value_key(value), -1)

    # -- order ----------------------------------------------------------------
    def _order_rank(self):
        """(order rank -> code, rank code -> rank, is_sorted), cached.
        STRING values order by UTF-8 bytes (code-point order, the order of
        the device string comparisons); fixed values numerically."""
        with self._lock:
            if self._order is not None:
                return self._order
        if self.size == 0:
            built = (np.zeros(0, np.int32), np.zeros(0, np.int32), True)
        else:
            vals = self.host_values() if self.is_fixed else \
                np.array(self._entries(), dtype=object)
            order = np.argsort(vals, kind="stable").astype(np.int32)
            rank = np.empty(self.size, np.int32)
            rank[order] = np.arange(self.size, dtype=np.int32)
            built = (order, rank, bool((order == np.arange(self.size)).all()))
        with self._lock:
            if self._order is None:
                self._order = built
            return self._order

    @property
    def is_sorted(self) -> bool:
        return self._order_rank()[2]

    def rank_codes(self) -> np.ndarray:
        """int32 code -> rank (the identity when already sorted)."""
        _order, rank, is_sorted = self._order_rank()
        return np.arange(self.size, dtype=np.int32) if is_sorted else rank

    def rank_remap(self) -> Optional[np.ndarray]:
        """code -> rank into `sorted_dict()`, None when already sorted."""
        _order, rank, is_sorted = self._order_rank()
        return None if is_sorted else rank

    def sorted_dict(self) -> "DeviceDictionary":
        """The interned dictionary of the same values in ascending order:
        its codes are ranks."""
        order, _rank, is_sorted = self._order_rank()
        if is_sorted:
            return self
        with self._lock:
            if self._sorted is not None:
                return self._sorted
        o = self.host_offsets
        lens = self.host_lens[order]
        offsets = np.zeros(self.size + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        src = np.repeat(o[:-1][order].astype(np.int64) - offsets[:-1], lens) \
            + np.arange(int(offsets[-1]))
        sd = DeviceDictionary.from_byte_table(self.host_bytes[src],
                                              offsets.astype(np.int32),
                                              self.value_dtype)
        with self._lock:
            if self._sorted is None:
                self._sorted = sd
            return self._sorted

    def count_lt_le(self, value) -> Tuple[int, int]:
        """(# values < literal, # values <= literal): the rank thresholds a
        comparison rewrites its literal to (reference :318), for literals
        absent from the dictionary too."""
        order, _rank, _s = self._order_rank()
        if self.size == 0:
            return 0, 0
        if self.is_fixed:
            svals = self.host_values()[order]
            v = self.value_dtype.to_np().type(value)
            return (int(np.searchsorted(svals, v, side="left")),
                    int(np.searchsorted(svals, v, side="right")))
        entries = self._entries()
        svals = [entries[c] for c in order]
        key = self._value_key(value)
        return bisect.bisect_left(svals, key), bisect.bisect_right(svals, key)

    # -- device tables -------------------------------------------------------
    def _cached(self, key: tuple, build):
        with self._lock:
            got = self._dev.get(key)
        if got is not None:
            return got
        t = build()
        with self._lock:
            return self._dev.setdefault(key, t)

    def device_strings(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bytes uint8, offsets int32 [size + 1]) on `device`."""
        dk = _device_key(device)
        byts = self._cached(("bytes", dk), lambda: _to_device(
            self.host_bytes if len(self.host_bytes) else
            np.zeros(1, np.uint8), device))
        offs = self._cached(("offsets", dk), lambda: _to_device(
            self.host_offsets, device))
        return byts, offs

    def device_fixed_values(self, device) -> torch.Tensor:
        """The value table (int32 for DATE, int64 for INT64 / TIMESTAMP)."""
        assert self.is_fixed
        return self._cached(("values", _device_key(device)),
                            lambda: _to_device(self.host_values(), device))

    def device_table(self, table: np.ndarray, name: str,
                     device) -> torch.Tensor:
        """A host int32 table of this dictionary (a remap) on `device`,
        uploaded once."""
        return self._cached((name, _device_key(device)),
                            lambda: _to_device(table, device))

    def hash_table(self, device):
        """(word table, table kind) for K4's code mode (reference
        `hash_words` :392 with `_dict_fixed_hash_words_kernel` :437 and
        `_dict_hash_words_kernel` :463): a STRING dictionary's K5 words
        [3, size], computed once per dictionary and device over its bytes;
        a fixed dictionary's value table itself."""
        from spark_rapids_tpu_torch.ops import hashing as H

        if self.is_fixed:
            vals = self.device_fixed_values(device)
            return vals, (H.TABLE_INT32 if vals.dtype == torch.int32
                          else H.TABLE_INT64)

        def build():
            byts, offs = self.device_strings(device)
            ok = torch.ones(self.size, dtype=torch.bool, device=byts.device)
            if byts.device.type == "cpu":
                return H.string_hash_words_plain(offs, byts, ok)
            return H.string_hash_words_u32(offs, byts, ok)

        return (self._cached(("hash", _device_key(device)), build),
                H.TABLE_STRING_WORDS)

    # -- alignment ------------------------------------------------------------
    def remap_to(self, other: "DeviceDictionary") -> Optional[np.ndarray]:
        """int32 [max(size, 1)] of my codes in `other`'s code space (-1 for
        values `other` lacks), None when `other` is this dictionary."""
        if other is self:
            return None
        with self._lock:
            if other.did in self._remaps:
                return self._remaps[other.did]
        table = np.full(max(self.size, 1), -1, dtype=np.int32)
        if self.is_fixed and other.value_dtype is self.value_dtype:
            # fixed values: one sorted search, not a lookup an entry
            mine, theirs = self._fixed_keys(), other._fixed_keys()
            if len(theirs):
                order = np.argsort(theirs, kind="stable")
                at = np.minimum(np.searchsorted(theirs[order], mine),
                                len(theirs) - 1)
                hit = theirs[order[at]] == mine
                table[:self.size] = np.where(hit, order[at], -1)
        else:
            for i, b in enumerate(self._entries()):
                table[i] = other.code_of(b)
        with self._lock:
            return self._remaps.setdefault(other.did, table)

    def __repr__(self):
        return (f"DeviceDictionary({self.value_dtype.name}, size={self.size},"
                f" did={self.did})")


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(torch.device(device))


# ---------------------------------------------------------------------------
# DictionaryColumn
# ---------------------------------------------------------------------------
class DictionaryColumn(ColumnVector):
    """An encoded device column: `dtype` is the value type (STRING, INT64,
    DATE, TIMESTAMP), `data` int32 codes into `dictionary`, `validity` the
    null mask (code 0 under NULL). It has no offsets, so batch operations
    move it as fixed int32 lanes and re-wrap it (`with_data`)."""

    __slots__ = ("dictionary",)

    def __init__(self, dtype: DataType, codes, validity,
                 dictionary: DeviceDictionary):
        super().__init__(dtype, codes, validity, None, dictionary.max_len)
        self.dictionary = dictionary

    def with_data(self, data, validity) -> "DictionaryColumn":
        return DictionaryColumn(self.dtype, data, validity, self.dictionary)

    def __repr__(self):
        return (f"DictionaryColumn({self.dtype.name}, cap={self.capacity}, "
                f"ndv={self.dictionary.size})")


def is_encoded(cv) -> bool:
    return isinstance(cv, DictionaryColumn)


def encoded_ordinals(batch: ColumnarBatch) -> Tuple[int, ...]:
    return tuple(i for i, c in enumerate(batch.columns) if is_encoded(c))


def enc_sig(batch: ColumnarBatch) -> tuple:
    """(ordinal, dictionary id) of each encoded column: with interned
    dictionaries it fixes every code-space plan of fixed expressions."""
    return tuple((i, c.dictionary.did) for i, c in enumerate(batch.columns)
                 if is_encoded(c))


class HostDictionaryColumn(HostColumnVector):
    """Host mirror of a DictionaryColumn: int32 codes + validity + the
    shared dictionary (reference :665). Uploads as codes; any value access
    decodes through the dictionary's host values."""

    __slots__ = ("dictionary",)

    def __init__(self, dtype: DataType, codes: np.ndarray,
                 validity: np.ndarray, dictionary: DeviceDictionary):
        super().__init__(dtype, np.asarray(codes, dtype=np.int32),
                         np.asarray(validity, dtype=bool))
        self.dictionary = dictionary

    def decoded(self) -> HostColumnVector:
        return HostColumnVector(self.dtype, materialize_host_values(
            self.data, self.validity, self.dictionary), self.validity)

    def to_pylist(self):
        return self.decoded().to_pylist()


# ---------------------------------------------------------------------------
# K23 dict_materialize and K24 remap_codes
# ---------------------------------------------------------------------------
def _clip(codes, n: int):
    return codes.long().clamp(0, max(n - 1, 0))


def dict_materialize_fixed_plain(codes, validity, vals):
    """vals[clip(code)] per valid row, 0 under NULL (reference
    `_materialize_fixed_kernel` :602)."""
    n = int(vals.shape[0])
    if n == 0:
        return torch.zeros(codes.shape[0], dtype=vals.dtype,
                           device=codes.device)
    return torch.where(validity, vals[_clip(codes, n)],
                       torch.zeros((), dtype=vals.dtype, device=codes.device))


def dict_materialize_fixed(codes, validity, vals):
    """K23, fixed mode. CPU tensors run the plain version, CUDA tensors the
    kernel."""
    if codes.device.type == "cpu":
        return dict_materialize_fixed_plain(codes, validity, vals)
    codes = codes.to(torch.int32).contiguous()
    validity = validity.contiguous()
    vals = vals.contiguous()
    CB.require_cuda(codes, validity, vals)
    width = vals.element_size()
    out = torch.empty(codes.shape[0], dtype=vals.dtype, device=codes.device)
    lib = CB.library("dict_encoded")
    rc = lib.srt_dict_materialize_fixed(
        codes.data_ptr(), validity.data_ptr(), int(codes.shape[0]),
        vals.data_ptr(), int(vals.shape[0]), width, out.data_ptr(),
        CB.stream_of(codes))
    CB.count_launch("dict_materialize_fixed")
    CB.check(lib, rc, "dict_materialize_fixed")
    return out


def dict_materialize_spans_plain(codes, validity, offsets):
    """(starts int64, lens int32) of each row's value in the dictionary's
    byte table, length 0 under NULL."""
    ndv = int(offsets.shape[0]) - 1
    dev = codes.device
    if ndv <= 0:
        z = torch.zeros(codes.shape[0], dtype=torch.int64, device=dev)
        return z, z.to(torch.int32)
    c = _clip(codes, ndv)
    starts = torch.where(validity, offsets[c].long(),
                         torch.zeros((), dtype=torch.int64, device=dev))
    lens = torch.where(validity, offsets[c + 1] - offsets[c],
                       torch.zeros((), dtype=offsets.dtype, device=dev))
    return starts, lens.to(torch.int32)


def dict_materialize_spans(codes, validity, offsets):
    """K23, string mode's own kernel (the bytes follow through K7's span
    entry)."""
    if codes.device.type == "cpu":
        return dict_materialize_spans_plain(codes, validity, offsets)
    codes = codes.to(torch.int32).contiguous()
    validity = validity.contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    CB.require_cuda(codes, validity, offsets)
    n = int(codes.shape[0])
    starts = torch.empty(n, dtype=torch.int64, device=codes.device)
    lens = torch.empty(n, dtype=torch.int32, device=codes.device)
    lib = CB.library("dict_encoded")
    rc = lib.srt_dict_materialize_spans(
        codes.data_ptr(), validity.data_ptr(), n, offsets.data_ptr(),
        int(offsets.shape[0]) - 1, starts.data_ptr(), lens.data_ptr(),
        CB.stream_of(codes))
    CB.count_launch("dict_materialize_strings")
    CB.check(lib, rc, "dict_materialize_strings")
    return starts, lens


def remap_codes_plain(codes, validity, remap, fill: int):
    """remap[clip(code)] per valid row, `fill` under NULL (reference
    `_remap_kernel` :707 with fill 0, `_remap_join_kernel` :841 with -1)."""
    n = int(remap.shape[0])
    f = torch.full((), fill, dtype=torch.int32, device=codes.device)
    if n == 0:
        return f.expand(codes.shape[0]).clone()
    return torch.where(validity, remap[_clip(codes, n)].to(torch.int32), f)


def remap_codes(codes, validity, remap, fill: int):
    """K24. CPU tensors run the plain version, CUDA tensors the kernel."""
    if codes.device.type == "cpu":
        return remap_codes_plain(codes, validity, remap, fill)
    codes = codes.to(torch.int32).contiguous()
    validity = validity.contiguous()
    remap = remap.to(torch.int32).contiguous()
    CB.require_cuda(codes, validity, remap)
    out = torch.empty(codes.shape[0], dtype=torch.int32, device=codes.device)
    lib = CB.library("dict_encoded")
    rc = lib.srt_remap_codes(
        codes.data_ptr(), validity.data_ptr(), int(codes.shape[0]),
        remap.data_ptr(), int(remap.shape[0]), int(fill), out.data_ptr(),
        CB.stream_of(codes))
    CB.count_launch("remap_codes")
    CB.check(lib, rc, "remap_codes")
    return out


# ---------------------------------------------------------------------------
# Materialization: the one path from codes back to values
# ---------------------------------------------------------------------------
# a string materialize sizes its bytes from cap * max_len when that bound
# stays under this many bytes (or 4x the dictionary's), else from one read
# of the exact total (reference :547)
_MATERIALIZE_BOUND_BUDGET = 64 << 20


def materialize(cv: DictionaryColumn) -> ColumnVector:
    """Decode an encoded column to a plain device column (reference :550):
    K23 over the dictionary's value table (fixed), or K23's spans plus
    K7's span entry (STRING). The decode runs under with_retry at the
    `encoded.materialize` site (reference :569-596): it is pure over the
    codes, so a CUDA OOM spills and decodes again."""
    from spark_rapids_tpu_torch.engine.retry import with_retry

    assert is_encoded(cv)
    _count("lateMaterializations")
    return with_retry(lambda: _materialize(cv), site="encoded.materialize")


def _materialize(cv: DictionaryColumn) -> ColumnVector:
    d = cv.dictionary
    dev = cv.data.device
    if d.is_fixed:
        data = dict_materialize_fixed(cv.data, cv.validity,
                                      d.device_fixed_values(dev))
        want = to_torch(cv.dtype)
        return ColumnVector(cv.dtype, data if data.dtype == want
                            else data.to(want), cv.validity)
    byts, offs = d.device_strings(dev)
    cap = cv.capacity
    starts, lens = dict_materialize_spans(cv.data, cv.validity, offs)
    bound = cap * d.max_len
    if bound <= max(4 * int(byts.shape[0]), _MATERIALIZE_BOUND_BUDGET):
        byte_cap = bucket_capacity(max(bound, 8))
    else:
        # host sync: the exact byte total of a wide dictionary at a large
        # capacity (the reference's `_materialize_total` read)
        byte_cap = bucket_capacity(max(int(lens.sum()), 8))
    offsets, data, valid = gather_string_spans(byts, starts, lens,
                                               cv.validity, cap, byte_cap)
    return ColumnVector(DataType.STRING, data, valid, offsets, d.max_len)


def decode_batch(batch: ColumnarBatch) -> ColumnarBatch:
    """Every encoded column of a batch materialized (an operator-boundary
    decode); the batch itself when none is encoded."""
    return batch_with_materialized(batch, encoded_ordinals(batch))


def batch_with_materialized(batch: ColumnarBatch, ords) -> ColumnarBatch:
    """The encoded columns at `ords` materialized."""
    ords = [i for i in ords if is_encoded(batch.columns[i])]
    if not ords:
        return batch
    cols = list(batch.columns)
    for i in ords:
        cols[i] = materialize(cols[i])
    return ColumnarBatch(cols, batch.num_rows, live=batch.live)


def materialize_host_values(codes: np.ndarray, validity: np.ndarray,
                            dictionary: DeviceDictionary) -> np.ndarray:
    """The sink's decode (reference :637): one numpy take through the
    dictionary's host values; codes crossed to the host, values never
    did."""
    _count("sinkMaterializations")
    vals = dictionary.host_values()
    n = len(codes)
    if dictionary.is_fixed:
        npdt = dictionary.value_dtype.to_np()
        if dictionary.size == 0:
            return np.zeros(n, dtype=npdt)
        out = vals[np.clip(codes, 0, dictionary.size - 1)]
        return np.where(validity, out, npdt.type(0))
    if dictionary.size == 0:
        return np.full(n, "", dtype=object)
    out = vals[np.clip(codes, 0, dictionary.size - 1)]
    if not validity.all():
        out = np.where(validity, out, "")
    return out.astype(object)


# ---------------------------------------------------------------------------
# Remaps, rank space, alignment
# ---------------------------------------------------------------------------
def apply_remap(cv: DictionaryColumn, remap: Optional[np.ndarray],
                target: DeviceDictionary) -> DictionaryColumn:
    """The column's codes in `target`'s code space through a host remap
    table of its dictionary (None: the identity), K24 with fill 0."""
    if remap is None:
        return cv if cv.dictionary is target else \
            DictionaryColumn(cv.dtype, cv.data, cv.validity, target)
    table = cv.dictionary.device_table(remap, f"remap:{target.did}",
                                       cv.data.device)
    codes = remap_codes(cv.data, cv.validity, table, 0)
    return DictionaryColumn(cv.dtype, codes, cv.validity, target)


def to_rank_space(cv: DictionaryColumn) -> DictionaryColumn:
    """The column re-encoded through its dictionary's sorted sibling, so
    code order is value order (no launch when already sorted). Not a
    decode."""
    d = cv.dictionary
    return apply_remap(cv, d.rank_remap(), d.sorted_dict())


def batch_to_rank_space(batch: ColumnarBatch, ords) -> ColumnarBatch:
    cols = list(batch.columns)
    changed = False
    for i in ords:
        if is_encoded(cols[i]) and not cols[i].dictionary.is_sorted:
            cols[i] = to_rank_space(cols[i])
            changed = True
    if not changed:
        return batch
    return ColumnarBatch(cols, batch.num_rows, live=batch.live)


def align_encoded(cols: Sequence[DictionaryColumn]
                  ) -> Tuple[DeviceDictionary, List[DictionaryColumn]]:
    """Same-position encoded columns of several batches on one dictionary:
    the first one's entries keep their codes, each value a later one adds
    appends once (reference :741). Interned dictionaries make the no-op
    the common case."""
    base = cols[0].dictionary
    dicts = [c.dictionary for c in cols]
    if all(d is base for d in dicts):
        return base, list(cols)
    union = _union_fixed(base, dicts) if base.is_fixed else \
        _union_entries(base, dicts)
    return union, [apply_remap(c, c.dictionary.remap_to(union), union)
                   for c in cols]


def _later_dicts(base: DeviceDictionary, dicts) -> List[DeviceDictionary]:
    """dicts[1:] without base and repeats, in order."""
    seen, out = {base.did}, []
    for d in dicts[1:]:
        if d.did not in seen:
            seen.add(d.did)
            out.append(d)
    return out


def _union_entries(base: DeviceDictionary, dicts) -> DeviceDictionary:
    """base's entries, then each value a later dictionary adds, in order."""
    entries = base._entries()
    mapping = {b: i for i, b in enumerate(entries)}
    for d in _later_dicts(base, dicts):
        for b in d._entries():
            if b not in mapping:
                mapping[b] = len(mapping)
                entries.append(b)
    if len(entries) == base.size:
        return base
    offsets = np.zeros(len(entries) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in entries], out=offsets[1:])
    return DeviceDictionary.from_byte_table(
        np.frombuffer(b"".join(entries), dtype=np.uint8),
        offsets.astype(np.int32), base.value_dtype)


def _union_fixed(base: DeviceDictionary, dicts) -> DeviceDictionary:
    """_union_entries for fixed values, vectorised: the values the later
    dictionaries add, in the order they first appear."""
    later = _later_dicts(base, dicts)
    if not later:
        return base
    cat = np.concatenate([d._fixed_keys() for d in later])
    cand = cat[~np.isin(cat, base._fixed_keys())]
    if not len(cand):
        return base
    _, first = np.unique(cand, return_index=True)
    keys = np.concatenate([base._fixed_keys(), cand[np.sort(first)]])
    return DeviceDictionary.from_fixed_values(
        keys.view(base.value_dtype.to_np()), base.value_dtype)


def union_rank_tables(dicts: Sequence[DeviceDictionary]
                      ) -> Dict[int, np.ndarray]:
    """{did: int32 code -> rank over the union of the dictionaries'
    values} (reference :785): range bounds compare across pieces under
    different dictionaries; equal values share a rank."""
    if len({d.did for d in dicts}) == 1:
        return {dicts[0].did: dicts[0].rank_codes()}
    if dicts[0].is_fixed:
        per = [np.asarray(d.host_values()) for d in dicts]
        union = np.unique(np.concatenate(per))
        return {d.did: np.searchsorted(union, v).astype(np.int32)
                for d, v in zip(dicts, per)}
    per = [d._entries() for d in dicts]
    pos = {b: i for i, b in enumerate(sorted({b for v in per for b in v}))}
    return {d.did: np.asarray([pos[b] for b in v], dtype=np.int32)
            for d, v in zip(dicts, per)}


def join_remap(stream_dict: DeviceDictionary,
               build_dict: DeviceDictionary) -> Optional[np.ndarray]:
    """Stream codes -> build codes, -1 for a value the build side lacks
    (reference :818); None when both sides share a dictionary."""
    return stream_dict.remap_to(build_dict)


def remapped_join_codes(cv: DictionaryColumn,
                        build_dict: DeviceDictionary):
    """int32 codes of a stream key in the build dictionary's space (K24
    with fill -1), or the codes themselves when the dictionaries are one."""
    remap = join_remap(cv.dictionary, build_dict)
    if remap is None:
        return cv.data
    table = cv.dictionary.device_table(remap, f"remap:{build_dict.did}",
                                       cv.data.device)
    return remap_codes(cv.data, cv.validity, table, -1)


def code_key(cv: DictionaryColumn):
    """The K4 code-mode key of an encoded column."""
    from spark_rapids_tpu_torch.ops.hashing import CodeKey

    table, kind = cv.dictionary.hash_table(cv.data.device)
    return CodeKey(cv.data, cv.validity, table, kind)


# ---------------------------------------------------------------------------
# Code-space rewrite of predicates (bound expressions)
# ---------------------------------------------------------------------------
def _is_enc_literal(e, ref) -> bool:
    """A literal that translates into the code space of the reference's
    value type: a string for STRING, an integer for INT64, its own type for
    DATE / TIMESTAMP; NULL for any."""
    from spark_rapids_tpu_torch.ops.literals import Literal

    if not isinstance(e, Literal):
        return False
    if e.value is None:
        return True
    rdt = ref.data_type
    if rdt is DataType.INT64:
        return e.data_type in (DataType.INT32, DataType.INT64)
    return e.data_type is rdt


def _is_ref(e) -> bool:
    from spark_rapids_tpu_torch.ops.base import BoundReference

    return isinstance(e, BoundReference)


def classify_refs(exprs: Sequence, enc_ords) -> Tuple[set, set]:
    """(code_ords, rank_ords): the encoded ordinals whose every use in
    `exprs` is computable on codes (reference `classify_code_refs` :881):
    equality or an order comparison against a literal, IN over literals,
    IS [NOT] NULL. An ordinal with an order comparison is also in
    rank_ords: it must re-encode to rank space first. Any other use needs
    values."""
    from spark_rapids_tpu_torch.ops.literals import Literal
    from spark_rapids_tpu_torch.ops.nulls import IsNotNull, IsNull
    from spark_rapids_tpu_torch.ops import predicates as P

    enc = set(enc_ords)
    ok = set(enc)
    rank = set()

    def enc_ref(e) -> bool:
        return _is_ref(e) and e.ordinal in enc

    def walk(e) -> None:
        if isinstance(e, P.EqualTo):
            if enc_ref(e.left) and _is_enc_literal(e.right, e.left):
                return
            if enc_ref(e.right) and _is_enc_literal(e.left, e.right):
                return
        elif isinstance(e, (P.LessThan, P.LessThanOrEqual, P.GreaterThan,
                            P.GreaterThanOrEqual)):
            if enc_ref(e.left) and _is_enc_literal(e.right, e.left):
                rank.add(e.left.ordinal)
                return
            if enc_ref(e.right) and _is_enc_literal(e.left, e.right):
                rank.add(e.right.ordinal)
                return
        elif isinstance(e, P.In):
            if enc_ref(e.value) and all(
                    isinstance(c, Literal) and _is_enc_literal(c, e.value)
                    for c in e.candidates):
                return
        elif isinstance(e, (IsNull, IsNotNull)) and enc_ref(e.child):
            return
        if enc_ref(e):
            ok.discard(e.ordinal)
            return
        for c in e.children():
            walk(c)

    for e in exprs:
        walk(e)
    return ok, rank & ok


def rewrite_condition(expr, dict_by_ord: Dict[int, DeviceDictionary]):
    """The expression with its uses of the ordinals in `dict_by_ord`
    rewritten into code space (reference :993): literals become codes
    (absent: -1), order comparisons rank thresholds of a sorted
    dictionary, references INT32. Callers classify first."""
    from spark_rapids_tpu_torch.ops.base import BoundReference
    from spark_rapids_tpu_torch.ops.literals import Literal
    from spark_rapids_tpu_torch.ops.nulls import IsNotNull, IsNull
    from spark_rapids_tpu_torch.ops import predicates as P

    def ref(e):
        return BoundReference(e.ordinal, DataType.INT32, e.nullable)

    def mine(e) -> bool:
        return _is_ref(e) and e.ordinal in dict_by_ord

    def code_lit(d, lit):
        if lit.value is None:
            return Literal(None, DataType.INT32)
        return Literal(int(d.code_of(lit.value)), DataType.INT32)

    def rank_lit(d, lit, ref_left: bool, cls):
        # v < x <=> r < lt; v <= x <=> r <= le - 1; v > x <=> r > le - 1;
        # v >= x <=> r >= lt (mirrored for lit OP col)
        if lit.value is None:
            return Literal(None, DataType.INT32)
        lt, le = d.count_lt_le(lit.value)
        want_lt = cls in ((P.LessThan, P.GreaterThanOrEqual) if ref_left
                          else (P.LessThanOrEqual, P.GreaterThan))
        return Literal(int(lt if want_lt else le - 1), DataType.INT32)

    def rw(e):
        if isinstance(e, P.EqualTo):
            if mine(e.left) and _is_enc_literal(e.right, e.left):
                return P.EqualTo(ref(e.left),
                                 code_lit(dict_by_ord[e.left.ordinal],
                                          e.right))
            if mine(e.right) and _is_enc_literal(e.left, e.right):
                return P.EqualTo(code_lit(dict_by_ord[e.right.ordinal],
                                          e.left), ref(e.right))
        elif isinstance(e, (P.LessThan, P.LessThanOrEqual, P.GreaterThan,
                            P.GreaterThanOrEqual)):
            cls = type(e)
            if mine(e.left) and _is_enc_literal(e.right, e.left):
                return cls(ref(e.left), rank_lit(
                    dict_by_ord[e.left.ordinal], e.right, True, cls))
            if mine(e.right) and _is_enc_literal(e.left, e.right):
                return cls(rank_lit(dict_by_ord[e.right.ordinal], e.left,
                                    False, cls), ref(e.right))
        elif isinstance(e, P.In) and mine(e.value):
            d = dict_by_ord[e.value.ordinal]
            return P.In(ref(e.value), [code_lit(d, c) for c in e.candidates])
        elif isinstance(e, (IsNull, IsNotNull)) and mine(e.child):
            return type(e)(ref(e.child))
        kids = e.children()
        return e.with_children([rw(c) for c in kids]) if kids else e

    return rw(expr)


def _ref_ords(expr) -> set:
    return {r.ordinal for r in expr.collect(_is_ref)}


class _Plan:
    """A code-space plan's batch preparation: `rank_ords` re-encode to
    rank space, `mat_ords` materialize."""

    __slots__ = ("rank_ords", "mat_ords")

    def prepare(self, batch: ColumnarBatch) -> ColumnarBatch:
        batch = batch_to_rank_space(batch, self.rank_ords)
        return batch_with_materialized(batch, self.mat_ords)


class CodePlan(_Plan):
    """How one set of bound expressions evaluates over a batch's encoded
    columns: the rewritten expressions, the ordinals read as codes, those
    that re-encode to rank space first and those that materialize."""

    __slots__ = ("exprs", "code_ords")

    def __init__(self, exprs, code_ords, rank_ords, mat_ords):
        self.exprs = exprs
        self.code_ords = code_ords
        self.rank_ords = rank_ords
        self.mat_ords = mat_ords


def plan_exprs(exprs: Sequence, batch: ColumnarBatch,
               keep_bare: bool = False) -> Optional[CodePlan]:
    """The code-space plan of bound expressions over a batch (reference
    `plan_filter` :1117, and the projection's plan, ops/eval.py :202-256);
    None when the batch has no encoded column. keep_bare: a bare reference
    (or an Alias of one) passes its encoded column through and does not
    force a decode."""
    from spark_rapids_tpu_torch.ops.base import Alias

    enc = {i: c for i, c in enumerate(batch.columns) if is_encoded(c)}
    if not enc:
        return None
    checked_at = [k for k, e in enumerate(exprs)
                  if not (keep_bare and _is_ref(
                      e.child if isinstance(e, Alias) else e))]
    checked = [exprs[k] for k in checked_at]
    ok, rank = classify_refs(checked, enc.keys())
    referenced = set()
    for e in checked:
        referenced |= _ref_ords(e)
    mat = sorted((set(enc) - ok) & referenced)
    dicts = {i: (enc[i].dictionary.sorted_dict() if i in rank
                 else enc[i].dictionary) for i in ok}
    out = list(exprs)
    if dicts:
        for k in checked_at:
            out[k] = rewrite_condition(exprs[k], dicts)
    return CodePlan(out, frozenset(ok), frozenset(rank), tuple(mat))


def eval_columns(batch: ColumnarBatch, code_ords=()):
    """ColV per column for evaluation: codes (INT32) for the ordinals kept
    in code space; any other encoded column raises in col_to_colv."""
    from spark_rapids_tpu_torch.ops.eval import col_to_colv
    from spark_rapids_tpu_torch.ops.values import ColV

    return [ColV(DataType.INT32, c.data, c.validity)
            if is_encoded(c) and i in code_ords else col_to_colv(c)
            for i, c in enumerate(batch.columns)]


def bare_ordinal(e, batch: ColumnarBatch) -> Optional[int]:
    """The ordinal of the encoded column `e` references bare (or under an
    Alias), else None."""
    from spark_rapids_tpu_torch.ops.base import Alias

    inner = e.child if isinstance(e, Alias) else e
    if _is_ref(inner) and is_encoded(batch.columns[inner.ordinal]):
        return inner.ordinal
    return None


def key_columns(batch: ColumnarBatch, bound, pidx: int = 0) -> list:
    """Per bound key expression: the encoded column a bare reference
    names, or the key's evaluated ColV over a view of the batch whose
    encoded columns the computed keys read are materialized (the
    exchange's and the join's keys)."""
    from spark_rapids_tpu_torch.ops.eval import eval_as_col
    from spark_rapids_tpu_torch.ops.values import EvalContext

    bare = [bare_ordinal(e, batch) for e in bound]
    out: list = [batch.columns[b] if b is not None else None for b in bare]
    computed = [e for e, b in zip(bound, bare) if b is None]
    if computed:
        enc = set(encoded_ordinals(batch))
        reads = set()
        for e in computed:
            reads |= _ref_ords(e)
        vbatch = batch_with_materialized(batch, sorted(enc & reads))
        ctx = EvalContext(True, eval_columns(vbatch, enc - reads),
                          vbatch.num_rows, vbatch.capacity,
                          partition_id=pidx, device=vbatch.device)
        for k, (e, b) in enumerate(zip(bound, bare)):
            if b is None:
                out[k] = eval_as_col(ctx, e)
    return out


# ---------------------------------------------------------------------------
# Aggregate planning (exec/aggregate.py): group on codes, min / max on ranks
# ---------------------------------------------------------------------------
class AggEncPlan(_Plan):
    """The update's plan for one batch's dictionaries (reference :1188):
    rewritten keys / inputs / filters, the ordinals kept as codes, those
    re-encoded to rank space, those materialized, and the dictionary of
    each code-valued output position (grouping keys, min / max
    buffers)."""

    __slots__ = ("keys", "inputs", "filters", "code_ords", "out_dicts")

    def __init__(self, keys, inputs, filters, code_ords, rank_ords,
                 mat_ords, out_dicts):
        self.keys = keys
        self.inputs = inputs
        self.filters = filters
        self.code_ords = code_ords
        self.rank_ords = rank_ords
        self.mat_ords = mat_ords
        self.out_dicts = out_dicts


def plan_agg_update(batch: ColumnarBatch, keys, inputs, filters,
                    op_names) -> Optional[AggEncPlan]:
    """None when the batch has no encoded column (reference
    `plan_agg_update` :1215, over bound expressions). An encoded column
    stays codes when its only uses are a bare grouping key (codes are
    injective per dictionary), a bare min / max input (reduced as ranks
    of the sorted dictionary; the winning code goes on to the sink), and
    code-space predicates in the filters or inside other inputs (a CASE
    over `col IN (...)`). Any other use decodes it at the boundary."""
    from spark_rapids_tpu_torch.ops.base import Alias

    enc = {i: c for i, c in enumerate(batch.columns) if is_encoded(c)}
    if not enc:
        return None

    def bare(e):
        inner = e.child if isinstance(e, Alias) else e
        return inner.ordinal if _is_ref(inner) and inner.ordinal in enc \
            else None

    minmax = set()
    checked = list(filters)
    for op, e in zip(op_names, inputs):
        b = bare(e)
        if op in ("min", "max") and b is not None:
            minmax.add(b)
        else:
            checked.append(e)
    for e in keys:
        if bare(e) is None:
            checked.append(e)
    kept, rank = classify_refs(checked, enc.keys())
    rank = (rank | minmax) & kept
    referenced = set(minmax)
    for e in list(keys) + list(inputs) + list(filters):
        referenced |= _ref_ords(e)
    mat = tuple(sorted((set(enc) - kept) & referenced))

    def eff(i):
        d = enc[i].dictionary
        return d.sorted_dict() if i in rank else d

    dicts = {i: eff(i) for i in kept}

    def rw(e):
        return rewrite_condition(e, dicts) if dicts else e

    n_keys = len(keys)
    out_dicts = {}
    for k, e in enumerate(keys):
        if bare(e) in kept:
            out_dicts[k] = dicts[bare(e)]
    for x, (op, e) in enumerate(zip(op_names, inputs)):
        if op in ("min", "max") and bare(e) in kept:
            out_dicts[n_keys + x] = dicts[bare(e)]
    return AggEncPlan([rw(e) for e in keys], [rw(e) for e in inputs],
                      [rw(f) for f in filters], frozenset(kept),
                      frozenset(rank), mat, out_dicts)


# ---------------------------------------------------------------------------
# Scan
# ---------------------------------------------------------------------------
def scan_encoded_ok(ndv: int, rows: int, max_fraction: float) -> bool:
    """A dictionary chunk stays encoded when ndv / rows clears the
    fraction (reference :1347)."""
    if rows <= 0 or ndv <= 0:
        return False
    return ndv / rows <= max_fraction


def record_scan_emission(cv: DictionaryColumn) -> None:
    """One encoded column emitted by a scan (reference :1369)."""
    _count("encodedColumns")
