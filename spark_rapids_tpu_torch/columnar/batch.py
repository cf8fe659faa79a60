"""Device and host columnar batches (port of spark_rapids_tpu/columnar/batch.py).

- `ColumnVector`: a device column, data + validity tensors padded to a
  bucketed capacity (next power of two, >= 8). Rows past num_rows have
  validity False and zeroed data.
- `ColumnarBatch`: columns + num_rows (a python int, or a 0-dim device
  tensor where an operator avoided a host sync) + an optional `live` mask:
  a live-masked batch is a zero-copy view (the shuffle's slices) that
  `ensure_compact` / `concat_batches` compact.
- `HostColumnVector` / `HostColumnarBatch`: numpy columns, the CPU engine's
  batches.

Uploads and downloads are grouped (reference: `_upload_grouped` :748,
`to_host_many` :700): one pinned host buffer and one copy per dtype group,
not one per column. DOUBLE stays float64 on the card (an H100 has f64
units), so the reference's TPU narrowing in `physical_np_dtype` (:56) is
not ported.

STRING columns (slice 2) are uint8 bytes + int32 offsets + validity with a
host-known `max_len` (columnar/strings.py). Every string gather goes through
the hand-written kernel K7 `gather_strings` (csrc/string_gather.cu, replacing
the reference's `_gather_string_plan_cap` :1592 / `_gather_string_bytes`
:1607): a plan launch (gathered lengths, the shared device-wide scan, new
offsets) and a copy launch (one warp per output row). Its output byte
buffer is sized from a host-known bound (the source buffer for a gather
that repeats no row, `rows * max_len` otherwise), so no string gather reads
a count back from the card. Concat and compaction of string columns are K7
gathers over the pieces laid end to end. Fixed-width columns move through
two more kernels of csrc/compact_gather.cu: K31 `compact_fixed` (filter
compaction and the masked concat, replacing the reference's `_compact_plan`
:1623 and the fixed half of `compact_batch` :1630) and K32 `gather_fixed`
(every fixed column of a gather in one launch, replacing
`_gather_fixed_cols` :1425).

Encoded columns (columnar/encoded.py, a DictionaryColumn: int32 codes and
a shared dictionary) move as fixed int32 lanes and keep their dictionary
(`with_data`); a concat first brings each position's pieces onto one
dictionary (`align_encoded`) or, where encoded and plain pieces meet,
materializes the encoded ones. Uploads and downloads move codes: the sink
decodes them on the host (reference: batch.py:623-640).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar import strings as S
from spark_rapids_tpu_torch.columnar.dtypes import DataType, from_np

MIN_CAPACITY = 8


def bucket_capacity(n: int) -> int:
    """Round up to the next power of two (min MIN_CAPACITY), as the
    reference does, so capacities line up between the packages."""
    if n <= MIN_CAPACITY:
        return MIN_CAPACITY
    return 1 << (int(n - 1).bit_length())


class ColumnVector:
    """A device-resident column (reference: GpuColumnVector.java).
    STRING columns also carry int32 `offsets` [capacity + 1] and the
    host-known power-of-two `max_len` bound (every producer of a device
    string column sets it); `data` is their uint8 bytes.

    `runs` is the scan's host run table (columnar/runs.py), host metadata
    only. A new column starts without one, so every op that rebuilds a
    column drops it (the reference's pytree did so); only the scan, a plain
    concat and the encoded alignment set it."""

    __slots__ = ("dtype", "data", "validity", "offsets", "max_len", "runs")

    def __init__(self, dtype: DataType, data, validity, offsets=None,
                 max_len=None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.max_len = max_len
        self.runs = None

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    def device_memory_size(self) -> int:
        size = self.data.numel() * self.data.element_size() + \
            self.validity.numel()
        if self.offsets is not None:
            size += self.offsets.numel() * 4
        return size

    def with_data(self, data, validity) -> "ColumnVector":
        """A fixed-width column like this one over new lanes (an encoded
        column keeps its dictionary)."""
        return ColumnVector(self.dtype, data, validity)

    def __repr__(self):
        return f"ColumnVector({self.dtype.name}, cap={self.capacity})"


class HostColumnVector:
    """Host column: numpy data + validity (reference: RapidsHostColumnVector).
    Strings are object arrays of str; nulls live only in the mask. A string
    column caches its UTF-8 form (offsets, bytes) once computed; one made
    from that form alone (data None, as a download makes it) decodes its
    strings at the first read of `data`."""

    __slots__ = ("dtype", "_data", "validity", "_utf8")

    def __init__(self, dtype: DataType, data: Optional[np.ndarray],
                 validity: np.ndarray, utf8=None):
        assert (utf8 is not None if data is None else
                len(data) == len(validity))
        self.dtype = dtype
        self._data = data
        self.validity = validity
        self._utf8 = utf8

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            offs, raw = self._utf8
            self._data = S.decode_utf8(offs, raw, self.validity,
                                       len(self.validity))
        return self._data

    @data.setter
    def data(self, value: np.ndarray) -> None:
        self._data = value

    def __len__(self):
        return len(self.validity)

    def utf8(self):
        """(offsets int32 [n + 1], bytes uint8) of a string column."""
        if self._utf8 is None:
            self._utf8 = S.encode_utf8(self.data, self.validity)
        return self._utf8

    @staticmethod
    def from_pool(pool: Sequence[str], codes: np.ndarray) -> "HostColumnVector":
        """A non-null string column `pool[codes]`, encoded without a
        per-row loop (the generators' categorical columns)."""
        values, offsets, raw = S.encode_pool(pool, codes)
        return HostColumnVector(DataType.STRING, values,
                                np.ones(len(values), dtype=bool),
                                (offsets, raw))

    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: DataType) -> "HostColumnVector":
        validity = np.array([v is not None for v in values], dtype=bool)
        if dtype is DataType.STRING:
            data = np.array([v if v is not None else "" for v in values],
                            dtype=object)
        elif getattr(dtype, "is_decimal", False):
            # logical values (Decimal/int/float/str) -> unscaled int64
            # (reference: batch.py:263-270)
            from spark_rapids_tpu_torch.ops.decimal_util import to_unscaled

            data = np.array(
                [to_unscaled(v, dtype.scale, dtype.precision)
                 if v is not None else 0 for v in values], dtype=np.int64)
        else:
            npdt = dtype.to_np()
            zero = npdt.type(0)
            data = np.array([v if v is not None else zero for v in values],
                            dtype=npdt)
        return HostColumnVector(dtype, data, validity)

    @staticmethod
    def from_numpy(arr: np.ndarray, validity: Optional[np.ndarray] = None,
                   dtype: Optional[DataType] = None) -> "HostColumnVector":
        arr = np.asarray(arr)
        dt = dtype or from_np(arr.dtype)
        if dt is DataType.STRING:
            if arr.dtype != object:
                arr = arr.astype(object)
            none_mask = np.equal(arr, None)
            if none_mask.any():
                base = np.ones(len(arr), dtype=bool) if validity is None \
                    else np.asarray(validity, dtype=bool)
                validity = base & ~none_mask
                arr = np.where(none_mask, "", arr)
        elif arr.dtype != dt.to_np():
            arr = arr.astype(dt.to_np())
        if validity is None:
            validity = np.ones(len(arr), dtype=bool)
        return HostColumnVector(dt, np.asarray(arr),
                                np.asarray(validity, dtype=bool))

    @staticmethod
    def from_unscaled(unscaled: np.ndarray, dtype,
                      validity: Optional[np.ndarray] = None
                      ) -> "HostColumnVector":
        """A DECIMAL column from its unscaled int64 values, which must lie
        inside the type's precision bound (the generators' money columns:
        the same values as a list of `decimal.Decimal`, without a Python
        object per row)."""
        from spark_rapids_tpu_torch.ops.decimal_util import bound

        data = np.asarray(unscaled, dtype=np.int64)
        if len(data) and int(np.abs(data).max()) > bound(dtype.precision):
            raise OverflowError(f"unscaled values exceed {dtype.value}")
        if validity is None:
            validity = np.ones(len(data), dtype=bool)
        return HostColumnVector(dtype, data, np.asarray(validity, dtype=bool))

    def to_pylist(self) -> List[Any]:
        dec_scale = self.dtype.scale if getattr(self.dtype, "is_decimal",
                                                False) else None
        if dec_scale is None:
            # numpy's tolist gives Python scalars, as .item() does
            out = self.data.tolist()
            if self.data.dtype == object and \
                    self.dtype is not DataType.STRING:
                out = [v.item() if isinstance(v, np.generic) else v
                       for v in out]
            valid = np.asarray(self.validity, dtype=bool)
            for i in np.flatnonzero(~valid).tolist():
                out[i] = None
            return out
        from spark_rapids_tpu_torch.ops.decimal_util import from_unscaled

        out = []
        for i in range(len(self.data)):
            if not self.validity[i]:
                out.append(None)
                continue
            v = self.data[i]
            if isinstance(v, np.generic):
                v = v.item()
            out.append(from_unscaled(v, dec_scale))
        return out


class HostColumnarBatch:
    """Host-side columnar batch (the CPU engine operates on these)."""

    __slots__ = ("columns", "num_rows")

    def __init__(self, columns: List[HostColumnVector],
                 num_rows: Optional[int] = None):
        self.columns = columns
        self.num_rows = num_rows if num_rows is not None else (
            len(columns[0]) if columns else 0)

    @property
    def num_columns(self):
        return len(self.columns)

    def to_pylist_rows(self) -> List[tuple]:
        col_lists = [c.to_pylist() for c in self.columns]
        return [tuple(vals) for vals in zip(*col_lists)] if col_lists else []

    def slice(self, start: int, length: int) -> "HostColumnarBatch":
        cols = []
        for c in self.columns:
            utf8 = None
            if c.dtype is DataType.STRING and c._utf8 is not None:
                offs, raw = c._utf8
                o = offs[start:start + length + 1]
                if len(o):
                    utf8 = (o - o[0], raw[o[0]:o[-1]])
            cols.append(HostColumnVector(c.dtype, c.data[start:start + length],
                                         c.validity[start:start + length],
                                         utf8))
        return HostColumnarBatch(cols,
                                 min(length, max(0, self.num_rows - start)))

    def estimated_size_bytes(self) -> int:
        total = 0
        for c in self.columns:
            if c.dtype is DataType.STRING:
                total += len(c.utf8()[1]) + 5 * len(c.validity)
            else:
                total += c.data.nbytes + len(c.validity)
        return total

    def to_device(self, device) -> "ColumnarBatch":
        """Grouped upload: every column's padded data, offsets and validity
        go into one host buffer per dtype (pinned when the target is a
        card), one copy per buffer, and device views slice the columns back
        out (reference: HostColumnarBatch.to_device, batch.py:390)."""
        device = torch.device(device)
        n = self.num_rows
        cap = bucket_capacity(n)
        parts = []
        max_lens = []
        for hc in self.columns:
            if getattr(hc, "dictionary", None) is not None:
                # an encoded host column uploads its codes
                parts.append((np.dtype(np.int32), np.where(
                    hc.validity[:n], hc.data[:n], 0).astype(np.int32), cap))
                max_lens.append(None)
            elif hc.dtype is DataType.STRING:
                offs, raw = hc.utf8()
                offsets = np.empty(cap + 1, dtype=np.int32)
                offsets[:n + 1] = offs[:n + 1]
                offsets[n + 1:] = offs[n]
                nbytes = int(offs[n])
                parts.append((np.dtype(np.int32), offsets, cap + 1))
                parts.append((np.dtype(np.uint8), raw[:nbytes],
                              bucket_capacity(max(nbytes, 1))))
                lens = np.diff(offs[:n + 1])
                max_lens.append(S.len_bucket(int(lens.max()) if n else 1))
            else:
                npdt = hc.dtype.to_np()
                valid = hc.validity[:n]
                # NULL lanes upload as 0; a column without NULLs as it is
                parts.append((npdt, hc.data[:n] if valid.all() else
                              np.where(valid, hc.data[:n], npdt.type(0)),
                              cap))
                max_lens.append(None)
            parts.append((np.dtype(np.bool_), hc.validity[:n], cap))
        arrays = _upload_grouped(parts, device)
        cols = []
        i = 0
        for hc, ml in zip(self.columns, max_lens):
            if getattr(hc, "dictionary", None) is not None:
                from spark_rapids_tpu_torch.columnar.encoded import (
                    DictionaryColumn,
                )

                cols.append(DictionaryColumn(hc.dtype, arrays[i],
                                             arrays[i + 1], hc.dictionary))
                i += 2
            elif hc.dtype is DataType.STRING:
                cols.append(ColumnVector(hc.dtype, arrays[i + 1],
                                         arrays[i + 2], arrays[i], ml))
                i += 3
            else:
                cols.append(ColumnVector(hc.dtype, arrays[i], arrays[i + 1]))
                i += 2
        return ColumnarBatch(cols, n)


def device_float64_supported() -> bool:
    """Whether the card computes DOUBLE in f64 lanes (reference :50: a TPU
    does not). An H100 does, so the casts that need f64 (float -> STRING,
    STRING -> float) may run on it."""
    return True


def _upload_grouped(parts, device: torch.device):
    """(np dtype, values, padded length) parts -> device tensors zero-padded
    to their lengths, with one host buffer and one host->device copy per
    dtype."""
    groups: dict = {}
    for i, (npdt, _, _) in enumerate(parts):
        groups.setdefault(npdt, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    pin = device.type == "cuda"
    for npdt, idxs in groups.items():
        tdt = torch.from_numpy(np.zeros(0, dtype=npdt)).dtype
        starts = np.cumsum([0] + [parts[i][2] for i in idxs])
        host = torch.empty(int(starts[-1]), dtype=tdt, pin_memory=pin)
        view = host.numpy()
        for j, i in enumerate(idxs):
            vals = parts[i][1]
            view[starts[j]:starts[j] + len(vals)] = vals
            view[starts[j] + len(vals):starts[j + 1]] = 0
        dev = host.to(device, non_blocking=pin)
        for j, i in enumerate(idxs):
            out[i] = dev[starts[j]:starts[j + 1]]
    return out


class ColumnarBatch:
    """Device-resident columnar batch (reference: batch.py:485)."""

    __slots__ = ("columns", "num_rows", "live")

    def __init__(self, columns: List[ColumnVector], num_rows, live=None):
        self.columns = columns
        self.num_rows = int(num_rows) if isinstance(
            num_rows, (int, np.integer)) else num_rows
        self.live = live

    @property
    def rows_on_host(self) -> bool:
        return isinstance(self.num_rows, int)

    def host_rows(self) -> int:
        if not self.rows_on_host:
            # host sync: a caller genuinely needs the python count
            self.num_rows = int(self.num_rows.item())
        return self.num_rows

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else \
            bucket_capacity(self.host_rows())

    def live_mask(self):
        """Mask of real rows (compact and masked batches alike)."""
        if self.live is not None:
            return self.live
        return torch.arange(self.capacity, device=self.device) < \
            self.num_rows

    @property
    def num_columns(self):
        return len(self.columns)

    def device_memory_size(self) -> int:
        return sum(c.device_memory_size() for c in self.columns)

    def to_host(self) -> HostColumnarBatch:
        return to_host_many([self])[0]

    def __repr__(self):
        return (f"ColumnarBatch(rows={self.num_rows}, cap={self.capacity}, "
                f"cols={[c.dtype.name for c in self.columns]})")


def to_host_many(batches: Sequence[ColumnarBatch],
                 keep_encoded: bool = False) -> List[HostColumnarBatch]:
    """Download many device batches with one grouped transfer per dtype and
    one wait (reference: to_host_many, batch.py:700). Row counts still on
    the card ride along in the int64 group. A STRING column comes back in
    its UTF-8 form and makes its Python strings only when they are read.
    keep_encoded: an encoded column stays host codes plus its dictionary (a
    HostDictionaryColumn, which the serialized shuffle ships with a pruned
    dictionary) instead of decoding at this sink."""
    batches = [ensure_compact(b) for b in batches]
    out: List[Optional[HostColumnarBatch]] = [None] * len(batches)
    plan = []   # (batch index, [(group key, offset, length)] , n or None)
    groups: dict = {}

    def add(t: torch.Tensor):
        key = t.dtype
        lst = groups.setdefault(key, [])
        off = sum(x.numel() for x in lst)
        lst.append(t.reshape(-1))
        return key, off, t.numel()

    for bi, b in enumerate(batches):
        if not b.columns:
            out[bi] = HostColumnarBatch([], b.host_rows())
            continue
        if b.rows_on_host:
            trim = min(b.capacity, bucket_capacity(max(b.num_rows, 1)))
            count = None
        else:
            trim = b.capacity
            count = add(b.num_rows.to(torch.int64).reshape(1))
        segs = []
        for c in b.columns:
            if c.offsets is not None:
                segs.append(add(c.offsets[:trim + 1]))
                segs.append(add(c.data))
            else:
                segs.append(add(c.data[:trim]))
            segs.append(add(c.validity[:trim]))
        plan.append((bi, segs, count))
    if not plan:
        return out  # type: ignore[return-value]
    device = batches[plan[0][0]].device
    pin = device.type == "cuda"
    host = {}
    for key, lst in groups.items():
        flat = torch.cat(lst) if len(lst) > 1 else lst[0]
        buf = torch.empty(flat.numel(), dtype=key, pin_memory=pin)
        buf.copy_(flat, non_blocking=pin)
        host[key] = buf
    if pin:
        # the one host sync of the download: every grouped copy is queued
        torch.cuda.current_stream(device).synchronize()
    np_host = {k: v.numpy() for k, v in host.items()}
    for bi, segs, count in plan:
        b = batches[bi]
        if count is None:
            n = b.num_rows
        else:
            k, off, _ = count
            n = int(np_host[k][off])
            b.num_rows = n
        cols = []
        seg_iter = iter(segs)
        for c in b.columns:
            if c.offsets is not None:
                ko, oo, _ = next(seg_iter)
                kb, ob, lb = next(seg_iter)
                kv, ov, _ = next(seg_iter)
                valid = np_host[kv][ov:ov + n].copy()
                # copies: the column outlives the (pinned) download buffer
                offs = np_host[ko][oo:oo + n + 1]
                raw = np_host[kb][ob:ob + lb][int(offs[0]):int(offs[n])]
                cols.append(HostColumnVector(
                    c.dtype, None, valid, (offs - offs[0], raw.copy())))
                continue
            kd, od, _ = next(seg_iter)
            kv, ov, _ = next(seg_iter)
            data = np_host[kd][od:od + n].copy()
            valid = np_host[kv][ov:ov + n].copy()
            d = getattr(c, "dictionary", None)
            if d is not None:
                from spark_rapids_tpu_torch.columnar import encoded as E

                if keep_encoded:
                    cols.append(E.HostDictionaryColumn(
                        c.dtype, np.where(valid, data, 0), valid, d))
                    continue
                # the sink: codes crossed to the host, decoded here
                cols.append(HostColumnVector(c.dtype, E.materialize_host_values(
                    data, valid, d), valid))
                continue
            npdt = c.dtype.to_np()
            if data.dtype != npdt:
                data = data.astype(npdt)
            data = np.where(valid, data, npdt.type(0))
            cols.append(HostColumnVector(c.dtype, data, valid))
        out[bi] = HostColumnarBatch(cols, n)
    return out  # type: ignore[return-value]


def _zeros_like_col(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# K7: string gather
# ---------------------------------------------------------------------------
def gather_strings_plan_plain(offsets, validity, indices, out_rows: int,
                              indices_valid=None):
    """(new offsets int32 [cap + 1], validity [cap]) of gathering rows
    `indices` (cap = len(indices)); lanes at or past out_rows, masked by
    indices_valid or out of range are NULL with length 0 (reference:
    _string_plan_body, batch.py:1577)."""
    cap = int(indices.shape[0])
    n_src = int(offsets.shape[0]) - 1
    dev = indices.device
    idx = indices.long()
    ok = (torch.arange(cap, device=dev) < out_rows) & (idx >= 0) & \
        (idx < n_src)
    if indices_valid is not None:
        ok = ok & indices_valid
    safe = torch.where(ok, idx, torch.zeros((), dtype=torch.int64,
                                            device=dev))
    lens = torch.where(ok, offsets[safe + 1] - offsets[safe],
                       torch.zeros((), dtype=offsets.dtype, device=dev))
    new_offsets = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    new_offsets[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    return new_offsets, ok & validity[safe]


def gather_strings_copy_plain(offsets, data, indices, new_offsets,
                              byte_cap: int):
    """Bytes of the gathered rows laid out at new_offsets, zero past the
    total (reference: _gather_string_bytes, batch.py:1607)."""
    out = torch.zeros(byte_cap, dtype=torch.uint8, device=data.device)
    lens = (new_offsets[1:] - new_offsets[:-1]).long()
    total = int(new_offsets[-1])
    if total:
        row = torch.repeat_interleave(
            torch.arange(lens.shape[0], device=data.device), lens)
        within = torch.arange(total, device=data.device) - \
            new_offsets[row].long()
        src = offsets[indices[row].long()].long() + within
        out[:total] = data[src]
    return out


def gather_strings(offsets, data, validity, indices, out_rows: int,
                   indices_valid, byte_cap: int):
    """K7 (replaces batch.py:_gather_string_plan_cap + _gather_string_bytes):
    (new offsets [cap + 1], bytes [byte_cap], validity [cap]) of the rows
    `indices` of a string column. byte_cap must bound the gathered bytes
    (the copy writes nothing past it). CPU tensors run the plain version,
    CUDA tensors the kernel."""
    if indices.device.type == "cpu":
        new_offsets, valid = gather_strings_plan_plain(
            offsets, validity, indices, out_rows, indices_valid)
        return (new_offsets, gather_strings_copy_plain(
            offsets, data, indices, new_offsets, byte_cap), valid)
    idx = indices.to(torch.int32).contiguous()
    offsets = offsets.contiguous()
    validity = validity.contiguous()
    CB.require_cuda(offsets, data, validity, idx)
    if indices_valid is not None:
        indices_valid = indices_valid.contiguous()
        CB.require_cuda(indices_valid)
    dev = idx.device
    cap = int(idx.shape[0])
    lib = CB.library("string_gather")
    scratch = torch.empty(int(lib.srt_gather_strings_scratch_bytes(cap)),
                          dtype=torch.uint8, device=dev)
    new_offsets = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    stream = CB.stream_of(idx)
    rc = lib.srt_gather_strings_plan(
        offsets.data_ptr(), validity.data_ptr(), int(offsets.shape[0]) - 1,
        idx.data_ptr(),
        indices_valid.data_ptr() if indices_valid is not None else None,
        int(out_rows), cap, new_offsets.data_ptr(), valid.data_ptr(),
        scratch.data_ptr(), scratch.numel(), stream)
    CB.check(lib, rc, "gather_strings plan")
    out = torch.empty(byte_cap, dtype=torch.uint8, device=dev)
    rc = lib.srt_gather_strings_copy(
        offsets.data_ptr(), data.data_ptr(), idx.data_ptr(),
        new_offsets.data_ptr(), cap, out.data_ptr(), byte_cap, stream)
    CB.count_launch("gather_strings")
    CB.check(lib, rc, "gather_strings copy")
    return new_offsets, out, valid


def gather_string_col(cv: ColumnVector, indices, out_rows: int,
                       indices_valid=None, unique: bool = False
                       ) -> ColumnVector:
    """One string column gathered through K7, its byte buffer sized from
    host-known bounds, so no gather reads a count back from the card:
    len(indices) * max_len, and the source buffer when no source row
    repeats."""
    bound = int(indices.shape[0]) * cv.max_len
    if unique:
        bound = min(bound, int(cv.data.shape[0]))
    offs, data, valid = gather_strings(cv.offsets, cv.data, cv.validity,
                                       indices, out_rows, indices_valid,
                                       bucket_capacity(max(bound, 1)))
    return ColumnVector(DataType.STRING, data, valid, offs, cv.max_len)


def gather_string_spans_plain(src, starts, lens, validity, out_rows: int,
                              byte_cap: int):
    """(offsets int32 [cap + 1], bytes [byte_cap], validity [cap]) of rows
    whose bytes are src[starts[j]:starts[j] + lens[j]]; rows at or past
    out_rows, not valid or of negative length are NULL with length 0, and
    bytes past src read as 0 (reference: build_from_plan,
    columnar/strings.py:177, over one source)."""
    cap = int(lens.shape[0])
    dev = lens.device
    ok = (torch.arange(cap, device=dev) < out_rows) & validity[:cap] & \
        (lens >= 0)
    row_lens = torch.where(ok, lens, torch.zeros((), dtype=lens.dtype,
                                                 device=dev)).long()
    offsets = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(row_lens, 0).to(torch.int32)
    out = torch.zeros(byte_cap, dtype=torch.uint8, device=dev)
    total = min(int(offsets[-1]), byte_cap)
    if total:
        row = torch.repeat_interleave(torch.arange(cap, device=dev),
                                      row_lens)[:total]
        pos = starts[row].long() + torch.arange(total, device=dev) - \
            offsets[row].long()
        n_src = int(src.shape[0])
        inside = (pos >= 0) & (pos < n_src)
        out[:total] = torch.where(inside, src[pos.clamp(0, max(n_src - 1, 0))],
                                  torch.zeros((), dtype=torch.uint8,
                                              device=dev))
    return offsets, out, ok


def gather_string_spans(src, starts, lens, validity, out_rows: int,
                        byte_cap: int):
    """K7's span entry (replaces the reference's build_from_plan call of
    io/parquet_device.py:decode_chunk_device :1397): rows by their (start
    int64, length int32) into one byte buffer, the rows of PLAIN
    BYTE_ARRAY Parquet pages. CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if lens.device.type == "cpu":
        return gather_string_spans_plain(src, starts, lens, validity,
                                         out_rows, byte_cap)
    starts = starts.to(torch.int64).contiguous()
    lens = lens.to(torch.int32).contiguous()
    validity = validity.contiguous()
    CB.require_cuda(src, starts, lens, validity)
    dev = lens.device
    cap = int(lens.shape[0])
    lib = CB.library("string_gather")
    scratch = torch.empty(int(lib.srt_gather_strings_scratch_bytes(cap)),
                          dtype=torch.uint8, device=dev)
    offsets = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    stream = CB.stream_of(lens)
    rc = lib.srt_gather_spans_plan(
        lens.data_ptr(), validity.data_ptr(), int(out_rows), cap,
        offsets.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
        scratch.numel(), stream)
    CB.check(lib, rc, "gather_string_spans plan")
    out = torch.empty(byte_cap, dtype=torch.uint8, device=dev)
    rc = lib.srt_gather_spans_copy(
        src.data_ptr(), int(src.shape[0]), starts.data_ptr(),
        offsets.data_ptr(), cap, out.data_ptr(), byte_cap, stream)
    CB.count_launch("gather_string_spans")
    CB.check(lib, rc, "gather_string_spans copy")
    return offsets, out, valid


def strings_end_to_end(cols: Sequence[ColumnVector]):
    """(one string column, first lane of each piece): the pieces laid end to
    end without a host sync — byte buffers concatenated, offsets shifted,
    and one dead (NULL) lane after each piece but the last, spanning the
    unused tail of its byte buffer."""
    dev = cols[0].validity.device
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    offs, valids, bases = [], [], []
    byte_base = lane_base = 0
    for c in cols:
        offs.append(c.offsets + byte_base)
        valids += [c.validity, false1]
        bases.append(lane_base)
        byte_base += int(c.data.shape[0])
        lane_base += c.capacity + 1
    if byte_base >= (1 << 31):
        raise ValueError("string pieces exceed 2 GiB of bytes")
    if len(cols) == 1:
        return cols[0], bases
    return ColumnVector(DataType.STRING, torch.cat([c.data for c in cols]),
                        torch.cat(valids[:-1]), torch.cat(offs),
                        max(c.max_len for c in cols)), bases


def _compact_strings(cols: Sequence[ColumnVector], lives, cap_out: int
                     ) -> ColumnVector:
    """The live rows of several string columns, in order, as one column of
    cap_out lanes, with no host sync: K7 gathers the live lanes of the
    pieces laid end to end."""
    src, _ = strings_end_to_end(cols)
    dev = src.validity.device
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    live = [t for lv in lives for t in (lv, false1)][:-1]
    live_mask = torch.cat(live) if len(live) > 1 else live[0]
    n_src = int(live_mask.shape[0])
    pos = torch.cumsum(live_mask.to(torch.int64), 0) - 1
    dest = torch.where(live_mask, pos, torch.full((), cap_out,
                                                  dtype=torch.int64,
                                                  device=dev))
    idx = torch.zeros(cap_out + 1, dtype=torch.int32, device=dev)
    idx.scatter_(0, dest, torch.arange(n_src, dtype=torch.int32, device=dev))
    idx_valid = torch.arange(cap_out, device=dev) < live_mask.sum()
    return gather_string_col(src, idx[:cap_out], cap_out, idx_valid,
                              unique=True)


# ---------------------------------------------------------------------------
# K31 compact_fixed and K32 gather_fixed (csrc/compact_gather.cu)
# ---------------------------------------------------------------------------
_COMPACT_TILE = 4096  # lanes a block of K31 takes (kTile in common.cuh)


def _device_words(words: Sequence[int], device) -> torch.Tensor:
    """An int64 table on the card through pinned memory: no host sync (the
    caching host allocator keeps the buffer until the copy ends)."""
    host = torch.tensor(list(words), dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True)


def compact_fixed_plain(pieces, lives, cap_out: int):
    """(outputs [cap_out] per column, kept-row count as an int32 on the
    tensors' device): the live lanes of the pieces (lists of tensors per
    piece, same column order, each at least as long as its live mask),
    stably in order; lanes past the count zero (False for validity).
    Reference: _compact_plan + _gather_fixed_cols, batch.py:1623, :1425."""
    live = torch.cat(lives) if len(lives) > 1 else lives[0]
    pos = torch.cumsum(live.to(torch.int64), 0) - 1
    dest = torch.where(live, pos, torch.full((), cap_out, dtype=torch.int64,
                                             device=live.device))
    total = live.sum(dtype=torch.int32)
    outs = []
    for ci in range(len(pieces[0])):
        srcs = [p[ci][:int(lv.shape[0])] for p, lv in zip(pieces, lives)]
        src = torch.cat(srcs) if len(srcs) > 1 else srcs[0]
        buf = _zeros_like_col(src, cap_out + 1)
        buf.scatter_(0, dest, src)
        outs.append(buf[:cap_out])
    return outs, total


def compact_fixed(pieces, lives, cap_out: int):
    """K31: compact_fixed_plain's outputs in one flagged select over every
    piece and column (count, scan of the tile counts, scatter). CPU
    tensors run the plain version, CUDA tensors the kernel."""
    if lives[0].device.type == "cpu":
        return compact_fixed_plain(pieces, lives, cap_out)
    lives = [lv.contiguous() for lv in lives]
    pieces = [[t.contiguous() for t in p] for p in pieces]
    CB.require_cuda(*lives, *[t for p in pieces for t in p])
    dev = lives[0].device
    ncols = len(pieces[0])
    caps = [int(lv.shape[0]) for lv in lives]
    for p, cap in zip(pieces, caps):
        if len(p) != ncols or any(int(t.shape[0]) < cap for t in p):
            raise ValueError("compact_fixed: a piece's columns are shorter "
                             "than its live mask or differ in number")
    tile_base = [0]
    for cap in caps:
        tile_base.append(tile_base[-1] + -(-cap // _COMPACT_TILE))
    ntiles = tile_base[-1]
    outs = [torch.empty(cap_out, dtype=t.dtype, device=dev)
            for t in pieces[0]]
    table = _device_words(
        tile_base + caps + [lv.data_ptr() for lv in lives]
        + [t.data_ptr() for p in pieces for t in p]
        + [o.data_ptr() for o in outs]
        + [t.element_size() for t in pieces[0]], dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    lib = CB.library("compact_gather")
    scratch = torch.empty(int(lib.srt_compact_scratch_bytes(ntiles)),
                          dtype=torch.uint8, device=dev)
    rc = lib.srt_compact_fixed(table.data_ptr(), len(pieces), ncols, ntiles,
                               cap_out, count.data_ptr(), scratch.data_ptr(),
                               scratch.numel(), CB.stream_of(count))
    CB.count_launch("compact_fixed")
    CB.check(lib, rc, "compact_fixed")
    return outs, count


def gather_fixed_plain(datas, valids, indices, out_rows: int,
                       indices_valid, cap: int):
    """(data, validity) [cap] of every fixed column gathered by `indices`:
    a lane is NULL with zero data at or past out_rows or the index vector,
    for an index out of [0, source capacity), where indices_valid is
    False, or where the source row is NULL (reference: _gather_fixed_body,
    batch.py:1434)."""
    dev = indices.device
    n_idx = int(indices.shape[0])
    idx = indices[:cap].to(torch.int64)
    lane = torch.arange(cap, device=dev)
    if idx.shape[0] < cap:
        idx = torch.cat([idx, torch.zeros(cap - idx.shape[0],
                                          dtype=torch.int64, device=dev)])
    src_cap = min(int(t.shape[0]) for t in list(datas) + list(valids))
    ok = (lane < out_rows) & (lane < n_idx) & (idx >= 0) & (idx < src_cap)
    if indices_valid is not None:
        iv = indices_valid[:cap]
        if iv.shape[0] < cap:
            iv = torch.cat([iv, torch.zeros(cap - iv.shape[0],
                                            dtype=torch.bool, device=dev)])
        ok = ok & iv
    safe = torch.where(ok, idx, torch.zeros((), dtype=torch.int64,
                                            device=dev))
    outs = []
    for d, v in zip(datas, valids):
        valid = v[safe] & ok
        outs.append((torch.where(valid, d[safe], torch.zeros(
            (), dtype=d.dtype, device=dev)), valid))
    return outs


def gather_fixed(datas, valids, indices, out_rows: int, indices_valid,
                 cap: int):
    """K32: gather_fixed_plain's outputs for every column in one launch.
    CPU tensors run the plain version, CUDA tensors the kernel."""
    if indices.device.type == "cpu":
        return gather_fixed_plain(datas, valids, indices, out_rows,
                                  indices_valid, cap)
    idx = indices if indices.dtype in (torch.int32, torch.int64) else \
        indices.to(torch.int64)
    idx = idx.contiguous()
    datas = [d.contiguous() for d in datas]
    valids = [v.contiguous() for v in valids]
    CB.require_cuda(idx, *datas, *valids)
    if indices_valid is not None:
        indices_valid = indices_valid.contiguous()
        CB.require_cuda(indices_valid)
    dev = idx.device
    src_cap = min(int(t.shape[0]) for t in datas + valids)
    out_d = [torch.empty(cap, dtype=d.dtype, device=dev) for d in datas]
    out_v = [torch.empty(cap, dtype=torch.bool, device=dev) for _ in datas]
    table = _device_words(
        [d.data_ptr() for d in datas] + [v.data_ptr() for v in valids]
        + [o.data_ptr() for o in out_d] + [o.data_ptr() for o in out_v]
        + [d.element_size() for d in datas], dev)
    lib = CB.library("compact_gather")
    rc = lib.srt_gather_fixed(
        table.data_ptr(), len(datas), idx.data_ptr(), idx.element_size(),
        int(idx.shape[0]),
        indices_valid.data_ptr() if indices_valid is not None else None,
        int(indices_valid.shape[0]) if indices_valid is not None else 0,
        int(out_rows), src_cap, cap, CB.stream_of(idx))
    CB.count_launch("gather_fixed")
    CB.check(lib, rc, "gather_fixed")
    return list(zip(out_d, out_v))


def _compact_pieces(batches: Sequence[ColumnarBatch], lives, cap_out: int):
    """(columns, device row count): the live rows of same-schema batches
    in order, in cap_out lanes."""
    fixed = [i for i, c in enumerate(batches[0].columns) if c.offsets is None]
    cols: List[Optional[ColumnVector]] = [None] * batches[0].num_columns
    total = None
    if fixed:
        pieces = [[t for i in fixed for t in (b.columns[i].data,
                                              b.columns[i].validity)]
                  for b in batches]
        outs, total = compact_fixed(pieces, lives, cap_out)
        for k, i in enumerate(fixed):
            cols[i] = batches[0].columns[i].with_data(outs[2 * k],
                                                      outs[2 * k + 1])
    for i, c in enumerate(batches[0].columns):
        if c.offsets is not None:
            cols[i] = _compact_strings([b.columns[i] for b in batches],
                                       lives, cap_out)
    if total is None:
        live = torch.cat(lives) if len(lives) > 1 else lives[0]
        total = live.sum(dtype=torch.int32)
    return cols, total


def ensure_compact(batch: ColumnarBatch) -> ColumnarBatch:
    """Compact a live-masked view into a dense batch (reference:
    batch.py:1047); the count stays a device scalar."""
    if batch.live is None:
        return batch
    cols, total = _compact_pieces([batch], [batch.live],
                                  bucket_capacity(batch.capacity))
    return ColumnarBatch(cols, total)


def _align_encoded_pieces(batches: Sequence[ColumnarBatch]
                          ) -> List[ColumnarBatch]:
    """Same-schema pieces with each encoded position on one dictionary
    (reference: batch.py:960): all-encoded positions align through their
    dictionaries' union, mixed ones materialize their encoded pieces."""
    from spark_rapids_tpu_torch.columnar import encoded as E

    ords = {i for b in batches for i in E.encoded_ordinals(b)}
    if not ords:
        return list(batches)
    cols = [list(b.columns) for b in batches]
    for i in sorted(ords):
        col_i = [c[i] for c in cols]
        if all(E.is_encoded(c) for c in col_i):
            union, aligned = E.align_encoded(col_i)
            for orig, new in zip(col_i, aligned):
                if new is not orig and orig.runs is not None:
                    new.runs = _remapped_runs(orig, union)
            col_i = aligned
        else:
            col_i = [E.materialize(c) if E.is_encoded(c) else c
                     for c in col_i]
        for c, new in zip(cols, col_i):
            c[i] = new
    return [ColumnarBatch(c, b.num_rows, live=b.live)
            for c, b in zip(cols, batches)]


def _remapped_runs(orig, union):
    """A run table of an encoded column whose codes moved into `union`'s
    code space, its values remapped the same way (reference :1025-1039),
    so a pre-union code never describes post-union codes."""
    from spark_rapids_tpu_torch.columnar.runs import RunTable

    remap = orig.dictionary.remap_to(union)
    vals = np.asarray(orig.runs.values)
    if remap is not None and len(vals):
        vals = remap[np.clip(vals, 0, len(remap) - 1)]
    return RunTable(orig.runs.starts, vals, orig.runs.num_rows)


def _concat_runs(cols, batches) -> None:
    """Run tables through a plain concat: each piece's starts shift by its
    row offset (reference: _concat_run_tables :978-995). A position keeps
    a table only when every piece has one covering its rows."""
    from spark_rapids_tpu_torch.columnar.runs import RunTable

    for ci, out in enumerate(cols):
        tabs = [b.columns[ci].runs for b in batches]
        if any(t is None or t.num_rows != b.num_rows
               for t, b in zip(tabs, batches)):
            continue
        bases = np.cumsum([0] + [b.num_rows for b in batches])
        out.runs = RunTable(
            np.concatenate([t.starts + base for t, base in
                            zip(tabs, bases)]),
            np.concatenate([np.asarray(t.values) for t in tabs]),
            int(bases[-1]))


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate same-schema batches in order (reference: batch.py:877).
    Host counts and no masks: slices and one cat per fixed column.
    Otherwise a masked scatter compaction with the count left on the card.
    String columns go through K7 either way (no host sync)."""
    assert batches, "cannot concat zero batches"
    if len(batches) == 1:
        return ensure_compact(batches[0])
    batches = _align_encoded_pieces(batches)
    ncols = batches[0].num_columns
    if all(b.rows_on_host and b.live is None for b in batches):
        total = sum(b.num_rows for b in batches)
        cap = bucket_capacity(total)
        cols = []
        for ci in range(ncols):
            c0 = batches[0].columns[ci]
            if c0.offsets is not None:
                cols.append(_compact_strings(
                    [b.columns[ci] for b in batches],
                    [b.live_mask() for b in batches], cap))
                continue
            data = _zeros_like_col(c0.data, cap)
            valid = _zeros_like_col(c0.validity, cap)
            off = 0
            for b in batches:
                n = b.num_rows
                data[off:off + n] = b.columns[ci].data[:n]
                valid[off:off + n] = b.columns[ci].validity[:n]
                off += n
            cols.append(c0.with_data(data, valid))
        _concat_runs(cols, batches)
        return ColumnarBatch(cols, total)
    cap = bucket_capacity(sum(b.capacity for b in batches))
    cols, total = _compact_pieces(batches, [b.live_mask() for b in batches],
                                  cap)
    return ColumnarBatch(cols, total)


def gather_batch(batch: ColumnarBatch, indices, out_rows: int,
                 indices_valid=None, unique_indices: bool = False
                 ) -> ColumnarBatch:
    """Rows by index into a new batch of `out_rows` rows (reference:
    batch.py:1501); lanes past out_rows or the index vector, out of range
    or masked off by `indices_valid` are null. Every fixed column (and an
    encoded column's codes) goes through one K32 launch, every string
    column through K7. unique_indices promises no source row repeats,
    which bounds the string bytes by the source buffer."""
    cap = bucket_capacity(max(out_rows, 1))
    cols: List[Optional[ColumnVector]] = [None] * batch.num_columns
    fixed = [i for i, c in enumerate(batch.columns) if c.offsets is None]
    if fixed:
        outs = gather_fixed([batch.columns[i].data for i in fixed],
                            [batch.columns[i].validity for i in fixed],
                            indices, out_rows, indices_valid, cap)
        for i, (data, valid) in zip(fixed, outs):
            cols[i] = batch.columns[i].with_data(data, valid)
    strings = [i for i, c in enumerate(batch.columns) if c.offsets is not None]
    if strings:
        idx = indices[:cap].to(torch.int64)
        ivalid = None if indices_valid is None else indices_valid[:cap]
        if idx.shape[0] < cap or (ivalid is not None and
                                  ivalid.shape[0] < cap):
            # lanes past the index vector are NULL, as in K32
            dev = idx.device
            lane_ok = torch.arange(cap, device=dev) < idx.shape[0]
            if ivalid is not None:
                lane_ok[:ivalid.shape[0]] &= ivalid
                lane_ok[ivalid.shape[0]:] = False
            ivalid = lane_ok
            idx = torch.cat([idx, torch.zeros(cap - idx.shape[0],
                                              dtype=torch.int64, device=dev)])
        for i in strings:
            cols[i] = gather_string_col(batch.columns[i], idx, out_rows,
                                        ivalid, unique_indices)
    return ColumnarBatch(cols, out_rows)


def slice_batch_host(batch: ColumnarBatch, start: int,
                     length: int) -> ColumnarBatch:
    """Rows [start, start + length) of a batch, clipped to its rows, by a
    gather (reference: batch.py:1696; used by split-and-retry)."""
    length = max(0, min(length, batch.host_rows() - start))
    idx = torch.arange(start, start + bucket_capacity(max(length, 1)),
                       dtype=torch.int64, device=batch.device)
    return gather_batch(batch, idx, length, unique_indices=True)


def compact_batch(batch: ColumnarBatch, keep_mask, sync: bool) -> ColumnarBatch:
    """Filter compaction (reference: batch.py:1630): kept rows move stably
    to the front. sync=True reads the count and shrinks the capacity."""
    out = ensure_compact(ColumnarBatch(batch.columns, batch.num_rows,
                                       live=keep_mask))
    if not sync:
        return out
    n = out.host_rows()
    cap = bucket_capacity(max(n, 1))
    if cap >= out.capacity:
        return out
    cols = [ColumnVector(c.dtype, c.data.clone(), c.validity[:cap].clone(),
                         c.offsets[:cap + 1].clone(), c.max_len)
            if c.offsets is not None else
            c.with_data(c.data[:cap].clone(), c.validity[:cap].clone())
            for c in out.columns]
    return ColumnarBatch(cols, n)
