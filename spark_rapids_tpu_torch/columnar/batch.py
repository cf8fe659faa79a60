"""Device and host columnar batches (port of spark_rapids_tpu/columnar/batch.py,
fixed-width columns).

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

Compaction, concat and gather here are plain torch ops (the reference's
B5/B9 kernels stay queued in ROADMAP.md). Strings have no device form yet.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, from_np

MIN_CAPACITY = 8


def bucket_capacity(n: int) -> int:
    """Round up to the next power of two (min MIN_CAPACITY), as the
    reference does, so capacities line up between the packages."""
    if n <= MIN_CAPACITY:
        return MIN_CAPACITY
    return 1 << (int(n - 1).bit_length())


class ColumnVector:
    """A device-resident column (reference: GpuColumnVector.java)."""

    __slots__ = ("dtype", "data", "validity")

    def __init__(self, dtype: DataType, data, validity):
        self.dtype = dtype
        self.data = data
        self.validity = validity

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def device_memory_size(self) -> int:
        return self.data.numel() * self.data.element_size() + \
            self.validity.numel()

    def __repr__(self):
        return f"ColumnVector({self.dtype.name}, cap={self.capacity})"


class HostColumnVector:
    """Host column: numpy data + validity (reference: RapidsHostColumnVector).
    Strings are object arrays of str; nulls live only in the mask."""

    __slots__ = ("dtype", "data", "validity")

    def __init__(self, dtype: DataType, data: np.ndarray, validity: np.ndarray):
        assert len(data) == len(validity)
        self.dtype = dtype
        self.data = data
        self.validity = validity

    def __len__(self):
        return len(self.data)

    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: DataType) -> "HostColumnVector":
        validity = np.array([v is not None for v in values], dtype=bool)
        if dtype is DataType.STRING:
            data = np.array([v if v is not None else "" for v in values],
                            dtype=object)
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
            none_mask = np.fromiter((v is None for v in arr), dtype=bool,
                                    count=len(arr))
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

    def to_pylist(self) -> List[Any]:
        out = []
        for i in range(len(self.data)):
            if not self.validity[i]:
                out.append(None)
                continue
            v = self.data[i]
            out.append(v.item() if isinstance(v, np.generic) else v)
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
        cols = [HostColumnVector(c.dtype, c.data[start:start + length],
                                 c.validity[start:start + length])
                for c in self.columns]
        return HostColumnarBatch(cols,
                                 min(length, max(0, self.num_rows - start)))

    def estimated_size_bytes(self) -> int:
        total = 0
        for c in self.columns:
            if c.dtype is DataType.STRING:
                total += sum(len(s) for s in c.data) + 5 * len(c.data)
            else:
                total += c.data.nbytes + len(c.validity)
        return total

    def to_device(self, device) -> "ColumnarBatch":
        """Grouped upload: every column's padded data and validity go into
        one host buffer per dtype (pinned when the target is a card), one
        copy per buffer, and device views slice the columns back out
        (reference: HostColumnarBatch.to_device, batch.py:390)."""
        device = torch.device(device)
        n = self.num_rows
        cap = bucket_capacity(n)
        parts = []
        for hc in self.columns:
            if hc.dtype is DataType.STRING:
                raise NotImplementedError(
                    "string columns have no device form yet (slice 2)")
            npdt = hc.dtype.to_np()
            parts.append((npdt, np.where(hc.validity[:n], hc.data[:n],
                                         npdt.type(0))))
            parts.append((np.dtype(np.bool_), hc.validity[:n]))
        arrays = _upload_grouped(parts, cap, device)
        cols = [ColumnVector(hc.dtype, arrays[2 * i], arrays[2 * i + 1])
                for i, hc in enumerate(self.columns)]
        return ColumnarBatch(cols, n)


def _upload_grouped(parts, cap: int, device: torch.device):
    """(np dtype, values[:n]) parts -> device tensors padded to cap, with
    one host buffer and one host->device copy per dtype."""
    groups: dict = {}
    for i, (npdt, _) in enumerate(parts):
        groups.setdefault(npdt, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    pin = device.type == "cuda"
    for npdt, idxs in groups.items():
        tdt = torch.from_numpy(np.zeros(0, dtype=npdt)).dtype
        host = torch.zeros(len(idxs) * cap, dtype=tdt, pin_memory=pin)
        view = host.numpy()
        for j, i in enumerate(idxs):
            vals = parts[i][1]
            view[j * cap:j * cap + len(vals)] = vals
        dev = host.to(device, non_blocking=pin)
        for j, i in enumerate(idxs):
            out[i] = dev[j * cap:(j + 1) * cap]
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


def to_host_many(batches: Sequence[ColumnarBatch]) -> List[HostColumnarBatch]:
    """Download many device batches with one grouped transfer per dtype and
    one wait (reference: to_host_many, batch.py:700). Row counts still on
    the card ride along in the int64 group."""
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
        for ci, c in enumerate(b.columns):
            kd, od, ld = segs[2 * ci]
            kv, ov, _ = segs[2 * ci + 1]
            data = np_host[kd][od:od + n].copy()
            valid = np_host[kv][ov:ov + n].copy()
            npdt = c.dtype.to_np()
            if data.dtype != npdt:
                data = data.astype(npdt)
            data = np.where(valid, data, npdt.type(0))
            cols.append(HostColumnVector(c.dtype, data, valid))
        out[bi] = HostColumnarBatch(cols, n)
    return out  # type: ignore[return-value]


def _zeros_like_col(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=t.dtype, device=t.device)


def _scatter_compact(pieces, lives, cap_out: int):
    """Stable compaction of the live lanes of pieces (lists of tensors per
    piece, same column order) into cap_out lanes: one cumsum over the
    concatenated live masks, one scatter per column. No host sync; the
    row count stays on the card."""
    live = torch.cat(lives) if len(lives) > 1 else lives[0]
    pos = torch.cumsum(live.to(torch.int64), 0) - 1
    dest = torch.where(live, pos, torch.full((), cap_out, dtype=torch.int64,
                                             device=live.device))
    total = live.sum(dtype=torch.int32)
    outs = []
    for ci in range(len(pieces[0])):
        src = torch.cat([p[ci] for p in pieces]) if len(pieces) > 1 \
            else pieces[0][ci]
        buf = _zeros_like_col(src, cap_out + 1)
        buf.scatter_(0, dest, src)
        outs.append(buf[:cap_out])
    return outs, total


def ensure_compact(batch: ColumnarBatch) -> ColumnarBatch:
    """Compact a live-masked view into a dense batch (reference:
    batch.py:1047); the count stays a device scalar."""
    if batch.live is None:
        return batch
    cap = bucket_capacity(batch.capacity)
    pieces = [[t for c in batch.columns for t in (c.data, c.validity)]]
    outs, total = _scatter_compact(pieces, [batch.live], cap)
    cols = [ColumnVector(c.dtype, outs[2 * i], outs[2 * i + 1])
            for i, c in enumerate(batch.columns)]
    return ColumnarBatch(cols, total)


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate same-schema batches in order (reference: batch.py:877).
    Host counts and no masks: slices and one cat per column. Otherwise a
    masked scatter compaction with the count left on the card."""
    assert batches, "cannot concat zero batches"
    if len(batches) == 1:
        return ensure_compact(batches[0])
    ncols = batches[0].num_columns
    if all(b.rows_on_host and b.live is None for b in batches):
        total = sum(b.num_rows for b in batches)
        cap = bucket_capacity(total)
        cols = []
        for ci in range(ncols):
            c0 = batches[0].columns[ci]
            data = _zeros_like_col(c0.data, cap)
            valid = _zeros_like_col(c0.validity, cap)
            off = 0
            for b in batches:
                n = b.num_rows
                data[off:off + n] = b.columns[ci].data[:n]
                valid[off:off + n] = b.columns[ci].validity[:n]
                off += n
            cols.append(ColumnVector(c0.dtype, data, valid))
        return ColumnarBatch(cols, total)
    cap = bucket_capacity(sum(b.capacity for b in batches))
    pieces = [[t for c in b.columns for t in (c.data, c.validity)]
              for b in batches]
    outs, total = _scatter_compact(pieces, [b.live_mask() for b in batches],
                                   cap)
    cols = [ColumnVector(batches[0].columns[i].dtype, outs[2 * i],
                         outs[2 * i + 1]) for i in range(ncols)]
    return ColumnarBatch(cols, total)


def gather_batch(batch: ColumnarBatch, indices, out_rows: int) -> ColumnarBatch:
    """Rows by index into a new batch of `out_rows` rows (reference:
    batch.py:1501, fixed-width columns); lanes past out_rows are null."""
    cap = bucket_capacity(max(out_rows, 1))
    src_cap = batch.capacity
    idx = indices[:cap].to(torch.int64)
    if idx.shape[0] < cap:
        idx = torch.cat([idx, torch.zeros(cap - idx.shape[0],
                                          dtype=torch.int64,
                                          device=idx.device)])
    lane = torch.arange(cap, device=idx.device)
    ok = (lane < out_rows) & (idx >= 0) & (idx < src_cap)
    safe = torch.where(ok, idx, torch.zeros((), dtype=torch.int64,
                                            device=idx.device))
    cols = []
    for c in batch.columns:
        valid = c.validity[safe] & ok
        data = torch.where(valid, c.data[safe],
                           torch.zeros((), dtype=c.data.dtype,
                                       device=c.data.device))
        cols.append(ColumnVector(c.dtype, data, valid))
    return ColumnarBatch(cols, out_rows)


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
    cols = [ColumnVector(c.dtype, c.data[:cap].clone(),
                         c.validity[:cap].clone()) for c in out.columns]
    return ColumnarBatch(cols, n)
