"""Spillable buffers: a catalog and the chained device -> host -> disk
stores (port of spark_rapids_tpu/memory/spill.py; reference:
RapidsBuffer*.scala, Rapids{Device,Host,Disk}*Store.scala,
SpillPriorities.scala, DeviceMemoryEventHandler.scala).

Tiers:
- DEVICE: the buffer holds a live device batch. Spilling copies it into
  pinned host memory column by column and serializes it to TPB1 bytes
  (columnar/serde.py), then drops every reference to its CUDA tensors, so
  PyTorch's allocator can hand the memory to the next tensor.
- HOST: the TPB1 bytes in process memory, bounded by
  rapids.tpu.memory.host.spillStorageSize; overflow goes to disk. The
  serialized shuffle registers its pieces here (`add_host_bytes`, at
  SpillPriorities.OUTPUT_FOR_READ) and reads them back with `read_bytes`.
- DISK: the bytes in a file under rapids.tpu.memory.spill.dir (default: a
  directory under the process's temporary directory).

`get_device_batch` brings a spilled buffer back through the grouped
upload. `MemoryWatermark.ensure_headroom` spills before an upload or a
rematerialisation would pass the budget; a CUDA OOM inside an operator
spills through engine/retry.with_retry (the store's synchronous spill to
half). Eviction order: lowest (priority, id) first, as the reference.

A batch the store hands out stays alive while its consumer holds it: a
spill drops the store's reference only, and the memory comes free when
the consumer lets go (as in the reference).
"""

from __future__ import annotations

import itertools
import logging
import os
import tempfile
import threading
from enum import IntEnum
from typing import Callable, Dict, Optional

import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    HostColumnarBatch,
)
from spark_rapids_tpu_torch.columnar.serde import (
    deserialize_batch,
    deserialize_to_device,
    serialize_device_batch,
    serialized_rows,
)
from spark_rapids_tpu_torch.utils import metrics as M

log = logging.getLogger(__name__)


class StorageTier(IntEnum):
    """Reference: RapidsBuffer.scala:53-58."""

    DEVICE = 0
    HOST = 1
    DISK = 2


class SpillPriorities:
    """Priority bands (reference: SpillPriorities.scala:26-50); lower
    spills first."""

    OUTPUT_FOR_READ = -100.0
    DEFAULT = 0.0
    INPUT_ACTIVE = 100.0


_id_counter = itertools.count(1)

# process-wide count of tier demotions, under its own lock
SPILL_EVENTS = 0
_SPILL_EVENTS_LOCK = threading.Lock()


def next_buffer_id() -> int:
    return next(_id_counter)


class SpillableBuffer:
    """One spillable batch (reference: RapidsBufferBase). Exactly one of
    device_batch, host_bytes and disk_path carries the payload of its tier
    (a device buffer may keep the bytes it was spilled from). `num_rows` is
    the batch's row count, known at every tier. The reference's refcount
    pins are left out: nothing in the port pins a buffer."""

    def __init__(self, buf_id: int, size: int, tier: StorageTier,
                 priority: float = SpillPriorities.DEFAULT,
                 num_rows: Optional[int] = None):
        self.id = buf_id
        self.size = size
        self.tier: Optional[StorageTier] = tier  # None: freed
        self.priority = priority
        self.num_rows = num_rows
        self.device_batch: Optional[ColumnarBatch] = None
        self.host_bytes: Optional[bytes] = None
        self.disk_path: Optional[str] = None
        self.lock = threading.Lock()

    def __repr__(self):
        tier = self.tier.name if self.tier is not None else "FREED"
        return f"SpillableBuffer(id={self.id}, tier={tier}, size={self.size})"


class BufferCatalog:
    """id -> buffer registry (reference: RapidsBufferCatalog.scala:40-99)."""

    def __init__(self):
        self._buffers: Dict[int, SpillableBuffer] = {}
        self._lock = threading.Lock()

    def register(self, buf: SpillableBuffer) -> None:
        with self._lock:
            self._buffers[buf.id] = buf

    def lookup(self, buf_id: int) -> SpillableBuffer:
        with self._lock:
            buf = self._buffers.get(buf_id)
        if buf is None:
            raise KeyError(f"unknown buffer id {buf_id}")
        return buf

    def remove(self, buf_id: int) -> Optional[SpillableBuffer]:
        with self._lock:
            return self._buffers.pop(buf_id, None)


class BufferStore:
    """A tier's tracker with a chained spill target (reference:
    RapidsBufferStore.scala:44-282)."""

    tier: StorageTier

    def __init__(self, catalog: BufferCatalog):
        self.catalog = catalog
        self.spill_store: Optional["BufferStore"] = None
        self._buffers: Dict[int, SpillableBuffer] = {}
        self._lock = threading.Lock()
        self.current_size = 0

    def set_spill_store(self, store: "BufferStore") -> None:
        self.spill_store = store

    def track(self, buf: SpillableBuffer) -> None:
        with self._lock:
            self._buffers[buf.id] = buf
            self.current_size += buf.size

    def untrack(self, buf: SpillableBuffer) -> None:
        with self._lock:
            if self._buffers.pop(buf.id, None) is not None:
                self.current_size -= buf.size

    def buffer_count(self) -> int:
        with self._lock:
            return len(self._buffers)

    def _spill_candidate(self, skip=()) -> Optional[SpillableBuffer]:
        """The lowest (priority, id) buffer."""
        with self._lock:
            candidates = [b for b in self._buffers.values()
                          if b.id not in skip]
        if not candidates:
            return None
        return min(candidates, key=lambda b: (b.priority, b.id))

    def synchronous_spill(self, target_size: int) -> int:
        """Spill until current_size <= target_size; returns bytes spilled
        (reference: RapidsBufferStore.synchronousSpill)."""
        spilled = 0
        skip = set()
        while self.current_size > target_size:
            buf = self._spill_candidate(skip)
            if buf is None:
                log.warning("%s store: cannot reach spill target %d "
                            "(size=%d, every buffer raced away)",
                            self.tier.name, target_size, self.current_size)
                break
            got = self.spill_buffer(buf)
            if got == 0:
                skip.add(buf.id)
            spilled += got
        return spilled

    def spill_buffer(self, buf: SpillableBuffer) -> int:
        """Move one buffer to the next tier (copy on spill, then the
        catalog's update). No buffer lock is held while another buffer's
        is taken, so spill chains cannot deadlock."""
        if self.spill_store is None:
            raise RuntimeError(f"{self.tier.name} store has no spill target")
        self.spill_store.make_room(buf.size)
        with buf.lock:
            if buf.tier is not self.tier:
                return 0  # moved or freed meanwhile
            global SPILL_EVENTS
            with _SPILL_EVENTS_LOCK:
                SPILL_EVENTS += 1
            self._demote(buf)
            self.untrack(buf)
            buf.tier = self.spill_store.tier
            self.spill_store.track(buf)
        M.record_spill(self.spill_store.tier.name.lower(), buf.size)
        limit = self.spill_store.size_limit()
        if limit is not None and self.spill_store.current_size > limit:
            self.spill_store.synchronous_spill(limit)
        return buf.size

    def make_room(self, nbytes: int) -> None:
        """Let a bounded store absorb nbytes by spilling down the chain."""
        limit = self.size_limit()
        if limit is not None and self.spill_store is not None:
            self.synchronous_spill(max(0, limit - nbytes))

    def size_limit(self) -> Optional[int]:
        return None

    def _demote(self, buf: SpillableBuffer) -> None:
        raise NotImplementedError


class DeviceStore(BufferStore):
    """Tier 0: live device batches (reference:
    RapidsDeviceMemoryStore.scala)."""

    tier = StorageTier.DEVICE

    def add_batch(self, batch: ColumnarBatch,
                  priority: float = SpillPriorities.DEFAULT,
                  host_bytes: Optional[bytes] = None) -> SpillableBuffer:
        """Register a device batch as spillable (reference: addTable);
        `host_bytes` spares the download at spill time."""
        size = len(host_bytes) if host_bytes is not None else \
            batch.device_memory_size()
        rows = getattr(batch, "num_rows", None)
        buf = SpillableBuffer(next_buffer_id(), size, self.tier, priority,
                              rows)
        buf.device_batch = batch
        buf.host_bytes = host_bytes
        self.catalog.register(buf)
        self.track(buf)
        return buf

    def _demote(self, buf: SpillableBuffer) -> None:
        if buf.host_bytes is None:
            buf.host_bytes = serialize_device_batch(buf.device_batch)
        buf.num_rows = serialized_rows(buf.host_bytes)
        buf.device_batch = None  # the last reference the store holds


class HostStore(BufferStore):
    """Tier 1: TPB1 bytes in process memory, bounded (reference:
    RapidsHostMemoryStore.scala)."""

    tier = StorageTier.HOST

    def __init__(self, catalog: BufferCatalog, limit_bytes: int):
        super().__init__(catalog)
        self.limit_bytes = limit_bytes

    def size_limit(self) -> Optional[int]:
        return self.limit_bytes

    def add_bytes_tracked(self, buf: SpillableBuffer) -> None:
        """Track a new host buffer and push any overflow to disk (never
        called under a buffer lock, unlike track from spill_buffer)."""
        self.track(buf)
        if self.current_size > self.limit_bytes and self.spill_store:
            self.synchronous_spill(self.limit_bytes)

    def _demote(self, buf: SpillableBuffer) -> None:
        disk: DiskStore = self.spill_store  # type: ignore[assignment]
        buf.disk_path = disk.write_file(buf.id, buf.host_bytes)
        buf.host_bytes = None


class DiskStore(BufferStore):
    """Tier 2: files under the spill directory (reference:
    RapidsDiskStore.scala)."""

    tier = StorageTier.DISK

    def __init__(self, catalog: BufferCatalog, spill_dir: Optional[str]):
        super().__init__(catalog)
        self._dir = spill_dir or os.path.join(
            tempfile.gettempdir(), f"tpu-spill-{os.getpid()}")

    def write_file(self, buf_id: int, data: bytes) -> str:
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, f"buffer-{buf_id}.tpb")
        with open(path, "wb") as f:
            f.write(data)
        return path

    def read_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def _demote(self, buf: SpillableBuffer) -> None:
        raise RuntimeError("disk store has no spill target")


class SpillFramework:
    """Catalog, store chain and watermark of one session (reference:
    GpuShuffleEnv.initStorage). The session owns it and hands it to its
    queries (ExecContext.spill, QueryContext.spill); a buffer keeps
    working through the framework that made it."""

    def __init__(self, tpu_conf: "C.TpuConf", hbm_budget: int,
                 bytes_in_use: Callable[[], int], device=None):
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.catalog = BufferCatalog()
        self.device_store = DeviceStore(self.catalog)
        self.host_store = HostStore(
            self.catalog, tpu_conf.get(C.HOST_SPILL_STORAGE_SIZE))
        self.disk_store = DiskStore(self.catalog, tpu_conf.get(C.SPILL_DIR))
        self.device_store.set_spill_store(self.host_store)
        self.host_store.set_spill_store(self.disk_store)
        self.watermark = MemoryWatermark(self.device_store, hbm_budget,
                                         bytes_in_use)

    def snapshot(self) -> dict:
        """Bytes and buffers per tier, and the process's demotions."""
        with _SPILL_EVENTS_LOCK:
            events = SPILL_EVENTS
        return {
            "events": events,
            "tiers": {
                store.tier.name.lower(): {
                    "bytes": store.current_size,
                    "buffers": store.buffer_count(),
                }
                for store in (self.device_store, self.host_store,
                              self.disk_store)
            },
        }

    def add_device_batch(self, batch: ColumnarBatch) -> SpillableBuffer:
        """Register a device batch at the default priority, spilling
        first if it would pass the budget."""
        self.watermark.ensure_headroom(batch.device_memory_size())
        return self.device_store.add_batch(batch)

    def add_host_bytes(self, data: bytes,
                       priority: float = SpillPriorities.DEFAULT
                       ) -> SpillableBuffer:
        """Register serialized bytes at the host tier (reference :445; the
        serialized shuffle's pieces, so shuffle data takes part in spill
        and demotes to disk past the host budget). `free` releases it."""
        buf = SpillableBuffer(next_buffer_id(), len(data), StorageTier.HOST,
                              priority, serialized_rows(data))
        buf.host_bytes = data
        self.catalog.register(buf)
        self.host_store.add_bytes_tracked(buf)
        return buf

    def read_bytes(self, buf: SpillableBuffer) -> bytes:
        """A host or disk buffer's serialized bytes."""
        with buf.lock:
            return self._read_bytes(buf)

    def get_device_batch(self, buf: SpillableBuffer) -> ColumnarBatch:
        """The batch on the device, uploaded again if spilled (reference
        :465). buf.lock is not held across the headroom spill and the
        upload; a concurrent rematerialisation keeps the first."""
        with buf.lock:
            if buf.device_batch is not None:
                return buf.device_batch
            data = self._read_bytes(buf)
        self.watermark.ensure_headroom(len(data))
        batch = deserialize_to_device(data, self.device)
        M.record_unspill()
        with buf.lock:
            if buf.device_batch is not None:
                return buf.device_batch
            if buf.tier is None:  # freed meanwhile
                return batch
            self._store_for(buf.tier).untrack(buf)
            buf.device_batch = batch
            buf.host_bytes = data if buf.tier is StorageTier.HOST else None
            if buf.disk_path:
                try:
                    os.unlink(buf.disk_path)
                except OSError:
                    pass
                buf.disk_path = None
            buf.tier = StorageTier.DEVICE
            self.device_store.track(buf)
            return batch

    def get_host_batch(self, buf: SpillableBuffer) -> HostColumnarBatch:
        """The batch on the host, leaving its tier as it is."""
        with buf.lock:
            if buf.tier is StorageTier.DEVICE and buf.device_batch is not None:
                if buf.host_bytes is not None:
                    return deserialize_batch(buf.host_bytes)
                return buf.device_batch.to_host()
            return deserialize_batch(self._read_bytes(buf))

    def free(self, buf: SpillableBuffer) -> None:
        """Release a buffer from whatever tier holds it."""
        with buf.lock:
            if buf.tier is None:
                return
            self._store_for(buf.tier).untrack(buf)
            self.catalog.remove(buf.id)
            buf.device_batch = None
            buf.host_bytes = None
            if buf.disk_path:
                try:
                    os.unlink(buf.disk_path)
                except OSError:
                    pass
                buf.disk_path = None
            buf.tier = None

    def _store_for(self, tier: StorageTier) -> BufferStore:
        return {StorageTier.DEVICE: self.device_store,
                StorageTier.HOST: self.host_store,
                StorageTier.DISK: self.disk_store}[tier]

    def _read_bytes(self, buf: SpillableBuffer) -> bytes:
        if buf.host_bytes is not None:
            return buf.host_bytes
        if buf.disk_path is not None:
            return self.disk_store.read_file(buf.disk_path)
        raise RuntimeError(f"buffer {buf.id} has no payload at any tier")


class MemoryWatermark:
    """Spill before an allocation would pass the budget (reference :571,
    the DeviceMemoryEventHandler analog). Untracked tensors count through
    the device manager's bytes in use."""

    def __init__(self, device_store: DeviceStore, budget: int,
                 bytes_in_use: Callable[[], int]):
        self.device_store = device_store
        self.budget = budget
        self.bytes_in_use = bytes_in_use

    def ensure_headroom(self, nbytes: int) -> None:
        """Spill tracked device buffers until `nbytes` fits under the
        budget (reference :606)."""
        if self.budget <= 0:
            return
        tracked = self.device_store.current_size
        external = max(0, self.bytes_in_use() - tracked)
        avail = self.budget - external - tracked
        if nbytes > avail:
            self.device_store.synchronous_spill(
                max(0, self.budget - external - nbytes))
