"""Parquet and ORC file scan execs (port of spark_rapids_tpu/io/scan.py;
reference: GpuParquetScan.scala, GpuOrcScan.scala).

- `plan_splits` groups each file's row groups into read tasks of at most
  rapids.tpu.sql.reader.batchSizeRows rows (reference :267,
  populateCurrentBlockChunk); a row group larger than that is one task.
- `TpuFileScanExec` (reference :454, `_read_device` :968) reads a task's
  column chunks and decodes them on the device (io/parquet_device.py),
  then slices the row group into batches of at most batchSizeRows rows
  (`_assemble_device_batch` :794).
- `CpuFileScanExec` (reference :442) runs the same decoder on CPU tensors,
  the kernels' plain versions, and hands the CPU engine host batches. The
  reference's CPU scan decodes with Arrow; the port has no Arrow, and its
  tests hold this scan to that one.

A scan decodes only the columns its output keeps (the optimizer prunes
them by name). The device scan keeps a dictionary chunk encoded under
rapids.tpu.sql.encoded.* (`encode_fraction`; reference: the scan's
`encoded_ok` plumbing): a STRING chunk, and an INT64 / DATE / TIMESTAMP
chunk unless fixedDictionaries is off, whose ndv / rows is at most
maxDictFraction. The CPU engine's scan emits plain columns.

ORC (reference `_read_device_orc` :611, `_orc_stripe_batches` :687):
stripes group into read tasks as row groups do. A task first reads every
stripe's footer and checks each column's encoding (and, for TIMESTAMP
columns, the writer's time zone), so a file the decoder does not take
raises before any byte moves to the device. Then, one stripe at a time,
the host reads the stripe, inflates the streams of the columns kept on
threads, walks their runs (io/orc_device.py:plan_column) and uploads the
stripe once, and the device decodes it (K27, K28, K21, K7's span entry):
one stripe's bytes are in memory at a time. A DICTIONARY_V2 STRING column
stays encoded under the same keys as a Parquet dictionary chunk.

Hive-partitioned directories (`k=v` parts) and CSV are queued and raise;
so does a column the decoders do not take (parquet_device.
unsupported_reason, orc_meta's column types) — there is no other decoder
to fall back to.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    bucket_capacity,
    gather_batch,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.engine.retry import with_retry
from spark_rapids_tpu_torch.exec.base import (
    CpuExec,
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)
from spark_rapids_tpu_torch.io import orc_device as OD
from spark_rapids_tpu_torch.io import orc_meta as OM
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io.parquet_meta import (
    ParquetFormatError,
    read_chunk,
    read_footer,
)
from spark_rapids_tpu_torch.memory.semaphore import acquire_for_task
from spark_rapids_tpu_torch.ops.base import AttributeReference

SUFFIXES = (".parquet", ".parq")
FORMAT_SUFFIXES = {"parquet": SUFFIXES, "orc": (".orc",)}
# host seconds of a scan: file reads, decompression, page and run walks
SCAN_HOST_SECONDS = "scanHostSeconds"
# threads for the host part of a row group's columns
HOST_THREADS = 8


@dataclass(frozen=True)
class FileSplit:
    """One read task: a file and the row groups (ORC: stripes) to read
    (reference :47)."""

    path: str
    fmt: str
    row_groups: Optional[Tuple[int, ...]] = None


def expand_paths(paths: List[str],
                 suffixes: Tuple[str, ...] = SUFFIXES) -> List[str]:
    """The data files under `paths` (reference :245): files named by a
    suffix, without `_` / `.` names (`_SUCCESS`), sorted per directory."""
    out: List[str] = []
    for p in paths:
        if not os.path.isdir(p):
            out.append(p)
            continue
        root = p.rstrip(os.sep)
        for d, dirs, files in os.walk(root):
            dirs.sort()
            rel = os.path.relpath(d, root)
            if rel != "." and any("=" in part for part in rel.split(os.sep)):
                raise NotImplementedError(
                    f"{d}: Hive-partitioned directories (key=value) are "
                    "queued: partition discovery is not ported yet")
            for f in sorted(files):
                if f.endswith(suffixes) and not f.startswith(("_", ".")):
                    out.append(os.path.join(d, f))
    if not out:
        raise FileNotFoundError(f"no input files under {paths}")
    return out


def plan_splits(fmt: str, paths: List[str], conf,
                files: Optional[List[str]] = None) -> List[FileSplit]:
    """Split input files into read tasks of at most batchSizeRows rows,
    whole row groups (ORC: stripes) each (reference :267)."""
    if fmt not in FORMAT_SUFFIXES:
        raise NotImplementedError(f"{fmt} reads are queued (Parquet and ORC "
                                  "only)")
    files = files or expand_paths(paths, FORMAT_SUFFIXES[fmt])
    max_rows = conf.get(C.MAX_READ_BATCH_SIZE_ROWS)
    splits: List[FileSplit] = []
    for f in files:
        counts = [g.num_rows for g in read_footer(f).row_groups] \
            if fmt == "parquet" else \
            [si.num_rows for si in OM.read_file_meta(f).stripes]
        group: List[int] = []
        rows = 0
        for rg, n in enumerate(counts):
            if group and rows + n > max_rows:
                splits.append(FileSplit(f, fmt, tuple(group)))
                group, rows = [], 0
            group.append(rg)
            rows += n
        if group:
            splits.append(FileSplit(f, fmt, tuple(group)))
    return splits


def encode_fraction(conf, dtype) -> Optional[float]:
    """maxDictFraction when a dictionary chunk of `dtype` may stay encoded
    under the session's conf, else None."""
    from spark_rapids_tpu_torch.columnar.encoded import FIXED_DICT_DTYPES

    if not conf.get(C.ENCODED_ENABLED):
        return None
    if dtype is DataType.STRING or (
            dtype in FIXED_DICT_DTYPES and
            conf.get(C.ENCODED_FIXED_DICTIONARIES)):
        return conf.get(C.ENCODED_MAX_DICT_FRACTION)
    return None


def _slices(batch: ColumnarBatch, max_rows: int) -> List[ColumnarBatch]:
    """A batch cut into pieces of at most max_rows rows (reference:
    slice_batch_host, a gather)."""
    n = batch.num_rows
    if n <= max_rows:
        return [batch]
    dev = batch.device
    out = []
    for lo in range(0, n, max_rows):
        m = min(max_rows, n - lo)
        idx = torch.arange(lo, lo + bucket_capacity(m), device=dev)
        out.append(gather_batch(batch, idx, m, unique_indices=True))
    return out


class _FileScanBase(PhysicalExec):
    def __init__(self, attrs: List[AttributeReference],
                 splits: List[FileSplit], fmt: str):
        super().__init__()
        self.attrs = attrs
        self.splits = splits
        self.fmt = fmt
        self.metrics[SCAN_HOST_SECONDS] = 0.0

    @property
    def output(self) -> List[AttributeReference]:
        return self.attrs

    @property
    def coalesce_after(self) -> bool:
        # row-group batches coalesce to the target batch size above the
        # scan, as the reference's GpuCoalesceBatches sits above scans
        return True

    def with_children(self, new_children):
        assert not new_children
        return self

    def node_name(self):
        return f"{type(self).__name__}({self.fmt}, {len(self.splits)} splits)"

    def _decode_split(self, split: FileSplit, conf, device: torch.device,
                      encode: bool = False) -> List[ColumnarBatch]:
        """Every row group of a split decoded on `device`, sliced to
        batchSizeRows (reference: _read_device :968). The host's part of
        each column (read, decompress, walk pages and runs) runs on
        threads; then each column uploads once and decodes on the card.
        encode: dictionary chunks may stay encoded (the device scan)."""
        if split.fmt == "orc":
            return self._decode_orc_split(split, conf, device, encode)
        md = read_footer(split.path)
        cols = {c.name: c for c in md.columns}
        groups = split.row_groups if split.row_groups is not None else \
            tuple(range(len(md.row_groups)))
        max_rows = conf.get(C.MAX_READ_BATCH_SIZE_ROWS)
        out: List[ColumnarBatch] = []
        for rg in groups:
            g = md.row_groups[rg]
            rows = g.num_rows
            work = []
            for a in self.attrs:
                col = cols.get(a.name)
                chunk = g.columns.get(a.name)
                if col is None or chunk is None:
                    raise ParquetFormatError(
                        f"{split.path}: column {a.name!r} is not in the file")
                why = PD.unsupported_reason(chunk, col)
                if why:
                    raise ParquetFormatError(f"{split.path}: {why}")
                if col.dtype != a.data_type:
                    raise ParquetFormatError(
                        f"{split.path}: column {a.name!r} is {col.dtype.name}"
                        f" in the file, {a.data_type.name} in the schema")
                work.append((col, chunk, encode_fraction(conf, col.dtype)
                             if encode else None))

            def host_part(item):
                col, chunk, frac = item
                return PD.keep_encoded(PD.prepare_chunk(
                    read_chunk(split.path, chunk), col.dtype, rows,
                    col.max_def, chunk.codec, col.physical, col.name,
                    device.type == "cuda", type_length=col.type_length),
                    frac)

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=min(HOST_THREADS,
                                                    len(work))) as ex:
                prepared = list(ex.map(host_part, work))
            self.metrics[SCAN_HOST_SECONDS] += time.perf_counter() - t0
            cap = bucket_capacity(max(rows, 1))
            vecs = [PD.decode_prepared(hc, cap, device) for hc in prepared]
            out.extend(_slices(ColumnarBatch(vecs, rows), max_rows))
        return out

    def _orc_columns(self, path: str, meta: OM.OrcMeta):
        """(attribute, column) pairs, checked against the file's types."""
        out = []
        for a in self.attrs:
            col = meta.column(a.name)
            if col.dtype is None:
                raise OM.OrcFormatError(f"{path}: column {a.name!r}: "
                                        f"{col.unsupported}")
            if col.dtype != a.data_type:
                raise OM.OrcFormatError(
                    f"{path}: column {a.name!r} is {col.dtype.name} in the "
                    f"file, {a.data_type.name} in the schema")
            out.append((a, col))
        return out

    def _decode_orc_split(self, split: FileSplit, conf,
                          device: torch.device,
                          encode: bool) -> List[ColumnarBatch]:
        """The stripes of an ORC split decoded on `device`, one at a time,
        sliced to batchSizeRows (reference: _read_device_orc :611 and
        _orc_stripe_batches :687)."""
        t0 = time.perf_counter()
        meta = OM.read_file_meta(split.path)
        cols = self._orc_columns(split.path, meta)
        cids = {c.cid for _, c in cols}
        stripes = split.row_groups if split.row_groups is not None else \
            tuple(range(len(meta.stripes)))
        for sidx in stripes:  # every stripe's encodings before any upload
            OM.check_stripe(split.path, meta, meta.stripes[sidx], cols)
        self.metrics[SCAN_HOST_SECONDS] += time.perf_counter() - t0
        max_rows = conf.get(C.MAX_READ_BATCH_SIZE_ROWS)
        frac = encode_fraction(conf, DataType.STRING) if encode else None
        pin = device.type == "cuda"
        out: List[ColumnarBatch] = []
        for sidx in stripes:
            t0 = time.perf_counter()
            held = {}

            def pinned(n: int):
                held["t"] = torch.empty(n, dtype=torch.uint8,
                                        pin_memory=True)
                return held["t"].numpy()

            img = OM.read_stripe(split.path, meta.stripes[sidx],
                                 meta.compression, cids,
                                 pinned if pin else None)
            with ThreadPoolExecutor(max_workers=min(HOST_THREADS,
                                                    len(cols))) as ex:
                plans = list(ex.map(lambda ac: OD.plan_column(
                    img, ac[1].cid, ac[0].data_type, ac[0].name), cols))
            self.metrics[SCAN_HOST_SECONDS] += time.perf_counter() - t0
            rows = img.num_rows
            buf_t = held["t"].to(device, non_blocking=True) if pin else \
                torch.from_numpy(img.buf)
            cap = bucket_capacity(max(rows, 1))
            vecs = [OD.decode_column(p, buf_t, cap, img.buf, frac)
                    for p in plans]
            out.extend(_slices(ColumnarBatch(vecs, rows), max_rows))
        return out


class CpuFileScanExec(_FileScanBase, CpuExec):
    """The CPU engine's scan: the same decoder on CPU tensors (the plain
    versions), host batches out (reference :442)."""

    placement = "cpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        cpu = torch.device("cpu")

        def factory(pidx: int):
            def gen():
                for b in self._decode_split(self.splits[pidx], ctx.conf,
                                            cpu):
                    yield b.to_host()
            return count_output(self.metrics, gen())

        return PartitionedBatches(len(self.splits), factory)


class TpuFileScanExec(_FileScanBase, TpuExec):
    """Parquet and ORC decoded on the device from raw chunk and stripe
    bytes (reference :454, GpuParquetScan.scala:536-556,
    GpuOrcScan.scala:284,709)."""

    placement = "tpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        def factory(pidx: int):
            # a split's decode is pure over (its bytes, conf): a CUDA OOM
            # spills and decodes it again (reference :481-510, where the
            # device ORC path is a generator and is left unwrapped; here
            # both formats decode a split into a list)
            acquire_for_task()
            return count_output(self.metrics, iter(with_retry(
                lambda: self._decode_split(self.splits[pidx], ctx.conf,
                                           ctx.device, encode=True),
                site="scan")))

        return PartitionedBatches(len(self.splits), factory)
