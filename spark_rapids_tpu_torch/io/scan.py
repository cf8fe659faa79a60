"""Parquet, ORC and CSV file scan execs (port of
spark_rapids_tpu/io/scan.py; reference: GpuParquetScan.scala,
GpuOrcScan.scala, GpuBatchScanExec.scala).

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

CSV (reference `_read_device_csv` :516): a split a file (reference
:272-274). The device path reads a file whole, or in line-aligned chunks
of at most rapids.tpu.sql.format.csv.deviceParse.maxSplitBytes (cut after
a newline outside quotes; the header is the first chunk's), each into
pinned memory. The first line gives the column count; the native sweep
plans every field's span (io/csv_device.py:plan_fields); the chunk, its
span tables and a malformed flag go to the device once, and K33-K36 and
K7's span entry parse the columns; DECIMAL, BOOLEAN and FLOAT32 columns
parse on the host from the same spans (io/csv_host.py:parse_column) and
upload. One host sync reads the flag of every column. A chunk the device
path does not take (a ragged line, another quote layout, a malformed field,
invalid UTF-8 under a STRING column, a header without a schema column) is
parsed alone by the host grammar (io/csv_host.py:parse_split), the
reference's host route, and counted in the scan's csvHostSplits metric;
the other chunks keep their device batches. ...csv.deviceParse.enabled
false raises in a device session; the CPU engine then parses every chunk
with the host grammar.

Hive-partitioned directories (`k=v` parts) are queued and raise; so does a
column the decoders do not take (parquet_device.unsupported_reason,
orc_meta's column types) — there is no other decoder to fall back to.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    HostColumnarBatch,
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
from spark_rapids_tpu_torch.io import csv_device as CD
from spark_rapids_tpu_torch.io import csv_host as CH
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
FORMAT_SUFFIXES = {"parquet": SUFFIXES, "orc": (".orc",),
                   "csv": (".csv", ".txt", ".tsv")}
# host seconds of a scan: file reads, decompression, page and run walks,
# CSV field plans
SCAN_HOST_SECONDS = "scanHostSeconds"
# CSV chunks (a file, or a piece of one past maxSplitBytes) parsed by the
# host grammar instead of the device
CSV_HOST_SPLITS = "csvHostSplits"
_BOM = b"\xef\xbb\xbf"
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
        raise NotImplementedError(f"{fmt} reads are not supported (Parquet, "
                                  "ORC and CSV)")
    files = files or expand_paths(paths, FORMAT_SUFFIXES[fmt])
    if fmt == "csv":  # a split a file (reference :272-274)
        return [FileSplit(f, fmt) for f in files]
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


def to_bool(v) -> bool:
    """A read option's truth (reference scan.py:_to_bool)."""
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes")


def csv_separator(sep) -> str:
    """A CSV separator, which is one byte, as the reference's parser and
    writer require."""
    if not isinstance(sep, str) or len(sep.encode()) != 1:
        raise ValueError(f"the CSV separator must be one byte: {sep!r}")
    return sep


def csv_options(options) -> Tuple[bool, str]:
    """(header, separator) of a CSV read (reference :312-314)."""
    return to_bool(options.get("header", False)), csv_separator(
        options.get("sep", options.get("delimiter", ",")))


def _first_line_fields(buf, sep: str) -> int:
    """The fields of the first line, separators inside quotes not
    counted."""
    head = bytes(buf[:1 << 20])
    sep_b = ord(sep)
    inside = False
    count = 1
    for c in head:
        if c == 0x22:
            inside = not inside
        elif not inside:
            if c == 0x0A:
                break
            if c == sep_b:
                count += 1
    return count


def _read_csv_chunk(fd: int, path: str, lo: int, size: int, limit: int,
                    pin: bool):
    """(buf, skip, end): the file's bytes from lo, at most `limit` of them
    unless one line is longer, in pinned memory for a card; buf[skip:end]
    is the chunk, whole lines ending outside quotes (skip: a BOM at the
    file's start)."""
    n = min(limit, size - lo)
    while True:
        buf = torch.empty(n, dtype=torch.uint8, pin_memory=pin).numpy()
        _pread(fd, buf, lo, path)
        skip = 3 if lo == 0 and bytes(buf[:3]) == _BOM else 0
        end = n if lo + n == size else native.csv_last_line_end(buf, skip, n)
        if end >= 0:
            return buf, skip, end
        n = min(2 * n, size - lo)  # a line longer than the chunk


def _pread(fd: int, buf, offset: int, path: str) -> None:
    """buf filled from the file at offset, in pieces on threads."""
    n = buf.size
    k = max(1, min(HOST_THREADS, n // (8 << 20)))
    bounds = [n * i // k for i in range(k + 1)]
    view = memoryview(buf)

    def part(i):
        a, b = bounds[i], bounds[i + 1]
        while a < b:
            got = os.preadv(fd, [view[a:b]], offset + a)
            if got <= 0:
                raise OSError(f"{path}: short read at {offset + a}")
            a += got

    with ThreadPoolExecutor(max_workers=k) as ex:
        list(ex.map(part, range(k)))


class _FileScanBase(PhysicalExec):
    def __init__(self, attrs: List[AttributeReference],
                 splits: List[FileSplit], fmt: str, options=None):
        super().__init__()
        self.attrs = attrs
        self.splits = splits
        self.fmt = fmt
        self.options = dict(options or {})
        self.metrics[SCAN_HOST_SECONDS] = 0.0
        if fmt == "csv":
            self.metrics[CSV_HOST_SPLITS] = 0

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
        if split.fmt == "csv":
            return self._decode_csv_split(split, conf, device)
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


    # ------------------------------------------------------------- CSV
    def _decode_csv_split(self, split: FileSplit, conf,
                          device: torch.device) -> List[ColumnarBatch]:
        """A CSV file parsed on `device` (reference _read_device_csv :516),
        in line-aligned chunks of at most maxSplitBytes (a longer line is
        a chunk of its own). A chunk the device path does not take goes
        through the host grammar alone, the reference's host route; the
        CPU engine with ...csv.deviceParse.enabled false sends every
        chunk there (a device session raises at planning)."""
        header, sep = csv_options(self.options)
        size = os.path.getsize(split.path)
        if not size:
            raise CH.CsvFormatError(f"{split.path}: Empty CSV file")
        device_parse = conf.get(C.CSV_DEVICE_PARSE)
        limit = max(int(conf.get(C.CSV_DEVICE_MAX_SPLIT_BYTES)), 1)
        max_rows = conf.get(C.MAX_READ_BATCH_SIZE_ROWS)
        pin = device.type == "cuda"
        names = None if header else [a.name for a in self.attrs]
        ncols = 0
        out: List[ColumnarBatch] = []
        lo = 0
        with open(split.path, "rb") as f:
            while lo < size:
                t0 = time.perf_counter()
                buf, skip, end = _read_csv_chunk(f.fileno(), split.path, lo,
                                                 size, limit, pin)
                self.metrics[SCAN_HOST_SECONDS] += time.perf_counter() - t0
                chunk = buf[skip:end]
                first = header and lo == 0
                res = None
                if device_parse:
                    if lo == 0:
                        ncols = _first_line_fields(chunk, sep)
                    res = self._device_csv_chunk(chunk, ncols, first, names,
                                                 sep, device)
                    if res is None:  # the plan may have unescaped it
                        _pread(f.fileno(), chunk, lo + skip, split.path)
                if res is None:
                    res = self._host_csv_chunk(chunk, first, names, sep,
                                               device)
                batch, names = res
                out.extend(_slices(batch, max_rows))
                lo += end
        return out

    def _device_csv_chunk(self, chunk, ncols: int, header: bool, names,
                          sep: str, device: torch.device):
        """(batch, the file's column names) of one line-aligned chunk (a
        writable uint8 array, in pinned memory for a card) through the
        device path, or None when it is not eligible or a field is
        malformed for the device grammar. header: the chunk starts with
        the header row, which names the columns; else `names` do."""
        t0 = time.perf_counter()
        pin = device.type == "cuda"
        alloc = (lambda k: torch.empty(k, dtype=torch.int32,
                                       pin_memory=True).numpy()) \
            if pin else None
        table = CD.plan_fields(chunk, ncols, header, sep, alloc)
        if table is not None and header:
            names = table.header_names
        ok = table is not None and self._csv_eligible(table, names)
        self.metrics[SCAN_HOST_SECONDS] += time.perf_counter() - t0
        if not ok:
            return None
        n = table.num_rows
        # pinned: the copies run ahead; the flag's sync below ends them
        # before the host buffers go
        ds = CD.DeviceSplit(table, *(
            torch.from_numpy(x).to(device, non_blocking=pin)
            for x in (table.raw, table.starts_cm, table.lens_cm)))
        cols = {}
        rest = []
        for a in self.attrs:
            j = names.index(a.name)
            if CD.device_parseable(a.data_type):
                cols[a.name] = CD.decode_column(ds, j, a.data_type)
            else:
                rest.append((a, j))
        if int(ds.flag.item()):  # one sync for every column's flag
            return None
        if rest:
            t0 = time.perf_counter()
            host = HostColumnarBatch([CH.parse_column(
                a.name, a.data_type, table.raw, table.starts[:, j],
                table.lens[:, j]) for a, j in rest], n)
            self.metrics[SCAN_HOST_SECONDS] += time.perf_counter() - t0
            up = host.to_device(device)
            for (a, _j), v in zip(rest, up.columns):
                cols[a.name] = v
        return ColumnarBatch([cols[a.name] for a in self.attrs], n), names

    def _csv_eligible(self, table, names) -> bool:
        """Whether the device path takes a planned chunk: every schema
        column is in the file, and the text is UTF-8 where a STRING column
        reads it (the host grammar validates UTF-8 where a STRING
        converts; the device carries raw bytes, so a chunk that is not
        UTF-8 takes the host route, which raises as the reference does)."""
        if len(names) != table.ncols or any(
                a.name not in names for a in self.attrs):
            return False
        if any(a.data_type is DataType.STRING for a in self.attrs) and \
                not table.ascii:
            try:
                str(memoryview(table.raw), "utf-8")
            except UnicodeDecodeError:
                return False
        return True

    def _host_csv_chunk(self, chunk, header: bool, names, sep: str,
                        device: torch.device):
        """(batch, the file's column names) of one chunk through the host
        grammar, uploaded: the reference's host route (it raises where the
        reference's parser does), counted in csvHostSplits."""
        self.metrics[CSV_HOST_SPLITS] += 1
        t0 = time.perf_counter()
        hb, names = CH.parse_split(chunk, self.attrs, header, sep, names)
        self.metrics[SCAN_HOST_SECONDS] += time.perf_counter() - t0
        return hb.to_device(device), names


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
