"""File writes (port of spark_rapids_tpu/io/writer.py: `execute_write`
:37; reference: GpuFileFormatWriter, ColumnarOutputWriter.scala).

Save modes error (the default; also "errorifexists"), ignore, overwrite
and append; one `part-{pidx:05d}-{id}.parquet` (`.orc`, `.csv`) file per
partition of the plan, then a `_SUCCESS` marker. The device plan's root
DeviceToHostExec is peeled and the device batches go to the device encoder
(Parquet: K22; ORC: K29 and K22's ORC mode, io/orc_encode_device.py), so
only page and stream payloads download (reference :62-121); host batches
(a plan that is only a host scan) upload to the session's device first.
The CPU engine (rapids.tpu.sql.enabled=false) hands host batches, which
the same encoders take as CPU tensors (their plain versions). A device
session with rapids.tpu.sql.format.parquet.deviceEncode.enabled, or
rapids.tpu.sql.format.orc.write.enabled / deviceEncode.enabled, false
raises: the port has no host encoder to move the write to. The Parquet and
ORC writers' one option is `compression` (Parquet: snappy by default; ORC:
uncompressed by default, as the reference's writer, or zlib / snappy).

CSV (reference :156-165, pyarrow's write_csv there): the options `header`
(default true) and `sep` (default ","). A device batch downloads its
columns' values, validity and string offsets and bytes; the host writes
the text (io/csv_host.py), the same bytes pyarrow writes, a slice of rows
at a time. `partitionBy` and other options raise.
"""

from __future__ import annotations

import os
import shutil
import uuid
from concurrent.futures import ThreadPoolExecutor

import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.batch import (
    HostColumnarBatch,
    ensure_compact,
)
from spark_rapids_tpu_torch.columnar.encoded import decode_batch
from spark_rapids_tpu_torch.exec.base import rows_of
from spark_rapids_tpu_torch.exec.transitions import DeviceToHostExec
from spark_rapids_tpu_torch.io import csv_host as CH
from spark_rapids_tpu_torch.io import orc_encode_device as OE
from spark_rapids_tpu_torch.io import parquet_encode_device as PE
from spark_rapids_tpu_torch.memory.semaphore import task_scope
from spark_rapids_tpu_torch.io.scan import csv_separator, to_bool
from spark_rapids_tpu_torch.plan import logical as L

_MODES = {"error": "error", "errorifexists": "error", "default": "error",
          "ignore": "ignore", "overwrite": "overwrite", "append": "append"}


class WriteError(RuntimeError):
    pass


# rows of a CSV text slice (bounds the writer's digit matrices), and the
# threads that format slices
CSV_SLICE_ROWS = 1 << 17
CSV_THREADS = 8
_WRITE_OPTIONS = {"parquet": {"compression"}, "orc": {"compression"},
                  "csv": {"header", "sep"}}


def execute_write(session, plan: L.WriteFile) -> None:
    if plan.fmt not in _WRITE_OPTIONS:
        raise NotImplementedError(f"{plan.fmt} writes are not supported "
                                  "(Parquet, ORC and CSV)")
    if plan.partition_by:
        raise NotImplementedError("partitionBy is queued: the port writes "
                                  f"unpartitioned {plan.fmt} directories")
    mode = _MODES.get(str(plan.mode).lower())
    if mode is None:
        raise ValueError(f"unknown save mode {plan.mode!r}")
    takes = _WRITE_OPTIONS[plan.fmt]
    unknown = sorted(set(map(str, plan.options)) - takes)
    if unknown:
        raise NotImplementedError(
            f"the {plan.fmt} writer takes only the option(s) "
            f"{', '.join(sorted(takes))}: {', '.join(unknown)}")
    if plan.fmt == "csv":
        return _write_csv(session, plan, mode)
    orc = plan.fmt == "orc"
    device = session.conf.sql_enabled
    keys = (C.ORC_WRITE_ENABLED, C.ORC_DEVICE_ENCODE) if orc else \
        (C.PARQUET_DEVICE_ENCODE,)
    for key in keys:
        if device and not session.conf.get(key):
            raise ValueError(
                f"{key.key}=false: a device session encodes {plan.fmt} on "
                "the device only (the CPU engine, rapids.tpu.sql.enabled="
                "false, encodes on the host)")
    enc = OE if orc else PE
    compression = str(plan.options.get("compression",
                                       "uncompressed" if orc else "snappy"))
    enc.require_codec(compression)
    attrs = plan.children[0].output
    bad = enc.schema_encodable(attrs)
    if bad:  # ORC: a ValueError, as every ORC shape the port does not take
        raise (OE.OrcFormatError if orc else WriteError)(
            f"cannot write column(s) {', '.join(bad)} as {plan.fmt}")
    path = plan.path
    if not _prepare_dir(path, mode):
        return

    # under a QueryContext, as a query: an OOM retry spills the
    # session's buffers
    with session.query_scope():
        physical = session._physical_plan(plan.children[0])
        if device and isinstance(physical, DeviceToHostExec):
            physical = physical.children[0]
        pb = physical.execute(session.exec_context())
        write_id = uuid.uuid4().hex[:12]
        # host batches (a plan that is a host scan alone, or the CPU engine's)
        # go to the session's device, so a device session encodes with K22
        target = session.device if device else torch.device("cpu")
        for pidx in range(pb.num_partitions):
            # the encoder writes values: encoded columns decode here
            with task_scope():
                batches = [b.to_device(target)
                           if isinstance(b, HostColumnarBatch)
                           else decode_batch(b) for b in pb.iterator(pidx)
                           if rows_of(b) > 0]
            if not batches:
                continue
            fname = f"part-{pidx:05d}-{write_id}.{plan.fmt}"
            enc.write_file(os.path.join(path, fname), attrs, batches,
                           compression=compression)
    with open(os.path.join(path, "_SUCCESS"), "w"):
        pass


def _prepare_dir(path: str, mode: str) -> bool:
    """Apply the save mode; False when the write is to be skipped."""
    if os.path.exists(path):
        if mode == "error":
            raise WriteError(f"path {path} already exists "
                             "(mode=error[ifexists])")
        if mode == "ignore":
            return False
        if mode == "overwrite":
            shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    return True


def _host_columns(batch, attrs):
    """(dtype, values, validity, offsets or None) numpy columns of a batch's
    rows: a device batch downloads them (STRING: offsets and bytes), a host
    batch gives its own."""
    if isinstance(batch, HostColumnarBatch):
        out = []
        for a, c in zip(attrs, batch.columns):
            if a.data_type is DataType.STRING:
                offs, data = c.utf8()
                out.append((a.data_type, data, c.validity, offs))
            else:
                out.append((a.data_type, c.data, c.validity, None))
        return out, batch.num_rows
    b = ensure_compact(decode_batch(batch))
    n = b.host_rows()
    out = []
    for a, c in zip(attrs, b.columns):
        valid = c.validity[:n].cpu().numpy()
        if a.data_type is DataType.STRING:
            offs = c.offsets[:n + 1].cpu().numpy()
            data = c.data[:int(offs[-1])].cpu().numpy()
            out.append((a.data_type, data, valid, offs))
        else:
            out.append((a.data_type, c.data[:n].cpu().numpy(), valid, None))
    return out, n


def _csv_text(cols, lo: int, hi: int, sep: str) -> bytes:
    return CH.join_rows([CH.column_slots(
        dt, data[lo:hi] if offs is None else data, valid[lo:hi],
        None if offs is None else offs[lo:hi + 1])
        for dt, data, valid, offs in cols], hi - lo, sep)


def _write_csv(session, plan: L.WriteFile, mode: str) -> None:
    """CSV text a partition (reference _write_table :156-165): a quoted
    header unless header=false, then the rows."""
    header = to_bool(plan.options.get("header", True))
    sep = csv_separator(plan.options.get("sep", ","))
    attrs = plan.children[0].output
    path = plan.path
    if not _prepare_dir(path, mode):
        return
    with session.query_scope():
        physical = session._physical_plan(plan.children[0])
        if isinstance(physical, DeviceToHostExec):
            # the writer downloads the columns it formats, not host rows
            physical = physical.children[0]
        pb = physical.execute(session.exec_context())
        write_id = uuid.uuid4().hex[:12]
        parts = []
        for pidx in range(pb.num_partitions):
            with task_scope():
                batches = [_host_columns(b, attrs) for b in pb.iterator(pidx)
                           if rows_of(b) > 0]
            if batches:
                parts.append((pidx, batches))
        # every partition's slices format on one pool of threads (numpy
        # leaves the GIL), each file written in order
        with ThreadPoolExecutor(max_workers=CSV_THREADS) as ex:
            texts = [[ex.submit(_csv_text, cols, lo,
                                min(n, lo + CSV_SLICE_ROWS), sep)
                      for cols, n in batches
                      for lo in range(0, n, CSV_SLICE_ROWS)]
                     for _pidx, batches in parts]
            for (pidx, _b), futures in zip(parts, texts):
                fname = f"part-{pidx:05d}-{write_id}.csv"
                with open(os.path.join(path, fname), "wb") as f:
                    if header:
                        f.write(CH.header_line([a.name for a in attrs],
                                               sep))
                    for fut in futures:
                        f.write(fut.result())
    with open(os.path.join(path, "_SUCCESS"), "w"):
        pass
