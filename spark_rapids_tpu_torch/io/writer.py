"""File writes (port of spark_rapids_tpu/io/writer.py: `execute_write`
:37; reference: GpuFileFormatWriter, ColumnarOutputWriter.scala).

Save modes error (the default; also "errorifexists"), ignore, overwrite
and append; one `part-{pidx:05d}-{id}.parquet` (`.orc`) file per partition
of the plan, then a `_SUCCESS` marker. The device plan's root
DeviceToHostExec is peeled and the device batches go to the device encoder
(Parquet: K22; ORC: K29 and K22's ORC mode, io/orc_encode_device.py), so
only page and stream payloads download (reference :62-121); host batches
(a plan that is only a host scan) upload to the session's device first.
The CPU engine (rapids.tpu.sql.enabled=false) hands host batches, which
the same encoders take as CPU tensors (their plain versions). A device
session with rapids.tpu.sql.format.parquet.deviceEncode.enabled, or
rapids.tpu.sql.format.orc.write.enabled / deviceEncode.enabled, false
raises: the port has no host encoder to move the write to. The one write
option is `compression` (Parquet: snappy by default; ORC: uncompressed by
default, as the reference's writer, or zlib / snappy); `partitionBy`,
other options and CSV raise.
"""

from __future__ import annotations

import os
import shutil
import uuid

import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
from spark_rapids_tpu_torch.columnar.encoded import decode_batch
from spark_rapids_tpu_torch.exec.base import rows_of
from spark_rapids_tpu_torch.exec.transitions import DeviceToHostExec
from spark_rapids_tpu_torch.io import orc_encode_device as OE
from spark_rapids_tpu_torch.io import parquet_encode_device as PE
from spark_rapids_tpu_torch.memory.semaphore import task_scope
from spark_rapids_tpu_torch.plan import logical as L

_MODES = {"error": "error", "errorifexists": "error", "default": "error",
          "ignore": "ignore", "overwrite": "overwrite", "append": "append"}


class WriteError(RuntimeError):
    pass


def execute_write(session, plan: L.WriteFile) -> None:
    if plan.fmt not in ("parquet", "orc"):
        raise NotImplementedError(f"{plan.fmt} writes are queued (Parquet "
                                  "and ORC only)")
    if plan.partition_by:
        raise NotImplementedError("partitionBy is queued: the port writes "
                                  f"unpartitioned {plan.fmt} directories")
    mode = _MODES.get(str(plan.mode).lower())
    if mode is None:
        raise ValueError(f"unknown save mode {plan.mode!r}")
    unknown = sorted(set(map(str, plan.options)) - {"compression"})
    if unknown:
        raise NotImplementedError(f"the {plan.fmt} writer takes only the "
                                  f"compression option: {', '.join(unknown)}")
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
    if os.path.exists(path):
        if mode == "error":
            raise WriteError(f"path {path} already exists "
                             "(mode=error[ifexists])")
        if mode == "ignore":
            return
        if mode == "overwrite":
            shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)

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
