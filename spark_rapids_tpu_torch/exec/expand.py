"""Expand (grouping sets) and Generate (explode / posexplode of a created
array) execs (port of spark_rapids_tpu/exec/expand.py: _ExpandBase :50,
CpuExpandExec :69, TpuExpandExec :87, CpuGenerateExec :146,
TpuGenerateExec :193; reference: GpuExpandExec.scala:66-102,
GpuGenerateExec.scala:101).

Expand applies every projection list to every input batch and emits one
output batch per list, in list order (rollup / cube feed the null-filled
keys and the grouping id through it). On the card each list is one
DeviceProjector; a bare reference to an encoded column passes through
encoded. A scan-form fused stage (exec/fused.py) may take an Expand
with its neighbouring filters and projections.

Output row i * k + j holds input row i's columns and element j of its
array, interleaved in Spark's row order. On the card one launch of the
hand-written kernel K18 `explode_rows` (csrc/explode.cu, replacing the
reference's `_replicate_indices` :257 and `_interleave_elems` :264) writes
every fixed child column, the element column, posexplode's position and
the int32 replicate index; STRING child columns are K7 gathers through
that index. The element columns are evaluated once over the input batch
by the DeviceProjector. A STRING element stays on the CPU engine
(plan/overrides.py tags it, as the reference does).
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    HostColumnarBatch,
    HostColumnVector,
    bucket_capacity,
    ensure_compact,
    gather_string_col,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch
from spark_rapids_tpu_torch.columnar.encoded import decode_batch
from spark_rapids_tpu_torch.exec.base import (
    CpuExec,
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)
from spark_rapids_tpu_torch.ops.base import AttributeReference, Expression
from spark_rapids_tpu_torch.ops.bind import bind_all
from spark_rapids_tpu_torch.ops.eval import DeviceProjector, cpu_project

# row indices past the explode are int32 (K7, the replicate index)
MAX_EXPLODE_ROWS = (1 << 31) - 1


# ---------------------------------------------------------------------------
# Expand
# ---------------------------------------------------------------------------
class _ExpandBase(PhysicalExec):
    def __init__(self, projections: Sequence[Sequence[Expression]],
                 output_attrs: List[AttributeReference], child: PhysicalExec):
        super().__init__(child)
        self.projections = [list(p) for p in projections]
        self.output_attrs = list(output_attrs)

    @property
    def output(self):
        return self.output_attrs

    def node_expressions(self):
        return [e for p in self.projections for e in p]

    def with_children(self, new_children):
        return type(self)(self.projections, self.output_attrs,
                          new_children[0])

    def node_name(self):
        return f"{type(self).__name__}[{len(self.projections)} projections]"


class CpuExpandExec(_ExpandBase, CpuExec):
    placement = "cpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        bound = [bind_all(p, self.children[0].output)
                 for p in self.projections]

        def factory(pidx: int) -> Iterator[HostColumnarBatch]:
            for batch in child_pb.iterator(pidx):
                for proj in bound:
                    yield cpu_project(proj, batch, partition_id=pidx)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


class TpuExpandExec(_ExpandBase, TpuExec):
    """One DeviceProjector a projection list; each input batch gives
    len(projections) output batches (reference: GpuExpandIterator cycling
    projectionIndex)."""

    placement = "tpu"

    def __init__(self, projections, output_attrs, child):
        super().__init__(projections, output_attrs, child)
        self._projectors = [DeviceProjector(bind_all(p, child.output))
                            for p in self.projections]

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)

        def factory(pidx: int) -> Iterator[ColumnarBatch]:
            for batch in child_pb.iterator(pidx):
                batch = ensure_compact(batch)
                for projector in self._projectors:
                    yield projector.project(batch, partition_id=pidx)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


# ---------------------------------------------------------------------------
# K18: explode rows
# ---------------------------------------------------------------------------
class _ExplodeCol(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("out_valid", ctypes.c_void_p),
                ("width", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _ExplodeElem(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p)]


def _check_rows(n: int, k: int, out_cap: int) -> None:
    if n * k > MAX_EXPLODE_ROWS:
        # the reference's int32 arange would wrap here
        raise ValueError(f"explode of {n} rows x {k} elements passes "
                         "2^31 - 1 rows in one batch")
    if out_cap < n * k:
        raise ValueError("explode output capacity below n * k")


def explode_rows_plain(children, elems, k: int, n: int, out_cap: int,
                       with_pos: bool):
    """(child outputs [(data, valid)], (elem data, elem valid), pos, rep)
    of exploding n rows by k elements into out_cap lanes: lane r < n * k
    takes row r // k and element r % k; NULL lanes and pads are 0."""
    _check_rows(n, k, out_cap)
    dev = (children[0][1] if children else elems[0][1]).device
    # an empty source gathers its (never live) lane 0 from one zero row
    children = [(d, v) if v.shape[0] else (d.new_zeros(1), v.new_zeros(1))
                for d, v in children]
    elems = [(d, v) if v.shape[0] else (d.new_zeros(1), v.new_zeros(1))
             for d, v in elems]
    r = torch.arange(out_cap, dtype=torch.int64, device=dev)
    live = r < n * k
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    src = torch.where(live, r // k, zero)
    j = torch.where(live, r % k, zero)
    outs = []
    for data, valid in children:
        v = valid[src] & live
        outs.append((torch.where(v, data[src], torch.zeros(
            (), dtype=data.dtype, device=dev)), v))
    elem_out = None
    if elems:
        data = torch.stack([d for d, _ in elems])[j, src]
        v = torch.stack([v for _, v in elems])[j, src] & live
        elem_out = (torch.where(v, data, torch.zeros((), dtype=data.dtype,
                                                     device=dev)), v)
    pos = j.to(torch.int32) if with_pos else None
    return outs, elem_out, pos, src.to(torch.int32)


def explode_rows(children, elems, k: int, n: int, out_cap: int,
                 with_pos: bool):
    """K18: `explode_rows_plain`'s outputs. children: (data, valid) of the
    fixed-width child columns; elems: k (data, valid) of one dtype, or
    empty. CPU tensors run the plain version, CUDA tensors the kernel."""
    probe = children[0][1] if children else elems[0][1]
    if probe.device.type == "cpu":
        return explode_rows_plain(children, elems, k, n, out_cap, with_pos)
    _check_rows(n, k, out_cap)
    dev = probe.device
    lib = CB.library("explode")
    max_child = lib.srt_explode_max_child_cols()
    if k > lib.srt_explode_max_elems():
        raise ValueError(f"explode of {k} elements exceeds the kernel's "
                         f"{lib.srt_explode_max_elems()}")
    keep: List[torch.Tensor] = []
    outs = []
    for data, valid in children:
        data, valid = data.contiguous(), valid.contiguous()
        CB.require_cuda(data, valid)
        keep += [data, valid]
        outs.append((torch.empty(out_cap, dtype=data.dtype, device=dev),
                     torch.empty(out_cap, dtype=torch.bool, device=dev)))
    edescs = (_ExplodeElem * max(k, 1))()
    elem_out = None
    width = 0
    if elems:
        dt = elems[0][0].dtype
        for jj, (data, valid) in enumerate(elems):
            data, valid = data.contiguous(), valid.contiguous()
            CB.require_cuda(data, valid)
            if data.dtype != dt:
                raise ValueError("explode elements must share one dtype")
            keep += [data, valid]
            edescs[jj].data, edescs[jj].valid = data.data_ptr(), \
                valid.data_ptr()
        width = elems[0][0].element_size()
        elem_out = (torch.empty(out_cap, dtype=dt, device=dev),
                    torch.empty(out_cap, dtype=torch.bool, device=dev))
    pos = torch.empty(out_cap, dtype=torch.int32, device=dev) \
        if with_pos else None
    rep = torch.empty(out_cap, dtype=torch.int32, device=dev)
    stream = CB.stream_of(rep)
    # one launch per max_child child columns; the first also writes the
    # elements, the position and the replicate index
    groups = [list(range(s, min(s + max_child, len(children))))
              for s in range(0, len(children), max_child)] or [[]]
    for gi, group in enumerate(groups):
        cdescs = (_ExplodeCol * max(len(group), 1))()
        for slot, c in enumerate(group):
            d = cdescs[slot]
            d.data, d.valid = keep[2 * c].data_ptr(), \
                keep[2 * c + 1].data_ptr()
            d.out, d.out_valid = outs[c][0].data_ptr(), outs[c][1].data_ptr()
            d.width = keep[2 * c].element_size()
        first = gi == 0
        rc = lib.srt_explode_rows(
            ctypes.addressof(cdescs), len(group), ctypes.addressof(edescs),
            k, width if first else 0, n, out_cap,
            elem_out[0].data_ptr() if first and elem_out else None,
            elem_out[1].data_ptr() if first and elem_out else None,
            pos.data_ptr() if first and pos is not None else None,
            rep.data_ptr() if first else None, stream)
        CB.count_launch("explode_rows")
        CB.check(lib, rc, "explode_rows")
    return outs, elem_out, pos, rep


# ---------------------------------------------------------------------------
# Generate execs
# ---------------------------------------------------------------------------
class _GenerateBase(PhysicalExec):
    def __init__(self, include_pos: bool, elem_exprs: Sequence[Expression],
                 generator_output: List[AttributeReference],
                 child: PhysicalExec):
        super().__init__(child)
        self.include_pos = include_pos
        self.elem_exprs = list(elem_exprs)
        self.generator_output = list(generator_output)

    @property
    def output(self):
        return self.children[0].output + self.generator_output

    def node_expressions(self):
        return list(self.elem_exprs)

    def with_children(self, new_children):
        return type(self)(self.include_pos, self.elem_exprs,
                          self.generator_output, new_children[0])

    def node_name(self):
        kind = "posexplode" if self.include_pos else "explode"
        return f"{type(self).__name__}[{kind} x{len(self.elem_exprs)}]"


class CpuGenerateExec(_GenerateBase, CpuExec):
    placement = "cpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        bound = bind_all(self.elem_exprs, self.children[0].output)
        k = len(self.elem_exprs)
        edt = self.generator_output[-1].data_type

        def factory(pidx: int) -> Iterator[HostColumnarBatch]:
            for batch in child_pb.iterator(pidx):
                n = batch.num_rows
                ev = cpu_project(bound, batch, partition_id=pidx)
                cols: List[HostColumnVector] = [
                    HostColumnVector(c.dtype, np.repeat(c.data[:n], k),
                                     np.repeat(c.validity[:n], k))
                    for c in batch.columns]
                if self.include_pos:
                    cols.append(HostColumnVector(
                        DataType.INT32,
                        np.tile(np.arange(k, dtype=np.int32), n),
                        np.ones(n * k, dtype=bool)))
                if edt is DataType.STRING:
                    data = np.empty(n * k, dtype=object)
                else:
                    data = np.zeros(n * k, dtype=edt.to_np())
                validity = np.zeros(n * k, dtype=bool)
                for j, c in enumerate(ev.columns):
                    d = c.data[:n]
                    if edt is not DataType.STRING and c.dtype is not edt:
                        d = d.astype(edt.to_np())
                    data[j::k] = d
                    validity[j::k] = c.validity[:n]
                if edt is DataType.STRING:
                    data = np.where(validity, data, "")
                cols.append(HostColumnVector(edt, data, validity))
                yield HostColumnarBatch(cols, n * k)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))


class TpuGenerateExec(_GenerateBase, TpuExec):
    """Device explode: the element columns evaluated once over the batch,
    then one K18 launch (K7 for STRING child columns)."""

    placement = "tpu"

    def __init__(self, include_pos, elem_exprs, generator_output, child):
        super().__init__(include_pos, elem_exprs, generator_output, child)
        self._projector = DeviceProjector(
            bind_all(self.elem_exprs, child.output))

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        k = len(self.elem_exprs)
        edt = self.generator_output[-1].data_type
        phys = to_torch(edt)

        def factory(pidx: int) -> Iterator[ColumnarBatch]:
            for batch in child_pb.iterator(pidx):
                # the explode copies values: encoded columns decode here
                batch = decode_batch(ensure_compact(batch))
                # host sync: the row count sizes the output (reference
                # :216, batch.host_rows())
                n = batch.host_rows()
                out_rows = n * k
                out_cap = bucket_capacity(max(out_rows, 1))
                ev = self._projector.project(batch, partition_id=pidx)
                elems = [(c.data if c.data.dtype == phys else c.data.to(phys),
                          c.validity) for c in ev.columns]
                fixed = [c for c in batch.columns if c.offsets is None]
                outs, elem, pos, rep = explode_rows(
                    [(c.data, c.validity) for c in fixed], elems, k, n,
                    out_cap, self.include_pos)
                it = iter(outs)
                cols = []
                for c in batch.columns:
                    if c.offsets is not None:
                        cols.append(gather_string_col(c, rep, out_rows))
                    else:
                        d, v = next(it)
                        cols.append(ColumnVector(c.dtype, d, v))
                if self.include_pos:
                    cols.append(ColumnVector(
                        DataType.INT32, pos,
                        torch.arange(out_cap, device=pos.device) < out_rows))
                cols.append(ColumnVector(edt, elem[0], elem[1]))
                yield ColumnarBatch(cols, out_rows)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, factory(p)))
