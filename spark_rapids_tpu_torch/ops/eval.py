"""Projection/filter evaluation entry points (port of spark_rapids_tpu/ops/eval.py).

Device path: a projection list or a filter condition runs as one K48
stage program a batch (ops/program.py, csrc/stage_program.cu; the
reference traces it into one jitted XLA program, B6). Outputs the program
does not take (a computed STRING, a nondeterministic node) evaluate
eagerly as before; a bare column passes through untouched. CPU path: the
same trees evaluate with numpy — the independent oracle engine.

Encoded columns (columnar/encoded.py): `col_to_colv` refuses a
DictionaryColumn, so no value kernel ever reads codes as values (the
reference's guard, eval.py:51-60). The projector passes a bare encoded
reference through, rewrites predicates it can compute on codes and
materializes the columns of the rest; the filter plans its condition the
same way (reference :130, :202-256, :282, :326). The rewritten code
predicates are integer comparisons, which the program takes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    HostColumnarBatch,
    HostColumnVector,
    compact_batch,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch
from spark_rapids_tpu_torch.ops.base import Expression
from spark_rapids_tpu_torch.ops.values import (
    ColV,
    EvalContext,
    ScalarV,
    broadcast_scalar,
)


def col_to_colv(cv: ColumnVector) -> ColV:
    if getattr(cv, "dictionary", None) is not None:
        raise TypeError(
            f"{cv!r} reached a value kernel without materialize(): an "
            "operator that needs the values of an encoded column decodes "
            "it at its boundary (columnar/encoded.py)")
    return ColV(cv.dtype, cv.data, cv.validity, cv.offsets, cv.max_len)


def colv_to_col(cv: ColV) -> ColumnVector:
    """Restore the storage dtype at the batch boundary."""
    if cv.offsets is not None:
        return ColumnVector(cv.dtype, cv.data, cv.validity, cv.offsets,
                            cv.max_len)
    data = cv.data
    want = to_torch(cv.dtype)
    if data.dtype != want:
        data = data.to(want)
    return ColumnVector(cv.dtype, data, cv.validity)


def scalar_to_colv(ctx: EvalContext, s: ScalarV, want: DataType) -> ColV:
    if s.dtype is DataType.NULL or s.is_null:
        s = ScalarV(want, None)
    if want is DataType.STRING:
        return _string_scalar_col(ctx, s)
    col = broadcast_scalar(ctx, ScalarV(want, s.value))
    return ColV(want, col.data, col.validity)


def _string_scalar_col(ctx: EvalContext, s: ScalarV) -> ColV:
    """A STRING scalar as a column of the batch's rows (reference:
    eval.py:_scalar_to_colv :87): kernel K7 gathers the one-row source at
    index 0 into every live lane."""
    from spark_rapids_tpu_torch.columnar.batch import (
        bucket_capacity,
        gather_strings,
    )
    from spark_rapids_tpu_torch.columnar.strings import (
        _literal_bytes,
        as_view,
        len_bucket,
        plan_byte_cap,
    )

    view = as_view(ctx, s)
    n = len(_literal_bytes(s))
    dev = ctx.device
    offsets = torch.tensor([0, n], dtype=torch.int32, device=dev)
    idx = torch.zeros(ctx.capacity, dtype=torch.int32, device=dev)
    offs, data, valid = gather_strings(
        offsets, view.data, view.validity[:1].contiguous(), idx,
        ctx.capacity, ctx.row_mask(), bucket_capacity(plan_byte_cap(ctx, s)))
    return ColV(DataType.STRING, data, valid, offs, len_bucket(n))


def device_eval_context(batch: ColumnarBatch, partition_id: int = 0,
                        row_start: int = 0) -> EvalContext:
    cols = [col_to_colv(c) for c in batch.columns]
    return EvalContext(True, cols, batch.num_rows, batch.capacity,
                       partition_id=partition_id, row_start=row_start,
                       device=batch.device)


def eval_as_col(ctx: EvalContext, e: Expression) -> ColV:
    r = e.eval(ctx)
    if isinstance(r, ScalarV):
        r = scalar_to_colv(ctx, r, e.data_type)
    return r


class StageCache:
    """An operator's code-space plan and K48 StagePlan, one pair per set
    of batch dictionaries (bounded; dictionaries are interned).
    `code_plan(batch)` plans an encoded batch (columnar/encoded.py);
    `stage(plan)` builds the StagePlan of the planned expressions, or of
    the operator's own when `plan` is None (nothing encoded)."""

    _MAX = 64

    def __init__(self, code_plan, stage):
        self._code_plan = code_plan
        self._stage = stage
        self._got: dict = {}

    def get(self, batch: ColumnarBatch):
        from spark_rapids_tpu_torch.columnar.encoded import enc_sig

        sig = enc_sig(batch)
        got = self._got.get(sig)
        if got is None:
            if len(self._got) >= self._MAX:
                self._got.clear()
            plan = self._code_plan(batch) if sig else None
            got = self._got[sig] = (plan, self._stage(plan))
        return got


def stage_context(plan, batch: ColumnarBatch, partition_id: int = 0,
                  row_start: int = 0):
    """(prepared batch, eval context) of a batch under its code plan (the
    batch itself when `plan` is None)."""
    if plan is None:
        return batch, device_eval_context(batch, partition_id, row_start)
    from spark_rapids_tpu_torch.columnar.encoded import eval_columns

    batch = plan.prepare(batch)
    return batch, EvalContext(True, eval_columns(batch, plan.code_ords),
                              batch.num_rows, batch.capacity,
                              partition_id=partition_id,
                              row_start=row_start, device=batch.device)


class DeviceProjector:
    """Evaluates a fixed list of bound expressions over device batches
    (reference: GpuProjectExec's bound-expression evaluation) as one K48
    launch a batch. A bare reference to an encoded column passes it
    through encoded."""

    def __init__(self, exprs: Sequence[Expression]):
        from spark_rapids_tpu_torch.columnar import encoded as E
        from spark_rapids_tpu_torch.ops.program import StagePlan

        self.exprs = list(exprs)
        self._stages = StageCache(
            lambda b: E.plan_exprs(self.exprs, b, keep_bare=True),
            lambda p: StagePlan(p.exprs if p is not None else self.exprs))

    def project(self, batch: ColumnarBatch, partition_id: int = 0,
                row_start: int = 0) -> ColumnarBatch:
        plan, stage = self._stages.get(batch)
        batch, ctx = stage_context(plan, batch, partition_id, row_start)
        return stage.run_batch(batch, ctx)[0]


class DeviceFilter:
    """Evaluates the condition on the card as a K48 program whose keep
    mask K31 compacts (reference: GpuFilterExec + cudf Table.filter);
    over encoded columns the condition runs in code space where it can."""

    def __init__(self, condition: Expression):
        from spark_rapids_tpu_torch.columnar import encoded as E
        from spark_rapids_tpu_torch.ops.program import StagePlan

        self.condition = condition
        self._stages = StageCache(
            lambda b: E.plan_exprs([condition], b, keep_bare=False),
            lambda p: StagePlan([], p.exprs if p is not None
                                else [condition]))

    def apply(self, batch: ColumnarBatch, partition_id: int = 0,
              row_start: int = 0, sync: bool = True) -> ColumnarBatch:
        plan, stage = self._stages.get(batch)
        batch, ctx = stage_context(plan, batch, partition_id, row_start)
        _, keep = stage.run(ctx)
        return compact_batch(batch, keep, sync)


# ---------------------------------------------------------------------------
# CPU oracle path
# ---------------------------------------------------------------------------
def host_to_colv(hc: HostColumnVector) -> ColV:
    return ColV(hc.dtype, hc.data, hc.validity)


def _colv_to_host(cv: ColV, dtype: DataType) -> HostColumnVector:
    data = cv.data
    if dtype is DataType.STRING:
        if data.dtype != object:
            data = data.astype(object)
        data = np.where(cv.validity, data, "")
        return HostColumnVector(dtype, data,
                                np.asarray(cv.validity, dtype=bool))
    npdt = dtype.to_np()
    if data.dtype != npdt:
        data = data.astype(npdt)
    data = np.where(cv.validity, data, npdt.type(0))
    return HostColumnVector(dtype, data, np.asarray(cv.validity, dtype=bool))


def cpu_eval_context(batch: HostColumnarBatch, partition_id: int = 0,
                     row_start: int = 0) -> EvalContext:
    cols = [host_to_colv(c) for c in batch.columns]
    n = batch.num_rows
    return EvalContext(False, cols, n, n, partition_id=partition_id,
                       row_start=row_start)


def cpu_project(exprs: Sequence[Expression], batch: HostColumnarBatch,
                partition_id: int = 0, row_start: int = 0) -> HostColumnarBatch:
    ctx = cpu_eval_context(batch, partition_id, row_start)
    outs = []
    for e in exprs:
        r = e.eval(ctx)
        if isinstance(r, ScalarV):
            if e.data_type is DataType.STRING or r.dtype is DataType.STRING:
                data = np.full((ctx.capacity,),
                               r.value if not r.is_null else "", dtype=object)
                validity = np.full((ctx.capacity,), not r.is_null, dtype=bool)
                outs.append(HostColumnVector(DataType.STRING, data, validity))
                continue
            r = broadcast_scalar(ctx, ScalarV(e.data_type, r.value))
        outs.append(_colv_to_host(r, e.data_type))
    return HostColumnarBatch(outs, batch.num_rows)


def cpu_filter(condition: Expression, batch: HostColumnarBatch,
               partition_id: int = 0, row_start: int = 0) -> HostColumnarBatch:
    ctx = cpu_eval_context(batch, partition_id, row_start)
    r = condition.eval(ctx)
    if isinstance(r, ScalarV):
        keep = np.full((batch.num_rows,), (not r.is_null) and bool(r.value))
    else:
        keep = np.asarray(r.data, dtype=bool) & r.validity
    cols = [HostColumnVector(c.dtype, c.data[keep], c.validity[keep])
            for c in batch.columns]
    return HostColumnarBatch(cols, int(keep.sum()))
