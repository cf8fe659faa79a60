"""Run-aware aggregate updates over Parquet RLE runs (port of
spark_rapids_tpu/columnar/runs.py).

A Parquet dictionary chunk whose index stream is pure RLE (a sorted or
low-cardinality column, as Spark's and Arrow's writers emit it) and has no
NULL leaves the scan with a host `RunTable` on its column
(io/parquet_device.py): the first row and the value (the code, for an
encoded column) of each run. When every column an aggregate update's keys,
inputs and folded filters read carries one, `collapse_update` turns the
update batch into ONE ROW PER MERGED RUN (the union of those columns' run
boundaries, inside which every read column is constant) plus a
`__run_len` column, and the update runs over it with its inputs rewritten:

    sum(e)   ->  sum(e * __run_len)      integral sums only: a modular
                                         multiply is modular repeated
                                         addition
    count(e) ->  sum(IF(e IS NOT NULL, __run_len, 0))
    min / max / first / last, the keys and the filters: unchanged (each
    is constant within a run)

The rewritten inputs compile into the update's K48 program like any
other, and K1-K3 group and reduce the run rows: no kernel of its own. A
float sum rounds differently from n additions and a percentile is not a
multiset expansion, so neither collapses; nor does a batch whose merged
runs are more than rapids.tpu.sql.runAware.maxRunFraction of its rows.
Any failed condition gives None and the update stays in row space. The
rows collapsed away are the `runCollapsedRows` metric.

A run table is host metadata only. A column rebuilt by any operator
(`with_data`, a gather, a compaction, a K48 output, a cast) is a new
ColumnVector whose `runs` is None, so a reordered, filtered or sliced
column can never keep a stale table: only the scan, a plain concat and
the encoded alignment set it (columnar/batch.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    HostColumnarBatch,
    HostColumnVector,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType

RUN_LEN_NAME = "__run_len"

# the update ops a run rewrite serves; any other keeps the row form
_RUN_OK_OPS = frozenset({"sum", "count", "min", "max", "any", "first",
                         "last", "first_ignore_nulls",
                         "last_ignore_nulls"})


class RunTable:
    """The host run table of one scan column: `starts[i]` is the first row
    of run i (strictly ascending, starts[0] == 0) and `values[i]` its value
    (raw values of a plain column, int32 codes of an encoded one). It
    covers rows [0, num_rows) and holds no NULL (the scan attaches one to
    all-present chunks only)."""

    __slots__ = ("starts", "values", "num_rows")

    def __init__(self, starts: np.ndarray, values: np.ndarray,
                 num_rows: int):
        self.starts = np.asarray(starts, dtype=np.int64)
        self.values = values
        self.num_rows = int(num_rows)

    @property
    def num_runs(self) -> int:
        return int(len(self.starts))

    def __repr__(self):
        return f"RunTable(runs={self.num_runs}, rows={self.num_rows})"


def runs_ok(n_runs: int, rows: int, max_fraction: float) -> bool:
    """The collapse pays only when runs are a small share of the rows."""
    if rows <= 0 or n_runs <= 0:
        return False
    return (n_runs / rows) <= max_fraction


def _intlike(dt: DataType) -> bool:
    try:
        return np.dtype(dt.to_np()).kind in "iu"
    except Exception:
        return False


def _ref_ordinals(exprs) -> set:
    from spark_rapids_tpu_torch.ops.base import BoundReference

    out = set()
    for e in exprs:
        out |= {r.ordinal for r in e.collect(
            lambda x: isinstance(x, BoundReference))}
    return out


def run_form(inputs: Sequence, op_names: Sequence[str], n_cols: int
             ) -> Tuple[list, tuple]:
    """The update's inputs and ops over a run batch of `n_cols` columns
    whose last is `__run_len`."""
    from spark_rapids_tpu_torch.ops.arithmetic import Multiply
    from spark_rapids_tpu_torch.ops.base import BoundReference
    from spark_rapids_tpu_torch.ops.cast import Cast
    from spark_rapids_tpu_torch.ops.conditional import If
    from spark_rapids_tpu_torch.ops.literals import Literal
    from spark_rapids_tpu_torch.ops.nulls import IsNotNull

    run_len = BoundReference(n_cols - 1, DataType.INT64, False)
    exprs: List = []
    ops: List[str] = []
    for op, e in zip(op_names, inputs):
        if op == "sum":
            rhs = run_len if e.data_type is DataType.INT64 \
                else Cast(run_len, e.data_type)
            exprs.append(Multiply(e, rhs))
            ops.append("sum")
        elif op == "count":
            exprs.append(If(IsNotNull(e), run_len,
                            Literal(0, DataType.INT64)))
            ops.append("sum")
        else:
            exprs.append(e)
            ops.append(op)
    return exprs, tuple(ops)


def run_form_ok(inputs: Sequence, op_names: Sequence[str]) -> bool:
    """Whether an update's ops and input types admit the run form at all
    (the per-batch conditions are collapse_update's)."""
    if any(op not in _RUN_OK_OPS for op in op_names):
        return False
    return all(_intlike(e.data_type) for op, e in zip(op_names, inputs)
               if op == "sum")


def collapse_update(batch: ColumnarBatch, keys, inputs, filters,
                    max_fraction: float) -> Optional[Tuple[ColumnarBatch,
                                                           int]]:
    """(run batch, rows collapsed away) of one compact update batch over
    bound keys, inputs and filters, or None when any condition fails (the
    caller keeps the row form). The run batch holds one row per merged run:
    each read column's run value, unread columns as NULL placeholders, and
    `__run_len` last; it is uploaded to the batch's own device."""
    from spark_rapids_tpu_torch.columnar import encoded as E

    if batch.live is not None or not batch.rows_on_host:
        return None
    rows = batch.num_rows
    if rows <= 0:
        return None
    referenced = _ref_ordinals(list(keys) + list(inputs) + list(filters))
    tabs: Dict[int, RunTable] = {}
    for o in referenced:
        if o >= len(batch.columns):
            return None
        rt = batch.columns[o].runs
        if rt is None or rt.num_rows != rows:
            return None
        tabs[o] = rt
    bounds = np.unique(np.concatenate([rt.starts for rt in tabs.values()])) \
        if tabs else np.zeros(1, dtype=np.int64)
    n_runs = int(len(bounds))
    if not runs_ok(n_runs, rows, max_fraction):
        return None
    lengths = np.diff(np.append(bounds, np.int64(rows)))
    cols: List[HostColumnVector] = []
    for o, cv in enumerate(batch.columns):
        dt = cv.dtype
        if o in tabs:
            rt = tabs[o]
            vals = np.asarray(rt.values)[
                np.searchsorted(rt.starts, bounds, side="right") - 1]
            valid = np.ones(n_runs, dtype=bool)
            if E.is_encoded(cv):
                cols.append(E.HostDictionaryColumn(
                    dt, vals.astype(np.int32), valid, cv.dictionary))
            elif dt is DataType.STRING:
                cols.append(HostColumnVector(dt, vals.astype(object), valid))
            else:
                cols.append(HostColumnVector(dt, vals.astype(dt.to_np()),
                                             valid))
        elif dt is DataType.STRING:
            # unread: a NULL placeholder, never evaluated
            cols.append(HostColumnVector(dt, np.full(n_runs, "",
                                                     dtype=object),
                                         np.zeros(n_runs, dtype=bool)))
        else:
            cols.append(HostColumnVector(dt, np.zeros(n_runs,
                                                      dtype=dt.to_np()),
                                         np.zeros(n_runs, dtype=bool)))
    cols.append(HostColumnVector(DataType.INT64, lengths.astype(np.int64),
                                 np.ones(n_runs, dtype=bool)))
    return HostColumnarBatch(cols, n_runs).to_device(batch.device), \
        rows - n_runs
