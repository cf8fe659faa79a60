"""TpuSession: the port's SparkSession analog (port of spark_rapids_tpu/session.py,
cut to createDataFrame, range, file reads and writes, cache, plan, execute
and collect).

Plan pipeline, as in the reference (session.py:378, :423-426): logical
plan -> column pruning (plan/optimizer.py) -> CPU physical plan
(plan/planner.py) -> device rewrite (plan/overrides.py)
-> transitions and coalesces (plan/transition_overrides.py) -> stage fusion
(plan/fusion.py). Execution is the per-operator host-loop executor: each
partition's iterator runs on the calling thread and ends at the
DeviceToHostExec sink (reference: _execute_device :1008, without admission
or the lifted-sink async path). The spmd, placement, adaptive, admission
and plan-cache keys of conf.py are read as off; those layers are later
queue items (ROADMAP.md queue 1).

The memory and failure layer is present (reference :173-185, :315): a
session sizes its device budget (memory/device_manager.py) and owns its
spill framework (memory/spill.py: cached device batches spill device ->
host -> disk) and circuit breaker, and every query or write runs under a
QueryContext (utils/metrics.py) that carries them with the conf's retry
policy and fault injector (engine/retry.py, utils/faultinject.py);
`last_query_metrics` holds its counters. Each session's budget reads the
whole card's allocated bytes, so sessions side by side each spill their
own buffers when the card passes their budget; stopping one touches no
other. The admission semaphore is one per process: the first live
session starts it and the last one's `stop()` shuts it down (reference
:271-272). The reference's query-scoped spill buffers (shuffle pieces,
staged batches; released at :879-896) have no counterpart in the port
yet: its only spillable buffers are the relation cache's.

A session runs on one device: `cuda:0` unless the caller asks for
`device="cpu"`, the only way onto the CPU. Without a CUDA device and
without that argument the session raises instead of carrying on on the
CPU.
"""

from __future__ import annotations

import contextlib
import decimal
import threading
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.batch import (
    HostColumnarBatch,
    HostColumnVector,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.engine import retry as R
from spark_rapids_tpu_torch.engine.retry import CircuitBreaker
from spark_rapids_tpu_torch.exec.base import ExecContext, PhysicalExec
from spark_rapids_tpu_torch.memory.device_manager import TpuDeviceManager
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore, task_scope
from spark_rapids_tpu_torch.memory.spill import SpillFramework
from spark_rapids_tpu_torch.ops.base import AttributeReference
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.dataframe import DataFrame
from spark_rapids_tpu_torch.plan.fusion import fuse_stages
from spark_rapids_tpu_torch.plan.optimizer import optimize
from spark_rapids_tpu_torch.plan.overrides import TpuOverrides
from spark_rapids_tpu_torch.plan.planner import plan_physical
from spark_rapids_tpu_torch.plan.transition_overrides import (
    TpuTransitionOverrides,
)
from spark_rapids_tpu_torch.utils import faultinject as FI
from spark_rapids_tpu_torch.utils import metrics as M


# the sessions not yet stopped: the semaphore lives from the first one's
# start to the last one's stop (reference :173-185, :271-272)
_RUNTIME_LOCK = threading.Lock()
_LIVE_SESSIONS: "weakref.WeakSet[TpuSession]" = weakref.WeakSet()


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run on the CPU explicitly")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class TpuSession:
    # the most recently created live session (reference :97, :198)
    _active: Optional["TpuSession"] = None

    def __init__(self, settings: Optional[Dict[str, Any]] = None,
                 device=None):
        self.conf = C.TpuConf(settings)
        self.device = resolve_device(device)
        # the final physical plan of the most recent query
        self.last_physical_plan: Optional[PhysicalExec] = None
        # the counters of the most recent query (utils/metrics.py)
        self.last_query_metrics: Dict[str, int] = {}
        # executor bring-up (reference :173-185): this session's budget,
        # spill store chain and breaker, sized from its conf
        self.device_manager = TpuDeviceManager(self.conf, self.device)
        self.spill = SpillFramework(
            self.conf, self.device_manager.hbm_budget,
            self.device_manager.bytes_in_use, self.device)
        self.breaker = CircuitBreaker()
        self._stopped = False
        with _RUNTIME_LOCK:
            if not _LIVE_SESSIONS:
                TpuSemaphore.shutdown()
                TpuSemaphore.initialize(self.conf.concurrent_tpu_tasks)
            _LIVE_SESSIONS.add(self)
            TpuSession._active = self

    # -- builder-style API (reference :202-210) -------------------------------
    @staticmethod
    def builder() -> "SessionBuilder":
        return SessionBuilder()

    @classmethod
    def active(cls, device=None) -> "TpuSession":
        """The active session, created on `device` (default cuda:0) when
        there is none."""
        with _RUNTIME_LOCK:
            got = cls._active
        return got if got is not None else TpuSession(device=device)

    def stop(self) -> None:
        """Stop the session (reference :315): disarm the process-wide
        fault-injection slot and, when this is the last live session,
        shut the semaphore down. Other sessions keep their layer, and
        buffers already handed out keep their framework."""
        with _RUNTIME_LOCK:
            if self._stopped:
                return
            self._stopped = True
            _LIVE_SESSIONS.discard(self)
            if TpuSession._active is self:
                TpuSession._active = None
            FI.disable_global()
            if not _LIVE_SESSIONS:
                TpuSemaphore.shutdown()

    def set_conf(self, key: str, value: Any) -> None:
        self.conf.set(key, value)

    # -- data sources ---------------------------------------------------------
    def createDataFrame(self, data, schema=None,
                        num_partitions: int = 1) -> DataFrame:
        """data: list of tuples + schema [(name, type)], or dict of
        name -> list/ndarray/HostColumnVector with schema optional."""
        attrs, batch = _to_host_batch(data, schema)
        return DataFrame(L.LocalRelation(attrs, _split_batch(
            batch, num_partitions)), self)

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: Optional[int] = None) -> DataFrame:
        """Int64 ids in [start, end) by step, in num_partitions (default:
        the shuffle partitions) host partitions (reference:
        session.py:363)."""
        if end is None:
            start, end = 0, start
        n = num_partitions or self.conf.shuffle_partitions
        return DataFrame(L.RangeRelation(start, end, step, n), self)

    @property
    def read(self):
        """Parquet reads (io/reader.py; reference: session.py:371)."""
        from spark_rapids_tpu_torch.io.reader import DataFrameReader

        return DataFrameReader(self)

    # -- plan pipeline --------------------------------------------------------
    def _physical_plan(self, plan: L.LogicalPlan) -> PhysicalExec:
        cpu_plan = plan_physical(optimize(plan, self.conf), self.conf)
        tpu_plan = TpuOverrides.apply(cpu_plan, self.conf)
        final = TpuTransitionOverrides.apply(tpu_plan, self.conf)
        final = fuse_stages(final, self.conf)
        self.last_physical_plan = final
        return final

    def explain_plan(self, plan: L.LogicalPlan, mode: str = "ALL") -> str:
        from spark_rapids_tpu_torch.plan.meta import explain_string

        explain_out: List[str] = []
        cpu_plan = plan_physical(optimize(plan, self.conf), self.conf)
        tpu_plan = TpuOverrides.apply(cpu_plan, self.conf,
                                      explain_out=explain_out)
        final = fuse_stages(TpuTransitionOverrides.apply(tpu_plan, self.conf),
                            self.conf)
        parts = []
        if explain_out:
            parts.append("== Device tagging ==\n" + explain_out[0])
        parts.append("== Final plan ==\n" + explain_string(final))
        return "\n".join(parts)

    # -- actions --------------------------------------------------------------
    @contextlib.contextmanager
    def query_scope(self):
        """The QueryContext a query or a write runs under: this conf's
        retry policy and fault injector, the session's breaker and spill
        framework; `last_query_metrics` takes its counters."""
        qctx = M.QueryContext()
        qctx.breaker = self.breaker.configure(self.conf)
        qctx.spill = self.spill
        FI.configure(self.conf, qctx)
        R.set_policy_from_conf(self.conf, qctx)
        token = M.push_query_ctx(qctx)
        try:
            qctx.breaker.note_probe()
            yield qctx
            qctx.breaker.note_success()
        finally:
            M.pop_query_ctx(token)
            self.last_query_metrics = qctx.snapshot()

    def exec_context(self) -> ExecContext:
        return ExecContext(self.conf, self.device, self.spill)

    def execute_partitions(self, plan: L.LogicalPlan
                           ) -> List[List[HostColumnarBatch]]:
        """Run a query under its QueryContext; each partition is one task,
        whose semaphore permits are released when it ends (reference:
        engine/scheduler.run_serial)."""
        with self.query_scope():
            physical = self._physical_plan(plan)
            pb = physical.execute(self.exec_context())
            out = []
            for p in range(pb.num_partitions):
                with task_scope():
                    out.append(list(pb.iterator(p)))
            return out

    def execute_batches(self, plan: L.LogicalPlan) -> List[HostColumnarBatch]:
        return [b for part in self.execute_partitions(plan) for b in part]

    def execute_write(self, plan: L.WriteFile) -> None:
        """Reference: session.py:1321."""
        from spark_rapids_tpu_torch.io.writer import execute_write

        execute_write(self, plan)

    def execute_collect(self, plan: L.LogicalPlan) -> List[tuple]:
        rows: List[tuple] = []
        for b in self.execute_batches(plan):
            rows.extend(b.to_pylist_rows())
        return rows


# ---------------------------------------------------------------------------
# createDataFrame input coercion
# ---------------------------------------------------------------------------
def _to_host_batch(data, schema):
    if isinstance(data, dict):
        return _dict_to_batch(data, schema)
    if isinstance(data, list):
        if schema is None:
            raise ValueError("schema required for list-of-rows input")
        names_types = _normalize_schema(schema)
        cols = {name: [row[i] for row in data]
                for i, (name, _) in enumerate(names_types)}
        attrs = [AttributeReference(n, t, True) for n, t in names_types]
        vecs = [HostColumnVector.from_pylist(cols[n], t)
                for n, t in names_types]
        return attrs, HostColumnarBatch(vecs, len(data))
    raise TypeError(f"cannot create DataFrame from {type(data)}")


def _normalize_schema(schema):
    out = []
    for item in schema:
        if isinstance(item, tuple):
            name, t = item
            if isinstance(t, str):
                t = DataType.parse(t)
            out.append((name, t))
        elif isinstance(item, AttributeReference):
            out.append((item.name, item.data_type))
        else:
            raise TypeError(f"bad schema element {item!r}")
    return out


def _dict_to_batch(cols: Dict[str, Any], schema):
    names_types = _normalize_schema(schema) if schema else None
    attrs, vecs = [], []
    for i, (name, values) in enumerate(cols.items()):
        want = names_types[i][1] if names_types else None
        if isinstance(values, HostColumnVector):
            vec = values
        elif isinstance(values, np.ndarray):
            vec = HostColumnVector.from_numpy(values, dtype=want)
        else:
            vec = HostColumnVector.from_pylist(list(values),
                                               want or _infer_type(values))
        attrs.append(AttributeReference(name, vec.dtype, True))
        vecs.append(vec)
    return attrs, HostColumnarBatch(vecs)


def _infer_type(values) -> DataType:
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return DataType.BOOL
        if isinstance(v, int):
            return DataType.INT64
        if isinstance(v, float):
            return DataType.FLOAT64
        if isinstance(v, str):
            return DataType.STRING
        if isinstance(v, decimal.Decimal):
            return _infer_decimal_type(values)
        raise TypeError(f"cannot infer SQL type for {v!r}")
    return DataType.STRING


def _infer_decimal_type(values):
    """The narrowest DECIMAL that holds every Decimal of a column: the
    widest integral part plus the widest scale (reference:
    session.py:1413-1435); beyond 18 digits it raises, never clamps."""
    from spark_rapids_tpu_torch.columnar.dtypes import DecimalType
    from spark_rapids_tpu_torch.ops.decimal_util import infer_decimal_type

    p = s = 0
    for w in values:
        if w is None:
            continue
        t = infer_decimal_type(w)
        s = max(s, t.scale)
        p = max(p, t.precision - t.scale)
    if p + s > DecimalType.MAX_PRECISION:
        raise ValueError(
            f"decimal column needs precision {p + s} "
            f"(> {DecimalType.MAX_PRECISION}, the 64-bit cap); "
            "pass an explicit narrower schema or use double")
    return DecimalType(p + s, s)


def _split_batch(batch: HostColumnarBatch,
                 n: int) -> List[List[HostColumnarBatch]]:
    n = max(1, n)
    total = batch.num_rows
    per = -(-total // n) if total else 0
    parts: List[List[HostColumnarBatch]] = []
    for i in range(n):
        lo, hi = i * per, min(total, (i + 1) * per)
        parts.append([batch.slice(lo, hi - lo)] if hi > lo else [])
    return parts


class SessionBuilder:
    """`TpuSession.builder().config(k, v).getOrCreate()` (reference
    :1327-1342): the active session with the settings applied, or a new
    one with them (on `device`, default cuda:0)."""

    def __init__(self):
        self._settings: Dict[str, Any] = {}

    def config(self, key: str, value: Any) -> "SessionBuilder":
        self._settings[key] = value
        return self

    def getOrCreate(self, device=None) -> TpuSession:
        with _RUNTIME_LOCK:
            existing = TpuSession._active
        if existing is not None:
            for k, v in self._settings.items():
                existing.conf.set(k, v)
            return existing
        return TpuSession(dict(self._settings), device=device)
