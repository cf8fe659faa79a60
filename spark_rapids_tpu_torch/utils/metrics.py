"""Query metrics of the memory and failure layer (port of the parts of
spark_rapids_tpu/utils/metrics.py that layer records).

- `QueryContext` (reference :201): one running query's counters and its
  policy handles (circuit breaker, fault injector, retry policy, the
  session's spill framework), made ambient by the session through a
  contextvar (`current_query_ctx`, reference :325).
- The fault-tolerance counters `retries`, `splitRetries` and
  `cpuFallbackEvents` (reference :39-41, `record_retry` :408,
  `record_split_retry` :414, `record_cpu_fallback` :420), and the spill
  counters of memory/spill.py: bytes moved device -> host and host ->
  disk, and the rematerialisations that brought a batch back.
- `trace_range` (reference :860): a host-clock range that adds its
  elapsed nanoseconds to a counter.
- The compressed-execution counters (reference :89-93, :658-670):
  `runCollapsedRows`, the rows the run-aware aggregate collapsed away
  (columnar/runs.py); `orderPreservingSorts`, the window batches ordered
  over rank codes; `fetchRetries`, the serialized shuffle pieces whose
  map partition ran again after a lost fetch (shuffle/exchange.py).

Every increment lands in a process-wide total and in the ambient query's
context; the session exposes the context's snapshot as
`session.last_query_metrics` (reference session.py:113). The reference's
other counters (dispatches, fences, AQE, serving) belong to layers the
port has not taken yet.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, Optional

RETRIES = "retries"
SPLIT_RETRIES = "splitRetries"
CPU_FALLBACK_EVENTS = "cpuFallbackEvents"
SPILL_TO_HOST_BYTES = "spillDeviceToHostBytes"
SPILL_TO_DISK_BYTES = "spillHostToDiskBytes"
UNSPILLS = "spillRematerializations"
RUN_COLLAPSED_ROWS = "runCollapsedRows"
ORDER_PRESERVING_SORTS = "orderPreservingSorts"
FETCH_RETRIES = "fetchRetries"


class QueryContext:
    """One running query's counters and policy handles."""

    __slots__ = ("_lock", "_counters", "breaker", "injector", "fi_scoped",
                 "retry_policy", "spill")

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        # the session's circuit breaker (engine/retry.CircuitBreaker.get)
        self.breaker = None
        # this query's fault injector; fi_scoped makes the slot
        # authoritative even when it holds None
        self.injector = None
        self.fi_scoped = False
        # this query's retry policy (engine/retry.set_policy_from_conf)
        self.retry_policy = None
        # the session's spill framework (memory/spill.py), which an OOM
        # retry spills
        self.spill = None

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


_QUERY_CTX: "contextvars.ContextVar[Optional[QueryContext]]" = \
    contextvars.ContextVar("srt_torch_query_ctx", default=None)


def current_query_ctx() -> Optional[QueryContext]:
    return _QUERY_CTX.get()


def push_query_ctx(ctx: Optional[QueryContext]):
    """Install `ctx` as the ambient query context; returns the token for
    pop_query_ctx."""
    return _QUERY_CTX.set(ctx)


def pop_query_ctx(token) -> None:
    _QUERY_CTX.reset(token)


_TOTALS_LOCK = threading.Lock()
_TOTALS: Dict[str, int] = {}


def _record(name: str, n: int) -> None:
    with _TOTALS_LOCK:
        _TOTALS[name] = _TOTALS.get(name, 0) + n
    ctx = _QUERY_CTX.get()
    if ctx is not None:
        ctx.add(name, n)


def total(name: str) -> int:
    """The process-wide total of a counter."""
    with _TOTALS_LOCK:
        return _TOTALS.get(name, 0)


def record_retry(n: int = 1) -> None:
    """One device re-dispatch (OOM spill + retry, or a transient retry)."""
    _record(RETRIES, n)


def record_split_retry(n: int = 1) -> None:
    """One batch bisection by split-and-retry."""
    _record(SPLIT_RETRIES, n)


def record_cpu_fallback(n: int = 1) -> None:
    """One degradation of a unit of work to the CPU engine."""
    _record(CPU_FALLBACK_EVENTS, n)


def record_spill(to_tier: str, nbytes: int) -> None:
    """Bytes one buffer moved down the spill chain, to "host" or "disk"."""
    _record(SPILL_TO_HOST_BYTES if to_tier == "host"
            else SPILL_TO_DISK_BYTES, int(nbytes))


def record_unspill(n: int = 1) -> None:
    """One spilled buffer brought back to the device."""
    _record(UNSPILLS, n)


def record_run_collapsed_rows(n: int) -> None:
    """Rows one run-collapsed update batch lost (rows minus merged runs)."""
    _record(RUN_COLLAPSED_ROWS, int(n))


def record_order_preserving_sort(n: int = 1) -> None:
    """One batch ordered over rank codes instead of decoded values."""
    _record(ORDER_PRESERVING_SORTS, n)


def record_fetch_retry(n: int = 1) -> None:
    """One lost shuffle piece whose map partition ran again."""
    _record(FETCH_RETRIES, n)


def add_node_metric(metrics: Dict[str, int], name: str, n: int) -> None:
    """Add to an exec node's own metric as well (EXPLAIN's per-node
    counters)."""
    metrics[name] = metrics.get(name, 0) + int(n)


@contextlib.contextmanager
def trace_range(name: str, counter: Optional[str] = None):
    """A host-clock range (reference: trace_range :860, the
    NvtxWithMetrics analog): adds its elapsed nanoseconds to `counter`,
    or to `name` when no counter is given. No device sync."""
    start = time.perf_counter_ns()
    try:
        yield
    finally:
        _record(counter or name, time.perf_counter_ns() - start)
