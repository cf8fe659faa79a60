"""Execution-time fault tolerance: typed retryable errors and the retry
combinators (port of spark_rapids_tpu/engine/retry.py).

The reference's typed errors come from translating backend errors
(memory/device_manager.translate_device_error) and from the fault
injector (utils/faultinject.py); the combinators wrap the engine's device
work at the reference's own sites:

- `with_retry(attempt, site)`: run one closure; on a retryable OOM spill
  the device store to half (DeviceStore.synchronous_spill) and run it
  again; on a transient error back off (exponential, deterministic jitter)
  and run it again. OOM retries exhausted escalate to
  TpuSplitAndRetryOOM.
- `split_and_retry(batch_fn, batch, site)`: on the escalation, bisect the
  input batch and run the halves (the splitSpillableInHalfByRows analog).
- `device_op_with_fallback(...)`: split_and_retry, then, when the device
  path is exhausted or the circuit breaker is open, the batch runs through
  the CPU engine and its result uploads again (cpuFallbackEvents).
- `CircuitBreaker`: after N device failures the remaining batches go to
  the CPU; half-open probes close it again.

When nothing fails, `attempt` runs exactly once: no launch and no host
sync is added (reference :34-36). A CUDA OutOfMemoryError is caught as it
is raised, so the attempt's tensors are still referenced by the
exception's frames: `with_retry` leaves the `except` block, dropping the
exception, before it spills and runs the attempt again.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from typing import Callable, List, Optional, TypeVar

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.utils import metrics as M

T = TypeVar("T")
log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Typed errors (reference :52-87)
# ---------------------------------------------------------------------------
class TpuRetryableError(RuntimeError):
    """Base of every error the execution layer may retry."""


class TpuRetryOOM(TpuRetryableError):
    """Device memory exhausted; spill tracked buffers and run again."""


class TpuSplitAndRetryOOM(TpuRetryOOM):
    """OOM persisted through every spill + retry: bisect the input."""


class TpuTransientDeviceError(TpuRetryableError):
    """A transient device failure: run again after a backoff."""


class TpuDispatchWedged(TpuTransientDeviceError):
    """A dispatch that went silent (the reference's watchdog classifies
    it; the port's injector raises it directly)."""


class TpuDeviceLostError(TpuTransientDeviceError):
    """The device itself is gone: never retried in place."""


class TpuAsyncSinkError(TpuRetryableError):
    """A failure the per-site machinery cannot own in place (the fault
    injector's deferred error surfaced at the sink)."""

    def __init__(self, message: str, origin_site: Optional[str] = None):
        super().__init__(message)
        self.origin_site = origin_site


class FetchFailedError(RuntimeError):
    """A lost shuffle piece (the reference's engine/scheduler.py class; the
    port has no task scheduler yet, so only the injector raises it)."""


# deterministic failure classes: retrying cannot change the outcome
NON_RETRYABLE = (TypeError, ValueError, AssertionError, NotImplementedError,
                 KeyError, IndexError, AttributeError, ZeroDivisionError)


def as_typed_error(e: BaseException) -> Optional[TpuRetryableError]:
    """The typed view of an execution error (reference :110): typed errors
    pass through, device errors translate, cancellations and
    deterministic errors give None."""
    from spark_rapids_tpu_torch.engine.cancel import (
        TpuOverloadedError,
        TpuQueryCancelled,
    )

    if isinstance(e, (TpuQueryCancelled, TpuOverloadedError)):
        return None
    if isinstance(e, TpuRetryableError):
        return e
    if isinstance(e, NON_RETRYABLE):
        return None
    from spark_rapids_tpu_torch.memory.device_manager import TpuDeviceManager

    return TpuDeviceManager.translate_device_error(e)


# ---------------------------------------------------------------------------
# Retry policy (reference :222-261)
# ---------------------------------------------------------------------------
class RetryPolicy:
    __slots__ = ("oom_retries", "transient_retries", "max_split_depth",
                 "backoff_ms", "cpu_fallback")

    def __init__(self, oom_retries: int = 2, transient_retries: int = 3,
                 max_split_depth: int = 3, backoff_ms: float = 5.0,
                 cpu_fallback: bool = True):
        self.oom_retries = oom_retries
        self.transient_retries = transient_retries
        self.max_split_depth = max_split_depth
        self.backoff_ms = backoff_ms
        self.cpu_fallback = cpu_fallback


_POLICY = RetryPolicy()


def set_policy_from_conf(tpu_conf: "C.TpuConf", ctx=None) -> None:
    """The retry policy of the executing session's conf, set at every query
    start and scoped to the query's context when one is given."""
    global _POLICY
    pol = RetryPolicy(
        oom_retries=tpu_conf.get(C.RETRY_OOM_RETRIES),
        transient_retries=tpu_conf.get(C.RETRY_TRANSIENT_RETRIES),
        max_split_depth=tpu_conf.get(C.RETRY_MAX_SPLIT_DEPTH),
        backoff_ms=tpu_conf.get(C.RETRY_BACKOFF_MS),
        cpu_fallback=tpu_conf.get(C.CPU_FALLBACK_ENABLED),
    )
    _POLICY = pol
    if ctx is not None:
        ctx.retry_policy = pol


def policy() -> RetryPolicy:
    ctx = M.current_query_ctx()
    if ctx is not None and ctx.retry_policy is not None:
        return ctx.retry_policy
    return _POLICY


def deterministic_jitter(*identity) -> float:
    """[0, 1) jitter as a pure function of the retry identity."""
    h = zlib.crc32(repr(identity).encode("utf-8")) & 0xFFFFFFFF
    return h / 4294967296.0


def backoff_delay_ms(attempt: int, *identity) -> float:
    """The backoff before retry `attempt` (reference :277-288)."""
    base = policy().backoff_ms
    if base <= 0:
        return 0.0
    return base * (2 ** attempt) * (0.5 + deterministic_jitter(attempt,
                                                               *identity))


def backoff_sleep(attempt: int, *identity) -> None:
    from spark_rapids_tpu_torch.engine.cancel import cancel_aware_sleep

    delay_ms = backoff_delay_ms(attempt, *identity)
    if delay_ms > 0:
        cancel_aware_sleep(delay_ms / 1000.0, site="retry.backoff")


def _spill_for_retry(site: str) -> int:
    """Free device memory before running again: spill the running query's
    session's tracked device buffers down to half the store's footprint
    (reference :291). Returns the bytes spilled."""
    ctx = M.current_query_ctx()
    if ctx is None or ctx.spill is None:
        return 0
    store = ctx.spill.device_store
    return store.synchronous_spill(store.current_size // 2)


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------
def with_retry(attempt: Callable[[], T], site: str = "device") -> T:
    """Run one device closure under the OOM / transient retry state machine
    (reference :308). The injector is consulted inside the loop, so an
    injected fault spends a retry like a real one. The reference registers
    each attempt with its hung-dispatch watchdog (`register` :328,
    `deregister` in its `finally`); the port has no watchdog yet, so those
    two calls are left out."""
    from spark_rapids_tpu_torch.utils import faultinject as FI

    pol = policy()
    oom_left = pol.oom_retries
    transient_left = pol.transient_retries
    attempt_no = 0
    while True:
        try:
            FI.maybe_inject(site)
            return attempt()
        except Exception as e:  # noqa: BLE001 - classification boundary
            typed = as_typed_error(e)
            if typed is None:
                raise
            if isinstance(typed, (TpuAsyncSinkError, TpuDeviceLostError,
                                  TpuSplitAndRetryOOM)):
                # owned elsewhere: the session, or an outer split
                if typed is e:
                    raise
                raise typed from e
            if isinstance(typed, TpuRetryOOM):
                if oom_left <= 0:
                    raise TpuSplitAndRetryOOM(
                        f"{site}: OOM persisted through "
                        f"{pol.oom_retries} spill+retry attempts: {typed}"
                    ) from e
                oom_left -= 1
                spill = True
            else:
                if transient_left <= 0:
                    if typed is e:
                        raise
                    raise typed from e
                transient_left -= 1
                spill = False
            M.record_retry()
            typed = None  # the exception (and its frames) dies here
        # outside the handler: the failed attempt's frames are released
        if spill:
            _spill_for_retry(site)
        else:
            backoff_sleep(attempt_no, site)
        attempt_no += 1


def split_batch_halves(batch):
    """Bisect a device batch by rows (reference :406): compacts a masked
    batch first (K31), then slices each half by a gather (K32)."""
    from spark_rapids_tpu_torch.columnar.batch import (
        ensure_compact,
        slice_batch_host,
    )

    batch = ensure_compact(batch)
    n = batch.host_rows()
    if n <= 1:
        raise TpuSplitAndRetryOOM(f"cannot split a {n}-row batch any further")
    mid = n // 2
    return (slice_batch_host(batch, 0, mid),
            slice_batch_host(batch, mid, n - mid), mid)


def split_and_retry(batch_fn: Callable, batch, site: str = "device",
                    row_offset: int = 0) -> List:
    """Run `batch_fn(batch, row_offset)`; on an escalated OOM bisect the
    batch and run the halves, recursively (reference :425). `row_offset`
    counts the rows before each piece in the original batch. Returns the
    output batches in row order."""

    def run(piece, off: int, depth: int) -> List:
        try:
            return [batch_fn(piece, off)]
        except TpuSplitAndRetryOOM:
            if depth >= policy().max_split_depth:
                raise
        left, right, mid = split_batch_halves(piece)
        M.record_split_retry()
        return run(left, off, depth + 1) + run(right, off + mid, depth + 1)

    return run(batch, row_offset, 0)


def device_op_with_fallback(batch_fn: Callable, batch,
                            cpu_fn: Optional[Callable], site: str,
                            row_offset: int = 0) -> List:
    """Breaker bypass -> split_and_retry -> CPU fallback for a batch-wise
    device operator (reference :452). `batch_fn(device_batch, offset)` is
    the device path, `cpu_fn(host_batch, offset)` the CPU engine's for the
    same unit of work (None: no per-batch fallback). Returns device
    batches."""
    breaker = CircuitBreaker.get()
    if cpu_fn is not None and policy().cpu_fallback and breaker.is_open():
        return [_run_cpu_fallback(cpu_fn, batch, row_offset)]
    try:
        return split_and_retry(batch_fn, batch, site=site,
                               row_offset=row_offset)
    except Exception as e:  # noqa: BLE001 - classification boundary
        typed = as_typed_error(e)
        if typed is None or isinstance(typed, TpuAsyncSinkError):
            raise
        breaker.record_failure()
        if cpu_fn is None or not policy().cpu_fallback:
            raise
        log.warning("%s: device path exhausted retries (%s); running the "
                    "batch on the CPU engine", site, typed)
    return [_run_cpu_fallback(cpu_fn, batch, row_offset)]


def _run_cpu_fallback(cpu_fn: Callable, batch, row_offset: int):
    """The batch through the CPU engine and back (reference :490)."""
    from spark_rapids_tpu_torch.columnar.batch import ensure_compact

    M.record_cpu_fallback()
    host = ensure_compact(batch).to_host()
    return cpu_fn(host, row_offset).to_device(batch.device)


# ---------------------------------------------------------------------------
# Circuit breaker (reference :503)
# ---------------------------------------------------------------------------
def _now_ns() -> int:
    return time.monotonic_ns()


class CircuitBreaker:
    """Counts device failures (retry exhaustions, not single retries); at
    `threshold` it opens and the remaining batches go to the CPU. After
    `cooldown_ms` open it admits `probe_queries` device probes: a probe
    that succeeds closes it, one that fails opens it again. cooldown_ms=0
    keeps it open until the session stops. Each session owns one and
    hands it to its queries; `get()` gives the ambient query's, and work
    run outside a session's query shares one process default."""

    _default: Optional["CircuitBreaker"] = None
    _lock = threading.Lock()

    def __init__(self, enabled: bool = True, threshold: int = 4,
                 cooldown_ms: float = 0.0, probe_queries: int = 1):
        self.enabled = enabled
        self.threshold = max(1, threshold)
        self.cooldown_ms = max(0.0, float(cooldown_ms))
        self.probe_queries = max(1, int(probe_queries))
        self._failures = 0
        self._opened_ns = 0
        self._probes_used = 0
        self._transitions = {"opened": 0, "half_opened": 0, "closed": 0}
        self._cv = threading.Lock()

    def configure(self, tpu_conf: "C.TpuConf") -> "CircuitBreaker":
        """Refresh the knobs from the session conf; the failure count
        survives (the breaker is per session, not per query)."""
        with self._cv:
            self.enabled = tpu_conf.get(C.CIRCUIT_BREAKER_ENABLED)
            self.threshold = max(1, tpu_conf.get(C.CIRCUIT_BREAKER_THRESHOLD))
            self.cooldown_ms = max(
                0.0, tpu_conf.get(C.CIRCUIT_BREAKER_COOLDOWN_MS))
            self.probe_queries = max(
                1, tpu_conf.get(C.CIRCUIT_BREAKER_PROBE_QUERIES))
        return self

    @classmethod
    def get(cls) -> "CircuitBreaker":
        ctx = M.current_query_ctx()
        if ctx is not None and ctx.breaker is not None:
            return ctx.breaker
        with cls._lock:
            if cls._default is None:
                cls._default = cls()
            return cls._default

    @classmethod
    def reset(cls) -> None:
        """Drop the process default breaker."""
        with cls._lock:
            cls._default = None

    def record_failure(self) -> bool:
        """Count one device failure; True when the breaker is now open. A
        failure in the half-open window is a failed probe."""
        with self._cv:
            was_tripped = self.enabled and self._failures >= self.threshold
            probing = was_tripped and self.cooldown_ms > 0 and \
                (_now_ns() - self._opened_ns) >= self.cooldown_ms * 1e6
            self._failures += 1
            now_open = self.enabled and self._failures >= self.threshold
            if now_open and (not was_tripped or probing):
                self._opened_ns = _now_ns()
                self._probes_used = 0
                self._transitions["opened"] += 1
            return now_open

    def note_probe(self) -> None:
        """Charge one half-open probe slot (once per device query)."""
        with self._cv:
            if self._phase() == "half_open":
                if self._probes_used == 0:
                    self._transitions["half_opened"] += 1
                self._probes_used += 1

    def note_success(self) -> None:
        """A device query completed: a tripped breaker with a cooldown
        closes."""
        with self._cv:
            if self.enabled and self.cooldown_ms > 0 and \
                    self._failures >= self.threshold:
                self._failures = 0
                self._opened_ns = 0
                self._probes_used = 0
                self._transitions["closed"] += 1

    def _phase(self) -> str:
        if not (self.enabled and self._failures >= self.threshold):
            return "closed"
        if self.cooldown_ms <= 0:
            return "open"
        if (_now_ns() - self._opened_ns) < self.cooldown_ms * 1e6:
            return "open"
        if self._probes_used < self.probe_queries:
            return "half_open"
        return "open"

    def state(self) -> str:
        with self._cv:
            return self._phase()

    def transitions(self) -> dict:
        with self._cv:
            return dict(self._transitions)

    @property
    def failures(self) -> int:
        with self._cv:
            return self._failures

    def is_open(self) -> bool:
        """Whether device work must go to the CPU now (half-open lets the
        probes through)."""
        with self._cv:
            return self._phase() == "open"
