"""Per-device task admission semaphore (port of
spark_rapids_tpu/memory/semaphore.py; reference: GpuSemaphore.scala).

At most `concurrentTpuTasks` tasks hold device memory at once. A task
acquires where the reference's does, before it first uploads (the host to
device transition and the file scan), re-entrantly, and releases when its
partition ends (`task_scope`, the reference's completion listener,
engine/scheduler.run_serial). The port runs partitions one after another
on the session's thread, so the semaphore never blocks today; it keeps
the reference's accounting. A task takes one permit: the reference's
weighted permits come from its resource analyzer, which the port lacks.
A plan executed outside a task (not through a session's query or write)
takes no permit, so nothing can leak one.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Dict, Optional

from spark_rapids_tpu_torch.utils.metrics import trace_range

_task_local = threading.local()
_task_counter = itertools.count(1)
_task_counter_lock = threading.Lock()


@contextlib.contextmanager
def task_scope():
    """One partition task on this thread (the TaskContext analog;
    reference exec/transitions.py:45): a fresh task id whose permits are
    released when the scope ends. A query run inside a running task stays
    in that task."""
    if getattr(_task_local, "task_id", None) is not None:
        yield _task_local.task_id
        return
    with _task_counter_lock:
        tid = next(_task_counter)
    _task_local.task_id = tid
    try:
        yield tid
    finally:
        _task_local.task_id = None
        TpuSemaphore.get().release_if_necessary(tid)


def acquire_for_task() -> None:
    """Acquire the running task's permits (re-entrant); outside a task,
    nothing."""
    tid = getattr(_task_local, "task_id", None)
    if tid is not None:
        TpuSemaphore.get().acquire_if_necessary(tid)


class TpuSemaphore:
    _instance: Optional["TpuSemaphore"] = None
    _lock = threading.Lock()

    class _TaskState:
        __slots__ = ("count", "permits", "lock")

        def __init__(self):
            self.count = 0
            self.permits = 0
            self.lock = threading.Lock()

    def __init__(self, max_concurrent: int):
        self.max_concurrent = max_concurrent
        self._available = max_concurrent
        self._cv = threading.Condition()
        self._holders: Dict[int, "TpuSemaphore._TaskState"] = {}
        self._holders_lock = threading.Lock()

    @classmethod
    def initialize(cls, max_concurrent: int) -> "TpuSemaphore":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(max_concurrent)
            return cls._instance

    @classmethod
    def get(cls) -> "TpuSemaphore":
        if cls._instance is None:
            return cls.initialize(2)
        return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        with cls._lock:
            cls._instance = None

    def _state(self, task_id: int) -> "TpuSemaphore._TaskState":
        with self._holders_lock:
            st = self._holders.get(task_id)
            if st is None:
                st = self._holders[task_id] = TpuSemaphore._TaskState()
            return st

    def acquire_if_necessary(self, task_id: int) -> None:
        """Reference: GpuSemaphore.acquireIfNecessary (:92)."""
        st = self._state(task_id)
        with st.lock:
            if st.count == 0:
                with trace_range("Acquire TPU Semaphore"):
                    with self._cv:
                        while self._available < 1:
                            self._cv.wait()
                        self._available -= 1
                st.permits = 1
            st.count += 1

    def release_if_necessary(self, task_id: int) -> None:
        """Reference: GpuSemaphore.releaseIfNecessary (:118)."""
        with self._holders_lock:
            st = self._holders.get(task_id)
        if st is None:
            return
        give_back = 0
        with st.lock:
            if st.count > 0:
                st.count = 0
                give_back = st.permits
                st.permits = 0
        if give_back:
            with self._cv:
                self._available += give_back
                self._cv.notify_all()
        with self._holders_lock:
            self._holders.pop(task_id, None)

    def held_by(self, task_id: int) -> bool:
        with self._holders_lock:
            st = self._holders.get(task_id)
        return st is not None and st.count > 0

    @property
    def available(self) -> int:
        with self._cv:
            return self._available
