"""What the retry layer needs of cancellation (port of the parts of
spark_rapids_tpu/engine/cancel.py that engine/retry.py calls).

A cancellation or a shed query is terminal: no retry, no split, no CPU
fallback absorbs it (`is_cancellation`, reference :268). Backoff sleeps
go through `cancel_aware_sleep` (reference :236). The port has no cancel
tokens, deadlines, admission queue or watchdog yet (ROADMAP.md queue 1),
so the sleep is a plain bounded wait and nothing fires the two errors but
the fault injector's `cancel` kind.
"""

from __future__ import annotations

import threading
from typing import Optional

_SLEEP = threading.Event()  # never set: a bounded, interruptible wait


class TpuQueryCancelled(RuntimeError):
    """The query was cancelled; terminal by contract (reference :61)."""

    def __init__(self, message: str, reason: str = "cancelled",
                 site: str = ""):
        super().__init__(message)
        self.reason = reason
        self.site = site


class TpuOverloadedError(RuntimeError):
    """The query was shed before it ran (reference :86)."""


def is_cancellation(e: BaseException) -> bool:
    """Whether a failure, or anything on its cause chain, is a
    cancellation or a shed (reference :268)."""
    seen = set()
    node: Optional[BaseException] = e
    while node is not None and id(node) not in seen:
        if isinstance(node, (TpuQueryCancelled, TpuOverloadedError)):
            return True
        seen.add(id(node))
        node = node.__cause__ or node.__context__
    return False


def cancel_aware_sleep(seconds: float, site: str = "backoff") -> None:
    """Sleep `seconds` (reference :236; with no cancel token in the port,
    a plain bounded wait). `site` names the wait, as in the reference."""
    if seconds > 0:
        _SLEEP.wait(seconds)
