"""Deterministic, conf-gated fault injection (port of
spark_rapids_tpu/utils/faultinject.py, whole).

Registered execution sites call `maybe_inject(site)` just before their
real work; when the harness is armed for that site, a seeded PRF decides
per invocation whether to raise the site's fault kind instead. The
decision is a pure function of (seed, site, invocation): the same zlib
CRC32 as the reference (`FaultInjector.decide` :110), so both packages
inject at the same invocations under the same conf, and every retry
re-rolls with a fresh invocation count, so rates below 1 terminate.

Conf: rapids.tpu.test.faultInjection.{enabled,seed,sites,rate,delayMs,
deferToSink}; `maybe_inject` is one None check when the harness is off.

Fault kinds: oom -> TpuRetryOOM; dispatch and transfer ->
TpuTransientDeviceError; fetch -> FetchFailedError; cancel ->
TpuQueryCancelled; delay -> a cancel-aware sleep, then the site proceeds;
wedge -> TpuDispatchWedged; device_loss -> TpuDeviceLostError. The port
has no hung-dispatch watchdog and no issue-ahead executor yet (ROADMAP.md
queue 1): a wedge raises at once instead of blocking until a watchdog
classifies it, and deferToSink never defers (dispatch is synchronous).
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.utils import metrics as _M

# every registered site -> its default fault kind (reference :49)
SITES: Dict[str, str] = {
    "scan": "oom",
    "project": "oom",
    "filter": "oom",
    "fused": "oom",
    "agg.update": "oom",
    "agg.merge": "oom",
    "agg.finalize": "oom",
    "join": "oom",
    "sort": "oom",
    "spmd.stage": "oom",
    "encoded.materialize": "oom",
    "aqe.replan": "dispatch",
    "transfer.upload": "transfer",
    "transfer.download": "transfer",
    "shuffle.fetch": "fetch",
    # excluded from '*': a cancelled query returns no rows to compare
    "cancel.race": "cancel",
}

KINDS = ("oom", "dispatch", "transfer", "fetch", "cancel",
         "delay", "wedge", "device_loss")

SINK_SITES = ("transfer.download",)


class FaultInjector:
    """Armed sites and the seeded decision function (reference :89)."""

    def __init__(self, seed: int, sites_spec: str, rate: float,
                 defer_to_sink: bool = False, delay_ms: float = 400.0):
        self.seed = int(seed)
        self.rate = float(rate)
        self.defer_to_sink = bool(defer_to_sink)
        self.delay_ms = max(0.0, float(delay_ms))
        self.armed: Dict[str, str] = _parse_sites(sites_spec)
        self._lock = threading.Lock()
        self._invocations: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self._deferred: List[Tuple[str, str]] = []

    def decide(self, site: str, invocation: int) -> bool:
        """Pure (seed, site, invocation) -> inject? (reference :110)."""
        h = zlib.crc32(f"{self.seed}:{site}:{invocation}".encode("utf-8"))
        return (h & 0xFFFFFFFF) / 4294967296.0 < self.rate

    def check(self, site: str) -> Optional[str]:
        """Count the invocation; the fault kind to raise, or None."""
        kind = self.armed.get(site)
        if kind is None:
            return None
        with self._lock:
            n = self._invocations.get(site, 0)
            self._invocations[site] = n + 1
        if not self.decide(site, n):
            return None
        with self._lock:
            self._injected[site] = self._injected.get(site, 0) + 1
        return kind

    def injected_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._injected)

    def invocation_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._invocations)

    def defer(self, site: str, kind: str) -> None:
        with self._lock:
            self._deferred.append((site, kind))

    def pop_deferred(self) -> Optional[Tuple[str, str]]:
        with self._lock:
            return self._deferred.pop(0) if self._deferred else None

    def deferred_pending(self) -> int:
        with self._lock:
            return len(self._deferred)

    def clear_deferred(self) -> None:
        with self._lock:
            self._deferred.clear()


def one_loss_seed(site: str, n: int, rate: float) -> int:
    """The first seed at `rate` under which `site` injects exactly once in
    its first n + 2 invocations, and within the first n: a run of n
    invocations loses one, and the two after them (those that run again
    after the loss) lose none."""
    for seed in range(100_000):
        inj = FaultInjector(seed, site, rate)
        rolls = [inj.decide(site, i) for i in range(n + 2)]
        if sum(rolls) == 1 and rolls.index(True) < n:
            return seed
    raise ValueError(f"no seed in 100000 loses exactly one of {n} "
                     f"{site} invocations at rate {rate}")


def _parse_sites(spec: str) -> Dict[str, str]:
    """'*' or 'name[,name:kind,...]' -> {site: kind}; unknown sites are
    accepted, unknown kinds raise (reference :156)."""
    armed: Dict[str, str] = {}
    spec = (spec or "").strip()
    if not spec:
        return armed
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if entry == "*":
            armed.update({k: v for k, v in SITES.items() if v != "cancel"})
            continue
        if ":" in entry:
            name, kind = entry.split(":", 1)
            name, kind = name.strip(), kind.strip()
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} for site {name!r} "
                    f"(must be one of {'|'.join(KINDS)})")
        else:
            name = entry
            kind = SITES.get(name, "oom")
        armed[name] = kind
    return armed


_ACTIVE: Optional[FaultInjector] = None


def configure(tpu_conf: "C.TpuConf", ctx=None) -> Optional[FaultInjector]:
    """Arm (or disarm) the harness from a session conf at query start; with
    a QueryContext the injector is scoped to that query (reference :187)."""
    global _ACTIVE
    if not tpu_conf.get(C.FAULT_INJECTION_ENABLED):
        _ACTIVE = None
        if ctx is not None:
            ctx.injector = None
            ctx.fi_scoped = True
        return None
    inj = FaultInjector(
        seed=tpu_conf.get(C.FAULT_INJECTION_SEED),
        sites_spec=tpu_conf.get(C.FAULT_INJECTION_SITES),
        rate=tpu_conf.get(C.FAULT_INJECTION_RATE),
        defer_to_sink=tpu_conf.get(C.FAULT_INJECTION_DEFER_TO_SINK),
        delay_ms=tpu_conf.get(C.FAULT_INJECTION_DELAY_MS),
    )
    _ACTIVE = inj
    if ctx is not None:
        ctx.injector = inj
        ctx.fi_scoped = True
    return inj


def disable() -> None:
    """Disarm injection for the current scope (the CPU fallback's run)."""
    ctx = _M.current_query_ctx()
    if ctx is not None and ctx.fi_scoped:
        ctx.injector = None
        return
    global _ACTIVE
    _ACTIVE = None


def disable_global() -> None:
    """Clear the process-wide slot (session teardown)."""
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    """The injector governing the caller: the ambient query's, else the
    process-wide slot."""
    ctx = _M.current_query_ctx()
    if ctx is not None and ctx.fi_scoped:
        return ctx.injector
    return _ACTIVE


def clear_deferred() -> None:
    inj = active()
    if inj is not None:
        inj.clear_deferred()


def raise_deferred_at_sink(site: str = "transfer.download") -> None:
    """Surface the oldest deferred fault as a TpuAsyncSinkError, or
    return (reference :241)."""
    inj = active()
    if inj is None:
        return
    pending = inj.pop_deferred()
    if pending is not None:
        origin, kind = pending
        from spark_rapids_tpu_torch.engine.retry import TpuAsyncSinkError

        raise TpuAsyncSinkError(
            f"[injected] async device error surfaced at {site} "
            f"(origin: {kind} at {origin})", origin_site=origin)


def maybe_inject(site: str) -> None:
    """Raise the armed fault for `site`, or return (reference :275)."""
    inj = active()
    if inj is None:
        return
    if site in SINK_SITES:
        raise_deferred_at_sink(site)
    kind = inj.check(site)
    if kind is None:
        return
    from spark_rapids_tpu_torch.engine import retry as R

    if kind == "cancel":
        from spark_rapids_tpu_torch.engine.cancel import TpuQueryCancelled

        raise TpuQueryCancelled(
            f"[injected] query cancelled racing {site}",
            reason=f"injected at {site}", site=site)
    if kind == "delay":
        from spark_rapids_tpu_torch.engine.cancel import cancel_aware_sleep

        cancel_aware_sleep(inj.delay_ms / 1000.0, site=site)
        return
    if kind == "wedge":
        raise R.TpuDispatchWedged(
            f"[injected] dispatch at {site} went silent (wedged)")
    if kind == "device_loss":
        raise R.TpuDeviceLostError(
            f"[injected] UNAVAILABLE: device lost at {site} "
            f"(backend restart / ICI peer loss)")
    if kind == "oom":
        raise R.TpuRetryOOM(
            f"[injected] RESOURCE_EXHAUSTED: out of memory at {site}")
    if kind == "dispatch":
        raise R.TpuTransientDeviceError(
            f"[injected] ABORTED: device dispatch failed at {site}")
    if kind == "transfer":
        raise R.TpuTransientDeviceError(
            f"[injected] UNAVAILABLE: host<->device transfer failed "
            f"at {site}")
    raise R.FetchFailedError(f"[injected] shuffle piece lost at {site}")
