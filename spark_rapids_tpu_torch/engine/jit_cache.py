"""Process-wide cache of encoded stage programs (port of
spark_rapids_tpu/engine/jit_cache.py).

The reference caches jitted XLA kernels by the semantic identity of the
kernel (expression fingerprints and operator structure), since exec nodes
are rebuilt for every query. The port's stage programs (ops/program.py)
run on one precompiled kernel, K48, so what is cached is the encoded
program: keyed by the op fingerprints of its expressions with literal
values out of the key (a literal keeps its type, NULL-ness and integer
width class), plus the Expand variant, and bound to each stage's literal
values on a hit. An LRU of 512 entries with hit / miss counters. The
reference's `_key_salt` carries its int64-narrowing flag, a TPU-only
workaround (ROADMAP §2), so the port has no salt.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Hashable

_LOCK = threading.Lock()
_MAX_ENTRIES = 512
_CACHE: "collections.OrderedDict[Hashable, Any]" = collections.OrderedDict()
_HITS = 0
_MISSES = 0


def get_or_build(key: Hashable, builder: Callable[[], Any]) -> Any:
    """The cached value of `key`, built (outside the lock) on a miss; two
    threads racing on one key keep the first build."""
    global _HITS, _MISSES
    with _LOCK:
        got = _CACHE.get(key)
        if got is not None:
            _CACHE.move_to_end(key)
            _HITS += 1
            return got
    built = builder()
    with _LOCK:
        got = _CACHE.setdefault(key, built)
        _CACHE.move_to_end(key)
        _MISSES += 1
        while len(_CACHE) > _MAX_ENTRIES:
            _CACHE.popitem(last=False)
        return got


def clear() -> None:
    with _LOCK:
        _CACHE.clear()


def stats() -> dict:
    with _LOCK:
        return {"entries": len(_CACHE), "hits": _HITS, "misses": _MISSES}
