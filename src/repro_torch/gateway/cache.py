"""Warm-result cache: bounded LRU of solved queries (a copy of the JAX
package's ``gateway/cache.py``; DESIGN.md §13).

Real personalized-PageRank traffic repeats: the same seed at the same
tolerance against the same graph version.  A repeat is a pure function
of ``(graph name, plan fingerprint, seed, tol, top_k, max_iters)`` —
the plan fingerprint already IS the graph-version key the rest of the
repo uses (core/plan.py fingerprint chains), so a cached answer is
served in O(k) with the ORIGINAL result arrays (bit-identical, no
recompute, no copy).

Invalidation rule: ``apply_delta`` flips the scheduler's plan
fingerprint inside its locked rebind commit, so entries keyed on the
old fingerprint can never be MISTAKEN for current — the gateway still
drops them eagerly (``invalidate_fp``) so a delta releases the dead
entries' memory immediately instead of waiting for LRU pressure.

Only unconditionally-correct results are cached: converged,
error-free, non-degraded.  A degraded or deadline-expired answer is
an artifact of the moment's load, not of the query.
"""
from __future__ import annotations

import collections
import hashlib
import threading

import numpy as np


def seed_digest(seeds) -> str:
    """Stable key for a teleport distribution: blake2b over the raw
    float32 bytes (the same normalization ``submit`` applies happens
    downstream, so byte-equal inputs hit; ``None`` = uniform)."""
    if seeds is None:
        return "uniform"
    arr = np.ascontiguousarray(np.asarray(seeds, dtype=np.float32)
                               .reshape(-1))
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()


class ResultCache:
    """Thread-safe bounded LRU mapping query keys to QueryResults.

    ``capacity <= 0`` disables caching (every ``get`` misses, ``put``
    is a no-op) — one code path, no conditionals at call sites."""

    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidated = 0
        self.evictions = 0            # capacity-pressure LRU drops

    def get(self, key):
        with self._lock:
            res = self._entries.get(key)
            if res is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return res

    def put(self, key, result) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._entries[key] = result
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def invalidate_fp(self, plan_fp: str) -> int:
        """Drop every entry solved against plan fingerprint
        ``plan_fp`` — called by the gateway right after a scheduler's
        ``apply_delta`` rebind commits.  Returns the number dropped."""
        with self._lock:
            dead = [k for k in self._entries if k[1] == plan_fp]
            for k in dead:
                del self._entries[k]
            self.invalidated += len(dead)
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
