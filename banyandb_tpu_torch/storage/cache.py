"""Serving cache: decoded columns for repeat queries.

Analog of the reference's serving cache
(banyand/internal/storage/cache.go:125), redesigned around this repo's
query pipeline: the expensive host work on the read path is (1) reading
+ decoding part blocks into ColumnData and (2) gathering sources into
one deduplicated global-code chunk for the device.  Both layers cache
here, keyed on immutable identities (part directories never mutate —
merges write NEW part dirs — so entries never go stale; deleted parts
simply age out of the LRU).

One process-global cache with a byte budget (BYDB_SERVING_CACHE_BYTES,
default 256 MiB), LRU eviction, and hit/miss counters that the query
trace spans and /metrics surface.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from banyandb_tpu_torch.qos import tenancy
from banyandb_tpu_torch.utils.envflag import env_int

DEFAULT_BUDGET = env_int("BYDB_SERVING_CACHE_BYTES", 256 << 20)


def default_cap() -> int:
    """Optional ENTRY capacity on top of the byte budget: the load
    harness showed a 916-entry squeeze churning 18k evictions in 10
    minutes (docs/load_r06.json) — operators size the entry population
    explicitly with BYDB_SERVING_CACHE_CAP / --serving-cache-cap
    (0 = bytes-only).  Read at CONSTRUCTION time, matching the other
    envflag call sites, so a post-import env change or late server flag
    takes effect without re-import (tests/test_serving_cache.py pins)."""
    return env_int("BYDB_SERVING_CACHE_CAP", 0)


def _sizeof(obj) -> int:
    """Approximate retained bytes of cached values (arrays dominate;
    covers numpy arrays and torch tensors via nbytes)."""
    if isinstance(obj, np.ndarray) or hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return 64 + sum(_sizeof(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return 64 + sum(_sizeof(v) for v in obj)
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if hasattr(obj, "__dict__"):
        return 64 + sum(_sizeof(v) for v in vars(obj).values())
    return 64


class ServingCache:
    """LRU byte-budget cache; values must be treated as immutable."""

    def __init__(
        self,
        budget_bytes: int = DEFAULT_BUDGET,
        max_entries: Optional[int] = None,
    ):
        self.budget = budget_bytes
        # entry cap: 0 = unlimited (byte budget only); None inherits the
        # BYDB_SERVING_CACHE_CAP env default, read now (construction)
        self.cap = default_cap() if max_entries is None else int(max_entries)
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, tuple[object, int]] = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def set_cap(self, max_entries: int) -> None:
        """Reconfigure the entry cap live (server flag); evicts down to
        the new bound immediately."""
        with self._lock:
            self.cap = int(max_entries)
            self._evict_locked()

    def _evict_locked(self) -> None:
        while self._entries and (
            self.bytes > self.budget
            or (self.cap and len(self._entries) > self.cap)
        ):
            _, (_, evicted) = self._entries.popitem(last=False)
            self.bytes -= evicted
            self.evictions += 1

    def get_or_load(self, key: tuple, loader: Callable[[], object]):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return hit[0]
            self.misses += 1
        # Load outside the lock (disk reads can be slow); racing loaders
        # compute the same immutable value, last-insert wins harmlessly.
        value = loader()
        size = _sizeof(value)
        if size > self.budget:
            return value  # too large to retain; serve uncached
        with self._lock:
            prev = self._entries.pop(key, None)
            if prev is not None:
                self.bytes -= prev[1]
            self._entries[key] = (value, size)
            self.bytes += size
            self._evict_locked()
        return value

    def invalidate_prefix(self, prefix: tuple) -> int:
        """Drop entries whose key starts with `prefix` (rarely needed —
        part identities are immutable — but retention tests use it)."""
        with self._lock:
            doomed = [
                k for k in self._entries if k[: len(prefix)] == prefix
            ]
            for k in doomed:
                _, size = self._entries.pop(k)
                self.bytes -= size
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes = 0

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "budget": self.budget,
                "cap": self.cap,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                # eviction churn: evictions per lookup — the r06 squeeze
                # signal (18102 evictions / 76k lookups) as one number
                "churn": round(self.evictions / lookups, 4)
                if lookups
                else 0.0,
            }


_global = ServingCache()

# Device-resident chunk cache (padded tensors keyed by gather identity)
# — its own budget so HBM residency is bounded independently of the host
# cache (default 1 GiB: a deliberate slice of the card's device memory,
# since resident chunks save both decode AND host->device transfer).
# max_entries=0: the serving-cache ENTRY cap (BYDB_SERVING_CACHE_CAP) is
# a host-cache knob and must not silently bound HBM residency too.
DEVICE_BUDGET = env_int("BYDB_DEVICE_CACHE_BYTES", 1 << 30)
_device = ServingCache(DEVICE_BUDGET, max_entries=0)

# Per-tenant serving-cache partitions (docs/robustness.md "Multi-tenant
# QoS"): queries running under a non-default tenant scope (qos/tenancy
# contextvar, bound by the serving roles) read/write their tenant's OWN
# LRU, so one tenant's churn cannot evict another's entries.  The
# default tenant keeps the original process-global instance — untenanted
# deployments are byte-identical to pre-QoS behavior.  Each partition
# gets the tenant's configured budget (qos limits `cache_bytes`) or the
# process default, and the same entry-cap knob.
_partitions: dict[str, ServingCache] = {}
_partitions_lock = threading.Lock()


def _tenant_partition(tenant: str) -> ServingCache:
    part = _partitions.get(tenant)
    if part is None:
        with _partitions_lock:
            part = _partitions.get(tenant)
            if part is None:
                from banyandb_tpu_torch.qos.plane import global_qos

                budget = (
                    global_qos().limits(tenant).cache_bytes or DEFAULT_BUDGET
                )
                part = _partitions[tenant] = ServingCache(budget)
    return part


def global_cache() -> ServingCache:
    tenant = tenancy.current_tenant()
    if tenant == tenancy.DEFAULT_TENANT:
        return _global
    return _tenant_partition(tenant)


def partition_stats() -> dict[str, dict]:
    """Per-tenant partition stats for /metrics (`tenant`-labeled rows);
    the default tenant's cache keeps its original unlabeled series."""
    with _partitions_lock:
        parts = dict(_partitions)
    return {t: c.stats() for t, c in sorted(parts.items())}


def device_cache() -> ServingCache:
    return _device


def reset_global_cache(budget_bytes: int = DEFAULT_BUDGET) -> ServingCache:
    """Test hook / server reconfiguration."""
    global _global, _device
    _global = ServingCache(budget_bytes)
    _device = ServingCache(DEVICE_BUDGET, max_entries=0)
    with _partitions_lock:
        _partitions.clear()
    return _global
