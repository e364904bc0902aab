"""Slow-query flight recorder: a bounded ring buffer of span trees.

Queries whose wall time crosses the slow threshold (accesslog's
``slow_query_ms``) persist their full span tree + plan text here; the
newest entries are retrievable live via ``cli.py slowlog``, the
``slowlog`` bus topic and ``GET /api/v1/slowlog`` on the HTTP gateway
(the reference's slow-query log, banyand/dquery/measure.go:169, grown
into a flight recorder).

``SignatureStats`` is the recorder plane's second table: a bounded
per-query-signature hit counter fed by the server query epilogue for
EVERY measure query (slow queries count double — they are the ones
materialization helps most).  The auto-registration loop
(query/planner.AutoRegistrar) mines it each tick to find hot
streamagg-eligible signatures; it holds no span trees, just
(group, measure, key_tags, fields) -> hits.

Bounded by construction (``BYDB_SLOWLOG_CAPACITY`` entries, oldest
evicted; ``SignatureStats`` caps distinct signatures and drops the
coldest) so a pathological workload cannot grow either without limit.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

_DEFAULT_CAPACITY = 128


def _env_capacity() -> int:
    from banyandb_tpu_torch.utils.envflag import env_int

    return max(env_int("BYDB_SLOWLOG_CAPACITY", _DEFAULT_CAPACITY), 1)


class SlowQueryRecorder:
    """Thread-safe ring buffer of slow-query records.

    A record is a plain JSON-safe dict; ``record`` stamps ``seq`` (a
    monotonic id that survives eviction — consumers can detect gaps)
    and ``ts`` (epoch millis) onto it.
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity if capacity is not None else _env_capacity()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0

    def record(self, entry: dict) -> int:
        with self._lock:
            self._seq += 1
            entry = dict(entry, seq=self._seq, ts=int(time.time() * 1000))
            self._ring.append(entry)
            return self._seq

    def entries(self, limit: Optional[int] = None) -> list[dict]:
        """Newest first."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        if limit is not None and limit >= 0:
            out = out[: int(limit)]
        return out

    def clear(self) -> int:
        with self._lock:
            n = len(self._ring)
            self._ring.clear()
            return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class SignatureStats:
    """Bounded per-signature query counter (the autoreg evidence
    table).  Keys are the planner's signature tuples
    ``(group, measure, key_tags, fields)``; values are cumulative hit
    counts (monotonic — the miner diffs against its last snapshot).

    Capacity-bounded: past ``cap`` distinct signatures the coldest
    (lowest-count) entry is dropped, so churn-heavy ad-hoc query
    populations cannot grow the table without limit while a steady
    dashboard signature keeps accumulating."""

    def __init__(self, cap: int = 512):
        self.cap = max(int(cap), 8)
        self._lock = threading.Lock()
        self._hits: dict[tuple, int] = {}

    def observe(self, key: Optional[tuple], weight: int = 1) -> None:
        if key is None:
            return
        with self._lock:
            n = self._hits.get(key)
            if n is None and len(self._hits) >= self.cap:
                coldest = min(self._hits, key=self._hits.get)
                del self._hits[coldest]
            self._hits[key] = (n or 0) + weight

    def snapshot(self) -> dict[tuple, int]:
        with self._lock:
            return dict(self._hits)

    def __len__(self) -> int:
        with self._lock:
            return len(self._hits)


# one per process by default (all server roles in a process share it,
# like the global meter); servers own explicit instances when isolation
# matters — the default exists so surfaces without a server handle
# (offline tooling) can still read the buffer
_DEFAULT: Optional[SlowQueryRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def record_slow_query(
    recorder: SlowQueryRecorder,
    threshold_ms: float,
    *,
    engine: str,
    group: str,
    name: str,
    duration_ms: float,
    rows: int,
    span_tree: dict,
    ql: Optional[str] = None,
    plan: Optional[str] = None,
    plan_fn=None,
    tenant: str = "",
) -> bool:
    """The slow-query epilogue every server role shares: one record
    schema, one threshold check.  `plan_fn` renders the plan post-hoc
    (role-specific: local vs distributed analyzer) — invoked only for
    queries already past the threshold, never on the hot path."""
    if duration_ms < threshold_ms:
        return False
    if plan is None and plan_fn is not None:
        try:
            plan = plan_fn()
        except Exception:  # noqa: BLE001 - the record stays useful
            plan = None
    if not tenant:
        from banyandb_tpu_torch.qos.tenancy import tenant_of_group

        tenant = tenant_of_group(group)
    recorder.record(
        {
            "engine": engine,
            "group": group,
            "name": name,
            "tenant": tenant,
            "ql": ql,
            "duration_ms": round(duration_ms, 3),
            "rows": rows,
            "threshold_ms": threshold_ms,
            "span_tree": span_tree,
            "plan": plan,
        }
    )
    return True


def slowlog_topic_reply(
    recorder: SlowQueryRecorder, env: dict, threshold_ms: float
) -> dict:
    """The `slowlog` bus-topic contract, shared by every server role so
    the surfaces cannot drift: {limit} reads newest-first, {clear: true}
    drains the ring."""
    if env.get("clear"):
        return {"cleared": recorder.clear(), "entries": []}
    return {
        "entries": recorder.entries(limit=env.get("limit")),
        "threshold_ms": threshold_ms,
        "capacity": recorder.capacity,
    }


def default_recorder() -> SlowQueryRecorder:
    global _DEFAULT
    r = _DEFAULT
    if r is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = SlowQueryRecorder()
            r = _DEFAULT
    return r
