"""The tenant admission plane: quotas, weighted query admission.

One ``QosPlane`` per process (like the global meter).  Three gates:

- **Ingest rate** — a per-tenant token bucket over accepted points
  (``write_rate`` points/s, ``write_burst`` tokens of headroom).  Over
  quota sheds IMMEDIATELY with ``ServerBusy`` — the existing retryable
  ``kind="shed"`` on the bus wire (cluster/rpc.py), RESOURCE_EXHAUSTED
  on the proto wire — never a silent drop.  The bucket admits into debt
  (one oversized batch is charged, the NEXT writes shed until the
  refill catches up) so no batch size can wedge a tenant permanently.
- **In-flight write bytes** — enforced by the memory protector's
  per-tenant charge accounting (admin/protector.py); this module only
  serves the limit.
- **Query concurrency** — per-tenant ``max_concurrent`` caps plus an
  optional global pool (``query_global_max``) shared by WEIGHT: a
  queued query waits only while its deadline budget has headroom
  (clamped to ``max_queue_s``), then sheds retryably.  Under global
  contention the waiter whose tenant has the fewest active slots per
  unit weight admits first.

Defaults are generous (every limit 0 = unlimited), so a single-tenant
deployment with ``BYDB_QOS`` on — the default — takes the fast paths
and stays byte-identical to pre-QoS behavior (tests/test_qos.py pins
this).  Per-tenant limits come from the ``BYDB_QOS_TENANTS`` JSON env
(``{"acme": {"write_rate": 1000, "weight": 4}, "*": {...}}``; ``*`` is
the default for unlisted tenants).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

from banyandb_tpu_torch.obs.metrics import global_meter
from banyandb_tpu_torch.qos.tenancy import tenant_of_group
from banyandb_tpu_torch.utils.envflag import env_flag, env_float, env_int, env_str


def _server_busy(msg: str):
    # lazy boundary (docs/linting.md layering): the canonical shed
    # exception lives in admin/protector; its class NAME is what the
    # rpc fabric serializes as kind="shed"
    from banyandb_tpu_torch.admin.protector import ServerBusy

    return ServerBusy(msg)


@dataclasses.dataclass(frozen=True)
class TenantLimits:
    """Per-tenant quota set; 0 anywhere = unlimited (the generous
    default — no behavior change until an operator configures less)."""

    write_rate: float = 0.0  # accepted points/s at ingest
    write_burst: float = 0.0  # bucket headroom (0 -> 2s of write_rate)
    inflight_bytes: int = 0  # concurrent in-flight write bytes
    max_concurrent: int = 0  # concurrent queries
    weight: float = 1.0  # share of the global query pool
    cache_bytes: int = 0  # serving-cache partition budget (0 -> default)
    max_signatures: int = 0  # streamagg registrations (manual + auto)

    def burst(self) -> float:
        return self.write_burst or max(2.0 * self.write_rate, 1.0)


_LIMIT_FIELDS = {f.name for f in dataclasses.fields(TenantLimits)}


def _parse_limits(doc) -> TenantLimits:
    """One tenant's limit doc -> TenantLimits; malformed values fall
    back to the generous defaults with a warning (same policy as
    malformed BYDB_QOS_TENANTS JSON — a typo'd tuning knob must never
    keep a server from booting)."""
    kw = {}
    try:
        items = dict(doc or {}).items()
    except (TypeError, ValueError):
        items = ()
    for k, v in items:
        if k not in _LIMIT_FIELDS:
            continue
        try:
            kw[k] = type(getattr(TenantLimits, k))(v)
        except (TypeError, ValueError):
            import logging

            logging.getLogger("banyandb.qos").warning(
                "malformed QoS limit %s=%r ignored (default kept)", k, v
            )
    return TenantLimits(**kw)


class _TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.t_last = time.monotonic()

    def take(self, n: float) -> bool:
        now = time.monotonic()
        self.tokens = min(
            self.burst, self.tokens + (now - self.t_last) * self.rate
        )
        self.t_last = now
        if self.tokens <= 0.0:
            return False
        self.tokens -= n  # admit into debt; future takes shed until refill
        return True


class QosPlane:
    def __init__(
        self,
        *,
        enabled: Optional[bool] = None,
        tenants: Optional[dict] = None,
        query_global_max: Optional[int] = None,
        max_queue_s: Optional[float] = None,
    ):
        self.enabled = (
            env_flag("BYDB_QOS", default=True) if enabled is None else enabled
        )
        if tenants is None:
            tenants = {}
            raw = env_str("BYDB_QOS_TENANTS").strip()
            if raw:
                try:
                    tenants = json.loads(raw)
                except ValueError:
                    import logging

                    logging.getLogger("banyandb.qos").warning(
                        "malformed BYDB_QOS_TENANTS ignored (%r)", raw
                    )
                    tenants = {}
        self._default_limits = _parse_limits(tenants.get("*", {}))
        self._limits = {
            t: _parse_limits(doc)
            for t, doc in tenants.items()
            if t != "*"
        }
        self.query_global_max = (
            env_int("BYDB_QOS_QUERY_GLOBAL_MAX", 0)
            if query_global_max is None
            else query_global_max
        )
        self.max_queue_s = (
            env_float("BYDB_QOS_MAX_QUEUE_S", 5.0)
            if max_queue_s is None
            else max_queue_s
        )
        # RLock: the shed path counts (takes the lock) while still
        # inside the admission condition's critical section
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._buckets: dict[str, _TokenBucket] = {}
        self._active: dict[str, int] = {}
        self._waiting: dict[str, int] = {}
        # per-tenant counters mirrored into the meter with a tenant label
        self._counts: dict[str, dict[str, int]] = {}

    # -- config --------------------------------------------------------------
    def limits(self, tenant: str) -> TenantLimits:
        return self._limits.get(tenant, self._default_limits)

    def inflight_limit(self, tenant: str) -> int:
        """The protector's per-tenant in-flight byte budget source."""
        if not self.enabled:
            return 0
        return self.limits(tenant).inflight_bytes

    def _count(self, tenant: str, key: str, n: int = 1) -> None:
        with self._lock:
            rec = self._counts.setdefault(tenant, {})
            rec[key] = rec.get(key, 0) + n
        global_meter().counter_add(f"qos_{key}", float(n), {"tenant": tenant})

    # -- ingest --------------------------------------------------------------
    def admit_write(self, group: str, points: int) -> str:
        """Charge ``points`` against the tenant's ingest bucket; -> the
        tenant name.  Over quota raises ServerBusy (retryable shed)."""
        tenant = tenant_of_group(group)
        if not self.enabled:
            return tenant
        lim = self.limits(tenant)
        if lim.write_rate <= 0:
            self._count(tenant, "write_admitted")
            return tenant
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None or bucket.rate != lim.write_rate:
                bucket = self._buckets[tenant] = _TokenBucket(
                    lim.write_rate, lim.burst()
                )
            ok = bucket.take(float(points))
        if not ok:
            self._count(tenant, "write_shed")
            raise _server_busy(
                f"tenant {tenant!r} over ingest quota "
                f"({lim.write_rate:g} points/s); retry after backoff"
            )
        self._count(tenant, "write_admitted")
        return tenant

    # -- queries -------------------------------------------------------------
    def admit_query(self, group: str, deadline_s: Optional[float] = None):
        """Context manager holding one query slot for ``group``'s tenant;
        entering may queue (deadline-aware) and raises ServerBusy when
        the wait budget runs out.  ``.tenant`` / ``.queued_ms`` are
        readable after entry (the ``qos`` span tags)."""
        return _QueryTicket(self, tenant_of_group(group), deadline_s)

    def _eligible_locked(self, tenant: str, cap: int) -> bool:
        if cap and self._active.get(tenant, 0) >= cap:
            return False
        gmax = self.query_global_max
        if gmax:
            if sum(self._active.values()) >= gmax:
                return False
            contenders = set(self._waiting) | {tenant}
            if len(contenders) > 1:
                # weighted deficit: fewest active slots per unit weight
                # admits first (ties broken by name for determinism)
                def prio(t: str):
                    w = max(self.limits(t).weight, 1e-9)
                    return (self._active.get(t, 0) / w, t)

                if min(contenders, key=prio) != tenant:
                    return False
        return True

    def _acquire_query(
        self, tenant: str, deadline_s: Optional[float]
    ) -> float:
        """-> queued milliseconds.  Raises ServerBusy on wait-budget
        exhaustion (the explicit retryable rejection)."""
        if not self.enabled:
            return 0.0
        cap = self.limits(tenant).max_concurrent
        if cap <= 0 and self.query_global_max <= 0:
            self._count(tenant, "query_admitted")
            return 0.0
        budget = self.max_queue_s
        if deadline_s is not None:
            budget = max(min(budget, deadline_s), 0.0)
        t0 = time.monotonic()
        t_end = t0 + budget
        with self._cond:
            if self._eligible_locked(tenant, cap):
                self._active[tenant] = self._active.get(tenant, 0) + 1
                queued = False
            else:
                queued = True
                self._waiting[tenant] = self._waiting.get(tenant, 0) + 1
                try:
                    while True:
                        remaining = t_end - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(min(remaining, 0.25))
                        if self._eligible_locked(tenant, cap):
                            self._active[tenant] = (
                                self._active.get(tenant, 0) + 1
                            )
                            remaining = 1.0  # admitted marker
                            break
                    admitted = remaining > 0
                finally:
                    n = self._waiting.get(tenant, 1) - 1
                    if n:
                        self._waiting[tenant] = n
                    else:
                        self._waiting.pop(tenant, None)
                if not admitted:
                    self._count(tenant, "query_shed")
                    raise _server_busy(
                        f"tenant {tenant!r} query admission queue timed "
                        f"out after {budget:.2f}s; retry after backoff"
                    )
        queued_ms = (time.monotonic() - t0) * 1000.0
        if queued:
            self._count(tenant, "query_queued")
            global_meter().observe(
                "qos_queue_ms", queued_ms, {"tenant": tenant}
            )
        self._count(tenant, "query_admitted")
        return queued_ms

    def _release_query(self, tenant: str) -> None:
        if not self.enabled:
            return
        cap = self.limits(tenant).max_concurrent
        if cap <= 0 and self.query_global_max <= 0:
            return
        with self._cond:
            n = self._active.get(tenant, 1) - 1
            if n:
                self._active[tenant] = n
            else:
                self._active.pop(tenant, None)
            self._cond.notify_all()

    # -- streamagg registrations --------------------------------------------
    def admit_streamagg(self, group: str, existing: int) -> str:
        """Gate one NEW streamagg registration for ``group``'s tenant
        against its signature cap (``existing`` = live signatures the
        tenant already holds)."""
        tenant = tenant_of_group(group)
        if not self.enabled:
            return tenant
        cap = self.limits(tenant).max_signatures
        if cap and existing >= cap:
            self._count(tenant, "streamagg_rejected")
            raise _server_busy(
                f"tenant {tenant!r} at its streamagg signature cap "
                f"({cap}); unregister one or raise the quota"
            )
        return tenant

    # -- exposition ----------------------------------------------------------
    def export_gauges(self, meter=None) -> None:
        m = meter or global_meter()
        m.gauge_set("qos_enabled", float(self.enabled))
        with self._lock:
            active = dict(self._active)
            waiting = dict(self._waiting)
            # every tenant the plane has ever counted: gauges must
            # OVERWRITE to zero when a tenant drains, or an idle
            # tenant's last nonzero value sticks forever (gauge_set
            # persists last value)
            known = set(self._counts) | set(active) | set(waiting)
        for t in known:
            m.gauge_set(
                "qos_query_active", float(active.get(t, 0)), {"tenant": t}
            )
            m.gauge_set(
                "qos_query_waiting", float(waiting.get(t, 0)), {"tenant": t}
            )

    def stats(self) -> dict:
        with self._lock:
            tenants = sorted(
                set(self._counts) | set(self._limits) | set(self._active)
            )
            out = {}
            for t in tenants:
                lim = self.limits(t)
                out[t] = {
                    **{
                        k: self._counts.get(t, {}).get(k, 0)
                        for k in (
                            "write_admitted",
                            "write_shed",
                            "query_admitted",
                            "query_queued",
                            "query_shed",
                            "streamagg_rejected",
                        )
                    },
                    "active": self._active.get(t, 0),
                    "limits": dataclasses.asdict(lim),
                }
        return {
            "enabled": self.enabled,
            "query_global_max": self.query_global_max,
            "max_queue_s": self.max_queue_s,
            "tenants": out,
        }


class _QueryTicket:
    """The admit_query context manager (one query slot)."""

    __slots__ = ("_plane", "tenant", "_deadline_s", "queued_ms", "_held")

    def __init__(self, plane: QosPlane, tenant: str, deadline_s):
        self._plane = plane
        self.tenant = tenant
        self._deadline_s = deadline_s
        self.queued_ms = 0.0
        self._held = False

    def __enter__(self) -> "_QueryTicket":
        self.queued_ms = self._plane._acquire_query(
            self.tenant, self._deadline_s
        )
        self._held = True
        return self

    def __exit__(self, *exc) -> None:
        if self._held:
            self._held = False
            self._plane._release_query(self.tenant)


# -- process-global plane -----------------------------------------------------
_PLANE: Optional[QosPlane] = None
_PLANE_LOCK = threading.Lock()


def global_qos() -> QosPlane:
    global _PLANE
    p = _PLANE
    if p is None:
        with _PLANE_LOCK:
            if _PLANE is None:
                _PLANE = QosPlane()
            p = _PLANE
    return p


def reset_qos() -> QosPlane:
    """Re-read the env (tests / harnesses that reconfigure quotas)."""
    global _PLANE
    with _PLANE_LOCK:
        _PLANE = QosPlane()
        return _PLANE
