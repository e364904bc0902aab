"""Instrument registry: counters, gauges, exponential-bucket histograms.

The ``Meter`` core of the metrics facade (pkg/meter analog) lives here
at the platform layer so storage loops, executors and the cluster
fabric can all instrument themselves without upward imports;
``admin/metrics.py`` re-exports it and adds the ``_monitoring``
self-measure sink on top.

Histograms are exponential-bucket (factor 2 from 0.25 ms): 26 buckets
cover 250 µs .. ~2330 s, so any latency quantile is recoverable from
``/metrics`` within one bucket factor (and much closer with the log
interpolation in ``Histogram.quantile`` — tests/test_obs.py pins the
error bound).  Hot-path contract: ``meter.histogram(...)`` hands out a
per-instrument handle ONCE; ``handle.observe(v)`` touches only that
handle's lock — the registry dict+lock is never on the per-observation
path (the reference's provider/instrument split).
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Optional

# exponential bucket ladder: bounds[i] = 0.25 * 2**i (ms)
_BUCKET_START_MS = 0.25
_BUCKET_FACTOR = 2.0
_NUM_BUCKETS = 26

DEFAULT_BOUNDS: tuple[float, ...] = tuple(
    _BUCKET_START_MS * (_BUCKET_FACTOR**i) for i in range(_NUM_BUCKETS)
)


class Histogram:
    """One instrument: bucket counts + running count/sum.

    observe() is the hot path: bucket search outside the lock, three
    plain stores under it.  Values land in the first bucket whose upper
    bound is >= value; values past the ladder land in the +Inf bucket.
    """

    __slots__ = ("bounds", "_counts", "count", "sum", "_lock")

    def __init__(self, bounds: Optional[tuple[float, ...]] = None):
        self.bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        self._counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += value

    def snapshot(self) -> tuple[int, float, tuple[int, ...]]:
        """-> (count, sum, per-bucket counts incl. trailing +Inf)."""
        with self._lock:
            return self.count, self.sum, tuple(self._counts)

    def quantile(self, q: float) -> float:
        """CDF inversion with log interpolation inside the hit bucket —
        exact to within one bucket, typically much closer on smooth
        distributions (the bound tests/test_obs.py pins)."""
        count, _total, counts = self.snapshot()
        return quantile_from_buckets(self.bounds, counts, count, q)


def quantile_from_buckets(
    bounds: tuple[float, ...], counts, count: int, q: float
) -> float:
    """Shared inversion used by live handles AND scraped exposition
    (obs/prom.py) so the bench's stage_breakdown and the in-process
    estimate cannot drift."""
    if count <= 0:
        return 0.0
    target = max(1.0, math.ceil(q * count))
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            if i >= len(bounds):  # +Inf bucket: report the last bound
                return bounds[-1]
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else 0.0
            frac = (target - (cum - c)) / max(c, 1.0)
            frac = min(max(frac, 0.0), 1.0)
            if lo <= 0.0:
                return hi * frac
            return lo * (hi / lo) ** frac
    return bounds[-1]


class Meter:
    """Scoped instrument registry: counters, gauges, histograms.

    Counters/gauges stay dict-under-one-lock (write-rate is per-request,
    not per-row); histograms hand out per-instrument handles.
    """

    def __init__(self, scope: str = ""):
        self.scope = scope
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hist: dict[tuple, Histogram] = {}

    def _key(self, name: str, labels: Optional[dict]) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def counter_add(self, name: str, value: float = 1.0, labels: Optional[dict] = None):
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def gauge_set(self, name: str, value: float, labels: Optional[dict] = None):
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def histogram(
        self,
        name: str,
        labels: Optional[dict] = None,
        bounds: Optional[tuple[float, ...]] = None,
    ) -> Histogram:
        """Per-instrument handle; grab once, observe many.  The lock-free
        first read keeps repeat lookups off the registry lock too."""
        k = self._key(name, labels)
        h = self._hist.get(k)
        if h is None:
            with self._lock:
                h = self._hist.get(k)
                if h is None:
                    h = self._hist[k] = Histogram(bounds)
        return h

    def observe(self, name: str, value: float, labels: Optional[dict] = None):
        self.histogram(name, labels).observe(value)

    # -- exposition ---------------------------------------------------------
    def snapshot(self) -> dict:
        """histograms keep the legacy (count, sum) shape consumed by the
        fodc watchdog source; hist_buckets adds the full ladder."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hist)
        hist_cs: dict[tuple, tuple[int, float]] = {}
        buckets: dict[tuple, tuple[tuple[float, ...], tuple[int, ...]]] = {}
        for k, h in hists.items():
            count, total, counts = h.snapshot()
            hist_cs[k] = (count, total)
            buckets[k] = (h.bounds, counts)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": hist_cs,
            "hist_buckets": buckets,
        }

    def prometheus_text(self) -> str:
        """Prometheus exposition format (pkg/meter/prom analog), with
        cumulative ``_bucket{le=...}`` series per histogram."""
        pfx = (self.scope + "_") if self.scope else ""
        lines = []

        def fmt_labels(lbls: tuple, extra: Optional[tuple] = None) -> str:
            items = list(lbls) + (list(extra) if extra else [])
            if not items:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in items)
            return "{" + inner + "}"

        def fmt_le(b: float) -> str:
            return repr(b) if b != int(b) else str(int(b))

        snap = self.snapshot()
        for (name, lbls), v in sorted(snap["counters"].items()):
            lines.append(f"{pfx}{name}_total{fmt_labels(lbls)} {v}")
        for (name, lbls), v in sorted(snap["gauges"].items()):
            lines.append(f"{pfx}{name}{fmt_labels(lbls)} {v}")
        for (name, lbls), (count, total) in sorted(snap["histograms"].items()):
            bounds, counts = snap["hist_buckets"][(name, lbls)]
            cum = 0
            for b, c in zip(bounds, counts):
                cum += c
                lines.append(
                    f"{pfx}{name}_bucket"
                    f"{fmt_labels(lbls, (('le', fmt_le(b)),))} {cum}"
                )
            lines.append(
                f"{pfx}{name}_bucket{fmt_labels(lbls, (('le', '+Inf'),))} "
                f"{count}"
            )
            lines.append(f"{pfx}{name}_count{fmt_labels(lbls)} {count}")
            lines.append(f"{pfx}{name}_sum{fmt_labels(lbls)} {total}")
        return "\n".join(lines) + "\n"


# -- process-global meter ----------------------------------------------------
# One registry per process: engines, storage loops, executors and the
# RPC fabric all write here, and every server role's metrics topic /
# /metrics endpoint exposes it.  (Multi-node-in-one-process test
# topologies share it — per-node split is a label, not a registry.)
_GLOBAL: Optional[Meter] = None
_GLOBAL_LOCK = threading.Lock()


def global_meter() -> Meter:
    global _GLOBAL
    m = _GLOBAL
    if m is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Meter("banyandb")
            m = _GLOBAL
    return m


def stage_histogram(stage: str) -> Histogram:
    """Handle for one query-stage latency instrument
    (``banyandb_query_stage_ms{stage=...}``) — the instrument the bench's
    stage_breakdown and ROADMAP item 1's attribution read."""
    return global_meter().histogram("query_stage_ms", {"stage": stage})
