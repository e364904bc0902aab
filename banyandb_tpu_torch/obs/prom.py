"""Prometheus exposition parsing + histogram quantile recovery.

The read side of obs/metrics: the bench (bench.py), the load probe
(scripts/load.py) and tests scrape a RUNNING server's exposition text
and recover stage latency quantiles from the ``_bucket`` series —
using the same inversion the live handles use
(obs.metrics.quantile_from_buckets), so scraped and in-process
estimates cannot drift.
"""

from __future__ import annotations

import re
from typing import Optional

from banyandb_tpu_torch.obs.metrics import quantile_from_buckets

_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_exposition(text: str) -> list[tuple[str, dict, float]]:
    """-> [(metric name, label dict, value)] for every sample line."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if m is None:
            continue
        name, raw_labels, raw_value = m.groups()
        labels = dict(_LABEL.findall(raw_labels or ""))
        try:
            value = float(raw_value)
        except ValueError:
            continue
        out.append((name, labels, value))
    return out


def histogram_series(text: str, metric: str) -> dict[tuple, dict]:
    """Collect one histogram family from exposition text.

    -> {sorted non-le label items: {"buckets": [(le, cumulative)...],
        "count": int, "sum": float}}; buckets sorted by bound with the
    +Inf entry last."""
    series: dict[tuple, dict] = {}

    def slot(labels: dict) -> dict:
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        return series.setdefault(key, {"buckets": [], "count": 0, "sum": 0.0})

    for name, labels, value in parse_exposition(text):
        if name == metric + "_bucket":
            le = labels.get("le", "+Inf")
            bound = float("inf") if le == "+Inf" else float(le)
            slot(labels)["buckets"].append((bound, value))
        elif name == metric + "_count":
            slot(labels)["count"] = int(value)
        elif name == metric + "_sum":
            slot(labels)["sum"] = value
    for s in series.values():
        s["buckets"].sort(key=lambda bv: bv[0])
    return series


def quantile(series_entry: dict, q: float) -> float:
    """Quantile estimate from one scraped histogram series entry."""
    buckets = series_entry["buckets"]
    count = series_entry["count"]
    if not buckets or count <= 0:
        return 0.0
    bounds = tuple(b for b, _ in buckets if b != float("inf"))
    # de-cumulate (exposition buckets are cumulative)
    counts = []
    prev = 0.0
    for _, cum in buckets:
        counts.append(max(cum - prev, 0.0))
        prev = cum
    if len(counts) == len(bounds):  # no explicit +Inf line
        counts.append(max(count - prev, 0.0))
    return quantile_from_buckets(bounds, counts, count, q)


def stage_breakdown(
    text: str,
    metric: str = "banyandb_query_stage_ms",
    quantiles: tuple[float, ...] = (0.5, 0.99),
) -> dict[str, dict]:
    """Per-stage latency attribution from a scraped exposition.

    -> {stage: {"count": n, "p50_ms": ..., "p99_ms": ...}} — the
    per-stage split a benchmark run reports (gather vs device-execute
    vs merge, measured not inferred).

    Series sharing a stage but differing in OTHER labels (the
    multi-process data plane stamps ``worker="wNNN"`` per worker
    exposition) merge before inversion: buckets share the exponential
    bound grid, so summing cumulative counts per bound is exact."""
    merged: dict[str, dict] = {}
    for key, entry in histogram_series(text, metric).items():
        stage = dict(key).get("stage")
        if stage is None or entry["count"] == 0:
            continue
        slot = merged.setdefault(
            stage, {"buckets": {}, "count": 0, "sum": 0.0}
        )
        for bound, cum in entry["buckets"]:
            slot["buckets"][bound] = slot["buckets"].get(bound, 0.0) + cum
        slot["count"] += entry["count"]
        slot["sum"] += entry["sum"]
    out: dict[str, dict] = {}
    for stage, slot in merged.items():
        entry = {
            "buckets": sorted(slot["buckets"].items()),
            "count": slot["count"],
            "sum": slot["sum"],
        }
        rec: dict = {"count": entry["count"]}
        for q in quantiles:
            rec[f"p{int(q * 100)}_ms"] = round(quantile(entry, q), 3)
        out[stage] = rec
    return out


def stage_breakdown_delta(
    before: str,
    after: str,
    metric: str = "banyandb_query_stage_ms",
    quantiles: tuple[float, ...] = (0.5, 0.99),
) -> dict[str, dict]:
    """Per-stage attribution of ONLY the window between two scrapes.

    Cumulative bucket counts are diffed per (stage, le) so one phase of
    a run — e.g. each leg of the bench's fused-vs-staged A/B — gets its
    own quantiles instead of the process-lifetime aggregate."""
    prior = histogram_series(before, metric)
    merged: dict[str, dict] = {}
    for key, entry in histogram_series(after, metric).items():
        stage = dict(key).get("stage")
        if stage is None:
            continue
        base = prior.get(key)
        buckets = entry["buckets"]
        count = entry["count"]
        total = entry["sum"]
        if base is not None:
            base_map = dict(base["buckets"])
            buckets = [
                (bound, max(cum - base_map.get(bound, 0.0), 0.0))
                for bound, cum in buckets
            ]
            count = entry["count"] - base["count"]
            total = entry["sum"] - base["sum"]
        if count <= 0:
            continue
        # merge across non-stage labels (per-worker expositions), same
        # shared-bound-grid argument as stage_breakdown
        slot = merged.setdefault(
            stage, {"buckets": {}, "count": 0, "sum": 0.0}
        )
        for bound, cum in buckets:
            slot["buckets"][bound] = slot["buckets"].get(bound, 0.0) + cum
        slot["count"] += count
        slot["sum"] += total
    out: dict[str, dict] = {}
    for stage, slot in merged.items():
        window = {
            "buckets": sorted(slot["buckets"].items()),
            "count": slot["count"],
            "sum": slot["sum"],
        }
        rec: dict = {"count": slot["count"]}
        for q in quantiles:
            rec[f"p{int(q * 100)}_ms"] = round(quantile(window, q), 3)
        out[stage] = rec
    return out


def gauge_value(text: str, metric: str, labels: Optional[dict] = None):
    """First sample matching metric (+ label subset), or None."""
    want = labels or {}
    for name, lbls, value in parse_exposition(text):
        if name != metric:
            continue
        if all(lbls.get(k) == v for k, v in want.items()):
            return value
    return None
