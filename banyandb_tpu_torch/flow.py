"""Streaming dataflow: event-time windows over pushed elements.

Analog of the reference's pkg/flow streaming DAG
(pkg/flow/streaming/streaming.go New/Filter/Map/Window/
To with TumblingTimeWindows + SlidingTimeWindows and event-time
triggers), re-shaped for this runtime: a push-based pipeline where
elements buffer per key and window-fire is driven by an explicit
watermark (the caller's event-time clock), with aggregation done as
vectorized numpy passes over the fired batch instead of per-element
accumulator objects — the same batch-first philosophy as the query
plane.

    flow = (Flow("cpm")
            .filter(lambda e: e.value > 0)
            .map(lambda e: e._replace(value=e.value * 2))
            .key_by(lambda e: e.tags["svc"])
            .window(SlidingEventTimeWindow(size_ms=60_000, slide_ms=15_000))
            .aggregate("sum")
            .to(collector.append))
    flow.feed(elements)                 # any order within lateness
    flow.advance_watermark(ts_millis)   # fires windows ending <= wm

TopN rides the same machinery (models/topn.py keeps its specialized
pre-aggregation path; this module is the general-purpose surface).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np


import types

_NO_TAGS = types.MappingProxyType({})


class Element(NamedTuple):
    ts_millis: int
    value: float
    # immutable default: a shared {} would alias every tag-less element
    tags: dict = _NO_TAGS


@dataclass(frozen=True)
class TumblingEventTimeWindow:
    size_ms: int

    def assign(self, ts: int) -> list[int]:
        return [ts - (ts % self.size_ms)]

    @property
    def length_ms(self) -> int:
        return self.size_ms


@dataclass(frozen=True)
class SlidingEventTimeWindow:
    """Overlapping windows: each element lands in size/slide windows
    (flow/streaming/sliding_window.go analog)."""

    size_ms: int
    slide_ms: int

    def __post_init__(self):
        assert self.size_ms % self.slide_ms == 0, "size must be a slide multiple"

    def assign(self, ts: int) -> list[int]:
        last = ts - (ts % self.slide_ms)
        first = last - self.size_ms + self.slide_ms
        return list(range(first, last + 1, self.slide_ms))

    @property
    def length_ms(self) -> int:
        return self.size_ms


@dataclass
class WindowResult:
    start_ms: int
    end_ms: int
    key: object
    value: object  # scalar for count/sum/mean/min/max; list for topn


_AGGS = {
    "count": lambda v: float(len(v)),
    "sum": lambda v: float(np.sum(v)),
    "mean": lambda v: float(np.mean(v)) if len(v) else 0.0,
    "min": lambda v: float(np.min(v)) if len(v) else float("inf"),
    "max": lambda v: float(np.max(v)) if len(v) else float("-inf"),
}


class Flow:
    def __init__(self, name: str):
        self.name = name
        self._filters: list[Callable] = []
        self._maps: list[Callable] = []
        self._key_fn: Callable = lambda e: None
        self._window = None
        self._agg: Optional[str] = None
        self._topn: Optional[tuple[int, bool]] = None
        self._sinks: list[Callable] = []
        self._allowed_lateness_ms = 0
        # open windows: (window_start, key) -> list[value]
        self._open: dict[tuple[int, object], list[float]] = {}
        self._watermark = -(1 << 62)

    # -- builder ------------------------------------------------------------
    def filter(self, fn: Callable) -> "Flow":
        self._filters.append(fn)
        return self

    def map(self, fn: Callable) -> "Flow":
        self._maps.append(fn)
        return self

    def key_by(self, fn: Callable) -> "Flow":
        self._key_fn = fn
        return self

    def window(self, w) -> "Flow":
        self._window = w
        return self

    def allowed_lateness(self, ms: int) -> "Flow":
        self._allowed_lateness_ms = ms
        return self

    def aggregate(self, fn: str) -> "Flow":
        if fn not in _AGGS:
            raise ValueError(f"unknown aggregate {fn!r}")
        self._agg = fn
        return self

    def top_n(self, n: int, desc: bool = True) -> "Flow":
        """Per-window ranking of keys by their aggregated value (requires
        aggregate(...) too; emits one WindowResult per window with a
        ranked [(key, value)] list)."""
        self._topn = (n, desc)
        return self

    def to(self, sink: Callable[[WindowResult], None]) -> "Flow":
        self._sinks.append(sink)
        return self

    # -- runtime ------------------------------------------------------------
    def feed(self, elements) -> int:
        """Push elements (any order within lateness); returns accepted
        count.  Elements at or before the watermark minus lateness are
        DROPPED (their windows already fired — reopening would emit
        duplicates, the same contract as the TopN tumbling windows)."""
        if self._window is None or self._agg is None:
            raise RuntimeError("window(...) and aggregate(...) must be set")
        accepted = 0
        for e in elements:
            ok = True
            for f in self._filters:
                if not f(e):
                    ok = False
                    break
            if not ok:
                continue
            for m in self._maps:
                e = m(e)
            late_cutoff = self._watermark - self._allowed_lateness_ms
            size = self._window.length_ms
            # per-start skip: an element may still belong to OPEN sliding
            # windows while its earlier windows already fired — appending
            # to a fired start would re-fire that window with a partial
            # duplicate
            starts = [
                s
                for s in self._window.assign(e.ts_millis)
                if s + size > late_cutoff
            ]
            if not starts:
                continue  # every window containing it has fired
            key = self._key_fn(e)
            for start in starts:
                self._open.setdefault((start, key), []).append(e.value)
            accepted += 1
        return accepted

    def advance_watermark(self, ts_millis: int) -> list[WindowResult]:
        """Move event time forward; fire every window whose end is at or
        before (watermark - allowed lateness).  Fired results go to the
        sinks and are returned."""
        self._watermark = max(self._watermark, ts_millis)
        cutoff = self._watermark - self._allowed_lateness_ms
        size = self._window.length_ms
        fired: dict[int, dict[object, np.ndarray]] = {}
        for (start, key), vals in list(self._open.items()):
            if start + size <= cutoff:
                fired.setdefault(start, {})[key] = np.asarray(vals)
                del self._open[(start, key)]
        out: list[WindowResult] = []
        agg = _AGGS[self._agg]
        for start in sorted(fired):
            per_key = {k: agg(v) for k, v in fired[start].items()}
            if self._topn is not None:
                n, desc = self._topn
                ranked = sorted(
                    per_key.items(), key=lambda kv: kv[1], reverse=desc
                )[:n]
                out.append(WindowResult(start, start + size, None, ranked))
            else:
                out.extend(
                    WindowResult(start, start + size, k, v)
                    for k, v in sorted(per_key.items(), key=lambda kv: str(kv[0]))
                )
        for r in out:
            for sink in self._sinks:
                sink(r)
        return out
