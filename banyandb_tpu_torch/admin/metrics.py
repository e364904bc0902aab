"""Metrics facade (pkg/meter analog) with two sinks:

- in-memory registry with Prometheus text exposition
  (pkg/meter/prom analog — scrape via the server's "metrics" topic),
  now with exponential-bucket histograms so latency quantiles are
  recoverable from ``/metrics`` (the core lives in obs/metrics.py at
  the platform layer; this module re-exports it for admin callers),
- self-measure writer: periodic dump of all instruments as data points
  into the `_monitoring` group (pkg/meter/native/provider.go:39,81
  analog), so the database monitors itself with its own query engine.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from banyandb_tpu_torch.obs.metrics import (  # noqa: F401 - the admin surface
    DEFAULT_BOUNDS,
    Histogram,
    Meter,
    global_meter,
)


class SelfMeasureSink:
    """Write instruments as measure points into `_monitoring`
    (the reference's native meter provider).

    ``start()`` runs a background flusher (``bydb-self-measure``) so the
    group is periodically populated without operator action; histograms
    land as count/sum plus p50/p99 estimates so the self-measures carry
    the same attribution ``/metrics`` does."""

    GROUP = "_monitoring"
    MEASURE = "instruments"
    DEFAULT_INTERVAL_S = 30.0

    def __init__(
        self,
        meter: Meter,
        measure_engine,
        interval_s: Optional[float] = None,
    ):
        from banyandb_tpu_torch.utils.envflag import env_float

        self.meter = meter
        self.engine = measure_engine
        self.interval_s = (
            interval_s
            if interval_s is not None
            else env_float("BYDB_SELF_MEASURE_INTERVAL_S", self.DEFAULT_INTERVAL_S)
        )
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ensure_schema()

    def _ensure_schema(self) -> None:
        from banyandb_tpu_torch.api.schema import (
            Catalog,
            Entity,
            FieldSpec,
            FieldType,
            Group,
            Measure,
            ResourceOpts,
            TagSpec,
            TagType,
        )

        reg = self.engine.registry
        try:
            reg.get_group(self.GROUP)
        except KeyError:
            reg.create_group(
                Group(self.GROUP, Catalog.MEASURE, ResourceOpts(shard_num=1))
            )
        try:
            reg.get_measure(self.GROUP, self.MEASURE)
        except KeyError:
            reg.create_measure(
                Measure(
                    group=self.GROUP,
                    name=self.MEASURE,
                    tags=(
                        TagSpec("name", TagType.STRING),
                        TagSpec("kind", TagType.STRING),
                    ),
                    fields=(FieldSpec("value", FieldType.FLOAT),),
                    entity=Entity(("name", "kind")),
                )
            )

    # -- periodic flusher ---------------------------------------------------
    def start(self) -> None:
        """Populate `_monitoring` on a cadence (idempotent)."""
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="bydb-self-measure", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - the sink must not die with
                # a transient engine error (e.g. mid-shutdown write refusal)
                import logging

                logging.getLogger(__name__).exception("self-measure flush failed")

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None

    def flush(self, now_millis: Optional[int] = None) -> int:
        from banyandb_tpu_torch.api.model import DataPointValue, WriteRequest

        ts = now_millis or int(time.time() * 1000)
        snap = self.meter.snapshot()
        points = []
        def add(kind: str, name: str, lbls: tuple, value: float):
            label_sfx = ",".join(f"{k}={val}" for k, val in lbls)
            full = f"{name}|{label_sfx}" if label_sfx else name
            points.append(
                DataPointValue(
                    ts_millis=ts,
                    tags={"name": full, "kind": kind},
                    fields={"value": float(value)},
                    version=ts,
                )
            )

        for (name, lbls), v in snap["counters"].items():
            add("counter", name, lbls, v)
        for (name, lbls), v in snap["gauges"].items():
            add("gauge", name, lbls, v)
        for (name, lbls), (count, total) in snap["histograms"].items():
            add("histogram_count", name, lbls, count)
            add("histogram_sum", name, lbls, total)
            bounds, counts = snap["hist_buckets"][(name, lbls)]
            if count:
                from banyandb_tpu_torch.obs.metrics import quantile_from_buckets

                for q, kind in ((0.5, "histogram_p50"), (0.99, "histogram_p99")):
                    add(
                        kind, name, lbls,
                        quantile_from_buckets(bounds, counts, count, q),
                    )
        if points:
            self.engine.write(
                WriteRequest(self.GROUP, self.MEASURE, tuple(points)),
                _internal=True,
            )
        return len(points)
