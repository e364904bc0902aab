"""Self-trace sink: the dogfood half of the trace engine.

Slow/sampled query span trees — the same trees the slowlog's 128-entry
ring keeps transiently — are mirrored as PERSISTENT trace rows in the
``_monitoring.self_query`` trace model, written through the database's
own ``TraceEngine.write`` (standalone) or its cluster facades.  Each
span of a recorded tree becomes one row: ``trace_id`` is the query's
id, the span name lands in ``stage``, and the span duration (µs, INT)
is the sidx ordering key — so ``cli.py``/bydbql answer "slowest queries
last hour, stage breakdown, per tenant" from the database itself
(ORDER BY duration_us DESC), exercising the full trace query surface
on a built-in production workload.

Flag-gated OFF by default (``BYDB_SELF_TRACE``); the sampling threshold
``BYDB_SELF_TRACE_MS`` mirrors the slowlog's rule (0 records every
traced query the serving surface offers).  The sink NEVER blocks the
query path: ``offer()`` drops into a bounded in-memory queue and sheds
(counted by ``selftrace_dropped_total``) when full; a background
flusher (``bydb-self-trace``) writes batches on a cadence and counts
flushed rows in ``selftrace_spans_total``.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

from banyandb_tpu_torch.obs import metrics as obs_metrics
from banyandb_tpu_torch.utils.envflag import env_flag, env_float, env_int

GROUP = "_monitoring"
NAME = "self_query"


class SelfTraceSink:
    """Mirror query span trees into the DB's own trace model."""

    DEFAULT_INTERVAL_S = 5.0
    DEFAULT_QUEUE = 256

    def __init__(self, trace_engine, registry, *, node: str = "standalone"):
        self.engine = trace_engine
        self.registry = registry
        self.node = node
        self.enabled = env_flag("BYDB_SELF_TRACE", False)
        self.threshold_ms = env_float("BYDB_SELF_TRACE_MS", 0.0)
        self.interval_s = env_float(
            "BYDB_SELF_TRACE_INTERVAL_S", self.DEFAULT_INTERVAL_S
        )
        self.queue_cap = max(env_int("BYDB_SELF_TRACE_QUEUE", self.DEFAULT_QUEUE), 1)
        self._lock = threading.Lock()
        self._schema_lock = threading.Lock()
        self._queue: list[dict] = []
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._schema_ready = False

    # -- query-path half (must shed, never block) ---------------------------
    def offer(
        self,
        *,
        engine: str,
        group: str,
        name: str,
        duration_ms: float,
        tree: Optional[dict],
        tenant: str = "",
        ql: Optional[str] = None,
        query_id: Optional[str] = None,
    ) -> bool:
        """Enqueue one query's span tree for mirroring.  Returns True
        when queued.  Never raises, never blocks: a full queue sheds the
        NEW entry and counts it — backpressure on the telemetry loop
        must not become backpressure on queries."""
        if not self.enabled or not tree:
            return False
        if duration_ms < self.threshold_ms:
            return False
        if group == GROUP:
            # never re-record queries against the monitoring group
            # itself: reading self_query would otherwise grow it
            return False
        entry = {
            "query_id": query_id or uuid.uuid4().hex,
            "ts_millis": int(time.time() * 1000),
            "engine": engine,
            "name": name,
            "tenant": tenant,
            "tree": tree,
        }
        with self._lock:
            if len(self._queue) >= self.queue_cap:
                obs_metrics.global_meter().counter_add(
                    "selftrace_dropped", 1.0
                )
                return False
            self._queue.append(entry)
        return True

    # -- background half ----------------------------------------------------
    def _ensure_schema(self) -> None:
        if self._schema_ready:
            return
        with self._schema_lock:
            # double-checked: the background flusher and a snapshot's
            # synchronous flush may race here; registry ops run under
            # the schema lock, never the queue lock (offer() stays free)
            if self._schema_ready:
                return
            from banyandb_tpu_torch.api.schema import (
                Catalog,
                Group,
                ResourceOpts,
                TagSpec,
                TagType,
                Trace,
            )

            reg = self.registry
            try:
                reg.get_group(GROUP)
            except KeyError:
                # match SelfMeasureSink's group spec: both sinks share
                # `_monitoring`, whichever initializes first creates it
                reg.create_group(
                    Group(GROUP, Catalog.MEASURE, ResourceOpts(shard_num=1))
                )
            try:
                reg.get_trace(GROUP, NAME)
            except KeyError:
                reg.create_trace(
                    Trace(
                        group=GROUP,
                        name=NAME,
                        tags=(
                            TagSpec("trace_id", TagType.STRING),
                            TagSpec("name", TagType.STRING),
                            TagSpec("engine", TagType.STRING),
                            TagSpec("stage", TagType.STRING),
                            TagSpec("tenant", TagType.STRING),
                            TagSpec("node", TagType.STRING),
                            TagSpec("duration_us", TagType.INT),
                        ),
                        trace_id_tag="trace_id",
                    )
                )
            self._schema_ready = True

    def start(self) -> None:
        """Run the background flusher (idempotent; no-op when the flag
        is off — the flag-off path must stay byte-identical)."""
        if not self.enabled or self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="bydb-self-trace", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - the sink must not die with
                # a transient engine error (e.g. mid-shutdown write refusal)
                import logging

                logging.getLogger(__name__).exception("self-trace flush failed")

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None

    def flush(self) -> int:
        """Drain the queue into `_monitoring.self_query` (one row per
        span, duration_us maintained in the sidx ordered index).
        Returns the number of span rows written."""
        if not self.enabled:
            return 0
        with self._lock:
            entries, self._queue = self._queue, []
        if not entries:
            return 0
        from banyandb_tpu_torch.models.trace import SpanValue
        from banyandb_tpu_torch.obs.tracer import iter_spans

        self._ensure_schema()
        spans = []
        for e in entries:
            for sp in iter_spans(e["tree"]):
                spans.append(
                    SpanValue(
                        ts_millis=e["ts_millis"],
                        tags={
                            "trace_id": e["query_id"],
                            "name": e["name"],
                            "engine": e["engine"],
                            "stage": sp.get("name", ""),
                            "tenant": e["tenant"],
                            "node": self.node,
                            "duration_us": int(
                                float(sp.get("duration_ms", 0.0)) * 1000
                            ),
                        },
                        span=b"",
                    )
                )
        if spans:
            self.engine.write(
                GROUP, NAME, spans, ordered_tags=("duration_us",)
            )
            obs_metrics.global_meter().counter_add(
                "selftrace_spans", float(len(spans))
            )
        return len(spans)
