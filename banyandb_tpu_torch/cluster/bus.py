"""Typed topic bus (pkg/bus analog).

Topics carry JSON-serializable envelopes; handlers are registered per
topic and return reply payloads.  The bus is the single dispatch surface
both transports target: LocalTransport calls handle() in-process, the
gRPC server calls the same handle() from its service method.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable


class Topic(str, enum.Enum):
    # write plane (api/data/data.go topic registry analog)
    MEASURE_WRITE = "measure-write"
    # columnar write envelope: base64-packed ts/field arrays +
    # optionally dictionary-encoded tag columns — the wire shape of the
    # vectorized ingest path (10x less per-point JSON than MEASURE_WRITE)
    MEASURE_WRITE_COLUMNS = "measure-write-cols"
    STREAM_WRITE = "stream-write"
    TRACE_WRITE = "trace-write"
    PROPERTY_APPLY = "property-apply"
    # query plane
    MEASURE_QUERY_PARTIAL = "measure-query-partial"
    MEASURE_QUERY_RAW = "measure-query-raw"
    STREAM_QUERY = "stream-query"
    TRACE_QUERY_BY_ID = "trace-query-by-id"
    TRACE_QUERY_ORDERED = "trace-query-ordered"
    # full trace query surface: criteria/projection/order-by QueryRequest
    # scattered per shard set, span rows + sidx keys back
    TRACE_QUERY_EXEC = "trace-query-exec"
    PROPERTY_QUERY = "property-query"
    # schema + control plane
    SCHEMA_SYNC = "schema-sync"
    SCHEMA_GET = "schema-get"  # barrier verification: per-object hash
    HEALTH = "health"
    # chunked part sync (cluster/v1/rpc.proto SyncPart analog)
    SYNC_PART = "sync-part"


Handler = Callable[[dict], dict]


class LocalBus:
    """Topic -> handler registry with thread-safe dispatch."""

    def __init__(self):
        self._handlers: dict[str, Handler] = {}
        self._lock = threading.Lock()

    def subscribe(self, topic: "Topic | str", handler: Handler) -> None:
        with self._lock:
            key = topic.value if isinstance(topic, Topic) else topic
            self._handlers[key] = handler

    def handle(self, topic: str, envelope: dict) -> dict:
        h = self._handlers.get(topic)
        if h is None:
            raise KeyError(f"no handler for topic {topic}")
        return h(envelope)

    def topics(self) -> list[str]:
        """Registered topic names (HealthCheck's service inventory)."""
        with self._lock:
            return list(self._handlers)
