"""Property-backed schema registry + event-driven watch plane.

The reference's metadata registry IS its Property engine: schema docs are
stored as properties by a schema server
(banyand/metadata/schema/schemaserver/service.go,
banyand/metadata/schema/property/client.go) and every node keeps an
event-driven schema cache fed by a WatchSchemas stream with retry
(pkg/schema/cache.go:275, api/proto/banyandb/schema/v1/internal.proto:79).

This module is this package's equivalent:

- PropertySchemaStore: dogfoods PropertyEngine as the registry's durable
  store.  Every registry create/update/delete lands as a property doc in
  the internal "_schema" group; on restart the registry replays from the
  property store.  One storage system, as upstream.
- WatchHub: in-process fan-out of schema events to any number of
  subscribed streams (schemaserver/watcher.go analog: bounded queues,
  slow watchers drop events and must re-sync).
- LiaisonBarrier: the SchemaBarrierService semantics over the
  in-process liaison (await a revision, applied keys, deleted keys).

The node-side watch client of the JAX package (``SchemaWatchClient``,
the WatchSchemas gRPC stream) comes with the gRPC transport.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time

from banyandb_tpu_torch.api import schema as schema_mod
from banyandb_tpu_torch.models.property import Property

log = logging.getLogger("banyandb.schemaplane")

SCHEMA_GROUP = "_schema"

# SchemaBarrierService key kinds (schema/v1/barrier.proto:46) -> registry
# kinds; the JAX package keeps this table in its gRPC wire server
_BARRIER_KINDS = {
    "measure": "measure",
    "stream": "stream",
    "trace": "trace",
    "property": "property_schema",
    "index_rule": "index_rule",
    "index_rule_binding": "index_rule_binding",
    "group": "group",
    "top_n_aggregation": "topn",
}

# wire enum values (schema/v1/internal.proto SchemaEventType)
EVENT_INSERT = 1
EVENT_UPDATE = 2
EVENT_DELETE = 3
EVENT_REPLAY_DONE = 4

_QUEUE_SIZE = 512


class WatchHub:
    """Bounded fan-out of schema events (watcher.go:Broadcast analog:
    a full subscriber queue drops the event — the stream layer then owes
    the subscriber a re-sync, which a watch client does by
    reconnecting)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict[int, queue.Queue] = {}
        self._dead: set[int] = set()
        self._next = 0

    def subscribe(self) -> tuple[int, queue.Queue]:
        with self._lock:
            self._next += 1
            q: queue.Queue = queue.Queue(maxsize=_QUEUE_SIZE)
            self._subs[self._next] = q
            return self._next, q

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)
            self._dead.discard(sid)

    def is_dead(self, sid: int) -> bool:
        with self._lock:
            return sid in self._dead

    def broadcast(self, event: dict) -> None:
        with self._lock:
            subs = [
                (sid, q) for sid, q in self._subs.items()
                if sid not in self._dead
            ]
        for sid, q in subs:
            try:
                q.put_nowait(event)
            except queue.Full:
                # a lossy stream must DIE so the client re-syncs via
                # reconnect replay — silently dropping one event would
                # leave the node's cache stale forever
                with self._lock:
                    self._dead.add(sid)
                log.warning(
                    "schema watcher %d queue full; terminating its stream",
                    sid,
                )


class PropertySchemaStore:
    """Registry persistence through the Property engine.

    Wiring order matters: construct with a registry whose file
    persistence is off (root=None) — the property store is then the one
    durable home of schema docs.  A registry with its own root still
    works (both stores stay consistent), which eases migration.
    """

    def __init__(self, registry, property_engine):
        self.registry = registry
        self.prop = property_engine
        self.hub = WatchHub()
        self._replaying = False
        self._ensure_group()
        self._replay_into_registry()
        registry.watch(self._on_put)
        registry.watch_deletes(self._on_delete)

    # -- bootstrap ---------------------------------------------------------
    def _ensure_group(self) -> None:
        try:
            self.registry.get_group(SCHEMA_GROUP)
        except KeyError:
            self._replaying = True  # group creation precedes watcher wiring,
            try:  # but stay safe if called twice
                self.registry.create_group(
                    schema_mod.Group(
                        SCHEMA_GROUP,
                        schema_mod.Catalog.PROPERTY,
                        schema_mod.ResourceOpts(shard_num=1),
                    )
                )
            finally:
                self._replaying = False

    def _replay_into_registry(self) -> None:
        """Load every persisted schema doc back into the registry (restart
        path: the property shards reload from disk lazily)."""
        self._replaying = True
        try:
            for kind, cls in schema_mod._KINDS.items():
                for doc in self.prop.query(SCHEMA_GROUP, kind, limit=100000):
                    payload = json.loads(doc.tags["payload"])
                    obj = schema_mod._from_jsonable(cls, payload)
                    key = self.registry._key(obj)
                    if self.registry._store[kind].get(key) != obj:
                        self.registry._put(kind, obj)
        finally:
            self._replaying = False

    # -- registry hooks ----------------------------------------------------
    def _on_put(self, kind: str, obj, revision: int) -> None:
        if self._replaying:
            return
        key = self.registry._key(obj)
        payload = json.dumps(schema_mod._to_jsonable(obj), sort_keys=True)
        self.prop.apply(
            Property(
                group=SCHEMA_GROUP,
                name=kind,
                id=key,
                tags={"payload": payload},
            ),
            strategy="replace",
        )
        self.prop.persist_group(SCHEMA_GROUP)
        self.hub.broadcast(
            {
                "type": EVENT_UPDATE,
                "kind": kind,
                "key": key,
                "payload": payload,
                "revision": revision,
            }
        )

    def _on_delete(self, kind: str, key: str, revision: int) -> None:
        if self._replaying:
            return
        self.prop.delete(SCHEMA_GROUP, kind, key)
        self.prop.persist_group(SCHEMA_GROUP)
        self.hub.broadcast(
            {
                "type": EVENT_DELETE,
                "kind": kind,
                "key": key,
                "payload": "",
                "revision": revision,
            }
        )

    # -- snapshot for stream replay ---------------------------------------
    def replay_events(self) -> list[dict]:
        """Current schema set as INSERT events + REPLAY_DONE marker."""
        out = []
        digests = self.registry.digests()
        for kind in schema_mod._KINDS:
            for key in digests.get(kind, {}):
                payload = self.registry.export_object(kind, key)
                if payload is None:
                    continue
                out.append(
                    {
                        "type": EVENT_INSERT,
                        "kind": kind,
                        "key": key,
                        "payload": json.dumps(payload, sort_keys=True),
                        "revision": self.registry.revision,
                    }
                )
        out.append({"type": EVENT_REPLAY_DONE})
        return out


def apply_event(registry, ev: dict) -> None:
    """Apply one watch event to a local registry (cache.go handler)."""
    kind = ev.get("kind", "")
    cls = schema_mod._KINDS.get(kind)
    if cls is None:
        return
    if ev["type"] in (EVENT_INSERT, EVENT_UPDATE):
        obj = schema_mod._from_jsonable(cls, json.loads(ev["payload"]))
        key = registry._key(obj)
        if registry._store[kind].get(key) != obj:
            registry._put(kind, obj)
    elif ev["type"] == EVENT_DELETE:
        try:
            registry._delete(kind, ev["key"])
        except KeyError:
            pass


class LiaisonBarrier:
    """Cluster SchemaBarrierService backend: verifies every alive data
    node serves each key at the liaison registry's CURRENT content hash
    (barrier.proto semantics over the bus SCHEMA_GET topic — content is
    the truth, never node-local counters; liaison.schema_barrier uses
    the same rule for push acks)."""

    def __init__(self, liaison):
        self.liaison = liaison

    @property
    def _registry(self):
        return self.liaison.registry

    def _nodes(self):
        return [
            n for n in self.liaison.selector.nodes
            if n.name in self.liaison.alive
        ]

    def _poll(self, timeout_s: float, check):
        deadline = time.monotonic() + timeout_s
        while True:
            laggards = check()
            if not laggards or time.monotonic() >= deadline:
                return (not laggards), laggards
            time.sleep(0.05)

    def await_revision(self, min_revision: int, timeout_s: float):
        """Liaison registry is the source of truth for the revision
        counter; data nodes must then match its content for every key."""
        if self._registry.revision < min_revision:
            return False, [
                {
                    "node": "liaison",
                    "current_mod_revision": self._registry.revision,
                }
            ]
        digests = self._registry.digests()
        keys, revs = [], []
        inv = {v: k for k, v in _BARRIER_KINDS.items()}
        for kind, objs in digests.items():
            for key in objs:
                group, _, name = key.rpartition("/")
                keys.append((inv.get(kind, kind), group, name))
                revs.append(0)
        return self.await_applied(keys, revs, timeout_s)

    def await_applied(self, keys, min_revisions, timeout_s: float):
        from banyandb_tpu_torch.cluster.bus import Topic
        from banyandb_tpu_torch.cluster.rpc import TransportError

        addr_of = {n.name: n.addr for n in self.liaison.selector.nodes}

        def check():
            want = []
            for kind, group, name in keys:
                rkind = _BARRIER_KINDS.get(kind)
                if rkind is None:
                    raise ValueError(f"unknown schema kind {kind!r}")
                key = name if rkind == "group" else f"{group}/{name}"
                local = self._registry.stored_object_hash(rkind, key)
                want.append((kind, group, name, rkind, key, local["hash"]))
            laggards = []
            missing_local = [
                (k, g, n) for k, g, n, _rk, _key, h in want if h is None
            ]
            if missing_local:
                laggards.append(
                    {
                        "node": "liaison",
                        "current_mod_revision": self._registry.revision,
                        "missing_keys": missing_local,
                    }
                )
            for node in self._nodes():
                missing = []
                for kind, group, name, rkind, key, h in want:
                    if h is None:
                        continue
                    try:
                        r = self.liaison.transport.call(
                            addr_of[node.name],
                            Topic.SCHEMA_GET.value,
                            {"kind": rkind, "key": key},
                            timeout=5,
                        )
                    except TransportError:
                        missing.append((kind, group, name))
                        continue
                    if r.get("hash") != h:
                        missing.append((kind, group, name))
                if missing:
                    laggards.append(
                        {
                            "node": node.name,
                            "current_mod_revision": 0,
                            "missing_keys": missing,
                        }
                    )
            return laggards

        return self._poll(timeout_s, check)

    def await_deleted(self, keys, timeout_s: float):
        from banyandb_tpu_torch.cluster.bus import Topic
        from banyandb_tpu_torch.cluster.rpc import TransportError

        addr_of = {n.name: n.addr for n in self.liaison.selector.nodes}

        def check():
            laggards = []
            for node in [{"name": "liaison", "addr": None}] + [
                {"name": n.name, "addr": addr_of[n.name]}
                for n in self._nodes()
            ]:
                present = []
                for kind, group, name in keys:
                    rkind = _BARRIER_KINDS.get(kind)
                    if rkind is None:
                        raise ValueError(f"unknown schema kind {kind!r}")
                    key = name if rkind == "group" else f"{group}/{name}"
                    if node["addr"] is None:
                        h = self._registry.stored_object_hash(rkind, key)["hash"]
                    else:
                        try:
                            h = self.liaison.transport.call(
                                node["addr"],
                                Topic.SCHEMA_GET.value,
                                {"kind": rkind, "key": key},
                                timeout=5,
                            ).get("hash")
                        except TransportError:
                            h = "unreachable"
                    if h is not None:
                        present.append((kind, group, name))
                if present:
                    laggards.append(
                        {
                            "node": node["name"],
                            "current_mod_revision": 0,
                            "still_present_keys": present,
                        }
                    )
            return laggards

        return self._poll(timeout_s, check)
