"""Schema objects + registry.

Vocabulary parity with the reference's database/v1 schema protos
(api/proto/banyandb/database/v1/schema.proto: Measure, TagSpec, FieldSpec,
Entity, IndexRule, TopNAggregation; common/v1/common.proto: Group,
ResourceOpts, IntervalRule).  The registry is the analog of the
property-backed schema server (banyand/metadata/schema/schemaserver/) in
single-process form: in-memory maps with mod-revision semantics, persisted
as JSON files under <root>/schema/ via atomic writes.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from banyandb_tpu_torch.utils import fs


class Catalog(enum.Enum):
    MEASURE = "measure"
    STREAM = "stream"
    TRACE = "trace"
    PROPERTY = "property"


class TagType(enum.Enum):
    STRING = "string"
    INT = "int"
    STRING_ARRAY = "string_array"
    INT_ARRAY = "int_array"
    DATA_BINARY = "data_binary"
    TIMESTAMP = "timestamp"


class FieldType(enum.Enum):
    STRING = "string"
    INT = "int"
    FLOAT = "float"
    DATA_BINARY = "data_binary"


@dataclass(frozen=True)
class TagSpec:
    name: str
    type: TagType


@dataclass(frozen=True)
class FieldSpec:
    name: str
    type: FieldType
    # encoding/compression method knobs from the reference are implied by
    # type here: INT -> delta+zstd, FLOAT -> decimal-mantissa+delta+zstd.


@dataclass(frozen=True)
class Entity:
    """Which tags form the series identity (database/v1 Entity)."""

    tag_names: tuple[str, ...]


@dataclass(frozen=True)
class IntervalRule:
    """common/v1 IntervalRule: a duration expressed as <num><unit>."""

    num: int
    unit: str  # "hour" | "day"

    @property
    def millis(self) -> int:
        return self.num * (3_600_000 if self.unit == "hour" else 86_400_000)


@dataclass(frozen=True)
class ResourceOpts:
    """common/v1 ResourceOpts: sharding/replication/retention per group."""

    shard_num: int = 1
    replicas: int = 0
    segment_interval: IntervalRule = IntervalRule(1, "day")
    ttl: IntervalRule = IntervalRule(7, "day")
    stages: tuple[str, ...] = ()  # hot/warm/cold tier names


@dataclass(frozen=True)
class Group:
    name: str
    catalog: Catalog
    resource_opts: ResourceOpts = ResourceOpts()


@dataclass(frozen=True)
class Measure:
    """database/v1 Measure: tag families + fields keyed by entity."""

    group: str
    name: str
    tags: tuple[TagSpec, ...]
    fields: tuple[FieldSpec, ...]
    entity: Entity
    interval: str = ""  # data-point interval hint (e.g. "1m")
    index_mode: bool = False  # index-mode measures live in the series index
    # wire-API family layout: ordered (family_name, tag_count) runs over
    # the flat `tags` tuple (database/v1 TagFamilySpec); empty = one
    # implicit "default" family
    tag_families: tuple[tuple[str, int], ...] = ()

    def tag(self, name: str) -> TagSpec:
        for t in self.tags:
            if t.name == name:
                return t
        raise KeyError(f"tag {name} not in measure {self.name}")

    def field(self, name: str) -> FieldSpec:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"field {name} not in measure {self.name}")


@dataclass(frozen=True)
class Stream:
    """database/v1 Stream schema: tagged append-only elements, no fields."""

    group: str
    name: str
    tags: tuple[TagSpec, ...]
    entity: tuple[str, ...]
    tag_families: tuple[tuple[str, int], ...] = ()  # see Measure.tag_families

    def tag(self, name: str) -> TagSpec:
        for t in self.tags:
            if t.name == name:
                return t
        raise KeyError(f"tag {name} not in stream {self.name}")


@dataclass(frozen=True)
class Trace:
    """database/v1 Trace schema: spans keyed by a trace-id tag."""

    group: str
    name: str
    tags: tuple[TagSpec, ...]
    trace_id_tag: str
    timestamp_tag: str = ""
    span_id_tag: str = ""  # schema.proto Trace.span_id_tag_name

    def tag(self, name: str) -> TagSpec:
        for t in self.tags:
            if t.name == name:
                return t
        raise KeyError(f"tag {name} not in trace {self.name}")


@dataclass(frozen=True)
class PropertySchema:
    """database/v1 Property schema (schema.proto:224): the declared tag
    set of a property namespace — registered via PropertyRegistryService,
    distinct from property VALUES (property/v1 Apply/Query)."""

    group: str
    name: str
    tags: tuple[TagSpec, ...]


@dataclass(frozen=True)
class IndexRule:
    """database/v1 IndexRule: which tags get inverted/skipping/tree index."""

    group: str
    name: str
    tags: tuple[str, ...]
    type: str = "inverted"  # inverted | skipping | tree
    analyzer: str = ""


@dataclass(frozen=True)
class IndexRuleBinding:
    """database/v1 IndexRuleBinding: which rules apply to which subject
    over a validity window."""

    group: str
    name: str
    rules: tuple[str, ...]
    subject_catalog: str  # stream | measure | trace
    subject_name: str
    begin_at_millis: int = 0
    expire_at_millis: int = 0


@dataclass(frozen=True)
class TopNAggregation:
    """database/v1 TopNAggregation: ingest-time streaming top-N source."""

    group: str
    name: str
    source_measure: str
    field_name: str
    field_value_sort: str = "desc"  # desc | asc | all
    group_by_tag_names: tuple[str, ...] = ()
    counters_number: int = 1000
    lru_size: int = 10
    # group of the source measure when it differs from the rule's group
    # ("" = same group); wire Get/List must round-trip this faithfully
    source_group: str = ""
    # optional ingest-time filter (database/v1 TopNAggregation.criteria):
    # only source rows matching it feed the windows.  Stored as the
    # protobuf-JSON dict of the model/v1 Criteria (registry persistence
    # stays plain JSON); None = no filter.
    criteria: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class TracePipelineConfig:
    """pipeline/v1 TracePipelineConfig: group-scoped, name-less tail-
    sampling config (one per group by construction — common.proto:156).
    The proto body is stored as canonical protobuf-JSON: the registry
    versions/persists/gossips it; the trace engine interprets it."""

    group: str
    config_json: str = "{}"

    @property
    def name(self) -> str:  # registry key: one config per group
        return "_pipeline"


_KINDS = {
    "group": Group,
    "measure": Measure,
    "stream": Stream,
    "trace": Trace,
    "property_schema": PropertySchema,
    "index_rule": IndexRule,
    "index_rule_binding": IndexRuleBinding,
    "topn": TopNAggregation,
    "trace_pipeline": TracePipelineConfig,
}


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj):
        return {
            f.name: _to_jsonable(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, tuple):
        return [_to_jsonable(x) for x in obj]
    return obj


def _from_jsonable(cls, data):
    if dataclasses.is_dataclass(cls):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in data:
                kwargs[f.name] = _from_jsonable_field(f.type, data[f.name])
        return cls(**kwargs)
    return data


_FIELD_TYPES = {
    "Catalog": Catalog,
    "TagType": TagType,
    "FieldType": FieldType,
    "tuple[TagSpec, ...]": (tuple, "TagSpec"),
    "tuple[FieldSpec, ...]": (tuple, "FieldSpec"),
    "tuple[str, ...]": (tuple, None),
    "tuple[tuple[str, int], ...]": (tuple, "pair"),
    "Entity": Entity,
    "IntervalRule": IntervalRule,
    "ResourceOpts": ResourceOpts,
}
_CLASSES = {
    "TagSpec": TagSpec,
    "FieldSpec": FieldSpec,
}


def _from_jsonable_field(type_str, value):
    spec = _FIELD_TYPES.get(type_str)
    if spec is None:
        return value
    if isinstance(spec, tuple):
        _, inner = spec
        if inner is None:
            return tuple(value)
        if inner == "pair":
            return tuple(tuple(v) for v in value)
        return tuple(_from_jsonable(_CLASSES[inner], v) for v in value)
    if isinstance(spec, type) and issubclass(spec, enum.Enum):
        return spec(value)
    return _from_jsonable(spec, value)


class SchemaRegistry:
    """Mod-revisioned schema store with optional file persistence.

    CRUD semantics mirror the reference's registry services
    (banyand/liaison/grpc/registry.go): create/update bump a global
    revision; deletes are recorded; watchers (engines) are notified
    synchronously in-process.
    """

    def __init__(self, root: Optional[str | Path] = None):
        self._lock = threading.RLock()
        self._root = Path(root) / "schema" if root else None
        self._revision = 0
        self._store: dict[str, dict[str, object]] = {k: {} for k in _KINDS}
        # per-object local revisions (barrier freshness checks); persisted
        # alongside the objects so min_revision barriers remain truthful
        # across restarts (pre-persistence files load as rev 0, and the
        # cluster barrier additionally matches by content hash)
        self._obj_revs: dict[tuple[str, str], int] = {}
        # content hashes cached at put/load time (objects are frozen
        # dataclasses) so digests() is a dict copy, not an O(n) hash
        # pass under the lock
        self._obj_hashes: dict[tuple[str, str], str] = {}
        # delete tombstones (key -> buried content hash), PERSISTED:
        # gossip must propagate deletions instead of resurrecting deleted
        # objects from lagging peers; the hash scopes the grave to the
        # EXACT deleted content, so a recreate with different content
        # gossips normally
        self._tombstones: dict[str, dict[str, str]] = {k: {} for k in _KINDS}
        self._watchers: list = []
        self._delete_watchers: list = []
        # watcher callbacks run OUTSIDE self._lock (they may persist to
        # disk / broadcast); events queue under the lock and drain FIFO
        # under _notify_lock, so observers still see revision order
        self._pending_events: collections.deque = collections.deque()
        self._notify_lock = threading.Lock()
        if self._root and self._root.exists():
            self._load()

    # -- internals ---------------------------------------------------------
    def _key(self, obj) -> str:
        group = getattr(obj, "group", None)
        return f"{group}/{obj.name}" if group else obj.name

    def _persist(self, kind: str) -> None:
        if not self._root:
            return
        payload = {k: _to_jsonable(v) for k, v in self._store[kind].items()}
        fs.atomic_write_json(
            self._root / f"{kind}.json",
            {
                "revision": self._revision,
                "items": payload,
                # per-object revisions persist so barrier min_revision
                # checks stay truthful across restarts
                "revs": {
                    k: self._obj_revs.get((kind, k), 0)
                    for k in self._store[kind]
                },
            },
        )

    def _load(self) -> None:
        for kind, cls in _KINDS.items():
            path = self._root / f"{kind}.json"
            if not path.exists():
                continue
            data = fs.read_json(path)
            self._revision = max(self._revision, data.get("revision", 0))
            revs = data.get("revs", {})
            for key, item in data.get("items", {}).items():
                obj = _from_jsonable(cls, item)
                self._store[kind][key] = obj
                self._obj_hashes[(kind, key)] = self.object_hash(obj)
                if revs.get(key):
                    self._obj_revs[(kind, key)] = revs[key]
        tpath = self._root / "tombstones.json"
        if tpath.exists():
            data = fs.read_json(tpath)
            for kind, graves in data.items():
                if kind in self._tombstones and isinstance(graves, dict):
                    self._tombstones[kind] = dict(graves)

    def _persist_tombstones(self) -> None:
        if self._root:
            fs.atomic_write_json(
                self._root / "tombstones.json", self._tombstones
            )

    def _drain_events(self) -> None:
        """Deliver queued watcher events in FIFO order.  Whoever holds
        _notify_lock drains everything pending; a mutator returning from
        _put/_delete is guaranteed its own event has been delivered
        (by itself or by a concurrent drainer)."""
        with self._notify_lock:
            while True:
                try:
                    op, kind, payload, rev = self._pending_events.popleft()
                except IndexError:
                    return
                targets = (
                    self._watchers if op == "put" else self._delete_watchers
                )
                for w in targets:
                    w(kind, payload, rev)

    def _put(self, kind: str, obj, *, exclusive: bool = False) -> int:
        with self._lock:
            key = self._key(obj)
            if exclusive and key in self._store[kind]:
                # atomic create-if-absent: the existence check must live
                # under the same lock as the insert (concurrent Creates)
                raise FileExistsError(f"{kind} {key} already exists")
            self._revision += 1
            self._store[kind][key] = obj
            self._obj_revs[(kind, key)] = self._revision
            self._obj_hashes[(kind, key)] = self.object_hash(obj)
            if self._tombstones[kind].pop(key, None) is not None:
                # recreate clears the grave
                self._persist_tombstones()
            self._persist(kind)
            rev = self._revision
            self._pending_events.append(("put", kind, obj, rev))
        self._drain_events()
        return rev

    def _get(self, kind: str, key: str):
        with self._lock:
            obj = self._store[kind].get(key)
            if obj is None:
                raise KeyError(f"{kind} {key} not found")
            return obj

    def _delete(self, kind: str, key: str) -> None:
        with self._lock:
            if key not in self._store[kind]:
                raise KeyError(f"{kind} {key} not found")
            self._revision += 1
            buried = self._obj_hashes.pop((kind, key), None) or self.object_hash(
                self._store[kind][key]
            )
            del self._store[kind][key]
            self._tombstones[kind][key] = buried
            self._persist(kind)
            self._persist_tombstones()
            self._pending_events.append(("delete", kind, key, self._revision))
        self._drain_events()

    # -- public CRUD (parity with the 9 registry services) -----------------
    @property
    def revision(self) -> int:
        return self._revision

    @staticmethod
    def object_hash(obj) -> str:
        """Content hash of one schema object (barrier ack verification —
        revisions are per-node counters, so equality of numbers proves
        nothing; equality of content does)."""
        import hashlib
        import json as _json

        payload = _json.dumps(_to_jsonable(obj), sort_keys=True)
        return hashlib.blake2b(payload.encode(), digest_size=16).hexdigest()

    def digests(self) -> dict[str, dict[str, str]]:
        """{kind: {key: content-hash}} over the whole store — the gossip
        reconciliation unit (pkg/schema cache sync analog).  Hashes are
        cached at put/load time, so this is a dict copy under the lock."""
        with self._lock:
            return {
                kind: {
                    k: self._obj_hashes.get((kind, k)) or self.object_hash(o)
                    for k, o in objs.items()
                }
                for kind, objs in self._store.items()
            }

    def tombstones(self) -> dict[str, dict[str, str]]:
        with self._lock:
            return {k: dict(v) for k, v in self._tombstones.items()}

    def apply_tombstone(self, kind: str, key: str, buried_hash: str) -> bool:
        """Gossip-propagated deletion: remove the local object ONLY if
        its content matches what the peer buried (differing content means
        a newer create, which must survive); records the grave either
        way so this node stops offering the dead content.  Returns True
        when something was deleted."""
        with self._lock:
            local_hash = self._obj_hashes.get((kind, key))
            existed = key in self._store[kind]
            if existed and local_hash != buried_hash:
                return False  # newer content under the same key: keep it
            if existed:
                self._revision += 1
                del self._store[kind][key]
                self._obj_hashes.pop((kind, key), None)
                self._persist(kind)
                # gossip deletions notify delete watchers like local ones:
                # a property-backed store must bury its doc too, or the
                # deleted schema resurrects from replay on restart
                self._pending_events.append(
                    ("delete", kind, key, self._revision)
                )
            self._tombstones[kind][key] = buried_hash
            self._persist_tombstones()
        self._drain_events()
        return existed

    def export_object(self, kind: str, key: str) -> Optional[dict]:
        """JSON-able form of one stored object (gossip pull)."""
        with self._lock:
            obj = self._store[kind].get(key)
        return None if obj is None else _to_jsonable(obj)

    def stored_object_hash(self, kind: str, key: str) -> dict:
        """-> {hash, rev}: rev is this node's LOCAL per-object revision
        (persisted with the object; 0 only for pre-persistence files —
        cluster barriers still verify by content hash, never by trusting
        another node's counters)."""
        with self._lock:
            present = key in self._store[kind]
            h = self._obj_hashes.get((kind, key)) if present else None
            if present and h is None:
                h = self.object_hash(self._store[kind][key])
            rev = self._obj_revs.get((kind, key), 0)
        return {"hash": h, "rev": rev}

    def watch(self, callback) -> None:
        """callback(kind, obj, revision) on every create/update."""
        self._watchers.append(callback)

    def watch_deletes(self, callback) -> None:
        """callback(kind, key, revision) on every delete."""
        self._delete_watchers.append(callback)

    def create_group(self, g: Group) -> int:
        return self._put("group", g)

    def get_group(self, name: str) -> Group:
        return self._get("group", name)

    def list_groups(self) -> list[Group]:
        return list(self._store["group"].values())

    def delete_group(self, name: str) -> None:
        if name.startswith("_"):
            # internal groups (e.g. _schema, the registry's own property
            # backing store) must not be deletable: dropping _schema would
            # break every subsequent schema mutation's persistence
            raise ValueError(f"group {name} is internal and cannot be deleted")
        # cascade: child resources die with the group (the reference
        # orchestrates this in liaison/grpc/deletion.go) — otherwise they
        # orphan and resurrect when the group name is reused
        for kind in _KINDS:
            if kind == "group":
                continue
            doomed = [
                key
                for key, obj in self._store[kind].items()
                if getattr(obj, "group", None) == name
            ]
            for key in doomed:
                self._delete(kind, key)
        self._delete("group", name)

    def create_measure(self, m: Measure) -> int:
        self.get_group(m.group)  # must exist
        return self._put("measure", m)

    def get_measure(self, group: str, name: str) -> Measure:
        return self._get("measure", f"{group}/{name}")

    def list_measures(self, group: str) -> list[Measure]:
        return [
            m for m in self._store["measure"].values() if m.group == group
        ]

    def delete_measure(self, group: str, name: str) -> None:
        self._delete("measure", f"{group}/{name}")

    def create_stream(self, s: Stream) -> int:
        self.get_group(s.group)
        return self._put("stream", s)

    def get_stream(self, group: str, name: str) -> Stream:
        return self._get("stream", f"{group}/{name}")

    def list_streams(self, group: str) -> list[Stream]:
        return [s for s in self._store["stream"].values() if s.group == group]

    def delete_stream(self, group: str, name: str) -> None:
        self._delete("stream", f"{group}/{name}")

    def delete_trace(self, group: str, name: str) -> None:
        self._delete("trace", f"{group}/{name}")

    def create_trace(self, t: Trace) -> int:
        self.get_group(t.group)
        return self._put("trace", t)

    def get_trace(self, group: str, name: str) -> Trace:
        return self._get("trace", f"{group}/{name}")

    def create_property_schema(self, p: PropertySchema) -> int:
        self.get_group(p.group)
        return self._put("property_schema", p)

    def get_property_schema(self, group: str, name: str) -> PropertySchema:
        return self._get("property_schema", f"{group}/{name}")

    def list_property_schemas(self, group: str) -> list[PropertySchema]:
        return [
            p
            for p in self._store["property_schema"].values()
            if p.group == group
        ]

    def delete_property_schema(self, group: str, name: str) -> None:
        self._delete("property_schema", f"{group}/{name}")

    def list_traces(self, group: str) -> list[Trace]:
        return [t for t in self._store["trace"].values() if t.group == group]

    def create_index_rule(self, r: IndexRule) -> int:
        return self._put("index_rule", r)

    def get_index_rule(self, group: str, name: str) -> IndexRule:
        return self._get("index_rule", f"{group}/{name}")

    def delete_index_rule(self, group: str, name: str) -> None:
        self._delete("index_rule", f"{group}/{name}")

    def list_index_rules(self, group: str) -> list[IndexRule]:
        return [
            r for r in self._store["index_rule"].values() if r.group == group
        ]

    def create_index_rule_binding(self, b: IndexRuleBinding) -> int:
        return self._put("index_rule_binding", b)

    def get_index_rule_binding(self, group: str, name: str) -> IndexRuleBinding:
        return self._get("index_rule_binding", f"{group}/{name}")

    def delete_index_rule_binding(self, group: str, name: str) -> None:
        self._delete("index_rule_binding", f"{group}/{name}")

    def list_index_rule_bindings(self, group: str) -> list[IndexRuleBinding]:
        return [
            b
            for b in self._store["index_rule_binding"].values()
            if b.group == group
        ]

    def create_trace_pipeline(
        self, c: TracePipelineConfig, *, exclusive: bool = False
    ) -> int:
        return self._put("trace_pipeline", c, exclusive=exclusive)

    def get_trace_pipeline(self, group: str) -> TracePipelineConfig:
        return self._get("trace_pipeline", f"{group}/_pipeline")

    def delete_trace_pipeline(self, group: str) -> None:
        self._delete("trace_pipeline", f"{group}/_pipeline")

    def list_trace_pipelines(self, group: str) -> list[TracePipelineConfig]:
        return [
            c
            for c in self._store["trace_pipeline"].values()
            if c.group == group
        ]

    def create_topn(self, t: TopNAggregation) -> int:
        return self._put("topn", t)

    def get_topn(self, group: str, name: str) -> TopNAggregation:
        return self._get("topn", f"{group}/{name}")

    def delete_topn(self, group: str, name: str) -> None:
        self._delete("topn", f"{group}/{name}")

    def list_topn(self, group: str) -> list[TopNAggregation]:
        return [t for t in self._store["topn"].values() if t.group == group]
