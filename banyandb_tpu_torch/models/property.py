"""Property engine: mutable documents with ModRevision semantics.

Analog of banyand/property (db/shard.go doc fields _source/_id/_timestamp,
etcd-style ModRevision, update = overwrite + tombstone semantics at merge).
Backed by one InvertedIndex per (group, shard) — the same backing choice
as the reference's per-(group,shard) Bluge store — and, like the
reference, this is also the store the schema registry rides on.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from banyandb_tpu_torch.api.schema import SchemaRegistry
from banyandb_tpu_torch.index.inverted import And, Doc, InvertedIndex, Query, TermQuery
from banyandb_tpu_torch.obs import metrics as obs_metrics
from banyandb_tpu_torch.utils import hashing

_H_QUERY_PROPERTY = obs_metrics.global_meter().histogram(
    "query_ms", {"engine": "property"}
)


@dataclass(frozen=True)
class Property:
    """property/v1 Property analog."""

    group: str
    name: str
    id: str
    tags: dict  # tag name -> str value
    mod_revision: int = 0
    create_revision: int = 0


class PropertyEngine:
    def __init__(self, registry: SchemaRegistry, root: str | Path):
        self.registry = registry
        self.root = Path(root) / "property"
        self._lock = threading.Lock()
        self._shards: dict[tuple[str, int], InvertedIndex] = {}
        self._revision = int(time.time() * 1000)

    def close(self) -> None:
        """Persist + release every shard index's memory and mmaps (bdsan
        fd hygiene; indexes lazily reopen on next use)."""
        with self._lock:
            shards = list(self._shards.values())
        for idx in shards:
            idx.reclaim()

    def _shard_idx(self, group: str, shard: int) -> InvertedIndex:
        with self._lock:
            key = (group, shard)
            idx = self._shards.get(key)
            if idx is None:
                idx = InvertedIndex(self.root / group / f"shard-{shard}.idx")
                self._shards[key] = idx
            return idx

    def _shard_for(self, group: str, name: str, pid: str) -> InvertedIndex:
        g = self.registry.get_group(group)
        sid = hashing.series_id([name.encode(), pid.encode()])
        return self._shard_idx(group, hashing.shard_id(sid, g.resource_opts.shard_num))

    def _all_shards(self, group: str) -> list[InvertedIndex]:
        g = self.registry.get_group(group)
        return [
            self._shard_idx(group, s)
            for s in range(g.resource_opts.shard_num)
        ]

    @staticmethod
    def _doc_id(name: str, pid: str) -> int:
        return hashing.series_id([name.encode(), pid.encode()])

    # -- apply/get/delete (liaison/grpc/property.go surface) ---------------
    def apply(
        self,
        p: Property,
        strategy: str = "merge",
        ttl_seconds: Optional[float] = None,
    ) -> Property:
        """Create or update; returns the stored property with revisions.

        strategy="merge" merges tags into an existing doc (the reference's
        default apply strategy); "replace" overwrites the tag set.
        ttl_seconds sets a lease: the property stops resolving at expiry
        and is physically removed by sweep_expired (the reference's
        property-expire-delete-timeout GC).
        """
        idx = self._shard_for(p.group, p.name, p.id)
        with self._lock:
            self._revision += 1
            rev = self._revision
        doc_id = self._doc_id(p.name, p.id)
        old = idx.get(doc_id)
        tags = dict(p.tags)
        create_rev = rev
        if old is not None:
            old_src = json.loads(old.payload)
            create_rev = old.numerics.get("@create", rev)
            if strategy == "merge":
                merged = dict(old_src["tags"])
                merged.update(tags)
                tags = merged
        stored = Property(
            group=p.group, name=p.name, id=p.id, tags=tags,
            mod_revision=rev, create_revision=create_rev,
        )
        keywords = {"@name": p.name.encode(), "@id": p.id.encode()}
        for k, v in tags.items():
            keywords[k] = str(v).encode()
        numerics = {"@mod": rev, "@create": create_rev}
        if ttl_seconds is not None:
            numerics["@expire"] = int((time.time() + ttl_seconds) * 1000)
        idx.insert(
            [
                Doc(
                    doc_id=doc_id,
                    keywords=keywords,
                    numerics=numerics,
                    payload=json.dumps(
                        {"id": p.id, "name": p.name, "tags": tags}
                    ).encode(),
                )
            ]
        )
        return stored

    @staticmethod
    def _expired(doc, now_millis: Optional[int] = None) -> bool:
        exp = doc.numerics.get("@expire")
        if exp is None:
            return False
        now = now_millis if now_millis is not None else int(time.time() * 1000)
        return exp <= now

    def sweep_expired(self, group: str, now_millis: Optional[int] = None) -> int:
        """Physically remove expired docs (merge-time GC analog)."""
        removed = 0
        for idx in self._all_shards(group):
            dead = [
                doc_id
                for doc_id in idx.search(None).tolist()
                if self._expired(idx.get(doc_id), now_millis)
            ]
            if dead:
                idx.delete(dead)
                removed += len(dead)
        if removed:
            with self._lock:
                self._revision += 1  # state-tree freshness (see delete())
        return removed

    def get(self, group: str, name: str, pid: str) -> Optional[Property]:
        idx = self._shard_for(group, name, pid)
        doc = idx.get(self._doc_id(name, pid))
        if doc is None or self._expired(doc):
            return None
        src = json.loads(doc.payload)
        return Property(
            group=group, name=name, id=pid, tags=src["tags"],
            mod_revision=doc.numerics.get("@mod", 0),
            create_revision=doc.numerics.get("@create", 0),
        )

    def delete(self, group: str, name: str, pid: str) -> bool:
        idx = self._shard_for(group, name, pid)
        doc_id = self._doc_id(name, pid)
        if idx.get(doc_id) is None:
            return False
        idx.delete([doc_id])
        with self._lock:
            # any mutation advances the revision: the repair state tree's
            # freshness guard must see deletions too
            self._revision += 1
        return True

    def query(
        self,
        group: str,
        name: str,
        *,
        tag_filters: Optional[dict] = None,
        ids: Optional[list[str]] = None,
        limit: int = 100,
    ) -> list[Property]:
        """Scatter across shards, filter by name + tags (+ id set)."""
        t0 = time.time()
        try:
            return self._query_inner(
                group, name, tag_filters=tag_filters, ids=ids, limit=limit
            )
        finally:
            _H_QUERY_PROPERTY.observe((time.time() - t0) * 1000)

    def _query_inner(
        self,
        group: str,
        name: str,
        *,
        tag_filters: Optional[dict] = None,
        ids: Optional[list[str]] = None,
        limit: int = 100,
    ) -> list[Property]:
        clauses: list = [TermQuery("@name", name.encode())]
        for k, v in (tag_filters or {}).items():
            clauses.append(TermQuery(k, str(v).encode()))
        q: Query = And(tuple(clauses))
        out: list[Property] = []
        idset = set(ids) if ids else None
        for idx in self._all_shards(group):
            for doc_id in idx.search(q).tolist():
                doc = idx.get(doc_id)
                if self._expired(doc):
                    continue
                src = json.loads(doc.payload)
                if idset is not None and src["id"] not in idset:
                    continue
                out.append(
                    Property(
                        group=group, name=name, id=src["id"], tags=src["tags"],
                        mod_revision=doc.numerics.get("@mod", 0),
                        create_revision=doc.numerics.get("@create", 0),
                    )
                )
                if len(out) >= limit:
                    return out
        return out

    def docs_in_shard(self, group: str, shard: int) -> list[Property]:
        """All live docs of one (group, shard) — repair-tree enumeration
        (banyand/property/db/repair.go walks the shard store the same
        way)."""
        idx = self._shard_idx(group, shard)
        out = []
        for doc_id in idx.search(None).tolist():
            doc = idx.get(doc_id)
            if doc is None or self._expired(doc):
                continue
            src = json.loads(doc.payload)
            out.append(
                Property(
                    group=group,
                    name=src["name"],
                    id=src["id"],
                    tags=src["tags"],
                    mod_revision=doc.numerics.get("@mod", 0),
                    create_revision=doc.numerics.get("@create", 0),
                )
            )
        return out

    @property
    def revision(self) -> int:
        return self._revision

    def persist(self) -> None:
        # snapshot under the lock: a concurrent first-touch (lifecycle
        # property sweep, schema-plane write) growing _shards mid-walk
        # is a RuntimeError otherwise
        with self._lock:
            shards = list(self._shards.values())
        for idx in shards:
            idx.persist()

    def persist_group(self, group: str) -> None:
        """Persist only one group's shards (schema-plane writes touch
        just the _schema group; fsyncing every shard would stall)."""
        with self._lock:
            shards = [
                idx for (g, _s), idx in self._shards.items() if g == group
            ]
        for idx in shards:
            idx.persist()
