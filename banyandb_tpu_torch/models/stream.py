"""Stream engine: append-only elements (logs).

Analog of banyand/stream (stream.go:40-43): elements have tags but no
fields; each element carries an opaque element-id (+ optional binary
body) stored in the part payload column (the reference keeps element ids
in timestamps.bin).  No version dedup — appends are immutable; dedup by
(series, ts, element_id) is not a stream contract.

Queries are retrieval-shaped (filter + time range + order + limit) and
IO-bound, so they run host-side; tag predicates are still evaluated on
dictionary codes, on the engine's device for large sources
(query/stream_exec.py).  Aggregations over streams go through the measure
model (the reference does the same).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from banyandb_tpu_torch.api.model import QueryRequest, QueryResult
from banyandb_tpu_torch.api.schema import SchemaRegistry, TagType
from banyandb_tpu_torch.backend import resolve_device
from banyandb_tpu_torch.obs import metrics as obs_metrics
from banyandb_tpu_torch.obs.tracer import NOOP_TRACER, Tracer
from banyandb_tpu_torch.query import filter as qfilter
from banyandb_tpu_torch.query import measure_exec
from banyandb_tpu_torch.storage import encoded as _encoded
from banyandb_tpu_torch.storage.memtable import PayloadMemtable
from banyandb_tpu_torch.storage.part import ColumnData
from banyandb_tpu_torch.storage.tsdb import TSDB
from banyandb_tpu_torch.utils import hashing


# Stream schema objects live in the registry (persisted + SCHEMA_SYNC'd
# like measures); re-exported here for engine-local convenience.
from banyandb_tpu_torch.api.schema import Stream  # noqa: E402

_H_QUERY_STREAM = obs_metrics.global_meter().histogram(
    "query_ms", {"engine": "stream"}
)


@dataclass(frozen=True)
class ElementValue:
    """measure/v1 ElementValue analog: one log element."""

    element_id: str
    ts_millis: int
    tags: dict
    body: bytes = b""


def encode_element_payload(element_id: str, body: bytes) -> bytes:
    """THE payload wire format for stream parts (id NUL body) — every
    writer (engine, liaison wqueue) and reader goes through this pair so
    the format can never fork."""
    return element_id.encode() + b"\x00" + body


def decode_element_payload(payload: bytes) -> tuple[str, bytes]:
    elem_id, _, body = payload.partition(b"\x00")
    return elem_id.decode(), body


class StreamEngine:
    def __init__(
        self, registry: SchemaRegistry, root: str | Path, device=None
    ):
        """`device` (``backend.resolve_device``), resolved once: where the
        tag mask of every large source runs — the CUDA device by default;
        without CUDA the constructor raises unless ``"cpu"`` was asked
        for."""
        import threading

        self.registry = registry
        self.device = resolve_device(device)
        self.root = Path(root) / "stream"
        self._tsdbs: dict[str, TSDB] = {}
        self._tsdb_lock = threading.Lock()

    def close(self) -> None:
        """Release every TSDB's index memory/file handles (bdsan fd
        hygiene; reopen stays lazy)."""
        with self._tsdb_lock:
            dbs = list(self._tsdbs.values())
        for db in dbs:
            db.close()

    def create_stream(self, s: Stream) -> None:
        self.registry.create_stream(s)

    def get_stream(self, group: str, name: str) -> Stream:
        return self.registry.get_stream(group, name)

    def _tsdb(self, group: str) -> TSDB:
        with self._tsdb_lock:
            db = self._tsdbs.get(group)
            if db is None:
                g = self.registry.get_group(group)
                db = TSDB(
                    self.root,
                    group,
                    g.resource_opts,
                    mem_factory=lambda: PayloadMemtable("stream"),
                )
                # element-index/bloom sidecars on every flushed/merged part
                # (banyand/stream/index.go + .tff filter analog)
                db.on_part_built = (
                    lambda part_dir, meta, g=group: self._build_part_index(
                        g, part_dir, meta
                    )
                )
                self._tsdbs[group] = db
            return db

    def _index_tags(
        self, group: str, stream_name: str = ""
    ) -> tuple[set[str], set[str]]:
        """(inverted tags, skipping tags) for a stream from the group's
        IndexRules, honoring IndexRuleBinding subject resolution when
        bindings exist (banyand/metadata binding semantics): with any
        binding present in the group, only rules bound to this stream
        apply; with none, every group rule applies (the common
        one-rule-set-per-group case)."""
        rules = self.registry.list_index_rules(group)
        bindings = self.registry.list_index_rule_bindings(group)
        if bindings and stream_name:
            bound: set[str] = set()
            for b in bindings:
                if b.subject_catalog == "stream" and b.subject_name == stream_name:
                    bound.update(b.rules)
            rules = [r for r in rules if r.name in bound]
        inverted: set[str] = set()
        skipping: set[str] = set()
        for r in rules:
            if r.type == "inverted":
                inverted.update(r.tags)
            elif r.type == "skipping":
                skipping.update(r.tags)
        return inverted, skipping

    def _build_part_index(self, group: str, part_dir, meta: dict) -> None:
        if "stream" not in meta:
            return
        from banyandb_tpu_torch.index import element

        inverted, skipping = self._index_tags(group, meta.get("stream", ""))
        if inverted or skipping:
            element.build_part_index(part_dir, inverted, skipping)

    def write(self, group: str, name: str, elements: list[ElementValue]) -> int:
        s = self.get_stream(group, name)
        db = self._tsdb(group)
        shard_num = self.registry.get_group(group).resource_opts.shard_num
        tag_names = [t.name for t in s.tags]
        n = 0
        for e in elements:
            entity = [name.encode()] + [
                hashing.entity_bytes(e.tags[t]) for t in s.entity
            ]
            sid = hashing.series_id(entity)
            shard = hashing.shard_id(sid, shard_num)
            seg = db.segment_for(e.ts_millis)
            tag_bytes = {
                t.name: hashing.entity_bytes(e.tags[t.name])
                if e.tags.get(t.name) is not None
                else b""
                for t in s.tags
            }
            payload = encode_element_payload(e.element_id, e.body)
            seg.shards[shard].ingest(
                lambda mem: mem.append(
                    name, tag_names, e.ts_millis, sid, tag_bytes, payload
                )
            )
            n += 1
        return n

    def flush(self, group: Optional[str] = None) -> list[str]:
        out = []
        for gname, db in self._tsdbs.items():
            if group is None or gname == group:
                out.extend(db.flush_all())
        return out

    def query(
        self, req: QueryRequest, shard_ids=None, tracer=None
    ) -> QueryResult:
        import time as _time

        own_tracer = tracer is None and req.trace
        if own_tracer:
            tracer = Tracer("stream:query")
        t = tracer if tracer is not None else NOOP_TRACER
        t0 = _time.perf_counter()
        try:
            res = self._query_inner(req, shard_ids, t, own_tracer, tracer)
        finally:
            _H_QUERY_STREAM.observe((_time.perf_counter() - t0) * 1000)
        return res

    def _query_inner(
        self, req: QueryRequest, shard_ids, t, own_tracer, tracer
    ) -> QueryResult:
        group = req.groups[0]
        s = self.get_stream(group, req.name)
        db = self._tsdb(group)
        # leaves validate against the schema; flat AND trees additionally
        # drive block pruning + the device mask (OR trees evaluate via
        # the host criteria-tree mask — pruning by AND-intersection would
        # be wrong under OR)
        leaves, expr = measure_exec._lower_criteria(req.criteria)
        for c in leaves:
            s.tag(c.name)
        conds = leaves if not expr else None
        res = QueryResult()
        rows: list[tuple] = []
        with t.span("scan") as ss:
            for attempt in range(3):
                try:
                    rows = self._scan(db, s, req, conds, shard_ids)
                    break
                except FileNotFoundError:
                    if attempt == 2:
                        raise
            ss.tag("rows", len(rows))
        if req.order_by_tag:
            have = [r for r in rows if r[3].get(req.order_by_tag) is not None]
            miss = [r for r in rows if r[3].get(req.order_by_tag) is None]
            have.sort(
                key=lambda r: r[3][req.order_by_tag],
                reverse=(req.order_by_dir == "desc"),
            )
            rows = have + miss  # missing-tag rows last under either order
        else:
            rows.sort(key=lambda r: r[0], reverse=(req.order_by_ts != "asc"))
        off = req.offset or 0
        for ts, elem_id, body, tags in rows[off : off + (req.limit or 100)]:
            res.data_points.append(
                {
                    "element_id": elem_id,
                    "timestamp": ts,
                    "tags": tags,
                    "body": body,
                }
            )
        if req.trace:
            from banyandb_tpu_torch.query import logical

            res.trace = {
                "plan": logical.analyze_stream(s, req).explain(),
                "rows_scanned": len(rows),
            }
            if own_tracer:
                res.trace["span_tree"] = tracer.finish()
        return res

    def _scan(
        self, db: TSDB, s: Stream, req: QueryRequest, conds, shard_ids=None
    ) -> list[tuple]:
        from banyandb_tpu_torch.index import element

        rows: list[tuple] = []
        tag_names = [t.name for t in s.tags]
        inverted, skipping = self._index_tags(req.groups[0], s.name)
        stats = {"blocks_selected": 0, "blocks_read": 0, "blocks_skipped": 0}
        from banyandb_tpu_torch.storage.chunk_stream import prefetched

        # the stream analog of the measure gather/compute pipeline: the
        # loop below only does metadata work (block selection, sidecar
        # pruning) and collects decode thunks; evaluation through the
        # prefetch stream overlaps part k+1's disk decode with part k's
        # mask+gather — order (and therefore result order) is identical
        # to the strict-serial path (BYDB_PIPELINE=0)
        read_ops: list = []
        for seg in db.select_segments(
            req.time_range.begin_millis, req.time_range.end_millis
        ):
            for shard_idx, shard in enumerate(seg.shards):
                if shard_ids is not None and shard_idx not in shard_ids:
                    continue
                # live memtable + in-flight flush snapshot (rows stay
                # visible while their part encodes outside the lock)
                for mem_cols in shard.hot_columns(s.name):
                    read_ops.append(lambda mc=mem_cols: mc)
                for part in shard.parts:
                    if part.meta.get("stream") != s.name:
                        continue
                    blocks = part.select_blocks(
                        req.time_range.begin_millis, req.time_range.end_millis
                    )
                    stats["blocks_selected"] += len(blocks)
                    if blocks and conds and (inverted or skipping):
                        allowed = element.prune_blocks(
                            part, conds, inverted, skipping
                        )
                        if allowed is not None:
                            blocks = [b for b in blocks if b in allowed]
                    stats["blocks_read"] += len(blocks)
                    if blocks:
                        # narrow_codes: tag columns keep their stored
                        # i8/i16 width so the device mask
                        # (stream_exec.device_tag_mask) ships them
                        # compressed and widens on device
                        read_ops.append(
                            lambda p=part, b=blocks: p.read(
                                b,
                                tags=[
                                    t
                                    for t in tag_names
                                    if t in p.meta["tags"]
                                ],
                                want_payload=True,
                                narrow_codes=_encoded.device_decode_enabled(),
                            )
                        )
        for src in prefetched(read_ops, name="bydb-stream-prefetch"):
            rows.extend(self._filter_source(s, src, req, conds))
        stats["blocks_skipped"] = stats["blocks_selected"] - stats["blocks_read"]
        # bdlint: disable=wp-shared-state -- diagnostic last-query
        # snapshot: an atomic rebind of a fresh dict, last-writer-wins by
        # design (readers only ever dereference one complete snapshot)
        self.last_scan_stats = stats
        return rows

    def _filter_source(self, s: Stream, src: ColumnData, req: QueryRequest, conds):
        from banyandb_tpu_torch.query import stream_exec

        if conds is None:  # OR criteria tree: host tree-mask evaluation
            mask = qfilter.criteria_mask(
                src, req.criteria,
                req.time_range.begin_millis, req.time_range.end_millis,
            )
        else:
            mask = stream_exec.row_mask(
                src, conds, req.time_range.begin_millis,
                req.time_range.end_millis, self.device,
            )
        out = []
        for i in np.nonzero(mask)[0]:
            payload = src.payloads[i] if src.payloads else b"\x00"
            elem_id, body = decode_element_payload(payload)
            tags = {
                t: qfilter.decode_tag_value(
                    src.dicts[t][src.tags[t][i]], s.tag(t).type
                )
                for t in src.tags
            }
            out.append((int(src.ts[i]), elem_id, body, tags))
        return out


