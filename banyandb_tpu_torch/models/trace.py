"""Trace engine: spans grouped by trace ID.

Analog of banyand/trace (trace.go:43-46): spans are opaque payloads
(spans.bin) with flat tag columns; routing is by trace-id hash
(partition.TraceShardID, pkg/partition/route.go:40); each part carries a
trace-id bloom filter (traceID.filter) consulted before block reads; and
ordered retrieval (e.g. traces by duration) goes through a per-segment
ordered secondary index (the reference's sidx, banyand/internal/sidx).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from banyandb_tpu_torch.api.model import QueryRequest, QueryResult, TimeRange
from banyandb_tpu_torch.api.schema import SchemaRegistry, TagType
from banyandb_tpu_torch.index.sidx import SidxStore
from banyandb_tpu_torch.index.sidx import decode_ref as sidx_decode_ref
from banyandb_tpu_torch.index.sidx import encode_ref as sidx_encode_ref
from banyandb_tpu_torch.obs import metrics as obs_metrics
from banyandb_tpu_torch.query import measure_exec
from banyandb_tpu_torch.storage.memtable import PayloadMemtable
from banyandb_tpu_torch.storage.part import ColumnData
from banyandb_tpu_torch.storage.tsdb import TSDB
from banyandb_tpu_torch.utils import hashing
from banyandb_tpu_torch.utils.bloom import Bloom

BLOOM_FILE = "traceid.filter"

_H_QUERY_TRACE = obs_metrics.global_meter().histogram(
    "query_ms", {"engine": "trace"}
)

# per-plan default row/trace limits when the request carries none
# (by_id/scan count span rows; ordered counts traces, the sidx key unit)
_DEFAULT_LIMITS = {"by_id": 100, "ordered": 20, "scan": 100}


def classify_plan(req: QueryRequest, tid_tag: str) -> tuple:
    """Lower a trace QueryRequest onto one of the three read plans.

    -> (kind, tids, lo, hi, residual) where kind is ``by_id`` (trace-id
    eq/IN criteria: bloom-gated span-store lookups), ``ordered``
    (order_by_tag set: sidx TYPE_TREE walk with key bounds lo/hi), or
    ``scan`` (criteria-only: zone-map-planned part scan).  AND criteria
    only — OR trees raise rather than silently flatten.  Multiple
    trace-id conditions INTERSECT (AND semantics); an empty intersection
    is an empty by_id plan, not an error.  The liaison shares this
    lowering so node and gather halves can never disagree on the plan.
    """
    from banyandb_tpu_torch.query.measure_exec import _lower_criteria

    leaves, expr = _lower_criteria(req.criteria)
    if expr:
        raise ValueError("OR criteria not supported for trace queries")
    id_sets: list[set[str]] = []
    residual = []
    for c in leaves:
        if c.name == tid_tag and c.op == "eq":
            id_sets.append({str(c.value)})
        elif c.name == tid_tag and c.op == "in":
            id_sets.append({str(v) for v in c.value})
        else:
            residual.append(c)
    if id_sets:
        return "by_id", sorted(set.intersection(*id_sets)), None, None, residual
    if req.order_by_tag:
        lo = hi = None
        rest = []
        for c in residual:
            if c.name == req.order_by_tag and c.op in ("gt", "ge", "lt", "le"):
                # duplicate bounds INTERSECT (AND semantics)
                if c.op in ("gt", "ge"):
                    b = int(c.value) + (1 if c.op == "gt" else 0)
                    lo = b if lo is None else max(lo, b)
                else:
                    b = int(c.value) - (1 if c.op == "lt" else 0)
                    hi = b if hi is None else min(hi, b)
            else:
                rest.append(c)
        return "ordered", None, lo, hi, rest
    return "scan", None, None, None, residual


# Trace schema objects live in the registry (persisted + SCHEMA_SYNC'd
# like measures); re-exported here for engine-local convenience.
from banyandb_tpu_torch.api.schema import Trace  # noqa: E402


@dataclass(frozen=True)
class SpanValue:
    ts_millis: int
    tags: dict
    span: bytes  # opaque span payload


def write_trace_bloom(part, trace_id_tag: str) -> bool:
    """THE trace-id bloom sidecar writer — local flushes and installed
    (liaison-shipped) parts both go through this, so sizing/encoding/
    filename can never fork.  Returns True when a bloom was written."""
    from banyandb_tpu_torch.utils import fs

    if trace_id_tag not in part.meta.get("tags", ()):
        return False
    ids = part.dict_for(trace_id_tag)
    bloom = Bloom(max(len(ids), 1))
    for v in ids:
        bloom.add(v)
    fs.atomic_write(part.dir / BLOOM_FILE, bloom.to_bytes())
    return True


def trace_shard_id(trace_id: str, shard_num: int) -> int:
    """partition.TraceShardID analog: hash the trace id directly."""
    h = hashlib.blake2b(trace_id.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % shard_num


class TraceEngine:
    def __init__(self, registry: SchemaRegistry, root: str | Path):
        import threading

        self.registry = registry
        self.root = Path(root) / "trace"
        self._tsdbs: dict[str, TSDB] = {}
        self._tsdb_lock = threading.Lock()
        # ordered-index stores per (group, segment-start, rule-tag): the
        # part-based sidx (index/sidx.py, interfaces.go:58 analog)
        self._sidx: dict[tuple, SidxStore] = {}
        # tail-sampling pipeline (post-trace-pipeline analog)
        from banyandb_tpu_torch.models.trace_pipeline import TracePipelineRegistry

        self.pipeline = TracePipelineRegistry()

    def close(self) -> None:
        """Release every TSDB's index memory/file handles (bdsan fd
        hygiene; reopen stays lazy)."""
        with self._tsdb_lock:
            dbs = list(self._tsdbs.values())
        for db in dbs:
            db.close()

    def create_trace(self, t: Trace) -> None:
        self.registry.create_trace(t)

    def get_trace(self, group: str, name: str) -> Trace:
        return self.registry.get_trace(group, name)

    def _tsdb(self, group: str) -> TSDB:
        with self._tsdb_lock:
            db = self._tsdbs.get(group)
            if db is None:
                g = self.registry.get_group(group)
                db = TSDB(
                    self.root, group, g.resource_opts,
                    mem_factory=lambda: PayloadMemtable("trace"),
                )
                # sampler-chain gating at merge (trace/merger.go:318-342)
                db.merge_filter = self.pipeline.merge_filter_for(group)
                self._tsdbs[group] = db
            return db

    def _ordered_index(self, group: str, seg, rule_tag: str) -> SidxStore:
        with self._tsdb_lock:
            key = (group, seg.start, rule_tag)
            idx = self._sidx.get(key)
            if idx is None:
                idx = SidxStore(seg.root / f"sidx-{rule_tag}")
                self._sidx[key] = idx
            return idx

    # -- write (svc write path analog) -------------------------------------
    def write(
        self,
        group: str,
        name: str,
        spans: list[SpanValue],
        *,
        ordered_tags: tuple[str, ...] = (),
    ) -> int:
        """Ingest spans; `ordered_tags` are INT tags maintained in the
        ordered secondary index (the TYPE_TREE rule analog, e.g. duration).
        """
        t = self.get_trace(group, name)
        db = self._tsdb(group)
        shard_num = self.registry.get_group(group).resource_opts.shard_num
        tag_names = [x.name for x in t.tags]
        n = 0
        for sp in spans:
            trace_id = str(sp.tags[t.trace_id_tag])
            sid = hashing.series_id([name.encode(), trace_id.encode()])
            shard = trace_shard_id(trace_id, shard_num)
            seg = db.segment_for(sp.ts_millis)
            tag_bytes = {
                x.name: hashing.entity_bytes(sp.tags[x.name])
                if sp.tags.get(x.name) is not None
                else b""
                for x in t.tags
            }
            # ordering keys FIRST: if a concurrent flush tick lands
            # between these two inserts, the failure direction is a
            # prunable dangling key — never a durable span whose key was
            # still mem-only (query_ordered would omit it forever)
            for rt in ordered_tags:
                v = sp.tags.get(rt)
                if v is None:
                    continue
                self._ordered_index(group, seg, rt).insert(
                    int(v), sidx_encode_ref(trace_id, sp.ts_millis)
                )
            seg.shards[shard].ingest(
                lambda mem: mem.append(
                    name, tag_names, sp.ts_millis, sid, tag_bytes, sp.span
                )
            )
            n += 1
        return n

    def _flush_sidx_first(self) -> None:
        """Commit sidx flushes BEFORE span parts publish (the adapted
        sidx/interfaces.go:37 snapshot-transaction contract): stage every
        store's part, then publish them all, then let the caller flush
        spans.  Any crash between the two publish points leaves at worst
        DANGLING ordered keys, which query_ordered prunes via
        verify_live — never durable spans missing their ordering keys
        (the old order's divergence)."""
        txns = []
        try:
            for idx in list(self._sidx.values()):
                t = idx.prepare_flush()
                if t is not None:
                    txns.append(t)
        except BaseException:
            for t in txns:
                t.abort()
            raise
        for i, t in enumerate(txns):
            try:
                t.commit()
            except BaseException:
                # a failed commit must not leak the remaining stores'
                # flush locks (that would deadlock every future flush)
                for u in txns[i + 1 :]:
                    try:
                        u.abort()
                    except Exception:  # noqa: BLE001
                        pass
                raise

    def flush(self, group: Optional[str] = None) -> list[str]:
        out = []
        self._flush_sidx_first()
        for gname, db in list(self._tsdbs.items()):
            if group is None or gname == group:
                out.extend(db.flush_all())
                self._write_blooms(db, gname)
        for idx in list(self._sidx.values()):
            idx.merge()
        return out

    def _write_blooms(self, db: TSDB, group: str) -> None:
        """Attach a trace-id bloom file to parts that lack one."""
        for seg in db.segments:
            for shard in seg.shards:
                for part in shard.parts:
                    name = part.meta.get("trace")
                    if not name or (part.dir / BLOOM_FILE).exists():
                        continue
                    try:
                        t = self.registry.get_trace(group, name)
                    except KeyError:
                        continue
                    write_trace_bloom(part, t.trace_id_tag)

    def maintain(
        self, group: Optional[str] = None, *, flush_sidx: bool = True
    ) -> None:
        """Periodic companion work the generic lifecycle flusher can't do
        for trace TSDBs: trace-id bloom sidecars on new parts + sidx
        ordered-index flush/merge.  Ordering keys always publish BEFORE
        span parts (_flush_sidx_first here and as the lifecycle
        pre_flush hook), so no crash window leaves durable spans without
        their keys.  Wired as the lifecycle extra tick."""
        for gname, db in list(self._tsdbs.items()):
            if group is None or gname == group:
                self._write_blooms(db, gname)
        if flush_sidx:
            # skipped when the caller already runs _flush_sidx_first as
            # the lifecycle pre_flush hook (one sidx part per tick, not
            # two)
            self._flush_sidx_first()
        for idx in list(self._sidx.values()):
            idx.merge()

    def finalize_segments(self, group: str) -> int:
        """Run the sampler chain over COMPLETE segments: every shard's
        parts merge in one pass, so whole-trace keep decisions see every
        span (PIPELINE_EVENT_FINALIZE, trace finalize_scanner analog).
        Returns the number of shards compacted."""
        db = self._tsdb(group)
        n = 0
        for seg in db.segments:
            for shard in seg.shards:
                parts = shard.parts
                if len(parts) < 2:
                    continue
                if shard.merge(min_merge=len(parts), max_parts=len(parts)):
                    n += 1
        return n

    # -- queries -----------------------------------------------------------
    def query_by_trace_id(self, group: str, name: str, trace_id: str) -> list[dict]:
        """All spans of one trace (the trace span-store lookup)."""
        t0 = time.perf_counter()
        try:
            return self._query_by_trace_id(group, name, trace_id)
        finally:
            _H_QUERY_TRACE.observe((time.perf_counter() - t0) * 1000)

    def _query_by_trace_id(
        self, group: str, name: str, trace_id: str
    ) -> list[dict]:
        t = self.get_trace(group, name)
        db = self._tsdb(group)
        shard_num = self.registry.get_group(group).resource_opts.shard_num
        shard_idx = trace_shard_id(trace_id, shard_num)
        tid = trace_id.encode()
        out: list[dict] = []
        self.last_bloom_blocks_skipped = 0
        for seg in db.segments:
            shard = seg.shards[shard_idx]
            # live memtable + in-flight flush snapshot (flush encodes
            # parts outside the shard lock)
            sources = list(shard.hot_columns(name))
            for part in shard.parts:
                if part.meta.get("trace") != name:
                    continue
                bloom_path = part.dir / BLOOM_FILE
                if bloom_path.exists():
                    bloom = Bloom.from_bytes(bloom_path.read_bytes())
                    if tid not in bloom:
                        n = len(part.blocks)
                        self.last_bloom_blocks_skipped += n
                        obs_metrics.global_meter().counter_add(
                            "blocks_skipped", float(n),
                            labels={"reason": "bloom"},
                        )
                        continue
                sources.append(
                    part.read(
                        range(len(part.blocks)),
                        tags=part.meta["tags"],
                        want_payload=True,
                    )
                )
            for src in sources:
                d = src.dicts.get(t.trace_id_tag, [])
                lut = {v: i for i, v in enumerate(d)}
                code = lut.get(tid, -1)
                if code < 0:
                    continue
                sel = np.nonzero(src.tags[t.trace_id_tag] == code)[0]
                for i in sel:
                    out.append(self._row_to_span(t, src, int(i)))
        out.sort(key=lambda s: s["timestamp"])
        return out

    def query_ordered(
        self,
        group: str,
        name: str,
        order_tag: str,
        time_range: TimeRange,
        *,
        lo: Optional[int] = None,
        hi: Optional[int] = None,
        asc: bool = False,
        limit: int = 20,
        offset: int = 0,
        verify_live: bool = True,
        with_keys: bool = False,
        accept=None,
        shard_pred=None,
    ) -> list:
        """Trace ids ordered by an indexed numeric tag (sidx TYPE_TREE
        retrieval: e.g. slowest traces in a window).

        limit AND offset both count accepted traces and are consumed
        inside the walk — offset skips the first `offset` survivors
        without ever fetching their spans into the result, so page N
        costs one walk, not N fetches.

        with_keys=True returns [(key, trace_id)] instead of bare ids —
        the distributed path needs the ordering keys to k-way merge
        per-node results at the liaison.

        verify_live drops ids whose spans were since removed by the
        sampler pipeline (the ordered index is ingest-time and is not
        rewritten by merge gating); cost is one span lookup per
        candidate, bounded by `limit + offset`.  `accept` generalizes it:
        a callable(trace_id) -> bool deciding survival (residual criteria
        checks ride the same span fetch).  `shard_pred(trace_id)` drops
        candidates routed to shards this node does not own — the sidx is
        per-segment, not per-shard.
        """
        t_q0 = time.perf_counter()
        try:
            return self._query_ordered(
                group, name, order_tag, time_range, lo=lo, hi=hi, asc=asc,
                limit=limit, offset=offset, verify_live=verify_live,
                with_keys=with_keys, accept=accept, shard_pred=shard_pred,
            )
        finally:
            _H_QUERY_TRACE.observe((time.perf_counter() - t_q0) * 1000)

    def _query_ordered(
        self,
        group: str,
        name: str,
        order_tag: str,
        time_range: TimeRange,
        *,
        lo: Optional[int] = None,
        hi: Optional[int] = None,
        asc: bool = False,
        limit: int = 20,
        offset: int = 0,
        verify_live: bool = True,
        with_keys: bool = False,
        accept=None,
        shard_pred=None,
    ) -> list:
        import heapq

        db = self._tsdb(group)
        # One key-ordered stream per overlapping segment, heap-merged so
        # the global order holds across segment boundaries.  Per-segment
        # fetch starts at 4x (limit+offset) (headroom for duplicates /
        # dead candidates) and grows adaptively: if fewer than `limit`
        # live ids survive while some segment's stream was truncated at
        # its cap, the fetch quadruples and the scan repeats — heavy
        # tail-sampling kill rates never starve the result below what
        # actually exists.  sidx block pruning keeps reads key-relevant.
        segs = db.select_segments(time_range.begin_millis, time_range.end_millis)
        fetch = max(limit + max(offset, 0), 1) * 4
        while True:
            self.last_sidx_blocks_read = 0
            streams = []
            truncated = False
            for seg in segs:
                st = self._ordered_index(group, seg, order_tag)
                chunk = st.range_query(lo, hi, asc=asc, limit=fetch)
                truncated = truncated or len(chunk) >= fetch
                streams.append(iter(chunk))
                self.last_sidx_blocks_read += st.last_blocks_read
            # tid tie-break keeps equal keys deterministic across
            # repeated walks, topologies and replica merges
            merged = heapq.merge(
                *streams,
                key=lambda kp: (
                    kp[0] if asc else -kp[0],
                    sidx_decode_ref(kp[1])[0],
                ),
            )
            seen: set[str] = set()
            out: list[str] = []
            keyed: list[tuple[int, str]] = []
            skip = 0
            for _k, payload in merged:
                tid, ts = sidx_decode_ref(payload)
                if not (time_range.begin_millis <= ts < time_range.end_millis):
                    continue
                if shard_pred is not None and not shard_pred(tid):
                    continue
                if tid in seen:
                    continue
                if accept is not None:
                    if not accept(tid):
                        continue
                elif verify_live and not self.query_by_trace_id(
                    group, name, tid
                ):
                    continue
                seen.add(tid)
                if skip < offset:
                    skip += 1
                    continue
                out.append(tid)
                keyed.append((int(_k), tid))
                if len(out) >= limit:
                    return keyed if with_keys else out
            if not truncated:
                return keyed if with_keys else out
            fetch *= 4

    # -- unified span-level query surface ----------------------------------
    def query(self, req: QueryRequest, *, shard_ids=None, tracer=None) -> QueryResult:
        """Full trace read surface: general AND tag criteria (eq/ne/in/
        not_in, numeric ranges), tag projection, sidx order-by asc/desc
        with limit+offset consumed inside the walk.  Plans split three
        ways (classify_plan): trace-id criteria go through the bloom-
        gated span store, order_by_tag through the sidx tree, and
        criteria-only scans prune blocks on per-part zone maps before
        any read.  `shard_ids` restricts to owned shards (distributed
        data nodes); rows are {trace_id, timestamp, tags, span[, key]}.
        """
        t_q0 = time.perf_counter()
        try:
            return self._query(req, shard_ids=shard_ids, tracer=tracer)
        finally:
            _H_QUERY_TRACE.observe((time.perf_counter() - t_q0) * 1000)

    def _query(self, req: QueryRequest, *, shard_ids=None, tracer=None) -> QueryResult:
        from banyandb_tpu_torch.obs.tracer import NOOP_TRACER
        from banyandb_tpu_torch.query.ql_exec import span_matches

        tr = tracer if tracer is not None else NOOP_TRACER
        group = req.groups[0]
        t = self.get_trace(group, req.name)
        tid_tag = t.trace_id_tag
        kind, tids, lo, hi, residual = classify_plan(req, tid_tag)
        off = max(req.offset or 0, 0)
        limit = req.limit or _DEFAULT_LIMITS[kind]
        proj = tuple(req.tag_projection or ())
        rng = req.time_range
        shard_num = self.registry.get_group(group).resource_opts.shard_num
        owned = set(shard_ids) if shard_ids is not None else None

        def in_range(ts: int) -> bool:
            return rng.begin_millis <= ts < rng.end_millis

        def shape(tid: str, span: dict, key=None) -> dict:
            tags = span["tags"]
            if proj:
                tags = {k: v for k, v in tags.items() if k in proj}
            row = {
                "trace_id": tid,
                "timestamp": span["timestamp"],
                "tags": tags,
                "span": span.get("span", b""),
            }
            if key is not None:
                row["key"] = int(key)
            return row

        res = QueryResult()
        if kind == "by_id":
            rows: list[dict] = []
            skipped = 0
            with tr.span("bloom") as bs:
                for tid in tids:
                    if owned is not None and (
                        trace_shard_id(tid, shard_num) not in owned
                    ):
                        continue
                    for s in self._query_by_trace_id(group, req.name, tid):
                        if not in_range(s["timestamp"]):
                            continue
                        if residual and not span_matches(s, residual):
                            continue
                        rows.append(shape(tid, s))
                    skipped += self.last_bloom_blocks_skipped
                bs.tag("traces", len(tids))
                bs.tag("blocks_skipped", skipped)
            with tr.span("merge") as ms:
                rows.sort(key=_row_order)
                rows = rows[off : off + limit]
                ms.tag("rows", len(rows))
            res.data_points = rows
            return res

        if kind == "ordered":
            spans_cache: dict[str, list[dict]] = {}

            def accept(tid: str) -> bool:
                spans = [
                    s
                    for s in self._query_by_trace_id(group, req.name, tid)
                    if in_range(s["timestamp"])
                    and (not residual or span_matches(s, residual))
                ]
                if spans:
                    spans_cache[tid] = spans
                return bool(spans)

            shard_pred = None
            if owned is not None:
                shard_pred = (
                    lambda tid: trace_shard_id(tid, shard_num) in owned
                )
            with tr.span("sidx") as ss:
                keyed = self._query_ordered(
                    group, req.name, req.order_by_tag, rng,
                    lo=lo, hi=hi, asc=(req.order_by_dir != "desc"),
                    limit=limit, offset=off, with_keys=True,
                    accept=accept, shard_pred=shard_pred,
                )
                ss.tag("traces", len(keyed))
                ss.tag("blocks_read", self.last_sidx_blocks_read)
            rows = []
            with tr.span("part_gather") as ps:
                for k, tid in keyed:
                    for s in spans_cache[tid]:
                        rows.append(shape(tid, s, key=k))
                ps.tag("rows", len(rows))
            res.data_points = rows
            return res

        # criteria-only scan: zone-map planning before any block read
        rows = []
        blocks_read = 0
        zone_conds, range_conds = _scan_pruners(t, residual)
        from banyandb_tpu_torch.storage.encoded import zone_skip_enabled

        use_zones = zone_skip_enabled()
        db = self._tsdb(group)
        with tr.span("part_gather") as ps:
            for seg in db.select_segments(rng.begin_millis, rng.end_millis):
                for shard_idx, shard in enumerate(seg.shards):
                    if owned is not None and shard_idx not in owned:
                        continue
                    sources = list(shard.hot_columns(req.name))
                    for part in shard.parts:
                        if part.meta.get("trace") != req.name:
                            continue
                        preds = None
                        if use_zones:
                            preds = _part_scan_preds(
                                part, zone_conds, range_conds
                            )
                        bids = part.select_blocks(
                            rng.begin_millis, rng.end_millis,
                            zone_preds=preds,
                        )
                        if not len(bids):
                            continue
                        blocks_read += len(bids)
                        sources.append(
                            part.read(
                                bids,
                                tags=part.meta["tags"],
                                want_payload=True,
                            )
                        )
                    for src in sources:
                        for i in range(len(src.ts)):
                            if not in_range(int(src.ts[i])):
                                continue
                            s = self._row_to_span(t, src, i)
                            if residual and not span_matches(s, residual):
                                continue
                            tid = str(s["tags"].get(tid_tag, ""))
                            rows.append(shape(tid, s))
            ps.tag("rows", len(rows))
            ps.tag("blocks_read", blocks_read)
        with tr.span("merge") as ms:
            rows.sort(key=_row_order)
            rows = rows[off : off + limit]
            ms.tag("rows", len(rows))
        res.data_points = rows
        return res

    def _row_to_span(self, t: Trace, src: ColumnData, i: int) -> dict:
        from banyandb_tpu_torch.query import filter as qfilter

        tags = {
            tn: qfilter.decode_tag_value(src.dicts[tn][col[i]], t.tag(tn).type)
            for tn, col in src.tags.items()
        }
        return {
            "timestamp": int(src.ts[i]),
            "tags": tags,
            "span": src.payloads[i] if src.payloads else b"",
        }


def _row_order(row: dict) -> tuple:
    """Deterministic scan/by-id row order: (ts, trace_id, payload) — the
    liaison merge re-sorts with the same key so topologies agree byte-
    for-byte even on equal timestamps."""
    return (row["timestamp"], row["trace_id"], row["span"])


def _scan_pruners(t: Trace, residual: list) -> tuple[list, dict]:
    """Split residual AND leaves into zone-map prunable shapes:
    (eq/IN byte-value conds, {int_tag: [range conds]}).  Anything not
    prunable stays residual-only — pruning is best-effort, filtering is
    authoritative."""
    zone_conds: list[tuple[str, list[bytes]]] = []
    range_conds: dict[str, list] = {}
    for c in residual:
        try:
            tag_type = t.tag(c.name).type
        except KeyError:
            continue
        if c.op == "eq":
            try:
                zone_conds.append((c.name, [measure_exec._tag_value_bytes(c.value)]))
            except TypeError:
                pass
        elif c.op == "in":
            try:
                zone_conds.append(
                    (c.name, [measure_exec._tag_value_bytes(v) for v in c.value])
                )
            except TypeError:
                pass
        elif c.op in ("gt", "ge", "lt", "le") and tag_type is TagType.INT:
            try:
                float(c.value)
            except (TypeError, ValueError):
                continue
            range_conds.setdefault(c.name, []).append(c)
    return zone_conds, range_conds


def _range_ok(v: float, conds: list) -> bool:
    for c in conds:
        b = float(c.value)
        if c.op == "gt" and not v > b:
            return False
        if c.op == "ge" and not v >= b:
            return False
        if c.op == "lt" and not v < b:
            return False
        if c.op == "le" and not v <= b:
            return False
    return True


def _part_scan_preds(part, zone_conds, range_conds) -> Optional[list]:
    """Allowed-code zone predicates for one part: eq/IN conds via the
    shared planner lowering, plus INT range conds decoded against the
    part's tag dictionary (absent raw = unset = 0, matching
    decode_tag_value).  A tag whose dictionary has no surviving code
    collapses to the none-match sentinel — the whole part prunes without
    reading a block."""
    from banyandb_tpu_torch.query.planner import part_zone_preds

    preds = list(part_zone_preds(part, zone_conds)) if zone_conds else []
    part_tags = part.meta.get("tags", ())
    for name, conds in range_conds.items():
        if name not in part_tags:
            # no column: every row decodes to 0; prune only if 0 fails
            if not _range_ok(0.0, conds):
                preds.append(("*", np.zeros(0, dtype=np.int64)))
            continue
        codes = [
            i
            for i, raw in enumerate(part.dict_for(name))
            if _range_ok(
                float(int.from_bytes(raw, "little", signed=True)) if raw else 0.0,
                conds,
            )
        ]
        if not codes:
            preds.append(("*", np.zeros(0, dtype=np.int64)))
        else:
            preds.append((f"tag_{name}", np.asarray(sorted(codes), dtype=np.int64)))
    return preds or None
