"""Data node role: engines + bus handlers (pkg/cmdsetup/data.go analog).

Hosts the storage engines and serves the internal topics: writes land in
the local engines; partial-aggregate queries run the device map phase
over the shard subset named in the envelope; chunked part sync
reassembles shipped parts.
"""

from __future__ import annotations

import zlib
from pathlib import Path

from banyandb_tpu_torch.api.schema import SchemaRegistry
from banyandb_tpu_torch.backend import resolve_device
from banyandb_tpu_torch.cluster import serde
from banyandb_tpu_torch.cluster.bus import LocalBus, Topic
from banyandb_tpu_torch.models.measure import MeasureEngine
from banyandb_tpu_torch.utils import fs


class DataNode:
    def __init__(
        self, name: str, registry: SchemaRegistry, root: str | Path,
        device=None,
    ):
        """`device` (``backend.resolve_device``), resolved once and
        passed to the node's measure and stream engines: the CUDA device
        by default; without CUDA the constructor raises unless ``"cpu"``
        was asked for."""
        import shutil

        from banyandb_tpu_torch.models.stream import StreamEngine
        from banyandb_tpu_torch.models.trace import TraceEngine

        self.device = resolve_device(device)
        self.name = name
        self.registry = registry
        self.root = Path(root)
        # advisory owner record: offline tools (lifecycle CLI) refuse to
        # open a root whose recorded owner process is still alive —
        # two Shard owners over one directory lose writes
        self.root.mkdir(parents=True, exist_ok=True)
        try:
            import os as _os

            (self.root / ".bydb-node.pid").write_text(str(_os.getpid()))
        except OSError:
            pass
        self.measure = MeasureEngine(registry, self.root, device=self.device)
        self.stream = StreamEngine(registry, self.root, device=self.device)
        self.trace = TraceEngine(registry, self.root)
        self.bus = LocalBus()
        from banyandb_tpu_torch.admin.diskmonitor import DiskMonitor

        self.disk = DiskMonitor(self.root)
        # Persisted content digests of installed synced parts, for
        # idempotent re-delivery.  dict-as-ordered-set so the size bound
        # evicts the OLDEST digest, never a fresh one.
        import json as _json
        import threading

        try:
            self._installed = dict.fromkeys(
                _json.loads((self.root / ".sync-installed.json").read_text())
            )
        except (OSError, ValueError):
            self._installed = {}
        self._installed_lock = threading.Lock()
        # placement-epoch write fence (cluster/placement.py): the
        # highest epoch this node has seen, persisted so a restart
        # keeps rejecting writers from before the last witnessed
        # cutover (docs/robustness.md "Elastic cluster")
        from banyandb_tpu_torch.cluster.placement import EpochRecord

        self.epoch_record = EpochRecord(self.root / ".placement-epoch.json")
        # content-digest cache for rebalance/repair manifests (parts
        # are immutable, so a digest computed once is good forever)
        self._manifest_digests: dict[str, str] = {}
        self._manifest_lock = threading.Lock()
        self._sync_sessions: dict[str, dict] = {}
        # abandoned chunked-sync sessions from a previous process die here
        shutil.rmtree(self.root / ".sync-staging", ignore_errors=True)
        self._register_handlers()

    def start_lifecycle(self, local_flush: bool = True, **kw) -> None:
        """Background flush/merge/retention over ALL engines' TSDBs —
        installed stream/measure parts (liaison wqueue, tier sync) merge
        and retention-sweep like locally-written ones; the extra tick
        runs trace maintenance (blooms + sidx flush/merge).

        local_flush=False keeps every maintenance tick (merge sweep,
        retention, rotation, blooms, series-index persist — all
        idempotent over immutable parts) but never drains memtables or
        sidx ordered keys: parts then publish ONLY through explicit
        engine flushes.  Worker processes need this — their parent trims
        its replay journal on the flushes IT initiates, so a loop-driven
        drain here would persist journaled rows the parent still replays
        after a crash, duplicating stream/trace appends (measure rows
        collapse in version dedup; streams/traces have none)."""
        if not local_flush:
            # no shard grows a memtable this large: the flush stage
            # visits every tick but never drains
            kw.setdefault("flush_min_rows", 1 << 62)
        self.measure.start_lifecycle(
            extra_tsdbs=lambda: (
                list(self.stream._tsdbs.values())
                + list(self.trace._tsdbs.values())
            ),
            extra_tick=lambda: self.trace.maintain(flush_sidx=False),
            pre_flush=self.trace._flush_sidx_first if local_flush else None,
            **kw,
        )

    def stop_lifecycle(self) -> None:
        self.measure.stop_lifecycle()

    def _register_handlers(self) -> None:
        self.bus.subscribe(Topic.MEASURE_WRITE, self._on_measure_write)
        self.bus.subscribe(
            Topic.MEASURE_WRITE_COLUMNS, self._on_measure_write_columns
        )
        self.bus.subscribe(Topic.MEASURE_QUERY_PARTIAL, self._on_measure_query_partial)
        self.bus.subscribe(Topic.MEASURE_QUERY_RAW, self._on_measure_query_raw)
        self.bus.subscribe(Topic.STREAM_WRITE, self._on_stream_write)
        self.bus.subscribe(Topic.STREAM_QUERY, self._on_stream_query)
        self.bus.subscribe(Topic.TRACE_WRITE, self._on_trace_write)
        self.bus.subscribe(Topic.TRACE_QUERY_BY_ID, self._on_trace_query)
        self.bus.subscribe(Topic.TRACE_QUERY_ORDERED, self._on_trace_query_ordered)
        self.bus.subscribe(Topic.TRACE_QUERY_EXEC, self._on_trace_query_exec)
        self.bus.subscribe(
            Topic.HEALTH,
            lambda env: {
                "status": "ok",
                "node": self.name,
                "schema_revision": self.registry.revision,
            },
        )
        self.bus.subscribe(Topic.SCHEMA_SYNC, self._on_schema_sync)
        self.bus.subscribe(
            Topic.SCHEMA_GET,
            lambda env: self.registry.stored_object_hash(
                env["kind"], env["key"]
            ),
        )
        self.bus.subscribe(Topic.SYNC_PART, self._on_sync_part)
        # node-local metrics exposition ("metrics" topic, same envelope
        # as the standalone server's TOPIC_METRICS): stage histograms
        # and engine instruments land in the process-global meter
        from banyandb_tpu_torch.obs import metrics as obs_metrics

        self.bus.subscribe(
            "metrics",
            lambda env: {
                "prometheus": obs_metrics.global_meter().prometheus_text()
            },
        )
        # streaming-aggregation control surface (query/streamagg.py):
        # liaisons broadcast dashboard signature registrations here;
        # stats expose window/watermark state per node
        self.bus.subscribe("streamagg", self._on_streamagg)
        # elastic-cluster control surface (docs/robustness.md):
        # placement-epoch get/adopt + the rebalance/repair data plane
        # (per-shard part manifests, chunked part pulls, all-model
        # flush before a manifest snapshot)
        self.bus.subscribe("placement", self._on_placement)
        self.bus.subscribe("rebalance", self._on_rebalance)
        # node-local TopN ranking over pre-aggregated windows — scatter
        # callers (the worker pool, a future liaison TopN plane) merge
        # per-node ranked lists
        self.bus.subscribe("topn", self._on_topn)
        # operator flush surface (data-node SnapshotService analog):
        # persists memtables to parts on demand — ops tooling and tests
        # use it to bound the direct-write plane's crash-loss window
        self.bus.subscribe(
            "flush",
            lambda env: {"parts": self.measure.flush(env.get("group"))},
        )
        # per-node FODC agent surface polled by the proxy (admin/fodc.py)
        from banyandb_tpu_torch.admin.diagnostics import DIAG_TOPIC

        self.bus.subscribe(DIAG_TOPIC, self._on_diagnostics)
        # schema anti-entropy gossip topics (cluster/schema_gossip.py)
        from banyandb_tpu_torch.cluster import schema_gossip

        schema_gossip.register_handlers(self.bus, self.registry)

    def _on_streamagg(self, env: dict) -> dict:
        op = env.get("op", "stats")
        if op == "register":
            info = self.measure.streamagg.register(
                env["group"],
                env["measure"],
                key_tags=tuple(env.get("key_tags", ())),
                fields=tuple(env.get("fields", ())),
                window_millis=env.get("window_millis"),
                max_windows=env.get("max_windows"),
                origin=env.get("origin", "manual"),
            )
            return {"registered": info, "node": self.name}
        if op == "unregister":
            removed = self.measure.streamagg.unregister(
                env["group"],
                env["measure"],
                key_tags=tuple(env.get("key_tags", ())),
                fields=tuple(env.get("fields", ())),
                window_millis=env.get("window_millis"),
            )
            return {"unregistered": removed, "node": self.name}
        if op == "stats":
            return {
                "streamagg": self.measure.streamagg.stats(),
                "node": self.name,
            }
        raise ValueError(f"bad streamagg op {op!r}")

    # -- elastic-cluster control surface (docs/robustness.md) ---------------
    def _on_placement(self, env: dict) -> dict:
        """Placement-epoch surface: ``get`` reads the fence, ``set``
        adopts a cutover broadcast (ratchet-up; adopting never
        rejects — only WRITE envelopes can be stale)."""
        op = env.get("op", "get")
        if op == "set":
            e = int(env["epoch"])
            if e > self.epoch_record.epoch:
                self.epoch_record.observe(e, source="placement-set")
            return {"epoch": self.epoch_record.epoch, "node": self.name}
        if op == "get":
            return {"epoch": self.epoch_record.epoch, "node": self.name}
        raise ValueError(f"bad placement op {op!r}")

    def _on_rebalance(self, env: dict) -> dict:
        """Rebalance/repair data plane (cluster/rebalance.py mover):

        - ``flush``: drain every engine's memtables so the next
          manifest snapshot covers all acked rows as parts;
        - ``manifest``: per-shard part inventory with install-dedup
          digest keys (the sealer's part uuid when stamped, content
          sha256 otherwise — the SAME keys the sync-install dedup
          uses, so a re-ship of a listed part is always a no-op);
        - ``pull``: one CRC-able chunk of one part file (the mover
          re-ships it to the new owner through Topic.SYNC_PART)."""
        op = env.get("op")
        if op == "flush":
            return {
                "flushed": {
                    "measure": self.measure.flush(),
                    "stream": self.stream.flush(),
                    "trace": self.trace.flush(),
                }
            }
        if op == "manifest":
            parts, skipped = self._shard_manifest(int(env["shard"]))
            return {"parts": parts, "skipped": skipped}
        if op == "pull":
            return self._pull_part_chunk(env)
        if op == "pull_all":
            return self._pull_part_all(env)
        raise ValueError(f"bad rebalance op {op!r}")

    def _engine_groups(self, engine, catalog: str) -> list[str]:
        """Groups with on-disk data for one catalog: already-open TSDBs
        plus directories from a previous process life (a restarted node
        must manifest parts it has not re-opened yet)."""
        names = set(engine._tsdbs)
        cat_root = self.root / catalog
        try:
            names.update(d.name for d in cat_root.iterdir() if d.is_dir())
        except OSError:
            pass
        return sorted(names)

    def _part_digest_key(self, group: str, shard_idx: int, part) -> str:
        """Manifest identity == install-dedup identity (`_synced_part_key`
        semantics): sealer part uuid when present, else a cached content
        sha256 over the part's files."""
        sess = part.meta.get("seal_session")
        if sess:
            return f"{group}/{shard_idx}/uuid:{sess}"
        cache_key = str(part.dir)
        with self._manifest_lock:
            hit = self._manifest_digests.get(cache_key)
        if hit is None:
            files = {
                f.name: f.read_bytes()
                for f in sorted(part.dir.iterdir())
                if f.is_file()
            }
            hit = self._synced_part_digest(files)
            with self._manifest_lock:
                self._manifest_digests[cache_key] = hit
                # parts come and go with merges/retention: bound the cache
                while len(self._manifest_digests) > 4096:
                    self._manifest_digests.pop(
                        next(iter(self._manifest_digests))
                    )
        return f"{group}/{shard_idx}/{hit}"

    def _shard_manifest(self, shard_idx: int) -> "tuple[list[dict], int]":
        """-> (entries, skipped): `skipped` counts parts that vanished
        under the merge loop mid-listing — the mover treats them like
        gone pulls (another round with a fresh manifest)."""
        skipped = 0
        out: list[dict] = []
        for engine, catalog in (
            (self.measure, "measure"),
            (self.stream, "stream"),
            (self.trace, "trace"),
        ):
            for group in self._engine_groups(engine, catalog):
                try:
                    db = engine._tsdb(group)
                except Exception:  # noqa: BLE001 - foreign dir under the
                    continue  # catalog root is not a group tree
                for seg in db.segments:
                    if shard_idx >= len(seg.shards):
                        continue
                    for part in seg.shards[shard_idx].parts:
                        try:
                            files = {
                                f.name: f.stat().st_size
                                for f in sorted(part.dir.iterdir())
                                if f.is_file()
                            }
                            key = self._part_digest_key(
                                group, shard_idx, part
                            )
                        except FileNotFoundError:
                            # merged away between the parts snapshot and
                            # the stat/read: its rows live on in the
                            # merged part, visible to the NEXT manifest
                            # — skip instead of failing the whole
                            # manifest (which would read as a dead node)
                            skipped += 1
                            continue
                        out.append({
                            "key": key,
                            "catalog": catalog,
                            "group": group,
                            "segment": seg.root.name,
                            "segment_start": int(seg.start),
                            "shard": shard_idx,
                            "part": part.dir.name,
                            "files": files,
                            "min_ts": int(part.meta.get("min_ts", seg.start)),
                        })
        return out, skipped

    def _pull_part_chunk(self, env: dict) -> dict:
        import base64

        engine = {
            "stream": self.stream,
            "trace": self.trace,
        }.get(env.get("catalog", "measure"), self.measure)
        db = engine._tsdb(env["group"])
        seg = db.segment_for(int(env["segment_start"]))
        pdir = seg.shards[int(env["shard"])].root / env["part"]
        fpath = pdir / env["file"]
        # containment: the wire names a file inside THIS part dir only
        if fpath.parent != pdir or "/" in env["file"] or ".." in env["file"]:
            raise ValueError(f"bad pull file {env['file']!r}")
        offset = int(env.get("offset", 0))
        length = int(env.get("length", 1 << 20))
        try:
            with open(fpath, "rb") as fh:
                fh.seek(offset)
                blob = fh.read(length)
                eof = fh.read(1) == b""
            size = fpath.stat().st_size
        except FileNotFoundError:
            # the lifecycle merge loop rewrote this part between the
            # manifest snapshot and the pull: its rows live on in the
            # merged part, which the NEXT manifest round ships
            return {"gone": True, "data": "", "eof": True, "size": 0}
        return {
            "data": base64.b64encode(blob).decode(),
            "eof": eof,
            "size": size,
        }

    def _pull_part_all(self, env: dict) -> dict:
        """Whole-part pull in ONE reply when the part fits the bundle
        cap (per-RPC latency dominates small-part moves on slow
        loopbacks); oversize parts return truncated=True and the mover
        falls back to per-file chunk pulls."""
        import base64

        engine = {
            "stream": self.stream,
            "trace": self.trace,
        }.get(env.get("catalog", "measure"), self.measure)
        db = engine._tsdb(env["group"])
        seg = db.segment_for(int(env["segment_start"]))
        pdir = seg.shards[int(env["shard"])].root / env["part"]
        cap = int(env.get("cap_bytes", 24 << 20))
        try:
            files = sorted(f for f in pdir.iterdir() if f.is_file())
            if sum(f.stat().st_size for f in files) > cap:
                return {"truncated": True, "files": {}}
            return {
                "truncated": False,
                "files": {
                    f.name: base64.b64encode(f.read_bytes()).decode()
                    for f in files
                },
            }
        except FileNotFoundError:
            # merged away between manifest and pull (see _pull_part_chunk)
            return {"gone": True, "truncated": False, "files": {}}

    def _on_diagnostics(self, env: dict) -> dict:
        from banyandb_tpu_torch.admin.diagnostics import DiagnosticsCollector

        return DiagnosticsCollector(self.root).collect(
            include_threads=bool(env.get("include_threads"))
        )

    # -- stream plane (stream svc_data analog) ------------------------------
    def _fence_epoch(self, env: dict, site: str) -> None:
        """Stale-epoch write fence: envelopes stamped with an older
        placement epoch than this node has witnessed are REJECTED
        (retryable kind="stale_epoch" on the wire) — a mover and a
        straggling liaison can never double-apply a write across a
        rebalance cutover.  Fresher epochs are adopted (and persisted):
        epoch knowledge gossips with ordinary traffic, so a node that
        missed the cutover broadcast still converges."""
        e = env.get("placement_epoch")
        if e is not None:
            self.epoch_record.observe(int(e), source=site)

    def _on_stream_write(self, env: dict) -> dict:
        self._fence_epoch(env, "stream-write")
        # schema piggybacked on first contact (streams live outside the
        # core registry kinds; liaison ships the spec with writes)
        if "schema" in env:
            item = env["schema"]
            try:
                self.stream.get_stream(item["group"], item["name"])
            except KeyError:
                self.stream.create_stream(serde.stream_schema_from_json(item))
        self.disk.check_write()
        import time as _time

        t0 = _time.perf_counter()
        # the write runs under the stamped tenant too: the engine's
        # cache invalidations and QoS accounting must land in the SAME
        # partition the tenant's queries read from
        with self._tenant_scope(env, env["group"]):
            n = self.stream.write(
                env["group"], env["name"],
                serde.elements_from_json(env["elements"]),
            )
        self._observe_write("stream", t0)
        return {"written": n}

    def _on_stream_query(self, env: dict) -> dict:
        import base64

        self._check_deadline(env)
        # queries fence too: a scatter routed on a superseded placement
        # map would read shards this node no longer (or not yet) owns —
        # and the fence's adopt-if-fresher half means epoch knowledge
        # gossips with READ traffic, not just writes
        self._fence_epoch(env, "stream-query")
        req = serde.query_request_from_json(env["request"])
        shard_ids = set(env["shards"]) if env.get("shards") is not None else None
        try:
            # Only the schema lookup is forgiving: this node may simply
            # never have learned the stream (schemas arrive with writes /
            # SCHEMA_SYNC) and must not fail the whole scatter.  Errors
            # from the query itself (e.g. typo'd predicate tags) propagate
            # exactly like standalone mode.
            self.stream.get_stream(req.groups[0], req.name)
        except KeyError:
            return {"data_points": []}
        tracer = self._node_tracer(req, env)
        with self._tenant_scope(env, req.groups[0] if req.groups else ""):
            res = self.stream.query(req, shard_ids=shard_ids, tracer=tracer)
        out = {
            "data_points": [
                {
                    **dp,
                    "tags": serde.tags_to_json(dp["tags"]),
                    "body": base64.b64encode(dp["body"]).decode(),
                }
                for dp in res.data_points
            ]
        }
        if tracer is not None:
            out["trace"] = tracer.finish()
        return out

    # -- trace plane (trace svc_data analog) --------------------------------
    def _on_trace_write(self, env: dict) -> dict:
        self._fence_epoch(env, "trace-write")
        if "schema" in env:
            item = env["schema"]
            try:
                self.trace.get_trace(item["group"], item["name"])
            except KeyError:
                self.trace.create_trace(serde.trace_schema_from_json(item))
        self.disk.check_write()
        import time as _time

        t0 = _time.perf_counter()
        with self._tenant_scope(env, env["group"]):
            n = self.trace.write(
                env["group"], env["name"],
                serde.spans_from_json(env["spans"]),
                ordered_tags=tuple(env.get("ordered_tags", ())),
            )
        self._observe_write("trace", t0)
        return {"written": n}

    def _on_trace_query(self, env: dict) -> dict:
        try:
            # forgiving only for the schema lookup: an ordinary not-found
            # must not turn into a shard-dependent error; real query
            # errors propagate like standalone mode
            self.trace.get_trace(env["group"], env["name"])
        except KeyError:
            return {"spans": []}
        spans = self.trace.query_by_trace_id(
            env["group"], env["name"], env["trace_id"]
        )
        return {"spans": serde.spans_to_json(spans)}

    def _on_trace_query_ordered(self, env: dict) -> dict:
        """Ordered retrieval map phase: local sidx scan, results carry
        their ordering keys for the liaison's k-way merge."""
        from banyandb_tpu_torch.api.model import TimeRange

        self._fence_epoch(env, "trace-query-ordered")
        try:
            self.trace.get_trace(env["group"], env["name"])
        except KeyError:
            return {"results": []}
        keyed = self.trace.query_ordered(
            env["group"], env["name"], env["order_tag"],
            TimeRange(env["begin"], env["end"]),
            lo=env.get("lo"), hi=env.get("hi"),
            asc=bool(env.get("asc", False)),
            limit=int(env.get("limit", 20)),
            with_keys=True,
        )
        return {"results": [[int(k), tid] for k, tid in keyed]}

    def _on_trace_query_exec(self, env: dict) -> dict:
        """Full trace query surface map phase: the complete QueryRequest
        (criteria/projection/order-by/limit+offset) runs against owned
        shards; span rows carry their sidx keys so the liaison's partial
        merge preserves sidx order across nodes."""
        import base64

        self._check_deadline(env)
        self._fence_epoch(env, "trace-query-exec")
        req = serde.query_request_from_json(env["request"])
        shard_ids = set(env["shards"]) if env.get("shards") is not None else None
        try:
            # forgiving only for the schema lookup (see _on_stream_query)
            self.trace.get_trace(req.groups[0], req.name)
        except KeyError:
            return {"data_points": []}
        tracer = self._node_tracer(req, env)
        with self._tenant_scope(env, req.groups[0] if req.groups else ""):
            res = self.trace.query(req, shard_ids=shard_ids, tracer=tracer)
        out = {
            "data_points": [
                {
                    **dp,
                    "tags": serde.tags_to_json(dp["tags"]),
                    "span": base64.b64encode(dp["span"]).decode(),
                }
                for dp in res.data_points
            ]
        }
        if tracer is not None:
            out["trace"] = tracer.finish()
        return out

    # -- write plane --------------------------------------------------------
    @staticmethod
    def _observe_write(model: str, t0: float) -> None:
        """write_ms{model} on the node-local meter: in worker mode this
        is what gives the merged /metrics its per-worker write labels."""
        import time as _time

        from banyandb_tpu_torch.obs.metrics import global_meter

        global_meter().observe(
            "write_ms", (_time.perf_counter() - t0) * 1000, {"model": model}
        )

    def _on_measure_write(self, env: dict) -> dict:
        import time as _time

        self._fence_epoch(env, "measure-write")
        self.disk.check_write()
        req = serde.write_request_from_json(env["request"])
        t0 = _time.perf_counter()
        with self._tenant_scope(env, req.group):
            n = self.measure.write(req)
        self._observe_write("measure", t0)
        return {"written": n}

    def _on_measure_write_columns(self, env: dict) -> dict:
        """Columnar write envelope on the data-node role: the vectorized
        ingest wire shape the standalone server already speaks, decoded
        with the shared serde codec.  The shard-owning worker processes
        (cluster/workers.py) receive their per-shard ingest slices on
        this topic."""
        import time as _time

        self._fence_epoch(env, "measure-write-cols")
        self.disk.check_write()
        t0 = _time.perf_counter()
        with self._tenant_scope(env, env.get("group", "")):
            n = self.measure.write_columns(
                **serde.write_columns_env_decode(env)
            )
        self._observe_write("measure", t0)
        return {"written": n}

    def _on_topn(self, env: dict) -> dict:
        """TopN query over this node's pre-aggregated windows
        (TopNService analog, node-local half): ranked items carry their
        entities so a scatter caller can merge — entities are
        shard-routed, so cross-node entity sets are disjoint and the
        merge is concat + re-rank."""
        from banyandb_tpu_torch.api.model import TimeRange
        from banyandb_tpu_torch.models import topn as topn_mod

        rules = {r.name for r in self.registry.list_topn(env["group"])}
        if env["name"] not in rules:
            raise KeyError(
                f"topn rule {env['name']} not found in group {env['group']}"
            )
        ranked = topn_mod.query_topn(
            self.measure,
            env["group"],
            env["name"],
            TimeRange(*env["time_range"]),
            n=env.get("n", 10),
            direction=env.get("direction", "desc"),
            agg=env.get("agg", "sum"),
            # JSON round-trip turns the (tag, op, value) triples into
            # lists; query_topn wants tuples
            conditions=tuple(
                (c[0], c[1], c[2]) for c in env.get("conditions", ())
            ),
        )
        return {
            "items": [
                {"entity": list(ent), "value": val} for ent, val in ranked
            ]
        }

    # -- query plane --------------------------------------------------------
    @staticmethod
    def _check_deadline(env: dict) -> None:
        """Liaison->data-node deadline propagation: the scatter envelope
        carries the query's REMAINING budget at send time; work whose
        budget is already gone is refused up front (kind="deadline" on
        the wire — the liaison degrades instead of evicting this node)
        rather than scanned into a reply nobody will read."""
        import time as _time

        d = env.get("deadline_ms")
        abs_d = env.get("deadline_unix_ms")
        expired = (d is not None and float(d) <= 0) or (
            # the absolute wall deadline catches budget spent while the
            # request sat in this node's executor queue (the relative
            # form is a send-time snapshot and cannot)
            abs_d is not None and float(abs_d) <= _time.time() * 1000.0
        )
        if expired:
            from banyandb_tpu_torch.cluster.faults import DeadlineExceeded

            raise DeadlineExceeded(
                "query deadline exhausted before node scan"
            )

    def _node_tracer(self, req, env: "dict | None" = None):
        """Per-node tracer when the request is traced OR the scatter
        caller runs its own tracer (``want_subtree`` on the envelope —
        the liaison stamps it whenever it holds a real tracer, e.g. the
        always-on serving-surface one): this node runs its own span tree
        and ships the subtree back in the reply for the caller's
        cluster-wide merge (pkg/query/tracer propagation,
        dquery/measure.go:104 analog).  The subtree rides the BUS reply,
        never the user-facing result, so untraced responses are
        byte-identical either way."""
        if not req.trace and not (env or {}).get("want_subtree"):
            return None
        from banyandb_tpu_torch.obs.tracer import Tracer

        return Tracer(f"data:{self.name}")

    @staticmethod
    def _tenant_scope(env: dict, group: str):
        """Bind the envelope's stamped tenant (else derive from the
        group) for the handler's work, so this node's serving-cache
        reads/writes land in the tenant's OWN partition
        (docs/robustness.md "Multi-tenant QoS")."""
        from banyandb_tpu_torch.qos import tenancy

        return tenancy.tenant_scope(
            env.get("tenant") or tenancy.tenant_of_group(group)
        )

    def _on_measure_query_partial(self, env: dict) -> dict:
        self._check_deadline(env)
        self._fence_epoch(env, "measure-query-partial")
        req = serde.query_request_from_json(env["request"])
        shard_ids = set(env["shards"]) if env.get("shards") is not None else None
        hist_range = tuple(env["hist_range"]) if env.get("hist_range") else None
        tracer = self._node_tracer(req, env)
        with self._tenant_scope(env, req.groups[0] if req.groups else ""):
            partials = self.measure.query_partials(
                req, shard_ids=shard_ids, hist_range=hist_range,
                tracer=tracer,
            )
        out = {"partials": serde.partials_to_json(partials)}
        if tracer is not None:
            out["trace"] = tracer.finish()
        return out

    def _on_measure_query_raw(self, env: dict) -> dict:
        self._check_deadline(env)
        self._fence_epoch(env, "measure-query-raw")
        req = serde.query_request_from_json(env["request"])
        shard_ids = set(env["shards"]) if env.get("shards") is not None else None
        tracer = self._node_tracer(req, env)
        with self._tenant_scope(env, req.groups[0] if req.groups else ""):
            res = self.measure.query(req, shard_ids=shard_ids, tracer=tracer)
        out = {"data_points": res.data_points}
        if tracer is not None:
            out["trace"] = tracer.finish()
        return out

    # -- schema sync (schemaserver/gossip analog, push-based) ---------------
    def _on_schema_sync(self, env: dict) -> dict:
        from banyandb_tpu_torch.api import schema as schema_mod

        kind = env["kind"]
        cls = schema_mod._KINDS[kind]
        obj = schema_mod._from_jsonable(cls, env["item"])
        rev = self.registry._put(kind, obj)
        return {"revision": self.registry.revision, "obj_rev": rev}

    # -- chunked part sync (sub/chunked_sync.go analog) ----------------------
    def _on_sync_part(self, env: dict) -> dict:
        import base64

        phase = env["phase"]
        session = env["session"]
        if phase == "begin":
            # the part-ship plane is fenced too: a straggling sender's
            # sealed part from before a cutover must not install on an
            # owner the new placement no longer routes reads to
            self._fence_epoch(env, "sync-part")
            # Stage OUTSIDE the shard dir: opening the shard GCs unlisted
            # entries, which would eat an in-flight session.
            dest = self.root / ".sync-staging" / session
            dest.mkdir(parents=True, exist_ok=True)
            self._sync_sessions[session] = {
                "dir": dest,
                "files": {},
                "group": env["group"],
                "segment": env["segment"],
                "shard": env["shard"],
            }
            return {"accepted": True}
        if phase == "abort":
            # sender gave up mid-session (e.g. the pulled part vanished
            # under a merge): drop the staged state
            import shutil as _shutil

            state = self._sync_sessions.pop(session, None)
            if state is not None:
                _shutil.rmtree(state["dir"], ignore_errors=True)
            return {"aborted": True}
        state = self._sync_sessions.get(session)
        if state is None:
            raise KeyError(f"unknown sync session {session}")
        if phase == "chunk":
            blob = base64.b64decode(env["data"])
            if zlib.crc32(blob) != env["crc32"]:
                raise ValueError("chunk CRC mismatch")
            buf = state["files"].setdefault(env["file"], bytearray())
            assert len(buf) == env["offset"], "out-of-order chunk"
            buf.extend(blob)
            return {"received": len(blob)}
        if phase == "files":
            # batched small-part form (the rebalance mover): every file
            # of the part in one envelope, CRC'd per file — cuts the
            # per-RPC latency tax a chunk-per-call stream pays on small
            # parts
            total = 0
            for fname, data in env["files"].items():
                blob = base64.b64decode(data)
                if zlib.crc32(blob) != env["crc32s"][fname]:
                    raise ValueError(f"file CRC mismatch for {fname}")
                state["files"][fname] = bytearray(blob)
                total += len(blob)
            return {"received": total}
        if phase == "finish":
            # materialize the part dir, then introduce it into the shard
            # (FinishSync -> introduce, §3.2 of SURVEY.md)
            import json as _json

            state = self._sync_sessions.pop(session)
            group = state["group"]
            shard_idx = int(state["shard"].split("-")[1])
            # idempotence, same contract as the streaming path: a re-ship
            # after a sender crash-before-progress-write installs nothing
            files = {f: bytes(b) for f, b in state["files"].items()}
            pmeta0 = _json.loads(files.get("metadata.json", b"{}"))
            digest = self._synced_part_key(group, shard_idx, pmeta0, files)
            with self._installed_lock:
                if digest in self._installed:
                    return {"introduced": "", "duplicate": True}
                self._installed[digest] = None
            try:
                # disk-fault boundary (cluster/faults.py): the part
                # materialization is the JSON sync plane's spool write —
                # ENOSPC here must surface as a failed FinishSync the
                # sender retries, never a half-installed part
                from banyandb_tpu_torch.cluster import faults as _faults

                _faults.check_disk("sync-part-finish")
                for fname, buf in files.items():
                    fs.atomic_write(state["dir"] / fname, buf)
                # catalog from the part's own metadata (parts carry their
                # resource kind), mirroring the streaming install path
                pmeta = _json.loads(files.get("metadata.json", b"{}"))
                catalog = pmeta.get(
                    "catalog",
                    "stream" if "stream" in pmeta
                    else ("trace" if "trace" in pmeta else "measure"),
                )
                if catalog not in ("measure", "stream", "trace"):
                    raise ValueError(f"unsupported part catalog {catalog!r}")
                min_ts = int(env["segment_start_millis"])
                part_name, part_dir = self._introduce_part_dir(
                    state["dir"], group, shard_idx, min_ts, catalog=catalog
                )
            except BaseException:
                with self._installed_lock:
                    self._installed.pop(digest, None)
                raise
            self._post_install_aux(
                catalog, group, pmeta, min_ts, shard_idx, part_name, part_dir
            )
            self._persist_installed_digests()
            return {"introduced": part_name}
        raise ValueError(f"bad sync phase {phase}")

    def _introduce_part_dir(
        self,
        staged_dir,
        group: str,
        shard_idx: int,
        segment_start_millis: int,
        catalog: str = "measure",
    ) -> "tuple[str, Path]":
        """Move a fully-staged part dir into the owning engine's shard +
        publish + register series (shared by the JSON path and streaming
        chunked sync).  catalog routes measure vs stream parts to their
        separate TSDB trees."""
        import os

        from banyandb_tpu_torch.storage.part import Part

        engine = {
            "stream": self.stream,
            "trace": self.trace,
        }.get(catalog, self.measure)
        db = engine._tsdb(group)
        seg = db.segment_for(segment_start_millis)
        shard = seg.shards[shard_idx]
        with shard._lock:
            shard._epoch += 1
            part_name = f"part-{shard._epoch:016x}"
            final = shard.root / part_name
            os.rename(staged_dir, final)
            part = shard._parts[part_name] = Part(final)
            shard._publish()
        self._register_synced_series(seg, part)
        return part_name, final

    def _synced_part_digest(self, files: dict) -> str:
        import hashlib

        h = hashlib.sha256()
        for fname in sorted(files):
            h.update(fname.encode())
            h.update(b"\0")
            h.update(files[fname])
            h.update(b"\0")
        return h.hexdigest()

    def _synced_part_key(
        self, group: str, shard_idx: int, pmeta: dict, files: dict
    ) -> str:
        """Idempotence key for an installed synced part.  Prefers the
        sealer's part uuid (``seal_session``, unique per wqueue seal):
        a re-shipped part after an ack-lost sender crash dedupes without
        hashing megabytes, and even if a metadata byte differs between
        deliveries.  Parts from sealers that stamp no uuid (tier
        migration meta_patch path, pre-uuid senders) fall back to the
        full content digest."""
        sess = pmeta.get("seal_session")
        if sess:
            return f"{group}/{shard_idx}/uuid:{sess}"
        return f"{group}/{shard_idx}/{self._synced_part_digest(files)}"

    def _persist_installed_digests(self) -> None:
        """Flush the installed-digest record (call with new digests already
        in self._installed; one write covers a whole sync batch)."""
        with self._installed_lock:
            # bound the sidecar; dict preserves insertion order, so this
            # evicts the oldest digests — far beyond any re-ship window
            while len(self._installed) > 8192:
                del self._installed[next(iter(self._installed))]
            # write under the lock: concurrent batch persists must not
            # land out of order and drop each other's digests from disk
            fs.atomic_write_json(
                self.root / ".sync-installed.json", list(self._installed)
            )

    def install_synced_parts(self, meta, parts) -> None:
        """Streaming ChunkedSyncService install callback
        (cluster/chunked_sync.py): write each part's files to staging,
        then introduce into the shard owning meta.shard_id.  The target
        segment comes from each part's min timestamp (the reference's
        receiver does the same: parts land in their time's segment).
        Idempotent per part content hash: re-delivery after a partial
        ship installs nothing twice."""
        import json as _json
        import uuid as _uuid

        # streaming-path epoch fence: the sender's placement epoch rides
        # a @epoch=N suffix on the metadata topic (the proto has no
        # spare field) — a straggling liaison's sealed part from before
        # a cutover must not install on an owner the new placement no
        # longer routes reads to
        from banyandb_tpu_torch.cluster.placement import parse_epoch_topic

        _bare, epoch = parse_epoch_topic(getattr(meta, "topic", "") or "")
        if epoch is not None:
            self.epoch_record.observe(epoch, source="part-sync")
        self.disk.check_write()
        installed_any = False
        try:
            for pi, files in parts:
                installed_any |= self._install_one_synced_part(
                    meta, pi, files, _json, _uuid
                )
        finally:
            if installed_any:
                self._persist_installed_digests()

    def _install_one_synced_part(self, meta, pi, files, _json, _uuid) -> bool:
        if "metadata.json" not in files:
            raise ValueError("part missing metadata.json")
        pmeta = _json.loads(files["metadata.json"])
        group = meta.group or pmeta.get("group")
        digest = self._synced_part_key(group, int(meta.shard_id), pmeta, files)
        with self._installed_lock:
            if digest in self._installed:
                return False
            # claim in-flight under the same acquisition: a concurrent
            # re-delivery of this part must not pass the check while the
            # first install is still running
            self._installed[digest] = None
        try:
            # disk-fault boundary: staging is where a chunk-synced part
            # first touches disk; an injected ENOSPC releases the
            # digest claim below so the sender's re-ship can install
            from banyandb_tpu_torch.cluster import faults as _faults

            _faults.check_disk("sync-install")
            staged = self.root / ".sync-staging" / _uuid.uuid4().hex
            staged.mkdir(parents=True, exist_ok=True)
            for fname, blob in files.items():
                fs.atomic_write(staged / fname, blob)
            min_ts = int(pmeta.get("min_ts", pi.min_timestamp))
            # explicit catalog from the sealer; key-sniff only for parts
            # written before the field existed
            catalog = pmeta.get(
                "catalog", "stream" if "stream" in pmeta else "measure"
            )
            if catalog not in ("measure", "stream", "trace"):
                raise ValueError(f"unsupported part catalog {catalog!r}")
            part_name, part_dir = self._introduce_part_dir(
                staged, group, int(meta.shard_id), min_ts, catalog=catalog
            )
        except BaseException:
            # failed install releases the claim so a retry can proceed
            with self._installed_lock:
                self._installed.pop(digest, None)
            raise
        self._post_install_aux(
            catalog, group, pmeta, min_ts, int(meta.shard_id), part_name, part_dir
        )
        return True

    def _post_install_aux(
        self, catalog, group, pmeta, min_ts, shard_idx, part_name, part_dir
    ) -> None:
        """Auxiliary rebuilds every installed part needs, whatever wire it
        arrived on (streaming chunked sync or the JSON SYNC_PART path):
        trace bloom+sidx, stream element-index sidecars, measure TopN
        observation."""
        import logging

        if catalog == "trace":
            try:
                self._index_trace_part(group, pmeta, min_ts, shard_idx, part_dir)
            except Exception:  # noqa: BLE001 - retrieval stays correct
                # via full scans; ordered/bloom pruning degrades
                logging.getLogger("banyandb.datanode").exception(
                    "trace index build failed for installed part %s",
                    part_dir,
                )
        elif catalog == "stream":
            # element-index/bloom sidecars for the installed part
            try:
                self.stream._build_part_index(group, part_dir, pmeta)
            except Exception:  # noqa: BLE001 - pruning is optional,
                # but silent degradation to full scans is not
                logging.getLogger("banyandb.datanode").exception(
                    "sidecar build failed for installed part %s", part_dir
                )
        else:
            self._observe_topn_part(group, pmeta, min_ts, shard_idx, part_name)
            try:
                self._observe_streamagg_part(
                    group, pmeta, shard_idx, part_dir
                )
            except Exception as exc:  # noqa: BLE001 - an install must
                # never fail over the windows; but a part whose rows
                # did NOT reach them makes every covered answer an
                # undercount, so coverage is POISONED (affected ranges
                # rescan) instead of served with a silent gap
                logging.getLogger("banyandb.datanode").exception(
                    "streamagg window update failed for installed part %s",
                    part_dir,
                )
                measure_name = pmeta.get("measure")
                if measure_name:
                    self.measure.streamagg.invalidate(
                        group, measure_name,
                        reason=f"install hook failed: {exc}",
                        # the failed part's rows may lie ABOVE the
                        # watermark: poison up to its max event ts
                        up_to=pmeta.get("max_ts"),
                    )

    def _observe_streamagg_part(
        self, group: str, pmeta: dict, shard_idx: int, part_dir
    ) -> None:
        """Feed an installed part's rows through the continuous
        streaming-aggregation windows (query/streamagg.py) — the wqueue
        drain path bypasses MeasureEngine.write, which is where direct
        writes update windows.  Install-digest idempotence upstream
        guarantees a re-shipped part reaches this hook at most once, so
        windows never double-count."""
        import numpy as np

        measure_name = pmeta.get("measure")
        if not measure_name:
            return
        needs = self.measure.streamagg.needs(group, measure_name)
        if needs is None:
            return
        if pmeta.get("rows") == 0:
            return  # wqueue row-count stamp: empty part, skip the read
        need_tags, need_fields = needs
        from banyandb_tpu_torch.storage.part import Part

        part = Part(part_dir)
        cols = part.read(
            range(len(part.blocks)),
            tags=[t for t in need_tags if t in part.meta["tags"]],
            fields=[f for f in need_fields if f in part.meta["fields"]],
            cached=False,
        )
        n = int(cols.ts.size)
        if n == 0:
            return
        from banyandb_tpu_torch.query.streamagg import (
            coldata_field_col,
            coldata_tag_col,
        )

        def tag_col(t: str):
            return coldata_tag_col(cols, t, n)

        def field_col(f: str):
            return coldata_field_col(cols, f, n)

        self.measure.streamagg.observe(
            group, measure_name,
            ts=cols.ts, series=cols.series, versions=cols.version,
            shards=int(shard_idx), tag_col=tag_col, field_col=field_col,
            # part identity: a registration backfill that already
            # consumed this part makes this hook a no-op for that
            # signature (the raced-install dedup contract)
            part_id=str(part_dir),
        )

    def _index_trace_part(
        self, group: str, pmeta: dict, min_ts: int, shard_idx: int, part_dir
    ) -> None:
        """Installed trace parts need the same auxiliaries local writes
        get: a trace-id bloom sidecar and sidx ordered-index entries for
        the part's tree-indexed tags (shipped in the part meta)."""
        from banyandb_tpu_torch.index.sidx import encode_ref
        from banyandb_tpu_torch.models.trace import write_trace_bloom
        from banyandb_tpu_torch.storage.part import Part

        name = pmeta.get("trace")
        if not name:
            return
        t = self.registry.get_trace(group, name)
        part = Part(part_dir)
        write_trace_bloom(part, t.trace_id_tag)
        ordered = [
            rt
            for rt in pmeta.get("ordered_tags", ())
            if rt in part.meta.get("tags", ())
        ]
        if not ordered or t.trace_id_tag not in part.meta.get("tags", ()):
            return
        db = self.trace._tsdb(group)
        seg = db.segment_for(min_ts)
        cols = part.read(
            range(len(part.blocks)),
            tags=[t.trace_id_tag] + ordered,
            cached=False,
        )
        from banyandb_tpu_torch.query.filter import decode_tag_value

        for rt in ordered:
            store = self.trace._ordered_index(group, seg, rt)
            tid_col = cols.tags[t.trace_id_tag]
            rt_col = cols.tags[rt]
            for i in range(cols.ts.size):
                raw = cols.dicts[rt][rt_col[i]]
                if not raw:
                    continue
                tid = decode_tag_value(
                    cols.dicts[t.trace_id_tag][tid_col[i]],
                    t.tag(t.trace_id_tag).type,
                )
                store.insert(
                    int.from_bytes(raw, "little", signed=True),
                    encode_ref(str(tid), int(cols.ts[i])),
                )
            store.flush()

    def _observe_topn_part(
        self, group: str, pmeta: dict, min_ts: int, shard_idx: int, part_name: str
    ) -> None:
        """Feed an installed part's rows through TopN pre-aggregation —
        the queued write path bypasses MeasureEngine.write, which is
        where per-point topn.observe normally happens.  Only runs when a
        TopN rule actually sources this measure."""
        measure_name = pmeta.get("measure")
        if not measure_name:
            return
        try:
            m = self.registry.get_measure(group, measure_name)
        except KeyError:
            return
        rules = [
            r
            for r in self.registry.list_topn(group)
            if r.source_measure == measure_name
        ]
        if not rules:
            return
        from banyandb_tpu_torch.api.model import DataPointValue
        from banyandb_tpu_torch.query.filter import decode_tag_value

        db = self.measure._tsdb(group)
        seg = db.segment_for(min_ts)
        part = seg.shards[shard_idx]._parts.get(part_name)
        if part is None:
            return
        need_tags = sorted(
            {t for r in rules for t in r.group_by_tag_names}
            | set(m.entity.tag_names)
        )
        need_fields = sorted({r.field_name for r in rules})
        cols = part.read(
            range(len(part.blocks)),
            tags=[t for t in need_tags if t in part.meta["tags"]],
            fields=[f for f in need_fields if f in part.meta["fields"]],
            cached=False,
        )
        for i in range(cols.ts.size):
            tags = {
                t: decode_tag_value(cols.dicts[t][cols.tags[t][i]], m.tag(t).type)
                for t in cols.tags
            }
            fields = {f: float(cols.fields[f][i]) for f in cols.fields}
            self.measure.topn.observe(
                m,
                DataPointValue(
                    ts_millis=int(cols.ts[i]),
                    tags=tags,
                    fields=fields,
                    version=int(cols.version[i]),
                ),
            )

    def _register_synced_series(self, seg, part) -> None:
        """Entity-tag series registration for a shipped part — without it,
        entity-filtered queries would prune the part's blocks away (the
        reference ships series docs alongside parts,
        banyand/measure/write_liaison.go:138 TopicMeasureSeriesSync)."""
        measure_name = part.meta.get("measure")
        if not measure_name:
            return
        try:
            m = self.registry.get_measure(
                part.meta.get("group") or self._group_of(part), measure_name
            )
        except (KeyError, RuntimeError):
            return
        entity_tags = [t for t in m.entity.tag_names if t in part.meta["tags"]]
        if len(entity_tags) != len(m.entity.tag_names):
            return
        cols = part.read(
            range(len(part.blocks)), tags=entity_tags, cached=False
        )
        import numpy as np

        series, first_idx = np.unique(cols.series, return_index=True)
        for sid, i in zip(series.tolist(), first_idx.tolist()):
            tags = {
                t: cols.dicts[t][cols.tags[t][i]] for t in entity_tags
            }
            tags["@measure"] = measure_name.encode()
            seg.series_index.insert_series(sid, tags)

    def _group_of(self, part) -> str:
        # part dirs live at <root>/measure/<group>/seg-*/shard-*/part-*
        return part.dir.parent.parent.parent.name
