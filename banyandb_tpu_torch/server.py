"""Standalone server: all roles in one process (pkg/cmdsetup/standalone.go
analog), served over its in-process bus and, when asked, over gRPC.

    srv = StandaloneServer(root)              # the CUDA device; or device="cpu"
    srv.start()
    srv.bus.handle("bydbql", {"ql": "SELECT ..."})
    srv.stop()

Run: python -m banyandb_tpu_torch.server --root /var/lib/banyandb --port 17912
(``--device cpu`` to run without CUDA)

User-facing topics (the MeasureService/StreamService/TraceService/
PropertyService + registry + BydbQLService analog): measure/stream/trace
writes and queries, property apply/get/query, registry CRUD, BydbQL,
health, snapshot, and the serving planes (metrics, slowlog, diagnostics,
qos, topn, streamagg, pprof capture).

``port`` serves the same bus over gRPC (``cluster/rpc.GrpcBusServer``,
driven by ``cli.py``); ``wire_port`` the reference-proto
``banyandb.*.v1`` services (``api/grpc_server.py``); ``http_port`` the
HTTP/JSON gateway and its console (``api/http_gateway.py``); one
``auth_file`` governs both of the latter.  ``grpc`` and protobuf load
only when one of those tiers is asked for.

``workers=N`` (or ``BYDB_WORKERS=N``) serves the data plane from N
shard-owning worker subprocesses on the server's device
(``cluster/workers.py``), with result JSON byte-identical to the
single-process layout.
"""

from __future__ import annotations

import base64
import time
from pathlib import Path

from banyandb_tpu_torch import bydbql
from banyandb_tpu_torch.api import schema as schema_mod
from banyandb_tpu_torch.api.model import QueryRequest, QueryResult
from banyandb_tpu_torch.api.schema import SchemaRegistry
from banyandb_tpu_torch.backend import resolve_device
from banyandb_tpu_torch.cluster import serde
from banyandb_tpu_torch.cluster.bus import LocalBus, Topic
from banyandb_tpu_torch.admin.accesslog import AccessLog
from banyandb_tpu_torch.admin.metrics import SelfMeasureSink
from banyandb_tpu_torch.obs.tracer import attach_tree
from banyandb_tpu_torch.admin.protector import MemoryProtector
from banyandb_tpu_torch.models.measure import MeasureEngine
from banyandb_tpu_torch.models.property import Property, PropertyEngine
from banyandb_tpu_torch.models.stream import Stream, StreamEngine
from banyandb_tpu_torch.models.trace import Trace, TraceEngine
from banyandb_tpu_torch.qos import tenant_of_group, tenant_scope
from banyandb_tpu_torch.qos.plane import global_qos

# user-facing topics beyond the internal cluster set
TOPIC_QL = "bydbql"
TOPIC_REGISTRY = "registry"
TOPIC_STREAM_QUERY = "stream-query-user"
TOPIC_SNAPSHOT = "snapshot"
TOPIC_METRICS = "metrics"
TOPIC_SLOWLOG = "slowlog"
from banyandb_tpu_torch.admin.diagnostics import DIAG_TOPIC as TOPIC_DIAGNOSTICS  # noqa: E402
TOPIC_TOPN = "topn"
TOPIC_STREAMAGG = "streamagg"
TOPIC_QOS = "qos"

# conservative per-point admission estimate for the memory protector
_POINT_BYTES = 256


def _rss() -> int:
    from banyandb_tpu_torch.admin.protector import process_rss

    return process_rss()


def _served_class(tree: dict) -> str:
    """Classify how a query was answered from its span tree:

    - ``materialized``: a ``streamagg`` span ran — the answer folded
      materialized rolling windows (query/streamagg.py), possibly with
      bounded head/tail rescans;
    - ``replay``: every reduce leg was a partials serving-cache hit —
      the latency measures cache replay, not scan work;
    - ``scan``: at least one real (cache-miss) reduction ran.
    """
    reduce_tags: list[dict] = []
    saw_streamagg = False

    def walk(node):
        nonlocal saw_streamagg
        if not isinstance(node, dict):
            return
        if node.get("name") == "streamagg" and (
            (node.get("tags") or {}).get("coverage") in ("covered", "partial")
        ):
            saw_streamagg = True
        if node.get("name") == "reduce":
            reduce_tags.append(node.get("tags", {}) or {})
        for c in node.get("children", ()) or ():
            walk(c)

    walk(tree)
    if saw_streamagg:
        return "materialized"
    # (a streamagg span tagged coverage="lost" fell back to rescan and
    # is deliberately NOT counted as materialized — see walk() above)
    if reduce_tags and all(
        t.get("partials_cache") == "hit" for t in reduce_tags
    ):
        return "replay"
    return "scan"


def _jsonable(v):
    """bytes anywhere in a reply (data_binary tags, bodies, groups) ride
    as base64 strings — json.dumps must never see raw bytes."""
    if isinstance(v, bytes):
        return base64.b64encode(v).decode()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def result_to_json(res: QueryResult) -> dict:
    out = {
        "groups": [_jsonable(list(g)) for g in res.groups],
        "values": {k: _jsonable(list(vs)) for k, vs in res.values.items()},
        "data_points": [_jsonable(dp) for dp in res.data_points],
    }
    if res.rep_tags:
        out["rep_tags"] = {
            t: _jsonable(list(vs)) for t, vs in res.rep_tags.items()
        }
    if res.trace is not None:
        out["trace"] = res.trace
    if getattr(res, "degraded", False):
        # explicit partial-result markers (docs/robustness.md): callers
        # must be able to tell "empty" from "missing replicas"
        out["degraded"] = True
        out["unavailable_nodes"] = sorted(res.unavailable_nodes)
    return out


class StandaloneServer:
    def __init__(
        self,
        root: str | Path,
        port: int | None = None,
        wire_port: int | None = None,
        http_port: int | None = None,
        pprof_port: int | None = None,
        auth_file: str | None = None,
        slow_query_ms: float | None = None,
        serving_cache_cap: int | None = None,
        workers: int | None = None,
        device=None,
    ):
        """`device` (``backend.resolve_device``), resolved once: the
        measure and stream engines scan there and the plan precompile
        registry warms there — the CUDA device by default; without CUDA
        the constructor raises unless ``"cpu"`` was asked for.

        ``port=None`` serves in-process only (``self.bus``; ``addr`` is
        None); a port (0 = any free one) serves the bus over gRPC too.
        ``wire_port``/``http_port`` None disable the reference-proto
        and HTTP tiers.  `workers` (else ``BYDB_WORKERS``, default 0)
        > 0 spawns that many shard workers on `device`."""
        from banyandb_tpu_torch.obs import SlowQueryRecorder
        from banyandb_tpu_torch.obs.metrics import global_meter
        from banyandb_tpu_torch.utils.envflag import env_float, env_int

        self.device = resolve_device(device)
        self.root = Path(root)
        self.registry = SchemaRegistry(self.root)
        self.measure = MeasureEngine(
            self.registry, self.root / "data", device=self.device
        )
        self.stream = StreamEngine(
            self.registry, self.root / "data", device=self.device
        )
        self.trace = TraceEngine(self.registry, self.root / "data")
        self.property = PropertyEngine(self.registry, self.root / "data")
        # Multi-process data plane (docs/performance.md): BYDB_WORKERS=N
        # maps shard ownership to N worker subprocesses on this server's
        # device — measure/stream/trace writes partition by shard hash
        # to the owning worker, queries scatter-gather over the
        # intra-node liaison machinery, and result JSON stays
        # byte-identical to the N=0 layout.  The parent engines above
        # then hold no data-plane rows; they keep serving the property
        # plane and schema state.
        self.pool = None
        n_workers = (
            workers if workers is not None else env_int("BYDB_WORKERS", 0)
        )
        if n_workers > 0:
            from banyandb_tpu_torch.cluster.workers import (
                PoolMeasureAdapter,
                PoolStreamAdapter,
                PoolTraceAdapter,
                WorkerPool,
            )

            self.pool = WorkerPool(
                self.root, self.registry, n_workers, device=self.device
            )
            self._pool_measure = PoolMeasureAdapter(self.pool)
            self._pool_stream = PoolStreamAdapter(self.pool)
            self._pool_trace = PoolTraceAdapter(self.pool)
        # the process-global registry: engine/executor/fabric instruments
        # (query stages, rpc, lifecycle loops) land in the same exposition
        # as the server's own counters
        self.meter = global_meter()
        # self-measures ride the data plane: in worker mode they route
        # through the pool like any other measure write
        self.self_metrics = SelfMeasureSink(
            self.meter,
            self._pool_measure if self.pool is not None else self.measure,
        )
        # dogfood loop (docs/observability.md "Self-trace"): slow/sampled
        # query span trees persist as trace rows in _monitoring.self_query
        # through the DB's own trace write path (pool-routed like the
        # self-measures when workers own the data plane)
        from banyandb_tpu_torch.obs.selftrace import SelfTraceSink

        self.self_trace = SelfTraceSink(
            self._pool_trace if self.pool is not None else self.trace,
            self.registry, node="standalone",
        )
        # multi-tenant QoS (docs/robustness.md "Multi-tenant QoS"):
        # tenant = group namespace; ingest token buckets + weighted
        # query admission shed with the retryable ServerBusy wire kind,
        # and the protector charges in-flight bytes per tenant
        self.qos = global_qos()
        self.protector = MemoryProtector(
            tenant_limit_fn=self.qos.inflight_limit
        )
        from banyandb_tpu_torch.admin.diskmonitor import DiskMonitor

        self.disk = DiskMonitor(self.root)
        # slow-query plane: one threshold governs the access log's slow
        # mark and the flight recorder (server config / BYDB_SLOW_QUERY_MS)
        if slow_query_ms is None:
            slow_query_ms = env_float(
                "BYDB_SLOW_QUERY_MS", AccessLog.DEFAULT_SLOW_QUERY_MS
            )
        self.slow_query_ms = slow_query_ms
        # serving-cache entry capacity (flag > BYDB_SERVING_CACHE_CAP
        # env > bytes-only): entry churn is an operator-sized knob
        if serving_cache_cap is not None and serving_cache_cap > 0:
            from banyandb_tpu_torch.storage.cache import global_cache

            global_cache().set_cap(serving_cache_cap)
        self.slowlog = SlowQueryRecorder()
        self.access_log = AccessLog(
            self.root / "logs" / "access.log", slow_query_ms=slow_query_ms
        )
        # self-driving materialization (query/planner): the query
        # epilogue feeds per-signature hit counts (slow queries weighted
        # double) and the bydb-autoreg loop registers hot eligible
        # signatures through the same streamagg surface operators use
        from banyandb_tpu_torch.obs.recorder import SignatureStats
        from banyandb_tpu_torch.query import planner as planner_mod
        from banyandb_tpu_torch.query.precompile import default_registry as _pre_reg

        # the process-global plan registry warms on this server's device
        # (start()'s warm_async runs on a background thread)
        _pre_reg().device = self.device
        self.sig_stats = SignatureStats()
        self.autoreg = planner_mod.AutoRegistrar(
            self.root / "autoreg.json",
            sig_stats=self.sig_stats,
            register_fn=lambda g, m, kt, f: self._streamagg({
                "op": "register", "group": g, "measure": m,
                "key_tags": list(kt), "fields": list(f),
                "origin": "auto",
            }),
            unregister_fn=lambda g, m, kt, f: bool(
                self._streamagg({
                    "op": "unregister", "group": g, "measure": m,
                    "key_tags": list(kt), "fields": list(f),
                }).get("unregistered")
            ),
            stats_fn=self._streamagg_signature_rows,
            plan_registry=_pre_reg(),
        )
        # schema docs dogfood the property engine (schemaserver analog);
        # the registry's own JSON files remain as a migration-safe mirror
        from banyandb_tpu_torch.cluster.schema_plane import PropertySchemaStore

        self.schema_store = PropertySchemaStore(self.registry, self.property)
        self.bus = LocalBus()
        self._register()
        # port=None: in-process only; grpc is imported by the bus server
        # itself, so the card's in-process path never loads it
        self.grpc = None
        if port is not None:
            from banyandb_tpu_torch.cluster.rpc import GrpcBusServer

            self.grpc = GrpcBusServer(self.bus, port=port)
        # reference-proto surfaces (banyandb.*.v1 gRPC + HTTP gateway);
        # None disables a tier
        self.wire = None
        self.http = None
        # wire/http surfaces speak to the data plane through whatever
        # shape is live: engines in-process, or the liaison adapters
        # over the worker pool (the cluster_server trio — the pool's
        # embedded Liaison has the same surface as the cluster one)
        if self.pool is not None:
            # every model rides its pool adapter, not a bare liaison
            # one: wire writes must journal-then-forward (the crash
            # contract covers EVERY ack, not just bus writes) and wire
            # TopN needs the pool's scatter plane (topn_scatter)
            _wire_measure = self._pool_measure
            _wire_stream = self._pool_stream
            _wire_trace = self._pool_trace
        else:
            _wire_measure, _wire_stream, _wire_trace = (
                self.measure, self.stream, self.trace,
            )
        if wire_port is not None:
            from banyandb_tpu_torch.api.grpc_server import WireServer, WireServices

            self._wire_services = WireServices(
                self.registry,
                _wire_measure,
                _wire_stream,
                property_engine=self.property,
                trace_engine=_wire_trace,
                node_info={
                    "name": "standalone",
                    "grpc_address": f"127.0.0.1:{wire_port}",
                    "roles": ("data", "liaison"),
                },
                schema_store=self.schema_store,
            )
            self.wire = WireServer(
                self._wire_services, port=wire_port, auth_file=auth_file
            )
        if http_port is not None:
            from banyandb_tpu_torch.api.grpc_server import WireServices
            from banyandb_tpu_torch.api.http_gateway import HttpGateway

            svcs = getattr(self, "_wire_services", None) or WireServices(
                self.registry,
                _wire_measure,
                _wire_stream,
                property_engine=self.property,
                trace_engine=_wire_trace,
            )
            # one users file governs both surfaces: an auth_file that only
            # locked gRPC while HTTP served the same CRUD would be a trap
            http_auth = None
            if auth_file:
                if self.wire is not None and self.wire.auth is not None:
                    http_auth = self.wire.auth
                else:
                    from banyandb_tpu_torch.api.auth import AuthReloader

                    http_auth = AuthReloader(auth_file)
            self.http = HttpGateway(
                svcs, port=http_port, auth=http_auth, slowlog=self.slowlog
            )
        self.pprof = None
        if pprof_port is not None:
            from banyandb_tpu_torch.admin.profiling import ProfilingServer

            self.pprof = ProfilingServer(port=pprof_port)
        # FODC agent plane (fodc/agent analog): watchdog feeds a flight
        # recorder from the node's meter + process stats; the pressure
        # profiler rides it, capturing artifacts when RSS crosses the
        # cgroup-derived threshold.  On-demand pprof capture is served
        # over the bus (PPROF_TOPIC).
        from banyandb_tpu_torch.admin import fodc_agent

        self.flight_recorder = fodc_agent.FlightRecorder()
        self.watchdog = fodc_agent.Watchdog(
            self.flight_recorder,
            [
                fodc_agent.meter_source(self.meter),
                fodc_agent.process_source,
                fodc_agent.io_source(),  # ktm io-monitor host re-scope
            ],
            node_role="standalone",
        )
        self.pressure_profiler = None
        if self.protector.limit:
            self.pressure_profiler = fodc_agent.PressureProfiler(
                self.root / "pressure-profiles",
                limit_bytes=self.protector.limit,
            )
            self.watchdog.add_post_poll_hook(self.pressure_profiler.hook)

    # -- wiring -------------------------------------------------------------
    def _register(self) -> None:
        b = self.bus
        b.subscribe(Topic.HEALTH, lambda env: {"status": "ok", "role": "standalone"})
        from banyandb_tpu_torch.admin import fodc_agent as _fa

        b.subscribe(_fa.PPROF_TOPIC, _fa.pprof_capture_handler)
        b.subscribe(Topic.MEASURE_WRITE, self._measure_write)
        b.subscribe(Topic.MEASURE_WRITE_COLUMNS, self._measure_write_columns)
        b.subscribe(Topic.MEASURE_QUERY_RAW, self._measure_query)
        b.subscribe(Topic.STREAM_WRITE, self._stream_write)
        b.subscribe(Topic.TRACE_WRITE, self._trace_write)
        b.subscribe(Topic.TRACE_QUERY_BY_ID, self._trace_query)
        b.subscribe(Topic.PROPERTY_APPLY, self._property_apply)
        b.subscribe(Topic.PROPERTY_QUERY, self._property_query)
        b.subscribe(TOPIC_QL, self._ql)
        b.subscribe(TOPIC_REGISTRY, self._registry_op)
        b.subscribe(TOPIC_STREAM_QUERY, self._stream_query)
        b.subscribe(TOPIC_SNAPSHOT, self._snapshot)
        b.subscribe(TOPIC_METRICS, self._metrics)
        b.subscribe(TOPIC_SLOWLOG, self._slowlog)
        b.subscribe(TOPIC_DIAGNOSTICS, self._diagnostics)
        b.subscribe(TOPIC_TOPN, self._topn)
        b.subscribe(TOPIC_STREAMAGG, self._streamagg)
        b.subscribe(TOPIC_QOS, self._qos)

    # -- handlers -----------------------------------------------------------
    def _measure_write(self, env):
        req = serde.write_request_from_json(env["request"])
        size = len(req.points) * _POINT_BYTES
        # write-side admission control (protector.AcquireResource +
        # disk_monitor.go:86 analogs, plus the per-tenant QoS token
        # bucket): shed load with ServerBusy / DiskFull instead of
        # OOMing or filling the data filesystem — never a silent drop
        self.disk.check_write()
        tenant = self.qos.admit_write(req.group, len(req.points))
        self.protector.acquire(size, tenant=tenant)
        t0 = time.perf_counter()
        try:
            with tenant_scope(tenant):
                if self.pool is not None:
                    # shard-partitioned forward to the owning workers
                    # (journaled ack — docs/performance.md)
                    n = self.pool.write_measure(req)
                else:
                    # batch decode -> columns -> bulk path (identical
                    # semantics to the row path incl. TopN observation)
                    n = self.measure.write_points_bulk(req)
        finally:
            self.protector.release(size, tenant=tenant)
        ms = (time.perf_counter() - t0) * 1000
        self.meter.counter_add("measure_write_points", n)
        self.meter.observe("write_ms", ms, {"model": "measure"})
        self.access_log.log_write(req.group, req.name, n, ms, tenant=tenant)
        return {"written": n}

    def _measure_write_columns(self, env):
        """Columnar write envelope (Topic.MEASURE_WRITE_COLUMNS): ts and
        numeric fields ride as base64-packed little-endian arrays, tag
        columns as JSON string lists or {"dict": [...], "codes": b64-i32}
        dictionary pairs.  One decode pass feeds write_columns — the
        envelope exists because per-point JSON dicts were the measured
        hot loop of the wire ingest path."""
        group, name = env["group"], env["name"]
        # row count from base64 length arithmetic — the ts column is
        # decoded exactly once, inside the codec (or the pool's router)
        ts_b64 = env["ts"]
        pad = 2 if ts_b64.endswith("==") else (1 if ts_b64.endswith("=") else 0)
        n = ((len(ts_b64) // 4) * 3 - pad) // 8
        size = n * _POINT_BYTES
        self.disk.check_write()
        tenant = self.qos.admit_write(group, n)
        self.protector.acquire(size, tenant=tenant)
        t0 = time.perf_counter()
        try:
            with tenant_scope(tenant):
                if self.pool is not None:
                    # vectorized shard routing + per-worker envelope
                    # slices (cluster/workers.py); the codes stay
                    # dictionary-encoded end-to-end on both paths
                    written = self.pool.write_measure_columns(env)
                else:
                    # shared wire codec (cluster/serde.py): engine +
                    # memtable consume the decoded codes directly
                    written = self.measure.write_columns(
                        **serde.write_columns_env_decode(env)
                    )
        finally:
            self.protector.release(size, tenant=tenant)
        ms = (time.perf_counter() - t0) * 1000
        self.meter.counter_add("measure_write_points", written)
        self.meter.observe("write_ms", ms, {"model": "measure"})
        self.access_log.log_write(group, name, written, ms, tenant=tenant)
        return {"written": written}

    def _admit_query(self, req, env):
        """Weighted per-tenant query admission (docs/robustness.md
        "Multi-tenant QoS"): entering the returned ticket may queue
        while the query's propagated deadline still has headroom, then
        sheds with the retryable ServerBusy wire kind."""
        deadline_ms = env.get("deadline_ms")
        return self.qos.admit_query(
            req.groups[0] if req.groups else "",
            deadline_s=(
                float(deadline_ms) / 1000.0 if deadline_ms else None
            ),
        )

    @staticmethod
    def _tag_qos(tracer, adm) -> None:
        """The ``qos`` span on the obs plane: which tenant ran, and how
        long admission queued it (only tagged when it actually queued)."""
        with tracer.span("qos") as sp:
            sp.tag("tenant", adm.tenant)
            if adm.queued_ms >= 1.0:
                sp.tag("queued_ms", round(adm.queued_ms, 2))

    def _measure_query(self, env):
        from banyandb_tpu_torch.obs import Tracer

        # the server always runs a tracer (a handful of spans per query,
        # sub-microsecond): slow queries land in the flight recorder with
        # their full tree whether or not the client asked for trace=true;
        # the tree only rides the RESPONSE when req.trace is set
        tracer = Tracer("standalone:measure")
        with tracer.span("wire_decode"):
            req = serde.query_request_from_json(env["request"])
        adm = self._admit_query(req, env)
        with adm, tenant_scope(adm.tenant):
            self._tag_qos(tracer, adm)
            t0 = time.perf_counter()
            if self.pool is not None:
                res = self.pool.query_measure(req, tracer=tracer)
            else:
                res = self.measure.query(req, tracer=tracer)
            ms = (time.perf_counter() - t0) * 1000
        tree = tracer.finish()
        self.meter.observe("measure_query_ms", ms)
        self._observe_query(
            "measure", req, ms,
            rows=len(res.data_points) or len(res.groups),
            tree=tree, res=res, tenant=adm.tenant,
        )
        attach_tree(res, req, tree)
        return {"result": result_to_json(res)}

    def _observe_query(
        self, engine: str, req, ms: float, *, rows: int, tree: dict,
        res=None, ql=None, tenant: str = "",
    ) -> None:
        """Shared query epilogue: access log + slow-query flight record
        (span tree + plan text, bounded ring — the slowlog topic)."""
        from banyandb_tpu_torch.obs.recorder import record_slow_query

        group = req.groups[0] if req.groups else ""
        tenant = tenant or tenant_of_group(group)
        self.access_log.log_query(
            group, req.name, ms, ql=ql, rows=rows, tenant=tenant
        )
        if engine == "measure":
            # autoreg evidence: every measure query's streamagg-eligible
            # signature counts; slow ones count double (materialization
            # helps them most)
            from banyandb_tpu_torch.query import planner as planner_mod

            self.sig_stats.observe(
                planner_mod.signature_of(req),
                weight=2 if ms >= self.slow_query_ms else 1,
            )

        def render_plan():
            # post-hoc plan render: slow queries only, never hot
            from banyandb_tpu_torch.query import logical

            if engine == "measure":
                m = self.registry.get_measure(group, req.name)
                return logical.analyze_measure(m, req).explain()
            if engine == "stream":
                s = self.registry.get_stream(group, req.name)
                return logical.analyze_stream(s, req).explain()
            if engine == "trace":
                from banyandb_tpu_torch.models import trace as trace_model

                t = self.registry.get_trace(group, req.name)
                kind, _, _, _, _ = trace_model.classify_plan(
                    req, t.trace_id_tag
                )
                return (
                    f"trace plan={kind} order_by={req.order_by_tag or '-'}"
                    f" limit={req.limit} offset={req.offset}"
                )
            return None

        record_slow_query(
            self.slowlog, self.slow_query_ms,
            engine=engine, group=group, name=req.name,
            duration_ms=ms, rows=rows, span_tree=tree, ql=ql,
            plan=(res.trace or {}).get("plan") if res is not None else None,
            plan_fn=render_plan,
            tenant=tenant,
        )
        self.self_trace.offer(
            engine=engine, group=group, name=req.name,
            duration_ms=ms, tree=tree, tenant=tenant, ql=ql,
        )

    def _slowlog(self, env):
        from banyandb_tpu_torch.obs.recorder import slowlog_topic_reply

        return slowlog_topic_reply(self.slowlog, env, self.slow_query_ms)

    def _metrics(self, env):
        self.meter.gauge_set("rss_bytes", _rss())
        # cache planes surface through the metrics topic so operators
        # read hit/miss/eviction counters from the RUNNING server, not
        # process-local globals
        from banyandb_tpu_torch.query.precompile import default_registry
        from banyandb_tpu_torch.storage.cache import device_cache, global_cache
        from banyandb_tpu_torch.utils import compile_cache

        for scope, cache in (
            ("serving", global_cache()),
            ("device", device_cache()),
        ):
            st = cache.stats()
            for k in (
                "hits", "misses", "evictions", "entries", "bytes",
                "cap", "churn",
            ):
                self.meter.gauge_set(f"{scope}_cache_{k}", float(st[k]))
        # materialized rolling-window plane (query/streamagg.py):
        # window/state population + per-signature watermark gauges
        self.measure.streamagg.export_gauges()
        # the kernel library's build cache (entries = built .so files)
        cc = compile_cache.stats()
        self.meter.gauge_set("compile_cache_enabled", float(cc["enabled"]))
        for k in ("hits", "misses", "entries"):
            self.meter.gauge_set(f"compile_cache_{k}", float(cc[k]))
        # multi-tenant QoS plane: admission gauges + per-tenant cache
        # partitions (tenant-labeled rows; the default tenant keeps its
        # original unlabeled series — no renames)
        self.qos.export_gauges(self.meter)
        from banyandb_tpu_torch.storage.cache import partition_stats

        for tenant, st in partition_stats().items():
            for k in ("hits", "misses", "evictions", "entries", "bytes"):
                self.meter.gauge_set(
                    f"serving_cache_{k}", float(st[k]), {"tenant": tenant}
                )
        for tenant, used in self.protector.tenant_usage().items():
            self.meter.gauge_set(
                "qos_inflight_bytes", float(used), {"tenant": tenant}
            )
        pr = default_registry().stats()
        for k in ("recorded", "compiled", "errors"):
            self.meter.gauge_set(f"precompile_{k}", float(pr[k]))
        ar = self.autoreg.stats()
        for k in ("known_signatures", "registered_total", "evicted_total"):
            self.meter.gauge_set(f"autoreg_{k}", float(ar[k]))
        if self.pool is not None:
            # pool gauges set BEFORE the render so the scrape that
            # matters most — every worker down, empty worker_text —
            # still carries workers_alive/workers_total
            self.meter.gauge_set(
                "workers_alive", float(len(self.pool.liaison.alive))
            )
            self.meter.gauge_set("workers_total", float(self.pool.n))
        text = self.meter.prometheus_text()
        if self.pool is not None:
            # graft worker expositions with per-worker labels — the
            # scrapers (obs/prom.py) aggregate across the worker label;
            # each worker's kernel launches and build cache ride there
            worker_text = self.pool.metrics_text()
            if worker_text:
                text = text + "\n" + worker_text
        return {"prometheus": text}

    def _streamagg(self, env):
        """Streaming-aggregation control surface (query/streamagg.py):
        register/unregister materialized dashboard signatures / read
        window state.  ``origin: "auto"`` marks autoreg registrations
        (budget-evictable; manual ones never are)."""
        if self.pool is not None:
            # windows are worker-local per shard: registrations
            # broadcast (with rejoin catch-up), stats fan out
            return self.pool.streamagg(env)
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
            return {"registered": info}
        if op == "unregister":
            removed = self.measure.streamagg.unregister(
                env["group"],
                env["measure"],
                key_tags=tuple(env.get("key_tags", ())),
                fields=tuple(env.get("fields", ())),
                window_millis=env.get("window_millis"),
            )
            return {"unregistered": removed}
        if op == "stats":
            return {"streamagg": self.measure.streamagg.stats()}
        raise KeyError(f"bad streamagg op {op!r}")

    def _streamagg_signature_rows(self) -> list:
        """Flat signature-stat rows for the autoreg budget (pool mode
        merges per-worker rows: states/hits sum, last-hit maxes)."""
        st = self._streamagg({"op": "stats"}).get("streamagg") or {}
        if self.pool is None:
            return st.get("signatures", [])
        merged: dict = {}
        for wstats in st.values():
            for row in (wstats or {}).get("signatures", ()):
                key = (
                    row.get("group"), row.get("measure"),
                    tuple(row.get("key_tags", ())),
                    tuple(row.get("fields", ())),
                )
                cur = merged.get(key)
                if cur is None:
                    merged[key] = dict(row)
                else:
                    cur["states"] = int(cur.get("states", 0)) + int(
                        row.get("states", 0)
                    )
                    cur["hits"] = int(cur.get("hits", 0)) + int(
                        row.get("hits", 0)
                    )
                    cur["last_hit_ms"] = max(
                        cur.get("last_hit_ms") or 0,
                        row.get("last_hit_ms") or 0,
                    ) or None
        return list(merged.values())

    def _topn(self, env):
        """TopN query over pre-aggregated windows (TopNService analog)."""
        from banyandb_tpu_torch.api.model import TimeRange
        from banyandb_tpu_torch.models import topn as topn_mod

        rules = {r.name for r in self.registry.list_topn(env["group"])}
        if env["name"] not in rules:
            raise KeyError(
                f"topn rule {env['name']} not found in group {env['group']}"
            )
        adm = self.qos.admit_query(
            env["group"],
            deadline_s=(
                float(env["deadline_ms"]) / 1000.0
                if env.get("deadline_ms")
                else None
            ),
        )
        with adm, tenant_scope(adm.tenant):
            if self.pool is not None:
                # scatter the node-local ranking; entities are shard-
                # routed so the concat re-rank is exact (cluster/workers)
                return self.pool.topn(env)
            ranked = topn_mod.query_topn(
                self.measure,
                env["group"],
                env["name"],
                TimeRange(*env["time_range"]),
                n=env.get("n", 10),
                direction=env.get("direction", "desc"),
                agg=env.get("agg", "sum"),
                # same envelope contract as DataNode._on_topn
                conditions=tuple(
                    (c[0], c[1], c[2]) for c in env.get("conditions", ())
                ),
            )
        return {
            "items": [
                {"entity": list(ent), "value": val} for ent, val in ranked
            ]
        }

    def _qos(self, env):
        """QoS introspection topic: per-tenant admission counters,
        limits, cache partitions and in-flight charges."""
        from banyandb_tpu_torch.storage.cache import partition_stats

        return {
            "qos": self.qos.stats(),
            "cache_partitions": partition_stats(),
            "inflight_bytes": self.protector.tenant_usage(),
        }

    def _diagnostics(self, env):
        from banyandb_tpu_torch.admin.diagnostics import DiagnosticsCollector

        collector = DiagnosticsCollector(self.root, self.meter)
        return collector.collect(
            include_threads=bool(env.get("include_threads"))
        )

    def _stream_write(self, env):
        self.disk.check_write()
        tenant = self.qos.admit_write(env["group"], len(env["elements"]))
        t0 = time.perf_counter()
        with tenant_scope(tenant):
            if self.pool is not None:
                # elements already ride the liaison wire shape; the pool
                # routes them by entity-hash shard to the owning workers
                n = self.pool.write_stream(
                    env["group"], env["name"], env["elements"]
                )
            else:
                n = self.stream.write(
                    env["group"], env["name"],
                    serde.elements_from_json(env["elements"]),
                )
        self.meter.observe(
            "write_ms", (time.perf_counter() - t0) * 1000, {"model": "stream"}
        )
        return {"written": n}

    def _stream_query(self, env):
        from banyandb_tpu_torch.obs import Tracer

        req = serde.query_request_from_json(env["request"])
        tracer = Tracer("standalone:stream")
        adm = self._admit_query(req, env)
        with adm, tenant_scope(adm.tenant):
            self._tag_qos(tracer, adm)
            t0 = time.perf_counter()
            if self.pool is not None:
                res = self.pool.query_stream(req, tracer=tracer)
            else:
                res = self.stream.query(req, tracer=tracer)
            ms = (time.perf_counter() - t0) * 1000
        tree = tracer.finish()
        self._observe_query(
            "stream", req, ms, rows=len(res.data_points), tree=tree,
            res=res, tenant=adm.tenant,
        )
        attach_tree(res, req, tree)
        return {"result": result_to_json(res)}

    def _trace_write(self, env):
        self.disk.check_write()
        tenant = self.qos.admit_write(env["group"], len(env["spans"]))
        t0 = time.perf_counter()
        with tenant_scope(tenant):
            if self.pool is not None:
                n = self.pool.write_trace(
                    env["group"], env["name"], env["spans"],
                    ordered_tags=tuple(env.get("ordered_tags", ())),
                )
            else:
                n = self.trace.write(
                    env["group"], env["name"],
                    serde.spans_from_json(env["spans"]),
                    ordered_tags=tuple(env.get("ordered_tags", ())),
                )
        self.meter.observe(
            "write_ms", (time.perf_counter() - t0) * 1000, {"model": "trace"}
        )
        return {"written": n}

    def _trace_query(self, env):
        if self.pool is not None:
            spans = self.pool.query_trace_by_id(
                env["group"], env["name"], env["trace_id"]
            )
        else:
            spans = self.trace.query_by_trace_id(
                env["group"], env["name"], env["trace_id"]
            )
        return {"spans": serde.spans_to_json(spans)}

    def _property_apply(self, env):
        self.disk.check_write()
        p = self.property.apply(
            Property(
                group=env["group"], name=env["name"], id=env["id"],
                tags=env.get("tags", {}),
            ),
            strategy=env.get("strategy", "merge"),
            ttl_seconds=env.get("ttl_seconds"),
        )
        return {"mod_revision": p.mod_revision, "create_revision": p.create_revision}

    def _property_query(self, env):
        if "id" in env:
            p = self.property.get(env["group"], env["name"], env["id"])
            return {"properties": [p.tags] if p else []}
        props = self.property.query(
            env["group"], env["name"],
            tag_filters=env.get("tag_filters"),
            limit=env.get("limit", 100),
        )
        return {"properties": [{"id": p.id, "tags": p.tags} for p in props]}

    def _ql(self, env):
        from banyandb_tpu_torch.obs import Tracer

        catalog, req = bydbql.parse_with_catalog(
            env["ql"], env.get("params", ())
        )
        if env.get("trace"):
            # explain (and any caller wanting the in-band tree): force
            # request-level tracing so the reply carries plan text +
            # span tree without a QL syntax extension
            import dataclasses as _dc

            req = _dc.replace(req, trace=True)
        tracer = Tracer(f"standalone:{catalog}")
        adm = self._admit_query(req, env)
        with adm, tenant_scope(adm.tenant):
            self._tag_qos(tracer, adm)
            t0 = time.perf_counter()
            if catalog == "stream":
                if self.pool is not None:
                    res = self.pool.query_stream(req, tracer=tracer)
                else:
                    res = self.stream.query(req, tracer=tracer)
            elif catalog == "trace":
                with tracer.span("execute"):
                    res = self._ql_trace(req, tracer=tracer)
            elif catalog == "property":
                with tracer.span("execute"):
                    res = self._ql_property(req)
            elif self.pool is not None:
                res = self.pool.query_measure(req, tracer=tracer)
            else:
                res = self.measure.query(req, tracer=tracer)
            ms = (time.perf_counter() - t0) * 1000
        tree = tracer.finish()
        self._observe_query(
            catalog, req, ms,
            rows=len(res.data_points) or len(res.groups),
            tree=tree, res=res, ql=env["ql"], tenant=adm.tenant,
        )
        attach_tree(res, req, tree)
        # serve-path marker OUTSIDE the result payload (the A/B byte
        # parity contracts compare reply["result"] only): a load harness
        # splits its latency headline into cache replay vs real
        # (cache-miss) scans vs materialized-window reads with this
        return {"result": result_to_json(res), "served": _served_class(tree)}

    def _ql_trace(self, req: QueryRequest, tracer=None) -> QueryResult:
        from banyandb_tpu_torch.query import ql_exec

        engine = self._pool_trace if self.pool is not None else self.trace
        return ql_exec.execute_trace_ql(engine, req, tracer=tracer)

    def _ql_property(self, req: QueryRequest) -> QueryResult:
        from banyandb_tpu_torch.query import ql_exec

        return ql_exec.execute_property_ql(self.property, req)

    def _registry_op(self, env):
        op, kind = env["op"], env["kind"]
        if op == "create":
            cls = schema_mod._KINDS[kind]
            obj = schema_mod._from_jsonable(cls, env["item"])
            if kind == "group":
                rev = self.registry.create_group(obj)
            elif kind == "measure":
                rev = self.registry.create_measure(obj)
            elif kind == "index_rule":
                rev = self.registry.create_index_rule(obj)
            elif kind == "topn":
                rev = self.registry.create_topn(obj)
            else:
                raise KeyError(kind)
            return {"revision": rev}
        if op == "create_stream":
            item = env["item"]
            self.stream.create_stream(
                Stream(
                    group=item["group"], name=item["name"],
                    tags=tuple(
                        schema_mod.TagSpec(t["name"], schema_mod.TagType(t["type"]))
                        for t in item["tags"]
                    ),
                    entity=tuple(item["entity"]),
                )
            )
            return {"revision": self.registry.revision}
        if op == "create_trace":
            item = env["item"]
            self.trace.create_trace(
                Trace(
                    group=item["group"], name=item["name"],
                    tags=tuple(
                        schema_mod.TagSpec(t["name"], schema_mod.TagType(t["type"]))
                        for t in item["tags"]
                    ),
                    trace_id_tag=item["trace_id_tag"],
                )
            )
            return {"revision": self.registry.revision}
        if op == "list":
            if kind == "group":
                items = self.registry.list_groups()
            elif kind == "measure":
                items = self.registry.list_measures(env["group"])
            else:
                raise KeyError(kind)
            return {"items": [schema_mod._to_jsonable(i) for i in items]}
        raise KeyError(f"bad registry op {op}")

    def _snapshot(self, env):
        # flush everything so on-disk state is complete, then report dirs
        flushed = []
        if self.pool is not None:
            # worker flushes also trim the parent write journal to the
            # flush watermark (cluster/workers.py)
            flushed += self.pool.flush()
        else:
            flushed += self.measure.flush()
            flushed += self.stream.flush()
            flushed += self.trace.flush()
        self.property.persist()
        self.self_metrics.flush()  # self-measures land in _monitoring
        self.self_trace.flush()  # queued self-query span trees likewise
        return {"flushed": flushed, "root": str(self.root)}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        # plan precompile at schema load: bind the per-root signature
        # store and warm recorded + builtin plan signatures on a
        # background thread (on this server's device), so the first
        # query after boot finds the kernel library loaded and the
        # executors built
        from banyandb_tpu_torch.query.precompile import default_registry

        reg = default_registry()
        reg.attach_store(self.root / "plan-registry.json")
        reg.warm_async()
        # the bydb-autoreg loop (query/planner): self-driving streamagg
        # registration under an eviction budget (BYDB_AUTOREG=0 disables)
        from banyandb_tpu_torch.query import planner as planner_mod

        if planner_mod.autoreg_enabled():
            self.autoreg.start()
        # one lifecycle group drives storage loops for ALL engines' TSDBs
        # AND property-lease GC
        self.measure.start_lifecycle(
            extra_tick=self._sweep_properties,
            # ordering keys must be durable BEFORE the span memtables they
            # describe flush (sidx-first commit ordering; mirrors the
            # data-node wiring in cluster/data_node.py)
            pre_flush=self.trace._flush_sidx_first,
            extra_tsdbs=lambda: (
                list(self.stream._tsdbs.values())
                + list(self.trace._tsdbs.values())
            ),
        )
        if self.grpc is not None:
            self.grpc.start()
        self.watchdog.start()
        # periodic _monitoring population (the native-meter provider
        # cadence); thread owned here, joined in stop()
        self.self_metrics.start()
        self.self_trace.start()
        if self.wire is not None:
            self.wire.start()
        if self.http is not None:
            self.http.start()
        if self.pprof is not None:
            self.pprof.start()

    def _sweep_properties(self) -> None:
        for g in self.registry.list_groups():
            try:
                self.property.sweep_expired(g.name)
            except Exception:  # noqa: BLE001 - GC must not kill the loop
                pass
        try:
            # trace maintenance: bloom sidecars + sidx merge only — the
            # sidx flush already ran in pre_flush, ahead of span memtables
            self.trace.maintain(flush_sidx=False)
        except Exception:  # noqa: BLE001
            pass

    def stop(self) -> None:
        # cancel + join in-flight plan warming FIRST: the warm thread may
        # sit in the kernel library's first build or inside a launch
        from banyandb_tpu_torch.query.precompile import default_registry

        default_registry().shutdown()
        self.autoreg.stop()
        self.measure.stop_lifecycle()
        self.self_metrics.stop()
        self.self_trace.stop()
        self.watchdog.stop()
        if self.grpc is not None:
            self.grpc.stop()
        # ALL ingress surfaces close before the pool: a write landing
        # after pool.stop() would ack into a journal that dies with the
        # process (acked-write loss on graceful shutdown)
        if self.wire is not None:
            self.wire.stop()
        if self.http is not None:
            self.http.stop()
        if self.pprof is not None:
            self.pprof.stop()
        if self.pool is not None:
            # graceful worker shutdown: lifecycle loops stop, engines
            # close, processes reap (procreg process hygiene)
            self.pool.stop()
        self.access_log.close()
        # every acked row still in a memtable becomes a part before the
        # engines close: with no ingress left nothing lands after it, and
        # a reopen over this root answers every acknowledged write (the
        # reference closes without it and loses the memtables' rows)
        self.measure.flush()
        self.stream.flush()
        self.trace.flush()
        # release index mmaps/fds deterministically (fd hygiene)
        self.measure.close()
        self.stream.close()
        self.trace.close()
        self.property.close()

    @property
    def addr(self) -> str | None:
        """host:port of the gRPC bus; None when served in-process only
        (``port=None``)."""
        return None if self.grpc is None else self.grpc.addr


def build_config():
    """Flag registry (pkg/config analog: CLI > BYDB_* env > --config
    JSON file > default)."""
    from banyandb_tpu_torch.config import Config

    cfg = Config("banyandb-tpu server")
    cfg.register("root", None, "data root directory", str, required=True)
    cfg.register("port", 17912, "bus gRPC port", int)
    cfg.register(
        "wire-port", 17914,
        "reference-proto gRPC surface (banyandb.*.v1); -1 disables", int,
    )
    cfg.register("http-port", 17913, "HTTP/JSON gateway; -1 disables", int)
    cfg.register("pprof-port", -1, "profiling endpoints; -1 disables", int)
    cfg.register(
        "compile-cache-dir", "",
        "build cache of the CUDA kernel library; empty = "
        "<root>/compile-cache, 'off' disables", str,
    )
    cfg.register(
        "slow-query-ms", 500.0,
        "slow-query threshold: queries at/over it get the access-log "
        "slow mark AND a flight-recorder entry (cli.py slowlog)", float,
    )
    cfg.register(
        "serving-cache-cap", 0,
        "serving-cache ENTRY capacity on top of the byte budget "
        "(BYDB_SERVING_CACHE_CAP env; 0 = bytes-only)", int,
    )
    cfg.register(
        "workers", -1,
        "shard-owning worker processes for the data plane "
        "(BYDB_WORKERS env): N>0 partitions shards over N subprocesses, "
        "0 = single-process layout, -1 = auto (on by default on hosts "
        "with >= 4 cores)", int,
    )
    # role topology (pkg/cmdsetup/root.go:89-91 standalone/data/liaison)
    cfg.register("role", "standalone", "standalone | data | liaison", str)
    cfg.register("name", "", "node name (data role)", str)
    cfg.register(
        "discovery", "", "node-list JSON file (liaison role)", str
    )
    cfg.register("replicas", 0, "replica count (liaison role)", int)
    # not a flag of the JAX package's command: the torch device the
    # engines scan on and the plan registry warms on
    cfg.register(
        "device", "cuda",
        "torch device of the engines: cuda by default, "
        "so the command runs on the card; without CUDA it refuses unless "
        "cpu is asked for", str,
    )
    return cfg


def main(argv=None) -> None:
    """``python -m banyandb_tpu_torch.server``: the standalone, data and
    liaison roles.  The roles that hold engines (standalone, data) scan
    on ``--device``: CUDA by default, and without CUDA the command
    refuses unless ``--device cpu`` was given.  The liaison holds no
    engine and works on the host."""
    import os as _os
    import sys as _sys

    from banyandb_tpu_torch.run import FuncUnit, Group

    s = build_config().load(argv)
    if s.role not in ("standalone", "data", "liaison"):
        raise SystemExit(f"unknown role {s.role!r}")
    device = None
    if s.role != "liaison":
        # no silent host fallback: without CUDA the command refuses
        # unless --device cpu was asked for
        try:
            device = resolve_device(s.device)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"error: {e} (--device cpu runs on the host)")
    # the kernel library's build cache, wired before any kernel builds:
    # the library builds once per machine, not once per process.  The
    # flag has already folded CLI > BYDB_COMPILE_CACHE_DIR env > config
    # file precedence via config.py.
    from pathlib import Path as _Path

    from banyandb_tpu_torch.utils import compile_cache

    if s.compile_cache_dir:
        compile_cache.enable_at(s.compile_cache_dir)
    else:
        compile_cache.enable_at(_Path(s.root) / "compile-cache")
    # an armed fault plane must be impossible to miss in a server log
    # (docs/robustness.md): chaos harnesses set it on purpose, a stray
    # env var in production must not inject faults silently
    from banyandb_tpu_torch.utils.envflag import env_str

    _faults_spec = env_str("BYDB_FAULTS").strip()
    if _faults_spec:
        print(
            f"warning: fault injection ARMED via BYDB_FAULTS="
            f"{_faults_spec!r}",
            file=_sys.stderr,
            flush=True,
        )
    # role-irrelevant flags must not silently do nothing (an operator
    # passing --http-port to a data node would wait on a port never bound)
    _ignored = {
        "data": [
            ("wire-port", s.wire_port != 17914),
            ("http-port", s.http_port != 17913),
            ("pprof-port", s.pprof_port != -1),
            ("discovery", bool(s.discovery)),
            ("replicas", s.replicas != 0),
            # the multi-process data plane lives in the standalone
            # role; cluster data nodes scale by adding node processes
            ("workers", s.workers not in (-1, 0)),
        ],
        "liaison": [
            ("pprof-port", s.pprof_port != -1),
            ("name", bool(s.name)),
            # liaisons hold no serving cache; data nodes size theirs via
            # the BYDB_SERVING_CACHE_CAP env (per-process)
            ("serving-cache-cap", s.serving_cache_cap != 0),
            ("workers", s.workers not in (-1, 0)),
            # the liaison holds no engine: it scans nothing
            ("device", s.device != "cuda"),
        ],
        "standalone": [
            ("discovery", bool(s.discovery)),
            ("replicas", s.replicas != 0),
            ("name", bool(s.name)),
        ],
    }[s.role]
    for flag, was_set in _ignored:
        if was_set:
            print(
                f"warning: --{flag} has no effect with --role {s.role}",
                file=_sys.stderr,
                flush=True,
            )
    if s.role == "data":
        from banyandb_tpu_torch.cluster_server import DataServer

        if s.serving_cache_cap:
            # data nodes hold the serving cache in cluster mode: the
            # entry-cap knob applies there exactly like standalone
            from banyandb_tpu_torch.storage.cache import global_cache

            global_cache().set_cap(s.serving_cache_cap)
        srv = DataServer(s.root, name=s.name, port=s.port, device=device)

        def announce():
            srv.start()
            print(
                f"banyandb-tpu data node {srv.name!r} on {srv.addr}",
                flush=True,
            )
            print(f"device: {srv.device}", flush=True)
    elif s.role == "liaison":
        from banyandb_tpu_torch.cluster_server import LiaisonServer

        if not s.discovery:
            raise SystemExit("liaison role requires --discovery <nodes.json>")
        srv = LiaisonServer(
            s.root, s.discovery, port=s.port, replicas=s.replicas,
            wire_port=None if s.wire_port < 0 else s.wire_port,
            http_port=None if s.http_port < 0 else s.http_port,
            slow_query_ms=s.slow_query_ms,
        )

        def announce():
            srv.start()
            print(
                f"banyandb-tpu liaison on {srv.addr} "
                f"(data nodes alive: {sorted(srv.liaison.alive)})",
                flush=True,
            )
            if srv.wire is not None:
                print(f"wire gRPC (banyandb.*.v1) on :{srv.wire.port}", flush=True)
            if srv.http is not None:
                print(f"HTTP gateway + console on :{srv.http.port}", flush=True)
    else:
        # on-by-default A/B flag (docs/performance.md "Multi-process
        # data plane"): auto resolves to a worker fleet on hosts with
        # enough cores to win from one; tiny hosts keep the
        # single-process layout (a 2-core box convoys either way)
        workers = s.workers
        if workers < 0:
            cpu = _os.cpu_count() or 1
            workers = min(4, cpu // 2) if cpu >= 4 else 0
        srv = StandaloneServer(
            s.root,
            s.port,
            wire_port=None if s.wire_port < 0 else s.wire_port,
            http_port=None if s.http_port < 0 else s.http_port,
            pprof_port=None if s.pprof_port < 0 else s.pprof_port,
            slow_query_ms=s.slow_query_ms,
            serving_cache_cap=s.serving_cache_cap or None,
            workers=workers,
            device=device,
        )

        def announce():
            srv.start()
            print(f"banyandb-tpu standalone listening on {srv.addr}", flush=True)
            print(f"device: {srv.device}", flush=True)
            if srv.pool is not None:
                print(
                    f"multi-process data plane: {srv.pool.n} shard workers",
                    flush=True,
                )
            if srv.wire is not None:
                print(f"wire gRPC (banyandb.*.v1) on :{srv.wire.port}", flush=True)
            if srv.http is not None:
                print(f"HTTP gateway + console on :{srv.http.port}", flush=True)
            if srv.pprof is not None:
                print(f"profiling endpoints on :{srv.pprof.port}", flush=True)

    group = Group(s.role)
    group.add(FuncUnit("server", serve=announce, stop=srv.stop))
    # panic supervisor: uncaught exceptions on any thread write a crash
    # artifact and trigger orderly teardown (supervisor.go analog)
    from banyandb_tpu_torch.admin.supervisor import Supervisor

    Supervisor(srv.root, on_crash=group.trigger_stop).install()
    group.run()
    # grpc's worker threads are non-daemon; an in-flight slow handler
    # (e.g. the kernel library's first build) must not wedge process
    # exit after SIGTERM.
    _os._exit(0)


if __name__ == "__main__":
    main()
