"""Wire-compatible gRPC server: the reference's proto services.

Serves the upstream service surface (banyand/liaison/grpc/server.go:448
registers the same set) on real protobuf so any client generated from
the BanyanDB protos can connect:

- banyandb.measure.v1.MeasureService      Query / Write (bidi) / TopN
- banyandb.stream.v1.StreamService        Query / Write (bidi)
- banyandb.database.v1.GroupRegistryService    CRUD
- banyandb.database.v1.MeasureRegistryService  CRUD
- banyandb.database.v1.StreamRegistryService   CRUD
- banyandb.database.v1.SnapshotService         Snapshot
- banyandb.bydbql.v1.BydbQLService             Query

Services are wired with grpc.method_handlers_generic_handler and the
generated message classes (no grpc_tools codegen step): the wire
behavior is identical to codegen'd servicers.
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Callable

import grpc

from banyandb_tpu_torch.api import pb, wire
# SchemaBarrierService key kinds (schema/v1/barrier.proto:46) -> registry
# kinds: one table, shared with the in-process barrier
from banyandb_tpu_torch.cluster.schema_plane import _BARRIER_KINDS

log = logging.getLogger("banyandb.grpc")


def _unary(fn: Callable, req_cls):
    return grpc.unary_unary_rpc_method_handler(
        fn,
        request_deserializer=req_cls.FromString,
        response_serializer=lambda m: m.SerializeToString(),
    )


def _stream_stream(fn: Callable, req_cls):
    return grpc.stream_stream_rpc_method_handler(
        fn,
        request_deserializer=req_cls.FromString,
        response_serializer=lambda m: m.SerializeToString(),
    )


def _unary_stream(fn: Callable, req_cls):
    return grpc.unary_stream_rpc_method_handler(
        fn,
        request_deserializer=req_cls.FromString,
        response_serializer=lambda m: m.SerializeToString(),
    )


def _abort(context, e: Exception):
    # lazy boundary (layering): the shed exceptions live in admin/
    from banyandb_tpu_torch.admin.diskmonitor import DiskFull
    from banyandb_tpu_torch.admin.protector import ServerBusy

    if isinstance(e, (ServerBusy, DiskFull)):
        # load shedding (QoS quota / memory gate / disk watermark) is an
        # explicit RETRYABLE rejection on the proto wire — the
        # ErrServerBusy contract, never a silent drop or a plain 500
        context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
    if isinstance(e, KeyError):
        context.abort(grpc.StatusCode.NOT_FOUND, str(e))
    if isinstance(e, NotImplementedError):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, str(e))
    if isinstance(e, FileExistsError):
        context.abort(grpc.StatusCode.ALREADY_EXISTS, str(e))
    if isinstance(e, (ValueError, TypeError)):
        context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
    log.exception("internal error")
    context.abort(grpc.StatusCode.INTERNAL, str(e))


API_VERSION = "0.10"  # upstream api/proto/banyandb/version.go:22
API_REVISION = "banyandb-tpu"


class RegistryBarrier:
    """Standalone SchemaBarrierService backend: the only 'cluster member'
    is this process's registry (barrier.proto:30 — the standalone
    implementation).  Cluster deployments pass a liaison-backed object
    with the same three methods instead."""

    def __init__(self, registry, node_name: str = "standalone"):
        self.registry = registry
        self.node = node_name

    def _poll(self, deadline: float, check):
        import time as _time

        while True:
            laggards = check()
            if not laggards or _time.monotonic() >= deadline:
                return (not laggards), laggards
            _time.sleep(0.02)

    def await_revision(self, min_revision: int, timeout_s: float):
        import time as _time

        def check():
            rev = self.registry.revision
            if rev >= min_revision:
                return []
            return [{"node": self.node, "current_mod_revision": rev}]

        return self._poll(_time.monotonic() + timeout_s, check)

    def await_applied(self, keys, min_revisions, timeout_s: float):
        import time as _time

        def check():
            missing = []
            for (kind, group, name), min_rev in zip(keys, min_revisions):
                rkind = _BARRIER_KINDS.get(kind)
                if rkind is None:
                    raise ValueError(f"unknown schema kind {kind!r}")
                key = name if rkind == "group" else f"{group}/{name}"
                st = self.registry.stored_object_hash(rkind, key)
                present = st["hash"] is not None
                # rev 0 means "just present"; local revs reset on restart,
                # so a present object always satisfies rev 0
                if not present or (min_rev and st["rev"] < min_rev):
                    missing.append((kind, group, name))
            if missing:
                return [
                    {
                        "node": self.node,
                        "current_mod_revision": self.registry.revision,
                        "missing_keys": missing,
                    }
                ]
            return []

        return self._poll(_time.monotonic() + timeout_s, check)

    def await_deleted(self, keys, timeout_s: float):
        import time as _time

        def check():
            present = []
            for kind, group, name in keys:
                rkind = _BARRIER_KINDS.get(kind)
                if rkind is None:
                    raise ValueError(f"unknown schema kind {kind!r}")
                key = name if rkind == "group" else f"{group}/{name}"
                if self.registry.stored_object_hash(rkind, key)["hash"] is not None:
                    present.append((kind, group, name))
            if present:
                return [
                    {
                        "node": self.node,
                        "current_mod_revision": self.registry.revision,
                        "still_present_keys": present,
                    }
                ]
            return []

        return self._poll(_time.monotonic() + timeout_s, check)


class WireServices:
    """Service handlers bound to the engines (StandaloneServer-compatible:
    any object exposing .registry/.measure/.stream works)."""

    def __init__(
        self,
        registry,
        measure_engine,
        stream_engine,
        bydbql_fn=None,
        property_engine=None,
        trace_engine=None,
        node_info: dict | None = None,
        cluster_view_fn=None,
        barrier=None,
        schema_store=None,
        watch_stream_cap: int = 4,
    ):
        self.registry = registry
        self.measure = measure_engine
        self.stream = stream_engine
        self.bydbql_fn = bydbql_fn
        self.property = property_engine
        self.trace = trace_engine
        # NodeQuery/ClusterState context: standalone defaults report this
        # single node as the whole (healthy) cluster
        self.node_info = node_info or {"name": "standalone", "roles": ("data", "liaison")}
        self.cluster_view_fn = cluster_view_fn or (
            lambda: {
                "tire2": {
                    "registered": [dict(self.node_info)],
                    "active": [self.node_info.get("name", "standalone")],
                    "evictable": [],
                }
            }
        )
        self.schema_store = schema_store
        self.barrier = barrier or RegistryBarrier(registry)
        # Barrier RPCs hold a worker thread for their whole wait; cap the
        # concurrent waiters so they can never exhaust the server pool and
        # starve the very writes that would satisfy them.
        import threading as _threading

        self._barrier_slots = _threading.BoundedSemaphore(4)
        # WatchSchemas streams hold a worker for their whole life; cap
        # them so watchers can never exhaust the server pool (WireServer
        # passes a cap proportional to its max_workers)
        self._watch_slots = _threading.BoundedSemaphore(watch_stream_cap)

    @staticmethod
    def _one_group(ireq) -> str:
        """Raises ValueError (-> INVALID_ARGUMENT) rather than aborting so
        the surrounding except/_abort flow stays single-shot."""
        if not ireq.groups:
            raise ValueError("groups must be non-empty")
        if len(ireq.groups) > 1:
            raise ValueError("multi-group queries are not supported yet")
        return ireq.groups[0]

    def _resolve_order(self, group: str, ireq):
        """order_by from the wire names an INDEX RULE; resolve it to the
        rule's tag (falling back to direct tag naming when no rule
        matches — both forms order correctly)."""
        if not ireq.order_by_tag:
            return ireq
        import dataclasses

        for r in self.registry.list_index_rules(group):
            if r.name == ireq.order_by_tag and r.tags:
                return dataclasses.replace(ireq, order_by_tag=r.tags[0])
        return ireq

    @staticmethod
    def _admit(group: str):
        """Per-tenant weighted query admission on the proto wire
        (docs/robustness.md "Multi-tenant QoS"); a shed maps to
        RESOURCE_EXHAUSTED in _abort.  Returns a context manager that
        also binds the tenant scope (serving-cache partitions)."""
        import contextlib

        from banyandb_tpu_torch.qos import tenant_scope
        from banyandb_tpu_torch.qos.plane import global_qos

        adm = global_qos().admit_query(group)

        @contextlib.contextmanager
        def scoped():
            with adm, tenant_scope(adm.tenant):
                yield adm

        return scoped()

    # -- MeasureService ----------------------------------------------------
    def measure_query(self, req, context):
        try:
            ireq = wire.measure_query_to_internal(req)
            if len(ireq.groups) > 1:
                return self._measure_query_multi_group(ireq)
            group = self._one_group(ireq)
            m = self.registry.get_measure(group, ireq.name)
            # projection names are schema errors, not silent drops
            # (ref WantErr project_non_existent_{tag,field} cases)
            for t in ireq.tag_projection:
                m.tag(t)
            for f in ireq.field_projection:
                m.field(f)
            ireq = self._resolve_order(group, ireq)
            with self._admit(group):
                res = self.measure.query(ireq)
            return wire.measure_result_to_pb(m, ireq, res)
        except Exception as e:  # noqa: BLE001 - mapped to gRPC status
            _abort(context, e)

    def _measure_query_multi_group(self, ireq):
        """Cross-group union (ref pkg/query/logical/measure/
        cross_group_merge.go): run the query per group against that
        group's OWN schema revision (tag/field sets may differ across
        groups — that is the feature's point), merge data points by
        timestamp in the requested time order."""
        import dataclasses as _dc

        merged = None
        for group in ireq.groups:
            m = self.registry.get_measure(group, ireq.name)
            known_tags = {t.name for t in m.tags}
            known_fields = {f.name for f in m.fields}
            sub = _dc.replace(
                ireq,
                groups=(group,),
                offset=0,  # offset applies ONCE, on the merged stream
                # the merged page [offset, offset+limit) may come wholly
                # from one group, so every sub-query must return
                # offset+limit rows — the original limit alone breaks
                # pages past the first
                limit=(ireq.offset or 0) + (ireq.limit or 100),
                tag_projection=tuple(
                    t for t in ireq.tag_projection if t in known_tags
                ),
                tag_families_projection=tuple(
                    (fam, tuple(t for t in tags if t in known_tags))
                    for fam, tags in ireq.tag_families_projection
                ),
                field_projection=tuple(
                    f for f in ireq.field_projection if f in known_fields
                ),
            )
            sub = self._resolve_order(group, sub)
            out = wire.measure_result_to_pb(
                m, sub, self.measure.query(sub)
            )
            # union projection: rows from a group lacking a projected
            # tag/field carry an explicit null in projection position
            # (ref cross-group merge emits the merged schema)
            for dp in out.data_points:
                for (fam_name, fam_tags), fam in zip(
                    ireq.tag_families_projection
                    or (("default", ireq.tag_projection),),
                    dp.tag_families,
                ):
                    have = [t.key for t in fam.tags]
                    for pos, tname in enumerate(fam_tags):
                        if tname not in have:
                            tag = pb.model_query_pb2.Tag(key=tname)
                            tag.value.null = 0
                            fam.tags.insert(pos, tag)
                            have.insert(pos, tname)
                have_f = [f.name for f in dp.fields]
                for pos, fname in enumerate(ireq.field_projection):
                    if fname not in have_f:
                        fv = pb.measure_query_pb2.DataPoint.Field(name=fname)
                        fv.value.null = 0
                        dp.fields.insert(pos, fv)
                        have_f.insert(pos, fname)
            if merged is None:
                merged = out
            else:
                merged.data_points.extend(out.data_points)
        desc = ireq.order_by_ts == "desc"
        pts = sorted(
            merged.data_points,
            key=lambda dp: (dp.timestamp.seconds, dp.timestamp.nanos),
            reverse=desc,
        )
        off = ireq.offset or 0
        del merged.data_points[:]
        merged.data_points.extend(pts[off : off + (ireq.limit or 100)])
        return merged

    _WRITE_BATCH = 256

    def measure_write(self, request_iterator, context):
        """Bidi stream with write batching: consecutive requests for the
        same measure accumulate into columnar batches committed through
        the bulk path (write_points_bulk), preserving the reference's
        one-WriteResponse-per-WriteRequest contract — responses emit
        after their batch commits.  A 1ms idle flush keeps strict
        ping-pong clients (that wait for each response) from
        deadlocking against the batcher; a failed bulk batch replays
        point-by-point so per-point statuses stay accurate."""
        import queue as _queue
        import threading as _threading

        from banyandb_tpu_torch.api import model as im

        pending: list = []  # [(wreq, decoded point), ...] one-measure run
        cur: tuple | None = None  # (group, name) of the pending run

        def _resp(wreq, status):
            r = pb.measure_write_pb2.WriteResponse(message_id=wreq.message_id)
            r.status = status
            r.metadata.CopyFrom(wreq.metadata)
            return r

        def commit():
            nonlocal pending, cur
            if not pending:
                return []
            group, name = cur
            from banyandb_tpu_torch.admin.diskmonitor import DiskFull
            from banyandb_tpu_torch.admin.protector import ServerBusy
            from banyandb_tpu_torch.qos.plane import global_qos

            try:
                # per-tenant ingest quota (QoS): the whole batch is one
                # admission charge; over-quota rejects the batch with
                # the shed-class wire status below — explicit and
                # retryable, never a silent drop
                global_qos().admit_write(group, len(pending))
                self.measure.write_points_bulk(
                    im.WriteRequest(
                        group, name, tuple(p for _, p in pending)
                    )
                )
                statuses = ["STATUS_SUCCEED"] * len(pending)
            except (ServerBusy, DiskFull):
                # the wire enum's only shed-class value (model/v1
                # Status): clients treat it as back-off-and-retry
                statuses = ["STATUS_DISK_FULL"] * len(pending)
            except Exception:  # noqa: BLE001 — replay for per-point status
                statuses = []
                for _, p in pending:
                    try:
                        self.measure.write(im.WriteRequest(group, name, (p,)))
                        statuses.append("STATUS_SUCCEED")
                    except KeyError:
                        statuses.append("STATUS_NOT_FOUND")
                    except (ServerBusy, DiskFull):
                        statuses.append("STATUS_DISK_FULL")
                    except Exception:  # noqa: BLE001
                        log.exception("measure write failed")
                        statuses.append("STATUS_INTERNAL_ERROR")
            out = [_resp(w, st) for (w, _), st in zip(pending, statuses)]
            pending, cur = [], None
            return out

        # Bounded queue restores HTTP/2 backpressure: the feeder blocks
        # once the batcher falls behind, so a client that never reads
        # responses cannot grow server memory with its whole stream.
        # `dead` unblocks the feeder if the response generator is torn
        # down early (client cancel) — a plain blocking put would leak
        # the thread.
        q: _queue.Queue = _queue.Queue(maxsize=2 * self._WRITE_BATCH)
        _DONE = object()
        dead = _threading.Event()

        def _put(item) -> bool:
            while not dead.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except _queue.Full:
                    continue
            return False

        def feeder():
            try:
                for r in request_iterator:
                    if not _put(r):
                        return
            except Exception:  # noqa: BLE001 — stream cancel/reset
                pass
            finally:
                _put(_DONE)

        _threading.Thread(target=feeder, daemon=True).start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.001 if pending else None)
                except _queue.Empty:
                    yield from commit()  # idle: client is waiting on us
                    continue
                if item is _DONE:
                    yield from commit()
                    return
                wreq = item
                key = (wreq.metadata.group, wreq.metadata.name)
                if cur is not None and (
                    key != cur or len(pending) >= self._WRITE_BATCH
                ):
                    yield from commit()
                try:
                    m = self.registry.get_measure(*key)
                    point = wire.write_request_to_point(m, wreq)
                except KeyError:
                    yield from commit()  # keep response ordering
                    yield _resp(wreq, "STATUS_NOT_FOUND")
                    continue
                except Exception:  # noqa: BLE001
                    yield from commit()
                    log.exception("measure write decode failed")
                    yield _resp(wreq, "STATUS_INTERNAL_ERROR")
                    continue
                cur = key
                pending.append((wreq, point))
        finally:
            dead.set()

    def measure_topn(self, req, context):
        try:
            from banyandb_tpu_torch.api.model import TimeRange
            from banyandb_tpu_torch.models import topn as topn_mod

            if not req.groups:
                raise ValueError("groups must be non-empty")
            # multi-group TopN (reference cross-group rank merge): the
            # rule must exist in EVERY named group; per-group ranked
            # lists merge distinct-best per entity below
            groups = list(req.groups)
            group = groups[0]
            rules_by_group = {}
            for g in groups:
                r = next(
                    (
                        r
                        for r in self.registry.list_topn(g)
                        if r.name == req.name
                    ),
                    None,
                )
                if r is None:
                    raise KeyError(
                        f"topn rule {req.name} not found in group {g}"
                    )
                rules_by_group[g] = r
            rule = rules_by_group[group]
            # ranked entities display the SOURCE measure's entity tuple
            # (reference TopNList item shape); conditions filter over
            # entity + rule group-by dims inside query_topn
            src_m = self.registry.get_measure(
                rule.source_group or group, rule.source_measure
            )
            group_tags = tuple(src_m.entity.tag_names)
            conds = []
            for c in req.conditions:
                if c.op not in wire._COND_OP:
                    # an unknown wire op must be INVALID_ARGUMENT, never
                    # silently filtered with eq semantics
                    raise ValueError(
                        f"unknown TopN condition op {c.op} on {c.name!r}"
                    )
                op = wire._COND_OP[c.op]
                if op not in ("eq", "ne", "in", "not_in"):
                    raise ValueError(f"TopN condition op {op} not supported")
                conds.append((c.name, op, wire.tag_value_to_py(c.value)))

            begin = wire.ts_to_millis(req.time_range.begin)
            end = wire.ts_to_millis(req.time_range.end)
            direction = "asc" if req.field_value_sort == 2 else "desc"
            agg = wire._AGG_FN.get(req.agg, "sum")
            n_top = req.top_n or 10

            # degraded markers accumulate across EVERY group's scatter
            # (a down worker in any leg makes the merged ranking partial)
            degraded_nodes: set = set()
            any_degraded = [False]

            def ranked_for(g: str) -> list:
                if hasattr(self.measure, "topn_scatter"):
                    # worker-pool facade: result-measure rows are worker-
                    # local, so TopN scatters per-node ranked lists and
                    # concat re-ranks (never a shard-routed query_measure,
                    # which would silently miss rows)
                    scatter = self.measure.topn_scatter({
                        "group": g,
                        "name": req.name,
                        "time_range": [begin, end],
                        "n": n_top,
                        "direction": direction,
                        "agg": agg,
                        "conditions": [list(c) for c in conds],
                    })
                    if scatter.get("degraded"):
                        any_degraded[0] = True
                        degraded_nodes.update(
                            scatter.get("unavailable_nodes", [])
                        )
                    return [
                        (tuple(it["entity"]), it["value"])
                        for it in scatter["items"]
                    ]
                return topn_mod.query_topn(
                    self.measure,
                    g,
                    req.name,
                    TimeRange(begin, end),
                    n=n_top,
                    direction=direction,
                    agg=agg,
                    conditions=tuple(conds),
                )

            if len(groups) == 1:
                ranked = ranked_for(group)
            else:
                # cross-group rank merge: distinct-best per displayed
                # entity across groups, then one re-rank with the same
                # (value, entity) tie-break the per-group path uses
                best: dict[tuple, float] = {}
                for g in groups:
                    for entity, value in ranked_for(g):
                        cur = best.get(entity)
                        if cur is None or (
                            value > cur
                            if direction == "desc"
                            else value < cur
                        ):
                            best[entity] = value
                ranked = sorted(
                    best.items(),
                    key=lambda kv: (kv[1], kv[0]),
                    reverse=(direction == "desc"),
                )[:n_top]
            # the output value is typed like the SOURCE measure's field
            # (int64 aggregation stays integral, mean truncates)
            as_int = False
            try:
                as_int = src_m.field(rule.field_name).type.name == "INT"
            except KeyError:
                pass
            out = pb.measure_topn_pb2.TopNResponse()
            lst = out.lists.add()
            for entity, value in ranked:
                item = lst.items.add()
                for name, v in zip(group_tags, entity):
                    t = item.entity.add(key=name)
                    # the empty value renders as null (a row written
                    # without the tag)
                    t.value.CopyFrom(wire.py_to_tag_value(v or None))
                item.value.CopyFrom(
                    wire.py_to_field_value(
                        int(value) if as_int else float(value)
                    )
                )
            if any_degraded[0]:
                # a down worker leg in ANY group makes the ranking
                # partial: surface it in-band like every degraded query
                from types import SimpleNamespace

                wire.fill_degraded(out, SimpleNamespace(
                    degraded=True,
                    unavailable_nodes=sorted(degraded_nodes),
                ))
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    # -- StreamService -----------------------------------------------------
    def stream_query(self, req, context):
        try:
            ireq = wire.stream_query_to_internal(req)
            group = self._one_group(ireq)
            ireq = self._resolve_order(group, ireq)
            with self._admit(group):
                res = self.stream.query(ireq)
            return wire.stream_result_to_pb(res)
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def stream_write(self, request_iterator, context):
        from banyandb_tpu_torch.admin.diskmonitor import DiskFull
        from banyandb_tpu_torch.admin.protector import ServerBusy
        from banyandb_tpu_torch.qos.plane import global_qos

        for wreq in request_iterator:
            resp = pb.stream_write_pb2.WriteResponse(message_id=wreq.message_id)
            try:
                s = self.registry.get_stream(
                    wreq.metadata.group, wreq.metadata.name
                )
                el = wire.element_value_from_pb(s, wreq)
                global_qos().admit_write(wreq.metadata.group, 1)
                self.stream.write(wreq.metadata.group, wreq.metadata.name, [el])
                resp.status = "STATUS_SUCCEED"
            except KeyError:
                resp.status = "STATUS_NOT_FOUND"
            except (ServerBusy, DiskFull):
                resp.status = "STATUS_DISK_FULL"  # shed-class: retryable
            except Exception:  # noqa: BLE001
                log.exception("stream write failed")
                resp.status = "STATUS_INTERNAL_ERROR"
            resp.metadata.CopyFrom(wreq.metadata)
            yield resp

    # -- PropertyService ---------------------------------------------------
    def property_apply(self, req, context):
        try:
            if self.property is None:
                raise ValueError("property engine not wired")
            from banyandb_tpu_torch.models.property import Property

            p = req.property
            tags = {t.key: wire.tag_value_to_py(t.value) for t in p.tags}
            stored = self.property.apply(
                Property(
                    group=p.metadata.group,
                    name=p.metadata.name,
                    id=p.id,
                    tags=tags,
                ),
                strategy="replace" if req.strategy == 2 else "merge",
            )
            return pb.property_rpc_pb2.ApplyResponse(
                created=stored.create_revision == stored.mod_revision,
                tags_num=len(stored.tags),
            )
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def property_delete(self, req, context):
        try:
            if self.property is None:
                raise ValueError("property engine not wired")
            ok = self.property.delete(req.group, req.name, req.id)
            return pb.property_rpc_pb2.DeleteResponse(deleted=ok)
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def property_query(self, req, context):
        try:
            if self.property is None:
                raise ValueError("property engine not wired")
            self._one_group(req)
            tag_filters = {}
            if req.HasField("criteria"):
                crit = wire.criteria_to_internal(req.criteria)
                from banyandb_tpu_torch.query.measure_exec import _lower_criteria

                leaves, expr = _lower_criteria(crit)
                if expr:
                    raise ValueError("property queries take AND criteria only")
                for c in leaves:
                    if c.op != "eq":
                        raise ValueError("property criteria support eq only")
                    tag_filters[c.name] = c.value
            props = self.property.query(
                req.groups[0],
                req.name,
                tag_filters=tag_filters or None,
                ids=list(req.ids) or None,
                limit=int(req.limit) or 100,
            )
            out = pb.property_rpc_pb2.QueryResponse()
            proj = set(req.tag_projection)
            for p in props:
                wire.fill_property_pb(
                    out.properties.add(), p.group, p.name, p.id, p.tags,
                    p.mod_revision, proj,
                )
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    # -- TraceService ------------------------------------------------------
    def trace_query(self, req, context):
        """trace/v1 Query: the full surface — general AND criteria
        (bloom/zone pruned), tag projection, sidx order-by with
        limit+offset pushed into the walk.  Plan selection lives in
        models.trace.classify_plan; this handler only converts wire
        shapes."""
        try:
            if self.trace is None:
                raise ValueError("trace engine not wired")
            self._one_group(req)  # validates single-group addressing
            ireq = wire.trace_query_to_internal(req)
            res = self.trace.query(ireq)
            return self._trace_result_to_pb(ireq, res)
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def _ordered_tags(self, group: str, t_schema) -> tuple[str, ...]:
        """Tree-rule tags applying to this trace schema, cached per
        (group, trace) and invalidated by registry revision — the rule
        scan must not run once per streamed span write."""
        cache = getattr(self, "_ordered_tags_cache", None)
        if cache is None:
            cache = self._ordered_tags_cache = {}
        key = (group, t_schema.name)
        rev = self.registry.revision
        hit = cache.get(key)
        if hit is not None and hit[0] == rev:
            return hit[1]
        schema_tags = {t.name for t in t_schema.tags}
        ordered = tuple(
            tag
            for r in self.registry.list_index_rules(group)
            if r.type == "tree"
            for tag in r.tags
            if tag in schema_tags
        )
        cache[key] = (rev, ordered)
        return ordered

    def trace_write(self, request_iterator, context):
        """Bidi stream: tag values ride positionally per tag_spec (or the
        schema's tag order)."""
        from banyandb_tpu_torch.models.trace import SpanValue

        for wreq in request_iterator:
            resp = pb.trace_write_pb2.WriteResponse(version=wreq.version)
            try:
                if self.trace is None:
                    raise ValueError("trace engine not wired")
                t_schema = self.registry.get_trace(
                    wreq.metadata.group, wreq.metadata.name
                )
                names = (
                    list(wreq.tag_spec.tag_names)
                    if wreq.HasField("tag_spec") and wreq.tag_spec.tag_names
                    else [t.name for t in t_schema.tags]
                )
                if len(wreq.tags) > len(names):
                    raise ValueError(
                        f"write carries {len(wreq.tags)} tags, spec has {len(names)}"
                    )
                tags = {
                    n: wire.tag_value_to_py(tv)
                    for n, tv in zip(names, wreq.tags)
                }
                ts_tag = t_schema.timestamp_tag
                ts_millis = int(tags.get(ts_tag, 0)) if ts_tag else 0
                if not ts_millis:
                    import time as _time

                    ts_millis = int(_time.time() * 1000)
                ordered = self._ordered_tags(wreq.metadata.group, t_schema)
                self.trace.write(
                    wreq.metadata.group,
                    wreq.metadata.name,
                    [SpanValue(ts_millis=ts_millis, tags=tags, span=wreq.span)],
                    ordered_tags=ordered,
                )
                resp.status = "STATUS_SUCCEED"
            except KeyError:
                resp.status = "STATUS_NOT_FOUND"
            except Exception:  # noqa: BLE001
                log.exception("trace write failed")
                resp.status = "STATUS_INTERNAL_ERROR"
            resp.metadata.CopyFrom(wreq.metadata)
            yield resp

    # -- registries --------------------------------------------------------
    def _registry_handlers(self, kind: str):
        """CRUD handlers for one registry service; kind in
        {group, measure, stream}.  Non-group kinds ride the shared
        spec-registry generator (same shapes); group has its own request
        forms (string-keyed, SchemaInfo delete response, has_group-only
        exist)."""
        if kind != "group":
            return self._spec_registry_handlers(
                f"{kind.capitalize()}RegistryService",
                kind,
                kind,
                getattr(wire, f"{kind}_to_internal"),
                getattr(wire, f"{kind}_to_pb"),
            )
        rpcpb = pb.database_rpc_pb2
        P = "GroupRegistryService"

        def create(req, context):
            try:
                rev = self.registry.create_group(wire.group_to_internal(req.group))
                return rpcpb.GroupRegistryServiceCreateResponse(mod_revision=rev or 1)
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def update(req, context):
            # registry _put is an upsert with mod-revision bump, matching
            # the reference's Update semantics
            try:
                rev = self.registry.create_group(wire.group_to_internal(req.group))
                return rpcpb.GroupRegistryServiceUpdateResponse(mod_revision=rev or 1)
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def delete(req, context):
            try:
                self.registry.delete_group(req.group)
                return rpcpb.GroupRegistryServiceDeleteResponse()
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def get(req, context):
            try:
                g = self.registry.get_group(req.group)
                return rpcpb.GroupRegistryServiceGetResponse(group=wire.group_to_pb(g))
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def list_(req, context):
            try:
                # internal groups (_schema backing store) stay off the
                # public surface
                gs = [
                    g
                    for g in self.registry.list_groups()
                    if not g.name.startswith("_")
                ]
                return rpcpb.GroupRegistryServiceListResponse(
                    group=[wire.group_to_pb(g) for g in gs]
                )
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def exist(req, context):
            try:
                try:
                    self.registry.get_group(req.group)
                    return rpcpb.GroupRegistryServiceExistResponse(has_group=True)
                except KeyError:
                    return rpcpb.GroupRegistryServiceExistResponse(has_group=False)
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        return {
            "Create": _unary(create, getattr(rpcpb, f"{P}CreateRequest")),
            "Update": _unary(update, getattr(rpcpb, f"{P}UpdateRequest")),
            "Delete": _unary(delete, getattr(rpcpb, f"{P}DeleteRequest")),
            "Get": _unary(get, getattr(rpcpb, f"{P}GetRequest")),
            "List": _unary(list_, getattr(rpcpb, f"{P}ListRequest")),
            "Exist": _unary(exist, getattr(rpcpb, f"{P}ExistRequest")),
        }

    def _spec_registry_handlers(
        self,
        service: str,
        pb_field: str,
        reg_suffix: str,
        to_internal,
        to_pb,
        reg_list: str = "",
    ):
        """CRUD handlers for the spec registries (IndexRule / Binding /
        TopNAggregation) — same shapes as the resource registries but
        keyed by metadata and named by their proto field."""
        rpcpb = pb.database_rpc_pb2
        reg = self.registry

        def create(req, context):
            try:
                rev = getattr(reg, f"create_{reg_suffix}")(
                    to_internal(getattr(req, pb_field))
                )
                return getattr(rpcpb, f"{service}CreateResponse")(
                    mod_revision=rev or 1
                )
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def update(req, context):
            try:
                rev = getattr(reg, f"create_{reg_suffix}")(
                    to_internal(getattr(req, pb_field))
                )
                return getattr(rpcpb, f"{service}UpdateResponse")(
                    mod_revision=rev or 1
                )
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def delete(req, context):
            try:
                getattr(reg, f"delete_{reg_suffix}")(
                    req.metadata.group, req.metadata.name
                )
                return getattr(rpcpb, f"{service}DeleteResponse")(deleted=True)
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def get(req, context):
            try:
                obj = getattr(reg, f"get_{reg_suffix}")(
                    req.metadata.group, req.metadata.name
                )
                return getattr(rpcpb, f"{service}GetResponse")(
                    **{pb_field: to_pb(obj)}
                )
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def list_(req, context):
            try:
                objs = getattr(reg, reg_list or f"list_{reg_suffix}s")(req.group)
                return getattr(rpcpb, f"{service}ListResponse")(
                    **{pb_field: [to_pb(o) for o in objs]}
                )
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        def exist(req, context):
            try:
                has_group = True
                try:
                    reg.get_group(req.metadata.group)
                except KeyError:
                    has_group = False
                has = True
                try:
                    getattr(reg, f"get_{reg_suffix}")(
                        req.metadata.group, req.metadata.name
                    )
                except KeyError:
                    has = False
                return getattr(rpcpb, f"{service}ExistResponse")(
                    has_group=has_group, **{f"has_{pb_field}": has}
                )
            except Exception as e:  # noqa: BLE001
                _abort(context, e)

        return {
            "Create": _unary(create, getattr(rpcpb, f"{service}CreateRequest")),
            "Update": _unary(update, getattr(rpcpb, f"{service}UpdateRequest")),
            "Delete": _unary(delete, getattr(rpcpb, f"{service}DeleteRequest")),
            "Get": _unary(get, getattr(rpcpb, f"{service}GetRequest")),
            "List": _unary(list_, getattr(rpcpb, f"{service}ListRequest")),
            "Exist": _unary(exist, getattr(rpcpb, f"{service}ExistRequest")),
        }

    # -- misc services -----------------------------------------------------
    def snapshot(self, req, context):
        try:
            out = pb.database_rpc_pb2.SnapshotResponse()
            if hasattr(self.measure, "flush"):
                self.measure.flush()
            for g in self.registry.list_groups():
                snp = out.snapshots.add()
                snp.name = g.name
                snp.catalog = wire._CATALOG_INV.get(g.catalog, 2)
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def get_api_version(self, req, context):
        """common/v1 Service.GetAPIVersion (api_version.go analog):
        clients negotiate compatibility from this before issuing calls."""
        out = pb.common_rpc_pb2.GetAPIVersionResponse()
        out.version.version = API_VERSION
        out.version.revision = API_REVISION
        return out

    _ROLE = {"meta": 1, "data": 2, "liaison": 3}

    def _node_to_pb(self, node_pb, info: dict) -> None:
        node_pb.metadata.name = info.get("name", "")
        node_pb.grpc_address = info.get("grpc_address", "")
        node_pb.http_address = info.get("http_address", "")
        for r in info.get("roles", ()):
            node_pb.roles.append(self._ROLE.get(r, 0))
        for k, v in (info.get("labels") or {}).items():
            node_pb.labels[k] = v

    def get_current_node(self, req, context):
        """database/v1 NodeQueryService.GetCurrentNode (rpc.proto:928)."""
        out = pb.database_rpc_pb2.GetCurrentNodeResponse()
        self._node_to_pb(out.node, self.node_info)
        return out

    def get_cluster_state(self, req, context):
        """database/v1 ClusterStateService (rpc.proto:952): route tables
        of registered/active/evictable members per tier."""
        try:
            out = pb.database_rpc_pb2.GetClusterStateResponse()
            for tier, table in self.cluster_view_fn().items():
                rt = out.route_tables[tier]
                for info in table.get("registered", ()):
                    self._node_to_pb(rt.registered.add(), info)
                rt.active.extend(table.get("active", ()))
                rt.evictable.extend(table.get("evictable", ()))
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    # -- schema barrier (schema/v1/barrier.proto:30) -----------------------
    @staticmethod
    def _barrier_timeout(req) -> float:
        d = req.timeout
        s = d.seconds + d.nanos / 1e9
        return s if s > 0 else 10.0

    @staticmethod
    def _laggards_to_pb(resp, laggards) -> None:
        for lag in laggards:
            lpb = resp.laggards.add(
                node=lag.get("node", ""),
                current_mod_revision=lag.get("current_mod_revision", 0),
                reason=lag.get("reason", ""),
            )
            for kind, group, name in lag.get("missing_keys", ()):
                lpb.missing_keys.add(kind=kind, group=group, name=name)
            for kind, group, name in lag.get("still_present_keys", ()):
                lpb.still_present_keys.add(kind=kind, group=group, name=name)

    def _barrier_slot(self, context):
        if not self._barrier_slots.acquire(blocking=False):
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                "too many concurrent schema barrier waits",
            )

    def barrier_await_revision(self, req, context):
        self._barrier_slot(context)
        try:
            applied, laggards = self.barrier.await_revision(
                req.min_revision, self._barrier_timeout(req)
            )
            out = pb.schema_barrier_pb2.AwaitRevisionAppliedResponse(applied=applied)
            self._laggards_to_pb(out, laggards)
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)
        finally:
            self._barrier_slots.release()

    def barrier_await_applied(self, req, context):
        self._barrier_slot(context)
        try:
            if len(req.keys) > 10000:
                raise ValueError("keys capped at 10000")
            keys = [(k.kind, k.group, k.name) for k in req.keys]
            revs = list(req.min_revisions) + [0] * (len(keys) - len(req.min_revisions))
            applied, laggards = self.barrier.await_applied(
                keys, revs, self._barrier_timeout(req)
            )
            out = pb.schema_barrier_pb2.AwaitSchemaAppliedResponse(applied=applied)
            self._laggards_to_pb(out, laggards)
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)
        finally:
            self._barrier_slots.release()

    def barrier_await_deleted(self, req, context):
        self._barrier_slot(context)
        try:
            keys = [(k.kind, k.group, k.name) for k in req.keys]
            applied, laggards = self.barrier.await_deleted(
                keys, self._barrier_timeout(req)
            )
            out = pb.schema_barrier_pb2.AwaitSchemaDeletedResponse(applied=applied)
            self._laggards_to_pb(out, laggards)
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)
        finally:
            self._barrier_slots.release()

    # -- node schema status (cluster/v1/node_schema_status.proto:29) -------
    def _schema_key_lookup(self, key) -> dict:
        kind = _BARRIER_KINDS.get(key.kind)
        if kind is None:
            raise ValueError(f"unknown schema kind {key.kind!r}")
        k = key.name if kind == "group" else f"{key.group}/{key.name}"
        return self.registry.stored_object_hash(kind, k)

    def node_schema_max_revision(self, req, context):
        return pb.cluster_node_schema_status_pb2.GetMaxRevisionResponse(
            max_mod_revision=self.registry.revision
        )

    def node_schema_key_revisions(self, req, context):
        try:
            out = pb.cluster_node_schema_status_pb2.GetKeyRevisionsResponse()
            for key in req.keys:  # response order mirrors request order
                st = self._schema_key_lookup(key)
                kr = out.revisions.add()
                kr.key.CopyFrom(key)
                kr.mod_revision = st["rev"]
                kr.present = st["hash"] is not None
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def node_schema_absent_keys(self, req, context):
        try:
            out = pb.cluster_node_schema_status_pb2.GetAbsentKeysResponse()
            for key in req.keys:
                st = self._schema_key_lookup(key)
                (
                    out.still_present_keys
                    if st["hash"] is not None
                    else out.absent_keys
                ).add().CopyFrom(key)
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    # -- trace pipeline registry (pipeline/v1/trace_pipeline.proto:87) -----
    # The shipped proto's TracePipelineConfig carries no identity (the
    # design doc's metadata.group field was dropped: "group-scoped,
    # name-less", common.proto:156), yet Create/Update requests carry only
    # the config.  Callers therefore scope Create/Update with an
    # 'x-banyandb-group' gRPC metadata header; Get/Delete/Exist/List use
    # the group from their request as specified.
    def _tp_group_from_md(self, context) -> str:
        for k, v in context.invocation_metadata():
            if k == "x-banyandb-group":
                return v
        raise ValueError(
            "TracePipelineConfig carries no identity; pass the target "
            "group in 'x-banyandb-group' request metadata"
        )

    def _tp_upsert(self, req, context, create: bool):
        from google.protobuf import json_format

        from banyandb_tpu_torch.api.schema import TracePipelineConfig

        group = self._tp_group_from_md(context)
        self.registry.get_group(group)  # admission: group must exist
        cfg_json = json_format.MessageToJson(req.trace_pipeline_config)
        # one config per group: Create is an atomic create-if-absent
        # (the check lives under the registry lock)
        return self.registry.create_trace_pipeline(
            TracePipelineConfig(group=group, config_json=cfg_json),
            exclusive=create,
        )

    def trace_pipeline_create(self, req, context):
        try:
            rev = self._tp_upsert(req, context, create=True)
            return pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceCreateResponse(
                mod_revision=rev
            )
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def trace_pipeline_update(self, req, context):
        try:
            rev = self._tp_upsert(req, context, create=False)
            return pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceUpdateResponse(
                mod_revision=rev
            )
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def trace_pipeline_get(self, req, context):
        from google.protobuf import json_format

        try:
            c = self.registry.get_trace_pipeline(req.metadata.group)
            out = pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceGetResponse()
            json_format.Parse(c.config_json, out.trace_pipeline_config)
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def trace_pipeline_delete(self, req, context):
        import time as _time

        try:
            self.registry.delete_trace_pipeline(req.metadata.group)
            return pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceDeleteResponse(
                deleted=True,
                delete_time=_time.time_ns(),
                mod_revision=self.registry.revision,
            )
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def trace_pipeline_list(self, req, context):
        from google.protobuf import json_format

        try:
            out = pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceListResponse()
            for c in self.registry.list_trace_pipelines(req.group):
                json_format.Parse(c.config_json, out.trace_pipeline_config.add())
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def trace_pipeline_exist(self, req, context):
        try:
            has_group = True
            try:
                self.registry.get_group(req.metadata.group)
            except KeyError:
                has_group = False
            return pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceExistResponse(
                has_group=has_group,
                has_trace_pipeline_config=bool(
                    self.registry.list_trace_pipelines(req.metadata.group)
                ),
            )
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    # -- fodc group lifecycle (fodc/v1/rpc.proto:257) ----------------------
    def group_lifecycle_inspect_all(self, req, context):
        try:
            out = pb.fodc_rpc_pb2.InspectAllResponse()
            for g in self.registry.list_groups():
                if g.name.startswith("_"):
                    continue  # same public surface as GroupRegistry.List
                info = out.groups.add()
                gpb = wire.group_to_pb(g)
                info.name = g.name
                info.catalog = pb.common_common_pb2.Catalog.Name(gpb.catalog)
                info.resource_opts.CopyFrom(gpb.resource_opts)
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    # -- schema plane (schema/v1/internal.proto) ---------------------------
    @staticmethod
    def _fill_schema_doc(prop_msg, kind: str, key: str, payload: str) -> None:
        """One place encodes a schema doc as a property/v1.Property —
        WatchSchemas replay and ListSchemas must never diverge."""
        from banyandb_tpu_torch.cluster import schema_plane

        prop_msg.metadata.group = schema_plane.SCHEMA_GROUP
        prop_msg.metadata.name = kind
        prop_msg.id = key
        tag = prop_msg.tags.add(key="payload")
        tag.value.str.value = payload

    @classmethod
    def _schema_event_to_pb(cls, ev: dict):
        from banyandb_tpu_torch.cluster import schema_plane

        ipb = pb.schema_internal_pb2
        out = ipb.WatchSchemasResponse(event_type=ev["type"])
        if ev["type"] != schema_plane.EVENT_REPLAY_DONE:
            cls._fill_schema_doc(
                out.property, ev["kind"], ev["key"], ev.get("payload", "")
            )
        return out

    def _require_schema_store(self):
        if self.schema_store is None:
            raise NotImplementedError(
                "schema plane not enabled (no PropertySchemaStore)"
            )
        return self.schema_store

    def watch_schemas(self, request_iterator, context):
        """SchemaUpdateService.WatchSchemas (internal.proto:79): replay
        the current schema set, mark REPLAY_DONE, then stream live
        events until the client goes away."""
        store = self._require_schema_store()
        if not self._watch_slots.acquire(blocking=False):
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                "too many concurrent schema watch streams",
            )
        try:
            yield from self._watch_schemas_inner(request_iterator, context, store)
        finally:
            self._watch_slots.release()

    def _watch_schemas_inner(self, request_iterator, context, store):
        import queue as _queue

        # half-close without a subscribe request ends the stream cleanly
        # (bare next() would raise StopIteration -> PEP 479 RuntimeError)
        if next(iter(request_iterator), None) is None:
            return
        sid, q = store.hub.subscribe()
        try:
            for ev in store.replay_events():
                yield self._schema_event_to_pb(ev)
            while context.is_active():
                if store.hub.is_dead(sid):
                    # this subscriber lost events (queue overflow); end
                    # the stream so the client reconnects and re-syncs
                    break
                try:
                    ev = q.get(timeout=0.2)
                except _queue.Empty:
                    continue
                yield self._schema_event_to_pb(ev)
        finally:
            store.hub.unsubscribe(sid)

    def _schema_doc_apply(self, prop_msg) -> None:
        """Insert/Update/Repair: a property doc whose metadata.name is
        the schema kind and whose payload tag is the schema json."""
        import json as _json

        from banyandb_tpu_torch.api import schema as schema_mod

        kind = prop_msg.metadata.name
        cls = schema_mod._KINDS.get(kind)
        if cls is None:
            raise ValueError(f"unknown schema kind {kind!r}")
        payload = ""
        for tag in prop_msg.tags:
            if tag.key == "payload":
                payload = tag.value.str.value
        if not payload:
            raise ValueError("schema doc missing payload tag")
        obj = schema_mod._from_jsonable(cls, _json.loads(payload))
        self.registry._put(kind, obj)

    def schema_insert(self, req, context):
        try:
            self._require_schema_store()
            self._schema_doc_apply(req.property)
            return pb.schema_internal_pb2.InsertSchemaResponse()
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def schema_update(self, req, context):
        try:
            self._require_schema_store()
            self._schema_doc_apply(req.property)
            return pb.schema_internal_pb2.UpdateSchemaResponse()
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def schema_delete(self, req, context):
        try:
            from banyandb_tpu_torch.api import schema as schema_mod

            self._require_schema_store()
            kind = req.delete.name
            key = req.delete.id
            if kind not in schema_mod._KINDS:
                raise ValueError(f"unknown schema kind {kind!r}")
            found = True
            try:
                self.registry._delete(kind, key)
            except KeyError:
                found = False
            return pb.schema_internal_pb2.DeleteSchemaResponse(found=found)
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def schema_list(self, req, context):
        """ListSchemas: server-streamed pages of the current docs."""
        try:
            store = self._require_schema_store()
            from banyandb_tpu_torch.cluster import schema_plane

            for ev in store.replay_events():
                if ev["type"] == schema_plane.EVENT_REPLAY_DONE:
                    continue
                out = pb.schema_internal_pb2.ListSchemasResponse()
                self._fill_schema_doc(
                    out.properties.add(), ev["kind"], ev["key"], ev["payload"]
                )
                out.delete_times.append(0)
                yield out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def schema_repair(self, req, context):
        try:
            self._require_schema_store()
            if req.delete_time > 0:
                from banyandb_tpu_torch.api import schema as schema_mod

                kind = req.property.metadata.name
                if kind not in schema_mod._KINDS:
                    raise ValueError(f"unknown schema kind {kind!r}")
                try:
                    self.registry._delete(kind, req.property.id)
                except KeyError:
                    pass
            else:
                self._schema_doc_apply(req.property)
            return pb.schema_internal_pb2.RepairSchemaResponse()
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def bydbql_query(self, req, context):
        """bydbql/v1 Query: parse QL, dispatch by catalog, return the
        catalog-typed result in the response oneof."""
        try:
            from banyandb_tpu_torch import bydbql

            params = [wire.tag_value_to_py(tv) for tv in req.params]
            catalog, ireq = bydbql.parse_with_catalog(req.query, params)
            out = pb.bydbql_query_pb2.QueryResponse()
            with self._admit(ireq.groups[0] if ireq.groups else ""):
                if catalog == "measure":
                    m = self.registry.get_measure(ireq.groups[0], ireq.name)
                    res = self.measure.query(ireq)
                    out.measure_result.CopyFrom(
                        wire.measure_result_to_pb(m, ireq, res)
                    )
                elif catalog == "stream":
                    res = self.stream.query(ireq)
                    out.stream_result.CopyFrom(wire.stream_result_to_pb(res))
                elif catalog == "trace":
                    if self.trace is None:
                        raise ValueError("trace engine not wired")
                    from banyandb_tpu_torch.query import ql_exec

                    res = ql_exec.execute_trace_ql(self.trace, ireq)
                    out.trace_result.CopyFrom(
                        self._trace_result_to_pb(ireq, res)
                    )
                elif catalog == "property":
                    if self.property is None:
                        raise ValueError("property engine not wired")
                    from banyandb_tpu_torch.query import ql_exec

                    res = ql_exec.execute_property_ql(self.property, ireq)
                    out.property_result.CopyFrom(
                        self._property_result_to_pb(ireq, res)
                    )
                else:
                    # NotImplementedError maps to UNIMPLEMENTED in _abort;
                    # aborting inside the try would be re-caught and
                    # re-aborted as INTERNAL with a spurious stack trace
                    raise NotImplementedError(
                        f"BydbQL catalog {catalog} not yet wired"
                    )
            return out
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def _trace_result_to_pb(self, ireq, res):
        """ql_exec trace QueryResult -> trace/v1 QueryResponse: span dicts
        (already projection-filtered by the executor) group into one
        trace per their 'trace_id' key."""
        out = pb.trace_query_pb2.QueryResponse()
        try:
            t_schema = self.registry.get_trace(ireq.groups[0], ireq.name)
        except KeyError:
            t_schema = None
        by_tid: dict[str, list] = {}
        for dp in res.data_points:
            by_tid.setdefault(str(dp.get("trace_id")), []).append(dp)
        for tid, dps in by_tid.items():
            tr = out.traces.add()
            tr.trace_id = tid
            for dp in dps:
                if "span" not in dp and "tags" not in dp:
                    continue  # ordered-query id rows carry no span body
                wire.fill_trace_span_pb(tr.spans.add(), dp, t_schema)
        return out

    def _property_result_to_pb(self, ireq, res):
        """ql_exec property QueryResult (already projection-filtered) ->
        property/v1 QueryResponse."""
        out = pb.property_rpc_pb2.QueryResponse()
        for dp in res.data_points:
            wire.fill_property_pb(
                out.properties.add(), ireq.groups[0], ireq.name,
                dp.get("id", ""), dp.get("tags", {}),
                dp.get("mod_revision", 0),
            )
        return out


class WireServer:
    """The listening gRPC server hosting WireServices."""

    def __init__(
        self,
        services: WireServices,
        port: int = 17912,
        host: str = "127.0.0.1",
        max_workers: int = 16,
        auth_file: str | None = None,
        health_auth: bool = False,
    ):
        self.services = services
        # long-lived watch streams may hold at most a quarter of the pool
        import threading as _threading

        services._watch_slots = _threading.BoundedSemaphore(
            max(2, max_workers // 4)
        )  # rebound to THIS server's pool size (services default is 4)
        interceptors = ()
        self.auth = None
        if auth_file:
            from banyandb_tpu_torch.api.auth import AuthReloader, BasicAuthInterceptor

            self.auth = AuthReloader(auth_file, health_auth=health_auth)
            interceptors = (BasicAuthInterceptor(self.auth),)
        # owned pool, joined in stop(): grpc never shuts down a
        # caller-provided executor, and leaked idle workers would fail a
        # thread-parity check
        self._pool = futures.ThreadPoolExecutor(max_workers=max_workers)
        self.server = grpc.server(
            self._pool,
            interceptors=interceptors,
        )
        s = services
        mq = pb.measure_query_pb2
        mw = pb.measure_write_pb2
        mt = pb.measure_topn_pb2
        sq = pb.stream_query_pb2
        sw = pb.stream_write_pb2
        generic = [
            (
                "banyandb.measure.v1.MeasureService",
                {
                    "Query": _unary(s.measure_query, mq.QueryRequest),
                    "Write": _stream_stream(s.measure_write, mw.WriteRequest),
                    "TopN": _unary(s.measure_topn, mt.TopNRequest),
                },
            ),
            (
                "banyandb.stream.v1.StreamService",
                {
                    "Query": _unary(s.stream_query, sq.QueryRequest),
                    "Write": _stream_stream(s.stream_write, sw.WriteRequest),
                },
            ),
            (
                "banyandb.database.v1.GroupRegistryService",
                s._registry_handlers("group"),
            ),
            (
                "banyandb.database.v1.MeasureRegistryService",
                s._registry_handlers("measure"),
            ),
            (
                "banyandb.database.v1.StreamRegistryService",
                s._registry_handlers("stream"),
            ),
            (
                "banyandb.database.v1.IndexRuleRegistryService",
                s._spec_registry_handlers(
                    "IndexRuleRegistryService",
                    "index_rule",
                    "index_rule",
                    wire.index_rule_to_internal,
                    wire.index_rule_to_pb,
                ),
            ),
            (
                "banyandb.database.v1.IndexRuleBindingRegistryService",
                s._spec_registry_handlers(
                    "IndexRuleBindingRegistryService",
                    "index_rule_binding",
                    "index_rule_binding",
                    wire.index_rule_binding_to_internal,
                    wire.index_rule_binding_to_pb,
                ),
            ),
            (
                "banyandb.database.v1.TopNAggregationRegistryService",
                s._spec_registry_handlers(
                    "TopNAggregationRegistryService",
                    "top_n_aggregation",
                    "topn",
                    wire.topn_to_internal,
                    wire.topn_to_pb,
                    reg_list="list_topn",
                ),
            ),
        ]
        if hasattr(pb.database_rpc_pb2, "SnapshotRequest"):
            generic.append(
                (
                    "banyandb.database.v1.SnapshotService",
                    {"Snapshot": _unary(s.snapshot, pb.database_rpc_pb2.SnapshotRequest)},
                )
            )
        generic.append(
            (
                "banyandb.bydbql.v1.BydbQLService",
                {"Query": _unary(s.bydbql_query, pb.bydbql_query_pb2.QueryRequest)},
            )
        )
        if s.property is not None:
            pr = pb.property_rpc_pb2
            generic.append(
                (
                    "banyandb.property.v1.PropertyService",
                    {
                        "Apply": _unary(s.property_apply, pr.ApplyRequest),
                        "Delete": _unary(s.property_delete, pr.DeleteRequest),
                        "Query": _unary(s.property_query, pr.QueryRequest),
                    },
                )
            )
        if s.trace is not None:
            generic.append(
                (
                    "banyandb.trace.v1.TraceService",
                    {
                        "Query": _unary(s.trace_query, pb.trace_query_pb2.QueryRequest),
                        "Write": _stream_stream(
                            s.trace_write, pb.trace_write_pb2.WriteRequest
                        ),
                    },
                )
            )
        generic += [
            (
                "banyandb.database.v1.TraceRegistryService",
                s._spec_registry_handlers(
                    "TraceRegistryService",
                    "trace",
                    "trace",
                    wire.trace_to_internal,
                    wire.trace_to_pb,
                ),
            ),
            (
                "banyandb.database.v1.PropertyRegistryService",
                s._spec_registry_handlers(
                    "PropertyRegistryService",
                    "property",
                    "property_schema",
                    wire.property_schema_to_internal,
                    wire.property_schema_to_pb,
                ),
            ),
            (
                "banyandb.common.v1.Service",
                {
                    "GetAPIVersion": _unary(
                        s.get_api_version, pb.common_rpc_pb2.GetAPIVersionRequest
                    )
                },
            ),
            (
                "banyandb.database.v1.NodeQueryService",
                {
                    "GetCurrentNode": _unary(
                        s.get_current_node,
                        pb.database_rpc_pb2.GetCurrentNodeRequest,
                    )
                },
            ),
            (
                "banyandb.database.v1.ClusterStateService",
                {
                    "GetClusterState": _unary(
                        s.get_cluster_state,
                        pb.database_rpc_pb2.GetClusterStateRequest,
                    )
                },
            ),
            (
                "banyandb.schema.v1.SchemaManagementService",
                {
                    "InsertSchema": _unary(
                        s.schema_insert, pb.schema_internal_pb2.InsertSchemaRequest
                    ),
                    "UpdateSchema": _unary(
                        s.schema_update, pb.schema_internal_pb2.UpdateSchemaRequest
                    ),
                    "ListSchemas": _unary_stream(
                        s.schema_list, pb.schema_internal_pb2.ListSchemasRequest
                    ),
                    "DeleteSchema": _unary(
                        s.schema_delete, pb.schema_internal_pb2.DeleteSchemaRequest
                    ),
                    "RepairSchema": _unary(
                        s.schema_repair, pb.schema_internal_pb2.RepairSchemaRequest
                    ),
                },
            ),
            (
                "banyandb.schema.v1.SchemaUpdateService",
                {
                    "WatchSchemas": _stream_stream(
                        s.watch_schemas,
                        pb.schema_internal_pb2.WatchSchemasRequest,
                    )
                },
            ),
            (
                "banyandb.schema.v1.SchemaBarrierService",
                {
                    "AwaitRevisionApplied": _unary(
                        s.barrier_await_revision,
                        pb.schema_barrier_pb2.AwaitRevisionAppliedRequest,
                    ),
                    "AwaitSchemaApplied": _unary(
                        s.barrier_await_applied,
                        pb.schema_barrier_pb2.AwaitSchemaAppliedRequest,
                    ),
                    "AwaitSchemaDeleted": _unary(
                        s.barrier_await_deleted,
                        pb.schema_barrier_pb2.AwaitSchemaDeletedRequest,
                    ),
                },
            ),
            (
                "banyandb.cluster.v1.NodeSchemaStatusService",
                {
                    "GetMaxRevision": _unary(
                        s.node_schema_max_revision,
                        pb.cluster_node_schema_status_pb2.GetMaxRevisionRequest,
                    ),
                    "GetKeyRevisions": _unary(
                        s.node_schema_key_revisions,
                        pb.cluster_node_schema_status_pb2.GetKeyRevisionsRequest,
                    ),
                    "GetAbsentKeys": _unary(
                        s.node_schema_absent_keys,
                        pb.cluster_node_schema_status_pb2.GetAbsentKeysRequest,
                    ),
                },
            ),
            (
                "banyandb.pipeline.v1.TracePipelineRegistryService",
                {
                    "Create": _unary(
                        s.trace_pipeline_create,
                        pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceCreateRequest,
                    ),
                    "Update": _unary(
                        s.trace_pipeline_update,
                        pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceUpdateRequest,
                    ),
                    "Delete": _unary(
                        s.trace_pipeline_delete,
                        pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceDeleteRequest,
                    ),
                    "Get": _unary(
                        s.trace_pipeline_get,
                        pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceGetRequest,
                    ),
                    "List": _unary(
                        s.trace_pipeline_list,
                        pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceListRequest,
                    ),
                    "Exist": _unary(
                        s.trace_pipeline_exist,
                        pb.pipeline_trace_pipeline_pb2.TracePipelineRegistryServiceExistRequest,
                    ),
                },
            ),
            (
                "banyandb.fodc.v1.GroupLifecycleService",
                {
                    "InspectAll": _unary(
                        s.group_lifecycle_inspect_all,
                        pb.fodc_rpc_pb2.InspectAllRequest,
                    ),
                },
            ),
        ]
        self.server.add_generic_rpc_handlers(
            tuple(
                grpc.method_handlers_generic_handler(name, hs)
                for name, hs in generic
            )
        )
        self.port = self.server.add_insecure_port(f"{host}:{port}")

    def start(self):
        from banyandb_tpu_torch.cluster.rpc import prespawn_pool

        # workers exist from second one, not first-request time: no lazy
        # thread-spawn latency, deterministic thread population
        prespawn_pool(self._pool)
        self.server.start()
        return self

    def stop(self, grace: float = 0.5):
        self.server.stop(grace).wait()
        self._pool.shutdown(wait=True)


def serve_standalone(root, port: int = 17912, device=None):
    """Convenience: wire-compatible server over fresh standalone engines.

    `device` (``backend.resolve_device``) is where the measure and
    stream engines scan: the CUDA device by default; without CUDA this
    raises unless ``"cpu"`` was asked for."""
    from banyandb_tpu_torch.api.schema import SchemaRegistry
    from banyandb_tpu_torch.backend import resolve_device
    from banyandb_tpu_torch.models.measure import MeasureEngine
    from banyandb_tpu_torch.models.stream import StreamEngine
    from pathlib import Path

    device = resolve_device(device)
    root = Path(root)
    registry = SchemaRegistry(root)
    measure = MeasureEngine(registry, root / "data", device=device)
    stream = StreamEngine(registry, root / "data", device=device)
    svcs = WireServices(registry, measure, stream)
    return WireServer(svcs, port=port).start()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--port", type=int, default=17912)
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of the engines (default cuda; cpu must be asked for)",
    )
    args = ap.parse_args()
    srv = serve_standalone(args.root, args.port, device=args.device)
    print(f"wire server on :{srv.port}")
    srv.server.wait_for_termination()
