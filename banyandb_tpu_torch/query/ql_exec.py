"""Shared BydbQL executors for the trace and property catalogs.

One implementation serves both entry surfaces — the standalone bus server
(server.py TOPIC_QL) and the gRPC BydbQLService (api/grpc_server.py) —
the way the reference routes every catalog through one handler
(banyand/liaison/grpc/bydbql.go:143-173).  Measure and stream QL lower
onto their engines' query() directly; trace and property need the
catalog-specific planning below (trace-id lookup vs sidx-ordered scan,
id/tag filter splitting).
"""

from __future__ import annotations

from banyandb_tpu_torch.api.model import QueryRequest, QueryResult


def and_leaves(req: QueryRequest):
    """Criteria leaves for catalogs whose executors take flat AND
    filters — OR trees are rejected rather than silently flattened
    (flattening an OR into AND returns wrong results)."""
    from banyandb_tpu_torch.query.measure_exec import _lower_criteria

    leaves, expr = _lower_criteria(req.criteria)
    if expr:
        raise ValueError("OR criteria not supported for this catalog")
    return leaves


def span_matches(span: dict, conds) -> bool:
    for c in conds:
        v = span.get("tags", {}).get(c.name)
        if c.op == "eq":
            if v != c.value:
                return False
        elif c.op == "ne":
            if v == c.value:
                return False
        elif c.op == "in":
            if v not in c.value:
                return False
        elif c.op == "not_in":
            if v in c.value:
                return False
        elif c.op in ("gt", "ge", "lt", "le"):
            if v is None:
                return False
            try:
                fv, fc = float(v), float(c.value)
            except (TypeError, ValueError):
                return False
            if c.op == "gt" and not fv > fc:
                return False
            if c.op == "ge" and not fv >= fc:
                return False
            if c.op == "lt" and not fv < fc:
                return False
            if c.op == "le" and not fv <= fc:
                return False
        else:  # never silently match an op we can't evaluate
            raise ValueError(f"trace QL op {c.op!r} not supported")
    return True


def execute_trace_ql(trace_engine, req: QueryRequest, tracer=None) -> QueryResult:
    """Trace QL execution over the unified engine surface
    (TraceEngine.query and its cluster facades): general AND criteria
    (eq/ne/in/not_in, numeric ranges), SELECT projection, ORDER BY
    <numeric tag> asc/desc with LIMIT+OFFSET pushed into the sidx walk.
    OR trees and unknown ops are rejected up front so every engine —
    standalone, worker pool, liaison — refuses them identically instead
    of half-scattering."""
    for c in and_leaves(req):
        if c.op not in ("eq", "ne", "in", "not_in", "gt", "ge", "lt", "le"):
            raise ValueError(f"trace QL op {c.op!r} not supported")
    return trace_engine.query(req, tracer=tracer)


def execute_property_ql(property_engine, req: QueryRequest) -> QueryResult:
    """Property QL: id equality / IN and tag-equality filters."""
    res = QueryResult()
    leaves = and_leaves(req)
    ids = None
    tag_filters = {}
    for c in leaves:
        if c.name == "id":
            if c.op == "eq":
                ids = [str(c.value)]
            elif c.op == "in":
                ids = [str(v) for v in c.value]
            else:
                raise ValueError("property id supports = / IN only")
        elif c.op == "eq":
            tag_filters[c.name] = c.value
        else:
            raise ValueError(f"property QL supports = on tags, got {c.op}")
    props = property_engine.query(
        req.groups[0],
        req.name,
        tag_filters=tag_filters or None,
        ids=ids,
        limit=req.limit or 100,
    )
    proj = set(req.tag_projection or ())
    res.data_points = [
        {
            "id": p.id,
            "tags": (
                {k: v for k, v in p.tags.items() if k in proj}
                if proj
                else p.tags
            ),
            "mod_revision": p.mod_revision,
        }
        for p in props
    ]
    return res
