"""pb <-> internal model translation for the wire-compatible API.

The generated modules under api/pb carry the exact upstream wire schema
(banyandb.*.v1); this module converts between those messages and the
framework's internal dataclasses (api/model.py, api/schema.py).  The
mapping notes cite the defining protos:

- model/v1/common.proto TagValue oneof  <-> python scalars/lists/bytes
- model/v1/query.proto Criteria tree    <-> Condition/LogicalExpression
- measure/v1/query.proto QueryRequest   <-> api.model.QueryRequest
- database/v1/schema.proto Measure etc. <-> api.schema dataclasses
- common/v1/common.proto Group          <-> api.schema.Group

Tag families: the wire schema groups tags into named families; the
internal schema is flat.  Family structure is preserved on the schema
objects (``tag_families`` = ordered (name, count) runs over the flat
tag tuple) so writes and Get responses regroup losslessly.
"""

from __future__ import annotations

from typing import Optional

from google.protobuf import json_format

from banyandb_tpu_torch.api import model as im
from banyandb_tpu_torch.api import pb
from banyandb_tpu_torch.api import schema as isch

# enum maps (numbers fixed by the protos)
_AGG_FN = {1: "mean", 2: "max", 3: "min", 4: "count", 5: "sum"}
_AGG_FN_INV = {v: k for k, v in _AGG_FN.items()}
# SORT_UNSPECIFIED (0) means ascending in query order_by paths
# (banyand/measure/query.go:292 treats SORT_ASC || SORT_UNSPECIFIED alike);
# only TopN field_value_sort defaults to desc (measure_plan_top.go:69).
_SORT = {0: "asc", 1: "desc", 2: "asc"}
_SORT_TOPN = {0: "desc", 1: "desc", 2: "asc"}
_CATALOG = {1: isch.Catalog.STREAM, 2: isch.Catalog.MEASURE,
            3: isch.Catalog.PROPERTY, 4: isch.Catalog.TRACE}
_CATALOG_INV = {v: k for k, v in _CATALOG.items()}
_TAG_TYPE = {1: isch.TagType.STRING, 2: isch.TagType.INT,
             3: isch.TagType.STRING_ARRAY, 4: isch.TagType.INT_ARRAY,
             5: isch.TagType.DATA_BINARY, 6: isch.TagType.TIMESTAMP}
_TAG_TYPE_INV = {v: k for k, v in _TAG_TYPE.items()}
_FIELD_TYPE = {1: isch.FieldType.STRING, 2: isch.FieldType.INT,
               3: isch.FieldType.DATA_BINARY, 4: isch.FieldType.FLOAT}
_FIELD_TYPE_INV = {v: k for k, v in _FIELD_TYPE.items()}
_COND_OP = {1: "eq", 2: "ne", 3: "lt", 4: "gt", 5: "le", 6: "ge",
            7: "having", 8: "not_having", 9: "in", 10: "not_in", 11: "match"}
_IV_UNIT = {1: "hour", 2: "day"}
_IV_UNIT_INV = {v: k for k, v in _IV_UNIT.items()}


# -- time ------------------------------------------------------------------


def ts_to_millis(ts) -> int:
    return ts.seconds * 1000 + ts.nanos // 1_000_000


def millis_to_ts(ms: int):
    from google.protobuf import timestamp_pb2

    return timestamp_pb2.Timestamp(
        seconds=ms // 1000, nanos=(ms % 1000) * 1_000_000
    )


# -- tag/field values ------------------------------------------------------


def tag_value_to_py(tv) -> object:
    which = tv.WhichOneof("value")
    if which is None or which == "null":
        return None
    if which == "str":
        return tv.str.value
    if which == "int":
        return tv.int.value
    if which == "str_array":
        return list(tv.str_array.value)
    if which == "int_array":
        return list(tv.int_array.value)
    if which == "binary_data":
        return tv.binary_data
    if which == "timestamp":
        return ts_to_millis(tv.timestamp)
    raise ValueError(f"unsupported TagValue kind {which}")


def py_to_tag_value(v, tag_type: Optional[isch.TagType] = None):
    m = pb.model_common_pb2.TagValue()
    if v is None:
        m.null = 0
    elif isinstance(v, bool):
        m.int.value = int(v)
    elif isinstance(v, bytes):
        if tag_type == isch.TagType.STRING:
            m.str.value = v.decode("utf-8", "replace")
        elif tag_type == isch.TagType.INT and len(v) == 8:
            m.int.value = int.from_bytes(v, "little", signed=True)
        elif tag_type == isch.TagType.TIMESTAMP and len(v) == 8:
            m.timestamp.CopyFrom(
                millis_to_ts(int.from_bytes(v, "little", signed=True))
            )
        else:
            m.binary_data = v
    elif isinstance(v, str):
        m.str.value = v
    elif isinstance(v, int):
        if tag_type == isch.TagType.TIMESTAMP:
            m.timestamp.CopyFrom(millis_to_ts(v))
        else:
            m.int.value = v
    elif isinstance(v, float):
        m.int.value = int(v)
    elif isinstance(v, (list, tuple)):
        if all(isinstance(x, int) for x in v):
            m.int_array.value.extend(v)
        else:
            m.str_array.value.extend(str(x) for x in v)
    else:
        raise TypeError(f"unsupported tag value {type(v)}")
    return m


def field_value_to_py(fv) -> object:
    which = fv.WhichOneof("value")
    if which is None or which == "null":
        return None
    if which == "str":
        return fv.str.value
    if which == "int":
        return fv.int.value
    if which == "float":
        return fv.float.value
    if which == "binary_data":
        return fv.binary_data
    raise ValueError(f"unsupported FieldValue kind {which}")


def py_to_field_value(v):
    m = pb.model_common_pb2.FieldValue()
    if v is None:
        m.null = 0
    elif isinstance(v, bytes):
        m.binary_data = v
    elif isinstance(v, str):
        m.str.value = v
    elif isinstance(v, float):
        m.float.value = v
    elif isinstance(v, int):
        m.int.value = v
    else:
        raise TypeError(f"unsupported field value {type(v)}")
    return m


# -- criteria --------------------------------------------------------------


def criteria_to_internal(c) -> Optional[im.Criteria]:
    if c is None:
        return None
    which = c.WhichOneof("exp")
    if which is None:
        return None
    if which == "condition":
        cond = c.condition
        if cond.op not in _COND_OP:
            # an unknown/unset wire op is INVALID_ARGUMENT, never a
            # silent eq filter (same contract as measure_topn)
            raise ValueError(
                f"unknown condition op {cond.op} on tag {cond.name!r}"
            )
        op = _COND_OP[cond.op]
        val = tag_value_to_py(cond.value)
        if op in ("in", "not_in") and not isinstance(val, (list, tuple)):
            # ref rejects IN/NOT_IN with a scalar literal (the array
            # oneof is mandatory; WantErr gen_err_in_scalar)
            raise ValueError(f"{op.upper()} requires an array value")
        match_op = "or"
        match_analyzer = ""
        if cond.HasField("match_option"):
            if cond.match_option.operator == 1:  # OPERATOR_AND
                match_op = "and"
            match_analyzer = cond.match_option.analyzer
        return im.Condition(
            cond.name, op, val,
            match_op=match_op, match_analyzer=match_analyzer,
        )
    le = c.le
    op = "and" if le.op == 1 else "or"
    return im.LogicalExpression(
        op, criteria_to_internal(le.left), criteria_to_internal(le.right)
    )


def _flatten_projection(proj) -> tuple[str, ...]:
    out: list[str] = []
    for fam in proj.tag_families:
        out.extend(fam.tags)
    return tuple(out)


# -- measure query ---------------------------------------------------------


def measure_query_to_internal(req) -> im.QueryRequest:
    group_by = None
    if req.HasField("group_by"):
        group_by = im.GroupBy(
            tag_names=_flatten_projection(req.group_by.tag_projection),
            field_name=req.group_by.field_name,
        )
    agg = None
    if req.HasField("agg"):
        agg = im.Aggregation(
            function=_AGG_FN.get(req.agg.function, "count"),
            field_name=req.agg.field_name,
        )
    top = None
    if req.HasField("top"):
        top = im.Top(
            number=req.top.number or 100,
            field_name=req.top.field_name,
            field_value_sort=_SORT_TOPN.get(req.top.field_value_sort, "desc"),
        )
    order_by_ts = ""
    order_by_tag = ""
    order_by_dir = "asc"
    if req.HasField("order_by"):
        if req.order_by.index_rule_name in ("", "timestamp"):
            order_by_ts = _SORT.get(req.order_by.sort, "")
        else:  # order-by-index: the rule names the tag to sort by
            order_by_tag = req.order_by.index_rule_name
            order_by_dir = _SORT.get(req.order_by.sort, "asc")
    return im.QueryRequest(
        groups=tuple(req.groups),
        name=req.name,
        time_range=im.TimeRange(
            ts_to_millis(req.time_range.begin),
            ts_to_millis(req.time_range.end),
        )
        if req.HasField("time_range")
        else im.TimeRange(0, 1 << 62),
        criteria=criteria_to_internal(req.criteria) if req.HasField("criteria") else None,
        tag_projection=_flatten_projection(req.tag_projection),
        tag_families_projection=tuple(
            (fam.name, tuple(fam.tags))
            for fam in req.tag_projection.tag_families
        ),
        field_projection=tuple(req.field_projection.names),
        group_by=group_by,
        agg=agg,
        top=top,
        limit=int(req.limit) or 100,
        offset=int(req.offset),
        order_by_ts=order_by_ts,
        order_by_tag=order_by_tag,
        order_by_dir=order_by_dir,
        trace=req.trace,
        stages=tuple(req.stages),
    )


def _families_of(spec) -> list[tuple[str, tuple[str, ...]]]:
    """Regroup a flat internal schema's tags into wire families."""
    fams = getattr(spec, "tag_families", ()) or ()
    names = [t.name for t in spec.tags]
    if not fams:
        return [("default", tuple(names))]
    out = []
    i = 0
    for fam_name, count in fams:
        out.append((fam_name, tuple(names[i : i + count])))
        i += count
    if i < len(names):  # tags added after proto creation
        out.append(("default", tuple(names[i:])))
    return out


def measure_result_to_pb(measure: isch.Measure, req: im.QueryRequest, res):
    """QueryResult -> measure/v1 QueryResponse.

    Aggregate results become one DataPoint per group (the reference's
    shape for grouped aggregations): group tags in their families,
    aggregate outputs as fields named by the result keys.
    """
    out = pb.measure_query_pb2.QueryResponse()
    if res.groups or res.values:
        group_tags = tuple(req.group_by.tag_names) if req.group_by else ()
        agg_key = agg_field = None
        agg_int = False
        if req.agg is not None:
            # Reference response shape for grouped aggregation (want/
            # group_*.yaml in test/cases/measure): exactly ONE field,
            # named after the aggregated field, typed like it — MEAN
            # over int fields truncates (Go int64 division,
            # pkg/query/aggregation meanInt64).
            fn = req.agg.function
            agg_field = req.agg.field_name or "value"
            if fn == "count":
                agg_key = "count"
            elif fn == "percentile":
                agg_key = f"percentile({agg_field})"
            else:
                agg_key = f"{fn}({agg_field})"
            try:
                # the output field is typed like the AGGREGATED FIELD —
                # including count (count over a float field emits float,
                # want/float_top_count.yaml)
                agg_int = (
                    fn != "percentile"
                    and measure.field(agg_field).type.name == "INT"
                )
            except (KeyError, AttributeError):
                agg_int = fn == "count"
        # Tags emit in PROJECTION order under the REQUESTED family names:
        # group-key values from the group tuple, other projected tags
        # from the representative (first scanned) row (reference
        # aggregation keeps the first fed row's TagFamilies).  Without an
        # explicit projection, group tags under "default".
        fam_specs = req.tag_families_projection or (
            ("default", tuple(req.tag_projection or group_tags)),
        )
        for i, g in enumerate(res.groups):
            by_name = dict(zip(group_tags, g))
            dp = out.data_points.add()
            for fam_name, fam_tags in fam_specs:
                fam = dp.tag_families.add(name=fam_name)
                for t in fam_tags:
                    if t not in by_name and t not in res.rep_tags:
                        continue
                    v = (
                        by_name[t]
                        if t in by_name
                        else res.rep_tags[t][i]
                        if i < len(res.rep_tags.get(t, ()))
                        else None
                    )
                    tag = fam.tags.add(key=t)
                    tag.value.CopyFrom(
                        py_to_tag_value(v, measure.tag(t).type if _has_tag(measure, t) else None)
                    )
            if req.agg is None:
                # groupBy without aggregation: distinct groups, no
                # fields (want/group_no_field.yaml)
                continue
            if agg_key is not None:
                vals = res.values.get(agg_key, ())
                v = vals[i] if i < len(vals) else None
                if isinstance(v, list):  # percentile -> one field per q
                    for qi, qv in enumerate(v):
                        name = agg_field if qi == 0 else f"{agg_field}[{qi}]"
                        f = dp.fields.add(name=name)
                        f.value.CopyFrom(py_to_field_value(float(qv)))
                else:
                    f = dp.fields.add(name=agg_field)
                    f.value.CopyFrom(
                        py_to_field_value(int(v) if agg_int else v)
                    )
                continue
            for key, vals in res.values.items():
                f = dp.fields.add(name=key)
                v = vals[i] if i < len(vals) else None
                if isinstance(v, list):  # percentile rows -> one field per q
                    for qi, qv in enumerate(v):
                        if qi == 0:
                            f.value.CopyFrom(py_to_field_value(float(qv)))
                        else:
                            extra = dp.fields.add(name=f"{key}[{qi}]")
                            extra.value.CopyFrom(py_to_field_value(float(qv)))
                else:
                    f.value.CopyFrom(py_to_field_value(v))
    int_fields = {
        f.name for f in measure.fields if getattr(f.type, "name", "") == "INT"
    }
    # Strict projection semantics (want/*.yaml): the response carries
    # ONLY the projected tags/fields, in projection order; an empty
    # tagProjection yields no tag families at all.
    tag_proj = tuple(req.tag_projection)
    field_proj = tuple(req.field_projection)
    for row in res.data_points:
        dp = out.data_points.add()
        dp.timestamp.CopyFrom(millis_to_ts(row["timestamp"]))
        tags = row.get("tags", {})
        fam_specs = req.tag_families_projection or (
            (("default", tag_proj),) if tag_proj else ()
        )
        for fam_name, fam_tags in fam_specs:
            fam = dp.tag_families.add(name=fam_name)
            for t in fam_tags:
                if t not in tags:
                    continue
                tag = fam.tags.add(key=t)
                tag.value.CopyFrom(
                    py_to_tag_value(
                        tags[t],
                        measure.tag(t).type if _has_tag(measure, t) else None,
                    )
                )
        fields = row.get("fields", {})
        for fname in field_proj:
            if fname not in fields:
                continue
            f = dp.fields.add(name=fname)
            # schema-typed emission: the engine's device column is f64,
            # but INT fields must return int on the wire (want/*.yaml)
            f.value.CopyFrom(
                py_to_field_value(
                    int(fields[fname]) if fname in int_fields else fields[fname]
                )
            )
    fill_trace(out, res)
    fill_degraded(out, res)
    return out


def fill_degraded(out, res) -> None:
    """Degraded-result markers on the proto wire (docs/robustness.md).

    The reference QueryResponse has no dedicated field, so the marker
    rides the in-band trace as one explicit error span named
    ``degraded`` with an ``unavailable_nodes`` tag — emitted whether or
    not the client asked for tracing, so a partial answer is never
    silently complete-looking.  The JSON surface mirrors this with
    top-level ``degraded``/``unavailable_nodes`` keys
    (server.result_to_json)."""
    if not getattr(res, "degraded", False) or not hasattr(out, "trace"):
        return
    sp = out.trace.spans.add()
    sp.message = "degraded"
    sp.error = True
    sp.tags.add(
        key="unavailable_nodes",
        value=",".join(sorted(res.unavailable_nodes)),
    )


def fill_trace(out, res) -> None:
    """Attach in-band query-trace spans to a QueryResponse proto
    (common/v1 Trace; the reference threads pkg/query/tracer spans back
    the same way — dquery/measure.go:104).  The hierarchical span_tree
    (obs/tracer) maps natively onto common/v1 Span.children — a merged
    cluster tree keeps per-node subtrees nested on the wire; remaining
    keys of the internal trace dict become flat spans (the plan
    rendering rides the span message so `trace=true` clients see the
    plan tree)."""
    tr = getattr(res, "trace", None)
    if not tr or not hasattr(out, "trace"):
        return

    def fill_tree(sp, node: dict) -> None:
        sp.message = str(node.get("name", ""))
        # duration is nanoseconds on the wire (common/v1 Span.duration)
        sp.duration = int(float(node.get("duration_ms", 0.0)) * 1e6)
        if node.get("error"):
            sp.error = True
            sp.tags.add(key="error", value=str(node["error"]))
        for k, v in (node.get("tags") or {}).items():
            sp.tags.add(key=str(k), value=str(v))
        for child in node.get("children", ()):
            if isinstance(child, dict):
                fill_tree(sp.children.add(), child)

    def add_span(message: str, fields: dict) -> None:
        span = out.trace.spans.add()
        span.message = message
        for k, v in fields.items():
            span.tags.add(key=str(k), value=str(v))

    for key, val in tr.items():
        if key == "span_tree" and isinstance(val, dict):
            fill_tree(out.trace.spans.add(), val)
        elif isinstance(val, list) and all(isinstance(x, dict) for x in val):
            # per-phase span lists (measure _trace_spans): one proto span
            # each, named by the entry's own name where present
            for i, entry in enumerate(val):
                add_span(str(entry.get("name", f"{key}[{i}]")), entry)
        elif isinstance(val, dict):
            add_span(key, val)
        else:
            add_span(f"{key}: {val}", {})


def _has_tag(spec, name: str) -> bool:
    return any(t.name == name for t in spec.tags)


def write_request_to_point(measure: isch.Measure, wreq) -> im.DataPointValue:
    """measure/v1 WriteRequest -> internal DataPointValue.

    Tag values ride positionally per family (TagFamilyForWrite); the
    names come from data_point_spec when present, else from the schema's
    family layout (banyand/liaison/grpc/measure.go navigator analog).
    """
    dp = wreq.data_point
    fams = _families_of(measure)
    if wreq.HasField("data_point_spec") and wreq.data_point_spec.tag_family_spec:
        fams = [
            (fs.name, tuple(fs.tag_names))
            for fs in wreq.data_point_spec.tag_family_spec
        ]
        field_names = list(wreq.data_point_spec.field_names)
    else:
        field_names = [f.name for f in measure.fields]
    tags: dict[str, object] = _positional_tags(fams, dp.tag_families)
    fields: dict[str, object] = {}
    for name, fv in zip(field_names, dp.fields):
        v = field_value_to_py(fv)
        if v is not None:
            fields[name] = v
    return im.DataPointValue(
        ts_millis=ts_to_millis(dp.timestamp),
        tags=tags,
        fields=fields,
        version=dp.version,
    )


# -- stream ----------------------------------------------------------------


def _positional_tags(fams, tag_families) -> dict[str, object]:
    """Zip positional family values against the schema layout, rejecting
    count mismatches (the reference liaison's navigator errors rather
    than dropping/misassigning tags — silent truncation corrupts data)."""
    if len(tag_families) > len(fams):
        raise ValueError(
            f"write carries {len(tag_families)} tag families, schema has {len(fams)}"
        )
    tags: dict[str, object] = {}
    for (fam_name, tag_names), tfw in zip(fams, tag_families):
        if len(tfw.tags) > len(tag_names):
            raise ValueError(
                f"family {fam_name!r} carries {len(tfw.tags)} tags, "
                f"schema has {len(tag_names)}"
            )
        for name, tv in zip(tag_names, tfw.tags):
            tags[name] = tag_value_to_py(tv)
    return tags


def stream_query_to_internal(req) -> im.QueryRequest:
    order_by_ts = ""
    order_by_tag = ""
    order_by_dir = "asc"
    if req.HasField("order_by"):
        if req.order_by.index_rule_name in ("", "timestamp"):
            order_by_ts = _SORT.get(req.order_by.sort, "")
        else:  # order-by-index: the rule names the tag to sort by
            order_by_tag = req.order_by.index_rule_name
            order_by_dir = _SORT.get(req.order_by.sort, "asc")
    return im.QueryRequest(
        groups=tuple(req.groups),
        name=req.name,
        time_range=im.TimeRange(
            ts_to_millis(req.time_range.begin),
            ts_to_millis(req.time_range.end),
        )
        if req.HasField("time_range")
        else im.TimeRange(0, 1 << 62),
        criteria=criteria_to_internal(req.criteria) if req.HasField("criteria") else None,
        tag_projection=_flatten_projection(req.projection),
        limit=int(req.limit) or 100,
        offset=int(req.offset),
        order_by_ts=order_by_ts,
        order_by_tag=order_by_tag,
        order_by_dir=order_by_dir,
        trace=req.trace,
        stages=tuple(req.stages),
    )


def stream_result_to_pb(res):
    out = pb.stream_query_pb2.QueryResponse()
    for row in res.data_points:
        el = out.elements.add()
        el.element_id = str(row.get("element_id", ""))
        el.timestamp.CopyFrom(millis_to_ts(row["timestamp"]))
        fam = el.tag_families.add(name="default")
        for t, v in row.get("tags", {}).items():
            tag = fam.tags.add(key=t)
            tag.value.CopyFrom(py_to_tag_value(v))
    fill_trace(out, res)
    fill_degraded(out, res)
    return out


def element_value_from_pb(stream: "isch.Stream", wreq):
    from banyandb_tpu_torch.models.stream import ElementValue

    el = wreq.element
    fams = _families_of(stream)
    if wreq.tag_family_spec:
        fams = [(fs.name, tuple(fs.tag_names)) for fs in wreq.tag_family_spec]
    tags = _positional_tags(fams, el.tag_families)
    body = tags.pop("body", b"") or b""
    if isinstance(body, str):
        body = body.encode()
    return ElementValue(
        element_id=el.element_id,
        ts_millis=ts_to_millis(el.timestamp),
        tags=tags,
        body=body,
    )


def trace_query_to_internal(req) -> im.QueryRequest:
    """trace/v1 QueryRequest -> internal: the full surface (criteria,
    flat tag projection, sidx order-by with limit+offset) — the plan
    split happens in models.trace.classify_plan, not here."""
    order_by_tag = ""
    order_by_dir = "asc"
    if req.HasField("order_by"):
        if req.order_by.index_rule_name not in ("", "timestamp"):
            order_by_tag = req.order_by.index_rule_name
            order_by_dir = _SORT.get(req.order_by.sort, "asc")
    return im.QueryRequest(
        groups=tuple(req.groups),
        name=req.name,
        time_range=im.TimeRange(
            ts_to_millis(req.time_range.begin),
            ts_to_millis(req.time_range.end),
        )
        if req.HasField("time_range")
        else im.TimeRange(0, 1 << 62),
        criteria=criteria_to_internal(req.criteria)
        if req.HasField("criteria")
        else None,
        tag_projection=tuple(req.tag_projection),
        limit=int(req.limit),  # 0 -> per-plan engine default
        offset=int(req.offset),
        order_by_tag=order_by_tag,
        order_by_dir=order_by_dir,
        trace=req.trace,
        stages=tuple(req.stages),
    )


def fill_trace_span_pb(sp, span: dict, t_schema=None, proj=()):
    """Fill one trace/v1 Span message from an engine span dict; tags
    outside `proj` (when non-empty) are dropped, tag types resolve from
    the schema when known.  Shared by TraceService.Query and the BydbQL
    trace catalog so the two wire surfaces cannot drift."""
    sp.span = span.get("span", b"")
    for k, v in span.get("tags", {}).items():
        if proj and k not in proj:
            continue
        ttype = None
        if t_schema is not None:
            try:
                ttype = t_schema.tag(k).type
            except KeyError:
                ttype = None
        t = sp.tags.add(key=k)
        t.value.CopyFrom(py_to_tag_value(v, ttype))


def fill_property_pb(m, group, name, pid, tags: dict, mod_revision=0, proj=()):
    """Fill one property/v1 Property message; shared by
    PropertyService.Query and the BydbQL property catalog."""
    m.metadata.group = group
    m.metadata.name = name
    m.metadata.mod_revision = int(mod_revision)
    m.id = str(pid)
    for k, v in tags.items():
        if proj and k not in proj:
            continue
        t = m.tags.add(key=k)
        t.value.CopyFrom(py_to_tag_value(v))


# -- schema objects --------------------------------------------------------


def group_to_internal(g) -> isch.Group:
    ro = g.resource_opts
    opts = isch.ResourceOpts(
        shard_num=ro.shard_num or 1,
        replicas=ro.replicas,
        segment_interval=_interval_to_internal(ro.segment_interval, isch.IntervalRule(1, "day")),
        ttl=_interval_to_internal(ro.ttl, isch.IntervalRule(7, "day")),
        stages=tuple(s.name for s in ro.stages),
    )
    return isch.Group(
        name=g.metadata.name,
        catalog=_CATALOG.get(g.catalog, isch.Catalog.MEASURE),
        resource_opts=opts,
    )


def _interval_to_internal(iv, default: isch.IntervalRule) -> isch.IntervalRule:
    if iv.num == 0:
        return default
    return isch.IntervalRule(iv.num, _IV_UNIT.get(iv.unit, "day"))


def group_to_pb(g: isch.Group):
    m = pb.common_common_pb2.Group()
    m.metadata.name = g.name
    m.catalog = _CATALOG_INV.get(g.catalog, 2)
    ro = m.resource_opts
    ro.shard_num = g.resource_opts.shard_num
    ro.replicas = g.resource_opts.replicas
    ro.segment_interval.num = g.resource_opts.segment_interval.num
    ro.segment_interval.unit = _IV_UNIT_INV[g.resource_opts.segment_interval.unit]
    ro.ttl.num = g.resource_opts.ttl.num
    ro.ttl.unit = _IV_UNIT_INV[g.resource_opts.ttl.unit]
    for s in g.resource_opts.stages:
        ro.stages.add(name=s, shard_num=g.resource_opts.shard_num)
    return m


def measure_to_internal(m) -> isch.Measure:
    tags: list[isch.TagSpec] = []
    fams: list[tuple[str, int]] = []
    for fam in m.tag_families:
        fams.append((fam.name, len(fam.tags)))
        for t in fam.tags:
            tags.append(isch.TagSpec(t.name, _TAG_TYPE.get(t.type, isch.TagType.STRING)))
    fields = tuple(
        isch.FieldSpec(f.name, _FIELD_TYPE.get(f.field_type, isch.FieldType.FLOAT))
        for f in m.fields
    )
    return isch.Measure(
        group=m.metadata.group,
        name=m.metadata.name,
        tags=tuple(tags),
        fields=fields,
        entity=isch.Entity(tuple(m.entity.tag_names)),
        interval=m.interval,
        index_mode=m.index_mode,
        tag_families=tuple(fams),
    )


def measure_to_pb(m: isch.Measure):
    out = pb.database_schema_pb2.Measure()
    out.metadata.group = m.group
    out.metadata.name = m.name
    for fam_name, tag_names in _families_of(m):
        fam = out.tag_families.add(name=fam_name)
        for tn in tag_names:
            t = m.tag(tn)
            fam.tags.add(name=t.name, type=_TAG_TYPE_INV[t.type])
    for f in m.fields:
        out.fields.add(name=f.name, field_type=_FIELD_TYPE_INV[f.type])
    out.entity.tag_names.extend(m.entity.tag_names)
    out.interval = m.interval
    out.index_mode = m.index_mode
    return out


def stream_to_internal(s) -> isch.Stream:
    tags: list[isch.TagSpec] = []
    fams: list[tuple[str, int]] = []
    for fam in s.tag_families:
        fams.append((fam.name, len(fam.tags)))
        for t in fam.tags:
            tags.append(isch.TagSpec(t.name, _TAG_TYPE.get(t.type, isch.TagType.STRING)))
    return isch.Stream(
        group=s.metadata.group,
        name=s.metadata.name,
        tags=tuple(tags),
        entity=tuple(s.entity.tag_names),
        tag_families=tuple(fams),
    )


def stream_to_pb(s: isch.Stream):
    out = pb.database_schema_pb2.Stream()
    out.metadata.group = s.group
    out.metadata.name = s.name
    for fam_name, tag_names in _families_of(s):
        fam = out.tag_families.add(name=fam_name)
        for tn in tag_names:
            t = s.tag(tn)
            fam.tags.add(name=t.name, type=_TAG_TYPE_INV[t.type])
    out.entity.tag_names.extend(s.entity)
    return out


def trace_to_internal(t) -> isch.Trace:
    """database/v1 Trace schema (schema.proto:247): flat TraceTagSpec
    list + trace/span/timestamp tag names."""
    return isch.Trace(
        group=t.metadata.group,
        name=t.metadata.name,
        tags=tuple(
            isch.TagSpec(s.name, _TAG_TYPE.get(s.type, isch.TagType.STRING))
            for s in t.tags
        ),
        trace_id_tag=t.trace_id_tag_name,
        timestamp_tag=t.timestamp_tag_name,
        span_id_tag=t.span_id_tag_name,
    )


def trace_to_pb(t: isch.Trace):
    out = pb.database_schema_pb2.Trace()
    out.metadata.group = t.group
    out.metadata.name = t.name
    for s in t.tags:
        out.tags.add(name=s.name, type=_TAG_TYPE_INV[s.type])
    out.trace_id_tag_name = t.trace_id_tag
    out.timestamp_tag_name = t.timestamp_tag
    out.span_id_tag_name = t.span_id_tag
    return out


def property_schema_to_internal(p) -> isch.PropertySchema:
    """database/v1 Property schema (schema.proto:224)."""
    return isch.PropertySchema(
        group=p.metadata.group,
        name=p.metadata.name,
        tags=tuple(
            isch.TagSpec(s.name, _TAG_TYPE.get(s.type, isch.TagType.STRING))
            for s in p.tags
        ),
    )


def property_schema_to_pb(p: isch.PropertySchema):
    out = pb.database_schema_pb2.Property()
    out.metadata.group = p.group
    out.metadata.name = p.name
    for s in p.tags:
        out.tags.add(name=s.name, type=_TAG_TYPE_INV[s.type])
    return out


# -- index rules / bindings / topn (database/v1) ----------------------------

_IDX_TYPE = {1: "inverted", 2: "skipping", 3: "tree"}
_IDX_TYPE_INV = {v: k for k, v in _IDX_TYPE.items()}


def index_rule_to_internal(r) -> isch.IndexRule:
    return isch.IndexRule(
        group=r.metadata.group,
        name=r.metadata.name,
        tags=tuple(r.tags),
        type=_IDX_TYPE.get(r.type, "inverted"),
        analyzer=r.analyzer,
    )


def index_rule_to_pb(r: isch.IndexRule):
    out = pb.database_schema_pb2.IndexRule()
    out.metadata.group = r.group
    out.metadata.name = r.name
    out.tags.extend(r.tags)
    out.type = _IDX_TYPE_INV.get(r.type, 1)
    out.analyzer = r.analyzer
    return out


def index_rule_binding_to_internal(b) -> isch.IndexRuleBinding:
    return isch.IndexRuleBinding(
        group=b.metadata.group,
        name=b.metadata.name,
        rules=tuple(b.rules),
        subject_catalog=_CATALOG.get(
            b.subject.catalog, isch.Catalog.MEASURE
        ).value,
        subject_name=b.subject.name,
        begin_at_millis=ts_to_millis(b.begin_at),
        expire_at_millis=ts_to_millis(b.expire_at),
    )


def index_rule_binding_to_pb(b: isch.IndexRuleBinding):
    out = pb.database_schema_pb2.IndexRuleBinding()
    out.metadata.group = b.group
    out.metadata.name = b.name
    out.rules.extend(b.rules)
    out.subject.catalog = _CATALOG_INV.get(
        isch.Catalog(b.subject_catalog), 2
    )
    out.subject.name = b.subject_name
    if b.begin_at_millis:
        out.begin_at.CopyFrom(millis_to_ts(b.begin_at_millis))
    if b.expire_at_millis:
        out.expire_at.CopyFrom(millis_to_ts(b.expire_at_millis))
    return out


_SORT_TOPN_RULE = {0: "all", 1: "desc", 2: "asc"}


def topn_to_internal(t) -> isch.TopNAggregation:
    src_group = t.source_measure.group
    return isch.TopNAggregation(
        group=t.metadata.group,
        name=t.metadata.name,
        source_measure=t.source_measure.name,
        field_name=t.field_name,
        # SORT_UNSPECIFIED on a RULE keeps BOTH directions (the rule can
        # then serve top AND bottom queries; ref topn.go sort handling)
        field_value_sort=_SORT_TOPN_RULE.get(t.field_value_sort, "desc"),
        group_by_tag_names=tuple(t.group_by_tag_names),
        counters_number=t.counters_number or 1000,
        lru_size=t.lru_size or 10,
        source_group="" if src_group in ("", t.metadata.group) else src_group,
        criteria=(
            json_format.MessageToDict(t.criteria)
            if t.HasField("criteria")
            else None
        ),
    )


def topn_to_pb(t: isch.TopNAggregation):
    out = pb.database_schema_pb2.TopNAggregation()
    out.metadata.group = t.group
    out.metadata.name = t.name
    out.source_measure.group = t.source_group or t.group
    out.source_measure.name = t.source_measure
    out.field_name = t.field_name
    out.field_value_sort = {"asc": 2, "desc": 1}.get(t.field_value_sort, 0)
    out.group_by_tag_names.extend(t.group_by_tag_names)
    out.counters_number = t.counters_number
    out.lru_size = t.lru_size
    if t.criteria:
        json_format.ParseDict(t.criteria, out.criteria)
    return out
