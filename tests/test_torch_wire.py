"""The port's ``banyandb.*.v1`` wire surface against the JAX package's.

Every test here starts one JAX wire server and one port wire server
(engines on ``device="cpu"``: the kernels' plain versions stand in on
the CPU) over the same seeded data, and sends each request to both over
real sockets through ``DualChannel``.  The two replies must be the same
bytes (``SerializeToString(deterministic=True)``) once ``VOLATILE``'s
fields are cleared in both; an error must carry the same status code
and details.  The test then goes on with the port's reply, so the JAX
test bodies that this file replays (``tests/test_wire_api.py``,
``tests/test_wire_cluster_services.py``,
``tests/test_wire_round3_services.py``, ``tests/test_aux_services.py``)
hold the port's answers to their own assertions as well.

Schema and data calls that those bodies make on a registry or engine
object go to both packages through ``Dual`` (JAX dataclasses are
rebuilt as the port's by ``to_port``).
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import json
import os
import shutil
import threading

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

import test_aux_services as aux  # noqa: E402
import test_wire_api as wa  # noqa: E402
import test_wire_cluster_services as wc  # noqa: E402
import test_wire_round3_services as w3  # noqa: E402

from banyandb_tpu_torch.api import pb as tpb  # noqa: E402

T0 = 1_700_000_000_000

# (message full name, dotted field path) -> why the field differs
# between two processes that got the same requests; both replies lose it
# before the byte compare.  Everything else must be equal.
VOLATILE = {
    ("banyandb.property.v1.Property", "metadata.mod_revision"):
        "a property's revision is its wall-clock write stamp in ms",
    ("banyandb.pipeline.v1.TracePipelineRegistryServiceDeleteResponse", "delete_time"):
        "the wall clock at the delete, in ns",
}


def _scrub(msg):
    """Clear VOLATILE's fields in `msg` and every message under it."""
    name = msg.DESCRIPTOR.full_name
    for (owner, path) in VOLATILE:
        if owner == name:
            *head, last = path.split(".")
            m = msg
            for part in head:
                m = getattr(m, part)
            m.ClearField(last)
    for fd, value in msg.ListFields():
        if fd.message_type is None:
            continue
        if fd.is_repeated:
            if fd.message_type.GetOptions().map_entry:
                vfd = fd.message_type.fields_by_name["value"]
                if vfd.message_type is not None:
                    for v in value.values():
                        _scrub(v)
            else:
                for v in value:
                    _scrub(v)
        else:
            _scrub(value)
    return msg


def same_bytes(want, got, what=""):
    """The JAX reply `want` and the port's `got`, VOLATILE cleared in
    copies, are the same serialized bytes."""
    a, b = type(want)(), type(got)()
    a.CopyFrom(want)
    b.CopyFrom(got)
    _scrub(a), _scrub(b)
    wa_, gb = a.SerializeToString(deterministic=True), b.SerializeToString(deterministic=True)
    assert wa_ == gb, f"{what}\nJAX:  {a}\nport: {b}"


def _same_error(ej, et, what):
    assert (ej.code(), ej.details()) == (et.code(), et.details()), what


class DualChannel:
    """A grpc channel stand-in that sends each call to the JAX server and
    to the port's server and checks the two replies (see module doc).
    Returns the port's reply, or raises the port's RpcError."""

    def __init__(self, jax_addr: str, port_addr: str):
        self.jax = grpc.insecure_channel(jax_addr)
        self.port = grpc.insecure_channel(port_addr)

    def _pair(self, kind, path, request_serializer=None, response_deserializer=None):
        mk = lambda ch: getattr(ch, kind)(  # noqa: E731
            path, request_serializer=request_serializer,
            response_deserializer=response_deserializer,
        )
        return mk(self.jax), mk(self.port)

    def _both(self, fj, ft, what):
        errs = []
        outs = []
        for fn in (fj, ft):
            try:
                outs.append(fn())
                errs.append(None)
            except grpc.RpcError as e:
                outs.append(None)
                errs.append(e)
        if errs[0] is not None or errs[1] is not None:
            assert errs[0] is not None and errs[1] is not None, (
                f"{what}: only one package failed: {errs}"
            )
            _same_error(errs[0], errs[1], what)
            raise errs[1]
        return outs

    def unary_unary(self, path, request_serializer=None, response_deserializer=None):
        sj, st = self._pair("unary_unary", path, request_serializer, response_deserializer)

        def call(req, **kw):
            rj, rt = self._both(lambda: sj(req, **kw), lambda: st(req, **kw), path)
            same_bytes(rj, rt, path)
            return rt

        return call

    def stream_stream(self, path, request_serializer=None, response_deserializer=None):
        sj, st = self._pair("stream_stream", path, request_serializer, response_deserializer)

        def call(req_iter, **kw):
            reqs = list(req_iter)
            rj, rt = self._both(
                lambda: list(sj(iter(reqs), **kw)), lambda: list(st(iter(reqs), **kw)), path
            )
            assert len(rj) == len(rt), path
            for i, (a, b) in enumerate(zip(rj, rt)):
                same_bytes(a, b, f"{path}[{i}]")
            return iter(rt)

        return call

    def unary_stream(self, path, request_serializer=None, response_deserializer=None):
        sj, st = self._pair("unary_stream", path, request_serializer, response_deserializer)

        def call(req, **kw):
            rj, rt = self._both(lambda: list(sj(req, **kw)), lambda: list(st(req, **kw)), path)
            assert len(rj) == len(rt), path
            for i, (a, b) in enumerate(zip(rj, rt)):
                same_bytes(a, b, f"{path}[{i}]")
            return iter(rt)

        return call

    def close(self):
        self.jax.close()
        self.port.close()


def _port_class(cls):
    """The port's twin of a JAX package class (same module path under
    ``banyandb_tpu_torch``, same qualified name)."""
    mod = importlib.import_module(
        cls.__module__.replace("banyandb_tpu.", "banyandb_tpu_torch.", 1)
    )
    obj = mod
    for part in cls.__qualname__.split("."):
        obj = getattr(obj, part)
    return obj


def to_port(v):
    """Rebuild JAX package dataclasses and enums (nested in tuples, lists
    and dicts) as the port's."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        if not type(v).__module__.startswith("banyandb_tpu."):
            return v
        kw = {f.name: to_port(getattr(v, f.name)) for f in dataclasses.fields(v) if f.init}
        return _port_class(type(v))(**kw)
    if isinstance(v, enum.Enum) and type(v).__module__.startswith("banyandb_tpu."):
        return _port_class(type(v))(v.value)
    if isinstance(v, tuple) and not hasattr(v, "_fields"):
        return tuple(to_port(x) for x in v)
    if isinstance(v, list):
        return [to_port(x) for x in v]
    if isinstance(v, dict):
        return {k: to_port(x) for k, x in v.items()}
    return v


_PLAIN = (int, float, str, bytes, bool, type(None), tuple, list, dict, set, os.PathLike)


class Dual:
    """Calls a method on a JAX object and, with the arguments rebuilt as
    the port's, on its port twin; returns the port's result.  Plain
    attributes read the port's; object attributes (an engine's ``topn``)
    are Duals themselves."""

    def __init__(self, jax_obj, port_obj):
        self._j, self._t = jax_obj, port_obj

    def __getattr__(self, name):
        ja, ta = getattr(self._j, name), getattr(self._t, name)
        if isinstance(ta, _PLAIN):
            return ta
        if not callable(ja):
            return Dual(ja, ta)

        def call(*a, **kw):
            ja(*a, **kw)
            return ta(*to_port(a), **to_port(kw))

        return call


# -- server pairs ------------------------------------------------------------


def _pkg(name):
    return importlib.import_module(name)


def _engines(pkg, root, full):
    """Fresh registry + engines of one package over `root` (the port's
    on the CPU)."""
    schema = _pkg(f"{pkg}.api.schema")
    reg = schema.SchemaRegistry(root)
    dev = {"device": "cpu"} if pkg == "banyandb_tpu_torch" else {}
    out = {
        "registry": reg,
        "measure": _pkg(f"{pkg}.models.measure").MeasureEngine(reg, root / "data", **dev),
        "stream": _pkg(f"{pkg}.models.stream").StreamEngine(reg, root / "data", **dev),
    }
    if full:
        out["property_engine"] = _pkg(f"{pkg}.models.property").PropertyEngine(reg, root / "data")
        out["trace_engine"] = _pkg(f"{pkg}.models.trace").TraceEngine(reg, root / "data")
    return out


class Pair:
    """One JAX and one port WireServer over fresh engines, the same
    WireServices options, and a DualChannel to them."""

    def __init__(self, tmp_path, full=False, setup=None, schema_store=False, **svc_kw):
        """`full`: property and trace engines too; `setup(schema module,
        registry)` runs in each package first; `schema_store`: each
        package's property-backed schema store (needs `full`)."""
        self.parts = {}
        self.servers = {}
        for pkg in ("banyandb_tpu", "banyandb_tpu_torch"):
            root = tmp_path / pkg
            e = _engines(pkg, root, full)
            if setup is not None:
                setup(_pkg(f"{pkg}.api.schema"), e["registry"])
            gs = _pkg(f"{pkg}.api.grpc_server")
            extra = {k: e[k] for k in ("property_engine", "trace_engine") if k in e}
            if schema_store:
                extra["schema_store"] = _pkg(f"{pkg}.cluster.schema_plane").PropertySchemaStore(
                    e["registry"], e["property_engine"])
            svcs = gs.WireServices(e["registry"], e["measure"], e["stream"], **extra, **svc_kw)
            srv = gs.WireServer(svcs, port=0)
            srv.start()
            self.parts[pkg], self.servers[pkg] = e, srv
        self.chan = DualChannel(
            f"127.0.0.1:{self.servers['banyandb_tpu'].port}",
            f"127.0.0.1:{self.servers['banyandb_tpu_torch'].port}",
        )

    def dual(self, key):
        return Dual(self.parts["banyandb_tpu"][key], self.parts["banyandb_tpu_torch"][key])

    def close(self):
        self.chan.close()
        for pkg, srv in self.servers.items():
            srv.stop()
            for k in ("measure", "stream", "property_engine", "trace_engine"):
                if k in self.parts[pkg]:
                    self.parts[pkg][k].close()


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


# -- tests/test_wire_api.py --------------------------------------------------


@pytest.mark.parametrize("name", [
    "test_group_registry_roundtrip",
    "test_measure_schema_write_query",
    "test_stream_write_query",
    "test_bydbql_service",
    "test_unknown_measure_is_not_found",
    "test_spec_registries_roundtrip",
])
def test_wire_api_over_both(name, pair):
    """tests/test_wire_api.py's server tests, each request to both."""
    getattr(wa, name)(pair.chan)


def test_wire_api_catalogs_over_both(tmp_path):
    """tests/test_wire_api.py's two server_full tests (BydbQL over the
    trace and property catalogs, the schema's trace-id tag): schema,
    spans and properties go to both packages, each query to both."""
    p = Pair(tmp_path, full=True)
    try:
        full = (p.chan, p.dual("registry"), p.dual("trace_engine"), p.dual("property_engine"))
        wa.test_bydbql_trace_and_property_catalogs(full)
        wa.test_bydbql_trace_custom_id_tag(full)
    finally:
        p.close()


def test_sort_unspecified_means_ascending():
    """The wire codec's sort defaults (tests/test_wire_api.py): the JAX
    test on the port's codec, and each internal request equal to the
    JAX codec's."""
    from banyandb_tpu.api import wire as jwire
    from banyandb_tpu_torch.api import wire as twire

    mq = tpb.measure_query_pb2.QueryRequest(groups=["g"], name="m")
    mq.order_by.sort = 0
    sq = tpb.stream_query_pb2.QueryRequest(groups=["g"], name="s")
    sq.order_by.index_rule_name = "idx_tag"
    mq2 = tpb.measure_query_pb2.QueryRequest(groups=["g"], name="m")
    mq2.top.number, mq2.top.field_name = 5, "f"
    for fn, req in (("measure_query_to_internal", mq), ("stream_query_to_internal", sq),
                    ("measure_query_to_internal", mq2)):
        assert getattr(twire, fn)(req) == to_port(getattr(jwire, fn)(req))
    assert twire.measure_query_to_internal(mq).order_by_ts == "asc"
    assert twire.stream_query_to_internal(sq).order_by_dir == "asc"
    assert twire.measure_query_to_internal(mq2).top.field_value_sort == "desc"
    mq.order_by.sort = 1
    assert twire.measure_query_to_internal(mq).order_by_ts == "desc"


def test_criteria_unknown_condition_op_rejected():
    """Both codecs refuse an unknown wire op with the same message."""
    from banyandb_tpu.api import wire as jwire
    from banyandb_tpu_torch.api import wire as twire

    crit = tpb.model_query_pb2.Criteria()
    crit.condition.name = "svc"
    crit.condition.op = 99
    crit.condition.value.str.value = "s"
    for wire in (jwire, twire):
        with pytest.raises(ValueError, match="unknown condition op 99"):
            wire.criteria_to_internal(crit)


def _page_source(pkg, root):
    """tests/test_wire_api.py's cross-group merge set-up in one package:
    g1 owns even timestamps, g2 odd, 20 rows each."""
    api = _pkg(f"{pkg}.api")
    e = _engines(pkg, root, full=False)
    reg = e["registry"]
    for g, start in (("g1", T0), ("g2", T0 + 1)):
        reg.create_group(api.Group(g, api.Catalog.MEASURE, api.ResourceOpts(shard_num=1)))
        reg.create_measure(api.Measure(
            group=g, name="m", tags=(api.TagSpec("svc", api.TagType.STRING),),
            fields=(api.FieldSpec("v", api.FieldType.FLOAT),), entity=api.Entity(("svc",)),
        ))
        e["measure"].write(api.WriteRequest(g, "m", tuple(
            api.DataPointValue(ts_millis=start + 2 * i, tags={"svc": "s"},
                               fields={"v": float(i)}, version=1)
            for i in range(20)
        )))
    e["measure"].flush()
    return e


def test_cross_group_merge_pagination_past_first_page(tmp_path):
    """Merged pages past the first slice the globally merged stream, and
    each page's reply is the JAX server's bytes."""
    svcs = {}
    for pkg in ("banyandb_tpu", "banyandb_tpu_torch"):
        e = _page_source(pkg, tmp_path / pkg)
        svcs[pkg] = (_pkg(f"{pkg}.api.grpc_server").WireServices(
            e["registry"], e["measure"], e["stream"]), _pkg(f"{pkg}.api.model"))

    def page(offset, limit):
        outs = []
        for svc, model in svcs.values():
            out = svc._measure_query_multi_group(model.QueryRequest(
                groups=("g1", "g2"), name="m", time_range=model.TimeRange(T0, T0 + 10_000),
                offset=offset, limit=limit,
            ))
            outs.append(out)
        same_bytes(*outs, f"page({offset}, {limit})")
        return [dp.timestamp.seconds * 1000 + dp.timestamp.nanos // 1_000_000
                for dp in outs[1].data_points]

    assert page(10, 5) == [T0 + 10, T0 + 11, T0 + 12, T0 + 13, T0 + 14]
    assert page(30, 5) == [T0 + 30, T0 + 31, T0 + 32, T0 + 33, T0 + 34]
    assert page(0, 40) == page(0, 10) + page(10, 10) + page(20, 10) + page(30, 10)


def _topn_request(group="g1", name="top_m", op=None):
    req = tpb.measure_topn_pb2.TopNRequest(groups=[group], name=name, top_n=5)
    req.time_range.begin.seconds = (T0 - 120_000) // 1000
    req.time_range.end.seconds = (T0 + 120_000) // 1000
    if op is not None:
        cond = req.conditions.add()
        cond.name, cond.op = "svc", op
        cond.value.str.value = "s"
    return req


def _topn_stub(chan):
    return wa._method(chan, "banyandb.measure.v1.MeasureService", "TopN",
                      tpb.measure_topn_pb2.TopNRequest, tpb.measure_topn_pb2.TopNResponse)


def test_topn_unknown_condition_op_rejected(pair):
    """An unknown TopN condition op is INVALID_ARGUMENT, and a mapped but
    unsupported one names itself, over the wire from both servers."""
    from banyandb_tpu.api import WriteRequest
    from banyandb_tpu.api.schema import TopNAggregation

    reg, measure = pair.dual("registry"), pair.dual("measure")
    measure.write(WriteRequest("g1", "m", wa._mk_measure(reg, "g1", 5, T0, 1)))
    reg.create_topn(TopNAggregation(
        group="g1", name="top_m", source_measure="m", field_name="v",
        group_by_tag_names=("svc",),
    ))
    topn = _topn_stub(pair.chan)
    with pytest.raises(grpc.RpcError) as ei:
        topn(_topn_request(op=99))
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "unknown TopN condition op 99" in ei.value.details()
    with pytest.raises(grpc.RpcError) as ei:
        topn(_topn_request(op=3))
    assert "not supported" in ei.value.details()


def test_topn_rule_with_criteria_matches_jax(pair):
    """A TopN rule with ingest-time ``criteria`` (proto JSON, parsed by
    ``json_format`` + ``wire.criteria_to_internal``; the port raised
    before): the same seeded points through MeasureService/Write into
    both servers, then TopN asked over the wire, byte-identical, and the
    ranking equal to numpy's over the rows the criteria keep."""
    rpc = tpb.database_rpc_pb2
    wa._create_group(pair.chan, name="tg", catalog=2)
    m = rpc.MeasureRegistryServiceCreateRequest()
    m.measure.metadata.group, m.measure.metadata.name = "tg", "calls"
    fam = m.measure.tag_families.add(name="default")
    fam.tags.add(name="svc", type=1)
    fam.tags.add(name="region", type=1)
    m.measure.fields.add(name="value", field_type=2)  # INT
    m.measure.entity.tag_names.extend(["svc", "region"])
    wa._method(pair.chan, "banyandb.database.v1.MeasureRegistryService", "Create",
               rpc.MeasureRegistryServiceCreateRequest,
               rpc.MeasureRegistryServiceCreateResponse)(m)
    t = rpc.TopNAggregationRegistryServiceCreateRequest()
    a = t.top_n_aggregation
    a.metadata.group, a.metadata.name = "tg", "top_calls"
    a.source_measure.group, a.source_measure.name = "tg", "calls"
    a.field_name = "value"
    a.field_value_sort = 1  # DESC
    a.group_by_tag_names.append("svc")
    a.counters_number = 100
    a.criteria.condition.name = "region"
    a.criteria.condition.op = 2  # NE
    a.criteria.condition.value.str.value = "r3"
    wa._method(pair.chan, "banyandb.database.v1.TopNAggregationRegistryService", "Create",
               rpc.TopNAggregationRegistryServiceCreateRequest,
               rpc.TopNAggregationRegistryServiceCreateResponse)(t)
    for pkg, e in pair.parts.items():
        assert e["registry"].get_topn("tg", "top_calls").criteria, pkg

    rng = np.random.default_rng(7)
    n = 400
    svc = rng.integers(0, 12, n)
    region = rng.integers(0, 4, n)
    val = rng.integers(1, 100, n)

    def gen():
        for i in range(n):
            w = tpb.measure_write_pb2.WriteRequest()
            w.metadata.group, w.metadata.name = "tg", "calls"
            w.message_id = i + 1
            dp = w.data_point
            dp.timestamp.CopyFrom(wa._ts(T0 + i))
            f = dp.tag_families.add()
            f.tags.add().str.value = f"s{svc[i]}"
            f.tags.add().str.value = f"r{region[i]}"
            dp.fields.add().int.value = int(val[i])
            dp.version = 1
            yield w

    write = wa._method(pair.chan, "banyandb.measure.v1.MeasureService", "Write",
                       tpb.measure_write_pb2.WriteRequest,
                       tpb.measure_write_pb2.WriteResponse, kind="stream")
    assert all(r.status == "STATUS_SUCCEED" for r in write(gen()))
    for e in pair.parts.values():
        e["measure"].topn.flush_all_windows()
        e["measure"].flush()
    req = _topn_request(group="tg", name="top_calls")
    req.agg = 5  # SUM over the window's rows
    got = _topn_stub(pair.chan)(req)
    # a counter per series (the source's entity, svc and region), summed
    # over the window the rows fall in
    items = [(tuple(t.value.str.value for t in it.entity), it.value.int.value)
             for it in got.lists[0].items]
    sums = {(f"s{s}", f"r{r}"): int(val[(svc == s) & (region == r)].sum())
            for s in range(12) for r in range(4) if r != 3}
    want = sorted(sums.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)[:5]
    assert items == want


# -- tests/test_wire_cluster_services.py -------------------------------------

_NODE = {
    "name": "dn-test",
    "grpc_address": "127.0.0.1:0",
    "roles": ("data", "liaison"),
    "labels": {"zone": "z1"},
}


@pytest.mark.parametrize("name", [
    "test_trace_registry_crud",
    "test_property_registry_crud",
    "test_api_version_node_and_cluster_state",
    "test_schema_barrier_service",
])
def test_cluster_services_over_both(name, tmp_path):
    """tests/test_wire_cluster_services.py's server tests, each request
    to both servers (node info as the JAX fixture gives it)."""
    p = Pair(tmp_path, node_info=_NODE)
    try:
        getattr(wc, name)((p.chan, p.dual("registry")))
    finally:
        p.close()


def test_barrier_concurrency_cap(tmp_path):
    """Barrier waits beyond the slot cap fail fast with
    RESOURCE_EXHAUSTED: the JAX test against each server on its own (a
    dual call would serialise the waits), with the same counts."""
    p = Pair(tmp_path, node_info=_NODE)
    try:
        for ch in (p.chan.jax, p.chan.port):
            wc.test_barrier_concurrency_cap((ch, None))
    finally:
        p.close()


def _users(tmp_path, users):
    from banyandb_tpu_torch.api.auth import write_users_file

    path = tmp_path / "users.yaml"
    write_users_file(path, users)
    return path


def test_basic_auth_with_hot_reload(tmp_path):
    """Basic auth over a users file, hot-reloaded: one users file (written
    by the port's ``write_users_file``) guards both servers; bare, wrong
    and right credentials, then a rotated password, answer alike."""
    from banyandb_tpu_torch.api.auth import write_users_file

    users = _users(tmp_path, {"admin": "s3cret"})
    servers = {}
    for pkg in ("banyandb_tpu", "banyandb_tpu_torch"):
        e = _engines(pkg, tmp_path / pkg, full=False)
        gs = _pkg(f"{pkg}.api.grpc_server")
        servers[pkg] = gs.WireServer(
            gs.WireServices(e["registry"], e["measure"], e["stream"]), port=0,
            auth_file=str(users),
        ).start()
    chan = DualChannel(*(f"127.0.0.1:{s.port}" for s in servers.values()))
    crpc = tpb.common_rpc_pb2
    svc, m = "banyandb.common.v1.Service", "GetAPIVersion"
    args = (crpc.GetAPIVersionRequest, crpc.GetAPIVersionResponse)
    try:
        with pytest.raises(grpc.RpcError) as ei:
            wc._method(chan, svc, m, *args)(crpc.GetAPIVersionRequest())
        assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
        with pytest.raises(grpc.RpcError) as ei:
            wc._method(chan, svc, m, *args, metadata=(("username", "admin"), ("password", "wrong")))(
                crpc.GetAPIVersionRequest())
        assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
        ok = wc._method(chan, svc, m, *args, metadata=(("username", "admin"), ("password", "s3cret")))
        assert ok(crpc.GetAPIVersionRequest()).version.version == "0.10"
        write_users_file(users, {"admin": "rotated"})
        for s in servers.values():
            s.auth.touch_for_test()
        with pytest.raises(grpc.RpcError) as ei:
            ok(crpc.GetAPIVersionRequest())
        assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
        ok2 = wc._method(chan, svc, m, *args, metadata=(("username", "admin"), ("password", "rotated")))
        assert ok2(crpc.GetAPIVersionRequest()).version.version == "0.10"
    finally:
        chan.close()
        for s in servers.values():
            s.stop()


def test_auth_refuses_world_readable_users_file(tmp_path):
    """A users file others can read is refused by both packages."""
    import os

    from banyandb_tpu.api.auth import AuthReloader as JAuth
    from banyandb_tpu_torch.api.auth import AuthReloader as TAuth

    users = _users(tmp_path, {"a": "b"})
    os.chmod(users, 0o644)
    for cls in (JAuth, TAuth):
        with pytest.raises(PermissionError):
            cls(users)


def test_barrier_revision_survives_restart(tmp_path):
    """Per-object revisions persist across a registry restart, in the
    port alone and across packages: a root written by either registry
    satisfies the other package's barrier at the written revision."""
    from banyandb_tpu_torch.api.grpc_server import RegistryBarrier as TBarrier
    from banyandb_tpu.api.grpc_server import RegistryBarrier as JBarrier

    for writer in ("banyandb_tpu", "banyandb_tpu_torch"):
        api = _pkg(f"{writer}.api")
        root = tmp_path / writer
        rev = api.SchemaRegistry(root).create_group(
            api.Group("rg", api.Catalog.MEASURE, api.ResourceOpts(shard_num=1)))
        assert rev > 0
        for reader, barrier in (("banyandb_tpu", JBarrier), ("banyandb_tpu_torch", TBarrier)):
            reg2 = _pkg(f"{reader}.api.schema").SchemaRegistry(root)  # restart
            applied, laggards = barrier(reg2).await_applied([("group", "", "rg")], [rev], 0.2)
            assert applied, (writer, reader, laggards)


def _http(port, path, auth=None):
    import base64
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if auth:
        req.add_header("Authorization", "Basic " + base64.b64encode(auth.encode()).decode())
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_gateway_honors_auth(tmp_path):
    """The HTTP gateway behind a users file: healthz open, 401 with a
    Basic challenge without credentials, the cluster state with them —
    the same status, challenge and body from both packages."""
    users = _users(tmp_path, {"web": "pw"})
    gws = {}
    for pkg in ("banyandb_tpu", "banyandb_tpu_torch"):
        e = _engines(pkg, tmp_path / pkg, full=False)
        gws[pkg] = _pkg(f"{pkg}.api.http_gateway").HttpGateway(
            _pkg(f"{pkg}.api.grpc_server").WireServices(e["registry"], e["measure"], e["stream"]),
            port=0, auth=_pkg(f"{pkg}.api.auth").AuthReloader(users),
        ).start()
    try:
        for path, auth, status in (("/api/healthz", None, 200),
                                   ("/api/v1/cluster/state", None, 401),
                                   ("/api/v1/cluster/state", "web:pw", 200),
                                   ("/api/v1/cluster/state", "web:no", 401)):
            (sj, hj, bj), (st, ht, bt) = (_http(g.port, path, auth) for g in gws.values())
            assert sj == st == status, path
            assert bj == bt, path
            assert hj.get("WWW-Authenticate") == ht.get("WWW-Authenticate"), path
        assert ht["WWW-Authenticate"].startswith("Basic") if status == 401 else True
        assert "route_tables" in json.loads(_http(gws["banyandb_tpu_torch"].port,
                                                  "/api/v1/cluster/state", "web:pw")[2])
    finally:
        for g in gws.values():
            g.stop()


# -- tests/test_wire_round3_services.py --------------------------------------


@pytest.mark.parametrize("name", [
    "test_node_schema_status_service",
    "test_trace_pipeline_registry_crud",
    "test_group_lifecycle_inspect_all",
])
def test_round3_services_over_both(name, pair):
    """tests/test_wire_round3_services.py's server tests, each request to
    both servers; the trace-pipeline test's restart check reads the
    port's root with the JAX registry."""
    getattr(w3, name)((pair.chan, pair.dual("registry")))


def test_cluster_send_and_healthcheck_on_reference_proto():
    """cluster.v1 Send/HealthCheck on the port's GrpcBusServer against
    the JAX one's, over one echo bus each: the same responses, and the
    JAX test's own assertions on the port's.  The streaming part sync
    (``sync_install``) is the next slice's and refuses, naming it."""
    from banyandb_tpu.cluster.bus import LocalBus as JBus
    from banyandb_tpu.cluster.rpc import GrpcBusServer as JServer
    from banyandb_tpu_torch.cluster.bus import LocalBus as TBus
    from banyandb_tpu_torch.cluster.rpc import GrpcBusServer as TServer

    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        TServer(TBus(), port=0, sync_install=lambda *a: None)
    servers = []
    for bus_cls, srv_cls in ((JBus, JServer), (TBus, TServer)):
        bus = bus_cls()
        bus.subscribe("echo", lambda env: {"got": env})
        srv = srv_cls(bus, port=0)
        srv.start()
        servers.append(srv)
    chan = DualChannel(servers[0].addr, servers[1].addr)
    cl, wr = tpb.cluster_rpc_pb2, tpb.model_write_pb2
    try:
        send = chan.stream_stream(
            "/banyandb.cluster.v1.Service/Send",
            request_serializer=cl.SendRequest.SerializeToString,
            response_deserializer=cl.SendResponse.FromString,
        )
        resps = list(send(iter([
            cl.SendRequest(topic="echo", message_id=1, body=json.dumps({"x": 1}).encode(),
                           batch_mod=True),
            cl.SendRequest(topic="nope", message_id=2, body=b"{}"),
        ])))
        assert [r.message_id for r in resps] == [1, 2]
        assert resps[0].status == wr.STATUS_SUCCEED
        assert json.loads(resps[0].body) == {"got": {"x": 1}}
        assert resps[1].status == wr.STATUS_INTERNAL_ERROR
        assert "no handler" in resps[1].error
        hc = chan.unary_unary(
            "/banyandb.cluster.v1.Service/HealthCheck",
            request_serializer=cl.HealthCheckRequest.SerializeToString,
            response_deserializer=cl.HealthCheckResponse.FromString,
        )
        assert hc(cl.HealthCheckRequest(service_name="echo")).status == wr.STATUS_SUCCEED
        assert hc(cl.HealthCheckRequest(service_name="ghost")).status == wr.STATUS_NOT_FOUND
    finally:
        chan.close()
        for s in servers:
            s.stop()


# -- tests/test_aux_services.py ----------------------------------------------


@pytest.mark.skipif(shutil.which("openssl") is None, reason="needs openssl")
def test_tls_hot_reload(tmp_path):
    """The port's GrpcBusServer over TLS, its PEMs rotated in place: a
    client trusting only the new cert connects after the rotation with no
    restart.  The old cert's client is the JAX package's GrpcTransport,
    the new one's the port's: one certificate pair serves both."""
    from banyandb_tpu.cluster.rpc import GrpcTransport as JTransport
    from banyandb_tpu_torch.cluster.bus import LocalBus, Topic
    from banyandb_tpu_torch.cluster.rpc import GrpcBusServer, GrpcTransport

    old_dir, new_dir, live = tmp_path / "old", tmp_path / "new", tmp_path / "live"
    for d in (old_dir, new_dir, live):
        d.mkdir()
    aux._mk_cert(old_dir, "localhost")
    aux._mk_cert(new_dir, "localhost")
    shutil.copy(old_dir / "cert.pem", live / "cert.pem")
    shutil.copy(old_dir / "key.pem", live / "key.pem")
    bus = LocalBus()
    bus.subscribe(Topic.HEALTH, lambda env: {"status": "ok"})
    srv = GrpcBusServer(bus, port=0, cert_file=live / "cert.pem", key_file=live / "key.pem")
    srv.start()
    try:
        t_old = JTransport(ca_file=str(old_dir / "cert.pem"))
        assert t_old.call(srv.addr, Topic.HEALTH.value, {})["status"] == "ok"
        t_old.close()
        shutil.copy(new_dir / "cert.pem", live / "cert.pem")
        shutil.copy(new_dir / "key.pem", live / "key.pem")
        t_new = GrpcTransport(ca_file=str(new_dir / "cert.pem"))
        assert t_new.call(srv.addr, Topic.HEALTH.value, {})["status"] == "ok"
        t_new.close()
        assert srv.tls_reloader.reloads >= 1
    finally:
        srv.stop()


def _aux_schema(S, reg):
    """tests/test_aux_services.py's ``wire`` fixture schema, in either
    package."""
    reg.create_group(S.Group("pg", S.Catalog.PROPERTY, S.ResourceOpts(shard_num=1)))
    reg.create_group(S.Group("tg", S.Catalog.TRACE, S.ResourceOpts(shard_num=1)))
    reg.create_trace(S.Trace(
        group="tg", name="sw",
        tags=(S.TagSpec("trace_id", S.TagType.STRING), S.TagSpec("ts", S.TagType.TIMESTAMP),
              S.TagSpec("dur", S.TagType.INT)),
        trace_id_tag="trace_id", timestamp_tag="ts",
    ))
    reg.create_index_rule(S.IndexRule(group="tg", name="dur_tree", tags=("dur",), type="tree"))


@pytest.mark.parametrize("name", ["test_property_service_wire", "test_trace_service_wire"])
def test_aux_wire_services_over_both(name, tmp_path):
    """The property and trace wire services (tests/test_aux_services.py),
    each request to both servers."""
    p = Pair(tmp_path, full=True, setup=_aux_schema)
    try:
        getattr(aux, name)(p.chan)
    finally:
        p.close()


def _watch_replay(chan) -> list:
    """SchemaUpdateService/WatchSchemas: subscribe, read the replay up to
    its REPLAY_DONE marker, hang up.  -> the replayed responses."""
    ipb = tpb.schema_internal_pb2
    done = threading.Event()

    def reqs():
        yield ipb.WatchSchemasRequest()
        done.wait(10)

    call = chan.stream_stream(
        "/banyandb.schema.v1.SchemaUpdateService/WatchSchemas",
        request_serializer=ipb.WatchSchemasRequest.SerializeToString,
        response_deserializer=ipb.WatchSchemasResponse.FromString,
    )(reqs(), timeout=30)
    out = []
    try:
        for resp in call:
            out.append(resp)
            if resp.event_type == 4:  # REPLAY_DONE
                break
    finally:
        done.set()
        call.cancel()
    return out


def test_schema_management_and_watch_over_both(tmp_path):
    """The schema plane's wire services over each package's property-backed
    schema store: tests/test_schema_plane.py's SchemaManagementService
    insert, list and delete, each request to both servers, then a
    WatchSchemas subscriber's replay of the schema set (up to
    REPLAY_DONE) from each, the same events in the same order."""
    import json as _json

    from banyandb_tpu.api import Catalog, Group, ResourceOpts
    from banyandb_tpu.api import schema as jschema

    import test_schema_plane as sp

    p = Pair(tmp_path, full=True, schema_store=True)
    try:
        p.dual("registry").create_group(Group("mg", Catalog.MEASURE, ResourceOpts(shard_num=1)))
        ipb = tpb.schema_internal_pb2
        S = "/banyandb.schema.v1.SchemaManagementService/"
        req = ipb.InsertSchemaRequest()
        req.property.metadata.group, req.property.metadata.name = "_schema", "measure"
        req.property.id = "mg/wire_m"
        req.property.tags.add(key="payload").value.str.value = _json.dumps(
            jschema._to_jsonable(sp._measure("mg", "wire_m")))
        p.chan.unary_unary(S + "InsertSchema", ipb.InsertSchemaRequest.SerializeToString,
                           ipb.InsertSchemaResponse.FromString)(req)
        for e in p.parts.values():
            assert e["registry"].get_measure("mg", "wire_m").fields[0].name == "lat"
        listing = p.chan.unary_stream(S + "ListSchemas", ipb.ListSchemasRequest.SerializeToString,
                                      ipb.ListSchemasResponse.FromString)
        assert "mg/wire_m" in [d.id for r in listing(ipb.ListSchemasRequest()) for d in r.properties]
        replays = [_watch_replay(c) for c in (p.chan.jax, p.chan.port)]
        assert [r.event_type for r in replays[1]][-1] == 4 and len(replays[1]) > 2
        assert len(replays[0]) == len(replays[1])
        for i, (a, b) in enumerate(zip(*replays)):
            same_bytes(a, b, f"WatchSchemas replay[{i}]")
        dreq = ipb.DeleteSchemaRequest()
        dreq.delete.group, dreq.delete.name, dreq.delete.id = "_schema", "measure", "mg/wire_m"
        assert p.chan.unary_unary(S + "DeleteSchema", ipb.DeleteSchemaRequest.SerializeToString,
                                  ipb.DeleteSchemaResponse.FromString)(dreq).found
        for e in p.parts.values():
            with pytest.raises(KeyError):
                e["registry"].get_measure("mg", "wire_m")
    finally:
        p.close()
