"""The port's standalone server against the JAX package's.

One JAX ``StandaloneServer(root, port=0)`` and one port
``StandaloneServer(root2, device="cpu")`` (the kernels' plain versions
stand in on the CPU) are started per module, and the same seeded
envelope script is replayed through each ``bus.handle``: health,
registry create/list, row and columnar measure writes, BydbQL (measure
aggregate, TopN, percentile, stream, trace, property), the raw measure
query topic, the TopN topic, streamagg register/read, qos, snapshot,
slowlog, metrics, diagnostics and the pprof capture topic.

Tolerance: ``reply["result"]`` is byte-identical (as JSON) wherever the
JAX contract is exact — counts, min/max, percentiles, rows, group order
and integer-valued sums — with span timings and ``*_ms`` fields
stripped; sums and means of the non-integer ``lat`` field follow
``tests/test_precision.py`` (rtol 1e-5).  Topics whose replies carry
process state (qos counters, slowlog timings, metrics, diagnostics)
are held to the same shape: the same keys, entry counts and metric
names.  A restart over the same root answers with the same bytes, and
the device policy, the network tiers starting and the command line
are pinned at the end.
"""

import base64
import json

import numpy as np
import pytest
import torch

from banyandb_tpu.api import schema as jschema
from banyandb_tpu.obs import prom as jprom
from banyandb_tpu_torch.obs import prom as tprom

T0 = 1_700_000_000_000
N = 6000
N_SVC = 12
RTOL = 1e-5
SEED = 11


def _b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _item(obj) -> dict:
    return json.loads(json.dumps(jschema._to_jsonable(obj)))


def _schema_envelopes() -> list:
    S = jschema
    groups = [
        S.Group("sw", S.Catalog.MEASURE, S.ResourceOpts(shard_num=2)),
        S.Group("sg", S.Catalog.STREAM, S.ResourceOpts(shard_num=2)),
        S.Group("tg", S.Catalog.TRACE, S.ResourceOpts(shard_num=2)),
        S.Group("pg", S.Catalog.PROPERTY, S.ResourceOpts(shard_num=2)),
    ]
    measures = [
        S.Measure(
            group="sw", name="srt",
            tags=(S.TagSpec("svc", S.TagType.STRING),
                  S.TagSpec("region", S.TagType.STRING)),
            fields=(S.FieldSpec("lat", S.FieldType.FLOAT),
                    S.FieldSpec("calls", S.FieldType.INT)),
            entity=S.Entity(("svc", "region")),
        ),
        S.Measure(
            group="sw", name="ep_cpm",
            tags=(S.TagSpec("ep", S.TagType.STRING),),
            fields=(S.FieldSpec("value", S.FieldType.INT),),
            entity=S.Entity(("ep",)),
        ),
    ]
    topn = S.TopNAggregation(
        group="sw", name="top_eps", source_measure="ep_cpm",
        field_name="value", group_by_tag_names=("ep",),
    )
    out = [("create group " + g.name, "registry",
            {"op": "create", "kind": "group", "item": _item(g)}) for g in groups]
    out += [("create measure " + m.name, "registry",
             {"op": "create", "kind": "measure", "item": _item(m)}) for m in measures]
    out.append(("create topn", "registry",
                {"op": "create", "kind": "topn", "item": _item(topn)}))
    out.append(("create stream", "registry", {
        "op": "create_stream", "kind": "stream",
        "item": {"group": "sg", "name": "logs",
                 "tags": [{"name": "svc", "type": "string"},
                          {"name": "level", "type": "string"}],
                 "entity": ["svc"]},
    }))
    out.append(("create trace", "registry", {
        "op": "create_trace", "kind": "trace",
        "item": {"group": "tg", "name": "spans",
                 "tags": [{"name": "trace_id", "type": "string"},
                          {"name": "svc", "type": "string"},
                          {"name": "duration", "type": "int"}],
                 "trace_id_tag": "trace_id"},
    }))
    return out


def _write_envelopes() -> list:
    rng = np.random.default_rng(SEED)
    svc = rng.integers(0, N_SVC, N).astype("<i4")
    region = rng.integers(0, 4, N).astype("<i4")
    lat = rng.gamma(2.0, 40.0, N)
    calls = rng.integers(1, 100, N).astype(np.float64)
    half = N // 2
    rows = [
        {"ts": T0 + i, "tags": {"svc": f"svc-{svc[i]:02d}", "region": f"r{region[i]}"},
         "fields": {"lat": float(lat[i]), "calls": int(calls[i])}, "version": 1}
        for i in range(half)
    ]
    cols = {
        "group": "sw", "name": "srt",
        "ts": _b64((T0 + np.arange(half, N)).astype("<i8")),
        "tags": {
            "svc": {"dict": [f"svc-{i:02d}" for i in range(N_SVC)],
                    "codes": _b64(svc[half:])},
            "region": {"dict": [f"r{i}" for i in range(4)], "codes": _b64(region[half:])},
        },
        "fields": {"lat": _b64(lat[half:].astype("<f8")),
                   "calls": _b64(calls[half:].astype("<f8"))},
        "versions": _b64(np.ones(N - half, "<i8")),
    }
    eps = [
        {"ts": T0 + w * 60_000 + i, "tags": {"ep": f"e{i % 4}"},
         "fields": {"value": (i % 4) * 10 + 1}, "version": 1}
        for w in range(3) for i in range(40)
    ]
    levels = ("INFO", "WARN", "ERROR")
    elements = [
        {"element_id": f"el-{i}", "ts": T0 + i,
         "tags": {"svc": f"svc-{i % 5}", "level": levels[i % 3]},
         "body": base64.b64encode(f"body {i}".encode()).decode()}
        for i in range(300)
    ]
    spans = [
        {"ts": T0 + t * 10 + s,
         "tags": {"trace_id": f"t{t}", "svc": f"s{t % 5}", "duration": t * 100 + s * 7},
         "span": base64.b64encode(f"sp-{t}-{s}".encode()).decode()}
        for t in range(60) for s in range(3)
    ]
    props = [
        ("property-apply", {"group": "pg", "name": "node", "id": f"n{i}",
                            "tags": {"role": ("data", "liaison")[i % 2]}})
        for i in range(20)
    ]
    out = [
        ("streamagg register", "streamagg", {
            "op": "register", "group": "sw", "measure": "srt",
            "key_tags": ["svc"], "fields": ["calls"],
        }),
        ("measure-write rows", "measure-write",
         {"request": {"group": "sw", "name": "srt", "points": rows}}),
        ("measure-write-cols", "measure-write-cols", cols),
        ("measure-write topn source", "measure-write",
         {"request": {"group": "sw", "name": "ep_cpm", "points": eps}}),
        ("stream-write", "stream-write",
         {"group": "sg", "name": "logs", "elements": elements}),
        ("trace-write", "trace-write",
         {"group": "tg", "name": "spans", "spans": spans, "ordered_tags": ["duration"]}),
    ]
    out += [(f"property-apply {e['id']}", t, e) for t, e in props]
    out.append(("property-apply merge", "property-apply",
                {"group": "pg", "name": "node", "id": "n3", "tags": {"zone": "z1"}}))
    return out


_SPAN = f"TIME BETWEEN {T0} AND {T0 + N - 1}"
QUERIES = {
    "aggregate": f"SELECT sum(calls) FROM MEASURE srt IN sw {_SPAN} GROUP BY svc",
    "aggregate lat": f"SELECT mean(lat) FROM MEASURE srt IN sw {_SPAN} "
                     "WHERE region != 'r3' GROUP BY svc",
    "topn": f"SELECT lat, calls FROM MEASURE srt IN sw {_SPAN} "
            "WHERE region != 'r3' GROUP BY svc TOP 5 BY calls",
    "percentile": f"SELECT percentile(lat, 0.5, 0.99) FROM MEASURE srt IN sw {_SPAN} "
                  f"WHERE region != 'r3' GROUP BY svc LIMIT {N_SVC}",
    "count region": f"SELECT count(calls) FROM MEASURE srt IN sw {_SPAN} "
                    "WHERE region IN ('r0', 'r2') GROUP BY region",
    "stream": f"SELECT * FROM STREAM logs IN sg TIME BETWEEN {T0} AND {T0 + 400} "
              "WHERE level = 'ERROR' LIMIT 20",
    "trace": "SELECT * FROM TRACE spans IN tg WHERE svc = 's3' AND duration >= 2000 "
             "LIMIT 100",
    "property": "SELECT * FROM PROPERTY node IN pg WHERE role = 'data' LIMIT 100",
}


def _query_envelopes() -> list:
    out = [(f"bydbql {k}", "bydbql", {"ql": ql}) for k, ql in QUERIES.items()]
    out.append(("bydbql traced", "bydbql", {"ql": QUERIES["percentile"], "trace": True}))
    raw = {
        "groups": ["sw"], "name": "srt", "time_range": [T0, T0 + N],
        "group_by": ["region"],
        "agg": {"function": "max", "field_name": "calls"},
    }
    out.append(("measure-query-raw", "measure-query-raw", {"request": raw}))
    out.append(("stream-query-user", "stream-query-user", {"request": {
        "groups": ["sg"], "name": "logs", "time_range": [T0, T0 + 50], "limit": 10,
    }}))
    out.append(("trace-query-by-id", "trace-query-by-id",
                {"group": "tg", "name": "spans", "trace_id": "t17"}))
    out.append(("property-query id", "property-query",
                {"group": "pg", "name": "node", "id": "n3"}))
    out.append(("property-query tags", "property-query",
                {"group": "pg", "name": "node", "tag_filters": {"role": "liaison"}}))
    out.append(("topn", "topn", {"group": "sw", "name": "top_eps",
                                 "time_range": [T0, T0 + 10 * 60_000], "n": 2}))
    out.append(("streamagg stats", "streamagg", {"op": "stats"}))
    return out


SCRIPT = (
    [("health", "health", {})]
    + _schema_envelopes()
    + [("list groups", "registry", {"op": "list", "kind": "group"}),
       ("list measures", "registry", {"op": "list", "kind": "measure", "group": "sw"})]
    + _write_envelopes()
    + [("snapshot", "snapshot", {})]
    + _query_envelopes()
    + [("qos", "qos", {}),
       ("slowlog", "slowlog", {}),
       ("metrics", "metrics", {}),
       ("diagnostics", "diagnostics", {}),
       ("pprof", "fodc-pprof", {"kinds": ["threads", "runtime"]})]
)
STEPS = [name for name, _t, _e in SCRIPT]


def _handle(srv, topic, env):
    # envelopes and replies cross JSON, as they would over the bus
    out = srv.bus.handle(topic, json.loads(json.dumps(env)))
    return json.loads(json.dumps(out))


def _flush_topn(srv):
    srv.measure.topn.flush_all_windows()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from banyandb_tpu.server import StandaloneServer as JServer
    from banyandb_tpu_torch.server import StandaloneServer as TServer

    jsrv = JServer(tmp_path_factory.mktemp("jax-srv"), port=0, slow_query_ms=0.0)
    tsrv = TServer(tmp_path_factory.mktemp("port-srv"), device="cpu", slow_query_ms=0.0)
    jsrv.start()
    tsrv.start()
    yield jsrv, tsrv
    tsrv.stop()
    jsrv.stop()


@pytest.fixture(scope="module")
def replies(servers):
    jsrv, tsrv = servers
    out = {}
    for name, topic, env in SCRIPT:
        if name == "topn":
            _flush_topn(jsrv)
            _flush_topn(tsrv)
        out[name] = (_handle(jsrv, topic, env), _handle(tsrv, topic, env))
    return out


# property revisions are stamped from the wall clock (a hybrid logical
# clock), so two servers never share them; their order is held instead
_CLOCKED = ("mod_revision", "create_revision")


def _strip(v):
    """Drop timings: every ``*_ms`` key and the clock-stamped revisions."""
    if isinstance(v, dict):
        return {
            k: _strip(x) for k, x in v.items()
            if not (k.endswith("_ms") or k in _CLOCKED)
        }
    if isinstance(v, list):
        return [_strip(x) for x in v]
    return v


def _integral(x) -> bool:
    return isinstance(x, (int, float)) and float(x).is_integer()


def _same_result(t, j):
    """reply["result"]: exact bytes except the sums/means of non-integer
    values (rtol 1e-5) and the in-band trace (its plan and span names)."""
    t, j = dict(t), dict(j)
    ttr, jtr = t.pop("trace", None), j.pop("trace", None)
    assert (ttr is None) == (jtr is None)
    if jtr is not None:
        # the port's executor builds no jit: its plan line says "fused"
        assert ttr["plan"] == jtr["plan"].replace("fused jit ", "fused ")
        assert "span_tree" in ttr and "span_tree" in jtr
    tv, jv = t.pop("values"), j.pop("values")
    assert json.dumps(_strip(t), sort_keys=True) == json.dumps(_strip(j), sort_keys=True)
    assert sorted(tv) == sorted(jv)
    for key, want in jv.items():
        got = tv[key]
        if key.startswith(("sum", "mean")) and not all(map(_integral, want)):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=key)
        else:
            assert json.dumps(got) == json.dumps(want), key


def _keys(v, depth=2):
    if isinstance(v, dict) and depth:
        return {k: _keys(x, depth - 1) for k, x in v.items()}
    return type(v).__name__


METRIC_NAMES = (
    "measure_write_points", "measure_query_ms", "write_ms", "rss_bytes",
    "serving_cache_hits", "serving_cache_misses", "device_cache_entries",
    "compile_cache_enabled", "compile_cache_entries", "precompile_recorded",
    "precompile_compiled", "precompile_errors", "autoreg_known_signatures",
)


def _metric_names(prom_mod, text) -> set:
    return {name for name, _labels, _v in prom_mod.parse_exposition(text)}


@pytest.mark.parametrize("step", STEPS)
def test_envelope_script_matches_jax(step, replies):
    j, t = replies[step]
    if step == "metrics":
        jn = _metric_names(jprom, j["prometheus"])
        tn = _metric_names(tprom, t["prometheus"])
        for want in METRIC_NAMES:
            hit = [n for n in jn if want in n]
            assert hit, want
            assert set(hit) <= tn, (want, set(hit) - tn)
        # the same parser reads both expositions the same way
        assert jprom.parse_exposition(t["prometheus"]) == tprom.parse_exposition(
            t["prometheus"]
        )
    elif step == "slowlog":
        je, te = j["entries"], t["entries"]
        assert len(te) == len(je) > 0
        assert [e["engine"] for e in te] == [e["engine"] for e in je]
        assert [sorted(e) for e in te] == [sorted(e) for e in je]
        assert all(e.get("span_tree") for e in te)
        assert sorted(t) == sorted(j)
    elif step in ("qos", "diagnostics", "pprof"):
        assert sorted(t) == sorted(j)
        if step == "qos":
            assert _keys(t["qos"], 1) == _keys(j["qos"], 1)
    elif step.startswith("property-apply"):
        assert sorted(t) == sorted(j) == sorted(_CLOCKED)
        assert 0 < t["create_revision"] <= t["mod_revision"]
        if step == "property-apply merge":
            # a merge keeps the first apply's create revision
            for srv_reply, first in ((t, replies["property-apply n3"][1]),
                                     (j, replies["property-apply n3"][0])):
                assert srv_reply["create_revision"] == first["create_revision"]
                assert srv_reply["mod_revision"] > first["mod_revision"]
    elif step == "snapshot":
        assert sorted(t) == sorted(j) == ["flushed", "root"]
    elif step == "streamagg stats":
        assert json.dumps(_strip(t), sort_keys=True) == json.dumps(
            _strip(j), sort_keys=True
        )
    elif "result" in j:
        _same_result(t["result"], j["result"])
        assert t.get("served") == j.get("served")
    else:
        assert json.dumps(_strip(t), sort_keys=True) == json.dumps(
            _strip(j), sort_keys=True
        )


def test_script_answers_are_not_empty(replies):
    """Guard against a vacuous match: the data reached every engine."""
    for name in ("bydbql aggregate", "bydbql stream", "bydbql trace", "bydbql property"):
        r = replies[name][1]["result"]
        assert r["groups"] or r["data_points"], name
    assert replies["trace-query-by-id"][1]["spans"]
    assert replies["topn"][1]["items"]
    assert sum(replies["bydbql aggregate"][1]["result"]["values"]["sum(calls)"]) > 0


def test_restart_over_same_root_is_byte_identical(tmp_path):
    from banyandb_tpu.server import StandaloneServer as JServer
    from banyandb_tpu_torch.server import StandaloneServer as TServer

    setup = _schema_envelopes() + _write_envelopes()[:3] + [("snapshot", "snapshot", {})]
    asks = [(k, QUERIES[k]) for k in ("aggregate", "topn", "percentile")]
    results = {}
    for label, make in (("jax", lambda r: JServer(r, port=0)),
                        ("port", lambda r: TServer(r, device="cpu"))):
        root = tmp_path / label
        srv = make(root)
        try:
            for _name, topic, env in setup:
                _handle(srv, topic, env)
            before = [_handle(srv, "bydbql", {"ql": ql})["result"] for _k, ql in asks]
        finally:
            srv.stop()
        srv = make(root)
        try:
            after = [_handle(srv, "bydbql", {"ql": ql})["result"] for _k, ql in asks]
        finally:
            srv.stop()
        assert json.dumps(after) == json.dumps(before), label
        results[label] = after
    for (k, _ql), t, j in zip(asks, results["port"], results["jax"]):
        _same_result(t, j)


def test_server_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    from banyandb_tpu_torch.server import StandaloneServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StandaloneServer(tmp_path / "a")
    srv = StandaloneServer(tmp_path / "b", device="cpu")
    try:
        assert srv.device == torch.device("cpu")
        assert srv.measure.device == srv.stream.device == srv.device
        from banyandb_tpu_torch.query.precompile import default_registry

        assert default_registry().device == srv.device
    finally:
        srv.stop()


@pytest.mark.parametrize("kw", [
    {"port": 0}, {"wire_port": 0}, {"http_port": 0},
    {"auth_file": "users.yaml", "wire_port": 0, "http_port": 0},
    {"workers": 1, "wire_port": 0},
], ids=["port", "wire_port", "http_port", "auth_file", "workers"])
def test_tiers_that_wait_raise(tmp_path, kw):
    """The tiers that once waited now start: the gRPC bus answers its
    address, the wire and HTTP tiers bind, one users file guards both,
    and with workers the wire tier rides the pool adapters (a wire write
    is journalled before it is forwarded; wire TopN scatters).  Stopping
    the server reaps every worker it spawned."""
    pytest.importorskip("grpc")
    from banyandb_tpu_torch.server import StandaloneServer
    from banyandb_tpu_torch.utils import procreg

    if "auth_file" in kw:
        from banyandb_tpu_torch.api.auth import write_users_file

        write_users_file(tmp_path / "users.yaml", {"admin": "pw"})
        kw = {**kw, "auth_file": str(tmp_path / "users.yaml")}
    before = procreg.snapshot()
    srv = StandaloneServer(tmp_path / "srv", device="cpu", **kw)
    srv.start()
    try:
        assert (srv.addr is not None) == ("port" in kw)
        if "port" in kw:
            from banyandb_tpu_torch.cluster.rpc import GrpcTransport

            t = GrpcTransport()
            try:
                assert t.call(srv.addr, "health", {})["status"] == "ok"
            finally:
                t.close()
        assert (srv.wire is not None) == ("wire_port" in kw)
        assert (srv.http is not None) == ("http_port" in kw)
        if srv.wire is not None:
            assert srv.wire.port > 0
            assert (srv.wire.auth is not None) == ("auth_file" in kw)
            if srv.pool is not None:
                assert srv._wire_services.measure is srv._pool_measure
                assert srv._wire_services.trace is srv._pool_trace
            else:
                assert srv._wire_services.measure is srv.measure
        if srv.http is not None and "auth_file" in kw:
            assert srv.http.auth is srv.wire.auth
    finally:
        srv.stop()
    assert procreg.snapshot() == before


def test_workers_env_and_command_line_raise(tmp_path, monkeypatch):
    """``BYDB_WORKERS`` sizes the worker pool (the multi-process data
    plane, tests/test_torch_workers.py); ``addr`` is None for a server
    that serves in-process only; ``build_config()`` reads the command's
    flags (with ``--device``, cuda by default); ``main()`` refuses the
    data and liaison roles, naming the ROADMAP.md item that brings
    them."""
    from banyandb_tpu_torch import server

    monkeypatch.setenv("BYDB_WORKERS", "1")
    srv = server.StandaloneServer(tmp_path / "w1", device="cpu")
    try:
        assert srv.pool is not None and srv.pool.n == 1
        assert srv.pool._clients[0].ready_info["device"] == "cpu"
    finally:
        srv.stop()
    monkeypatch.setenv("BYDB_WORKERS", "0")
    srv = server.StandaloneServer(tmp_path / "w0", device="cpu")
    try:
        assert srv.pool is None
        assert srv.addr is None and srv.grpc is None
    finally:
        srv.stop()
    s = server.build_config().load(["--root", str(tmp_path), "--wire-port", "-1"])
    assert (s.port, s.wire_port, s.http_port, s.device, s.role) == (
        17912, -1, 17913, "cuda", "standalone")
    for role in ("data", "liaison"):
        with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 7"):
            server.main(["--root", str(tmp_path / role), "--role", role, "--device", "cpu"])
        assert not (tmp_path / role).exists()
