"""The port's serving planes against the JAX package's, module by module.

Each block feeds the same input to a module of ``banyandb_tpu`` and its
copy in ``banyandb_tpu_torch`` and holds the outputs equal: the
slow-query recorder and signature table, the exposition parser (each
package's parser over both packages' expositions), access-log lines
(modulo their ``ts``), the ``_monitoring`` self-measure rows and the
self-trace span rows (read back through each package's engine, the
port's measure engine on ``device="cpu"``), the FODC flight recorder,
watchdog and pressure profiler, the pprof capture topic and the
profiling endpoints, and the property-backed schema plane (a schema
written by one package replays in the other; watch hub; events;
the barrier over the port's in-process liaison).  Everything here is
host code, so the bar is equality; only wall-clock stamps and
durations are left out.
"""

import json
import time
import urllib.request

import pytest

from banyandb_tpu import api as japi
from banyandb_tpu.admin import accesslog as jaccess
from banyandb_tpu.admin import fodc_agent as jfodc
from banyandb_tpu.admin import metrics as jmetrics
from banyandb_tpu.admin import profiling as jprof
from banyandb_tpu.cluster import schema_plane as jplane
from banyandb_tpu.obs import prom as jprom
from banyandb_tpu.obs import recorder as jrec
from banyandb_tpu.obs import selftrace as jself
from banyandb_tpu_torch import api as tapi
from banyandb_tpu_torch.admin import accesslog as taccess
from banyandb_tpu_torch.admin import fodc_agent as tfodc
from banyandb_tpu_torch.admin import metrics as tmetrics
from banyandb_tpu_torch.admin import profiling as tprof
from banyandb_tpu_torch.cluster import schema_plane as tplane
from banyandb_tpu_torch.obs import prom as tprom
from banyandb_tpu_torch.obs import recorder as trec
from banyandb_tpu_torch.obs import selftrace as tself

T0 = 1_700_000_000_000

TREE = {
    "name": "standalone:measure", "duration_ms": 12.5, "tags": {},
    "children": [
        {"name": "qos", "duration_ms": 0.01, "tags": {"tenant": "default"},
         "children": []},
        {"name": "execute", "duration_ms": 11.0, "tags": {},
         "children": [{"name": "reduce", "duration_ms": 4.25,
                       "tags": {"partials_cache": "miss"}, "children": []}]},
    ],
}


def _feed_meter(meter):
    meter.counter_add("measure_write_points", 1200, {"group": "sw"})
    meter.counter_add("rpc_calls", 3)
    meter.gauge_set("rss_bytes", 123456.0)
    meter.gauge_set("serving_cache_hits", 7.0, {"tenant": "acme"})
    for v in (0.5, 1.0, 2.0, 3.0, 100.0, 250.0):
        meter.observe("measure_query_ms", v)
        meter.observe("query_stage_ms", v / 2, {"stage": "gather"})
        meter.observe("query_stage_ms", v / 4, {"stage": "reduce"})


def _meters():
    j, t = jmetrics.Meter("banyandb"), tmetrics.Meter("banyandb")
    _feed_meter(j)
    _feed_meter(t)
    return j, t


# -- obs/recorder ---------------------------------------------------------------


def _drive_recorder(rec_mod):
    rec = rec_mod.SlowQueryRecorder(capacity=3)
    kept = [
        rec_mod.record_slow_query(
            rec, 10.0, engine="measure", group=f"acme.g{i}", name="m",
            duration_ms=5.0 + 4 * i, rows=i, span_tree=TREE, ql=f"q{i}",
            plan_fn=lambda i=i: f"plan {i}",
        )
        for i in range(6)
    ]
    reply = rec_mod.slowlog_topic_reply(rec, {"limit": 2}, 10.0)
    cleared = rec_mod.slowlog_topic_reply(rec, {"clear": True}, 10.0)
    stats = rec_mod.SignatureStats(cap=2)
    for key, w in ((("g", "m", ("svc",)), 1), (("g", "m", ("svc",)), 2),
                   (("g", "n", ()), 1), (None, 5), (("g", "o", ()), 1)):
        stats.observe(key, weight=w)
    return kept, reply, cleared, stats.snapshot(), len(stats)


def _no_ts(v):
    if isinstance(v, dict):
        return {k: _no_ts(x) for k, x in v.items() if k not in ("ts", "ts_millis")}
    if isinstance(v, list):
        return [_no_ts(x) for x in v]
    return v


def test_recorder_matches_jax():
    j, t = _drive_recorder(jrec), _drive_recorder(trec)
    assert j[0] == t[0] == [False, False, True, True, True, True]
    assert _no_ts(t[1]) == _no_ts(j[1])
    assert [e["plan"] for e in t[1]["entries"]] == ["plan 5", "plan 4"]
    assert t[2] == j[2] == {"cleared": 3, "entries": []}
    assert t[3:] == j[3:]


# -- obs/prom -------------------------------------------------------------------


@pytest.mark.parametrize("parser", [jprom, tprom], ids=["jax_parser", "port_parser"])
def test_prom_parses_both_expositions_alike(parser):
    jm, tm = _meters()
    jtext, ttext = jm.prometheus_text(), tm.prometheus_text()
    assert ttext == jtext
    assert parser.parse_exposition(ttext) == jprom.parse_exposition(jtext)
    assert parser.histogram_series(ttext, "banyandb_query_stage_ms") == (
        jprom.histogram_series(jtext, "banyandb_query_stage_ms")
    )
    assert parser.stage_breakdown(ttext) == jprom.stage_breakdown(jtext)
    assert parser.gauge_value(ttext, "banyandb_serving_cache_hits", {"tenant": "acme"}) == 7.0
    before = tm.prometheus_text()
    tm.observe("query_stage_ms", 1000.0, {"stage": "gather"})
    jm.observe("query_stage_ms", 1000.0, {"stage": "gather"})
    assert parser.stage_breakdown_delta(before, tm.prometheus_text()) == (
        jprom.stage_breakdown_delta(before, jm.prometheus_text())
    )


# -- admin/accesslog ------------------------------------------------------------


def _access_lines(mod, path):
    log = mod.AccessLog(path, slow_query_ms=10.0)
    log.log_write("sw", "srt", 65536, 3.5)
    log.log_write("acme.sw", "srt", 10, 0.25, tenant="acme")
    log.log_query("sw", "srt", 4.0, ql="SELECT 1", rows=3)
    log.log_query("acme.sw", "srt", 40.0, rows=0)
    log.close()
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_accesslog_lines_match_jax(tmp_path):
    j = _access_lines(jaccess, tmp_path / "j.log")
    t = _access_lines(taccess, tmp_path / "t.log")
    assert len(t) == 4
    assert all("ts" in r for r in t)
    assert _no_ts(t) == _no_ts(j)


# -- admin/metrics: the _monitoring self-measures --------------------------------


def _self_measure_rows(api, metrics_mod, engine_cls, root, **kw):
    reg = api.SchemaRegistry(root)
    eng = engine_cls(reg, root / "data", **kw)
    try:
        meter = metrics_mod.Meter()
        _feed_meter(meter)
        sink = metrics_mod.SelfMeasureSink(meter, eng, interval_s=3600)
        n = sink.flush(now_millis=T0)
        eng.flush()
        res = eng.query(api.QueryRequest(
            ("_monitoring",), "instruments", api.TimeRange(T0, T0 + 1), limit=100))
        return n, sorted(
            (dp["tags"]["name"], dp["tags"]["kind"], dp["fields"]["value"])
            for dp in res.data_points
        )
    finally:
        eng.close()


def test_self_measure_rows_match_jax(tmp_path):
    from banyandb_tpu.models.measure import MeasureEngine as JEngine
    from banyandb_tpu_torch.models.measure import MeasureEngine as TEngine

    j = _self_measure_rows(japi, jmetrics, JEngine, tmp_path / "j")
    t = _self_measure_rows(tapi, tmetrics, TEngine, tmp_path / "t", device="cpu")
    # 2 counters + 2 gauges + 3 histograms x (count, sum, p50, p99)
    assert t[0] == j[0] == 16
    assert t == j


# -- obs/selftrace: the _monitoring.self_query span rows --------------------------


def _self_trace_rows(api, self_mod, trace_mod, root):
    reg = api.SchemaRegistry(root)
    eng = trace_mod.TraceEngine(reg, root / "data")
    try:
        sink = self_mod.SelfTraceSink(eng, reg, node="standalone")
        offered = [
            sink.offer(engine="measure", group="sw", name="srt", duration_ms=12.5,
                       tree=TREE, ql="SELECT ...", query_id=f"q{i}")
            for i in range(2)
        ]
        wrote = sink.flush()
        eng.flush()
        rows = []
        for qid in ("q0", "q1"):
            for sp in eng.query_by_trace_id("_monitoring", "self_query", qid):
                tags = dict(sp["tags"])
                rows.append(tuple(sorted(tags.items())))
        return offered, wrote, sorted(rows)
    finally:
        eng.close()


def test_self_trace_rows_match_jax(tmp_path, monkeypatch):
    from banyandb_tpu.models import trace as jtrace
    from banyandb_tpu_torch.models import trace as ttrace

    monkeypatch.setenv("BYDB_SELF_TRACE", "1")
    monkeypatch.setenv("BYDB_SELF_TRACE_MS", "0")
    j = _self_trace_rows(japi, jself, jtrace, tmp_path / "j")
    t = _self_trace_rows(tapi, tself, ttrace, tmp_path / "t")
    assert t[:2] == j[:2] == ([True, True], 8)
    assert t == j
    stages = {dict(r)["stage"] for r in t[2]}
    assert stages == {"standalone:measure", "qos", "execute", "reduce"}


# -- admin/fodc_agent ---------------------------------------------------------


def _fodc_cycles(mod):
    fr = mod.FlightRecorder(window_s=1e9, max_cycles=3)
    fails = {"n": 0}

    def flaky():
        fails["n"] += 1
        if fails["n"] < 3:
            raise RuntimeError("scrape failed")
        return [mod.RawMetric("up", (), float(fails["n"]), mod.GAUGE)]

    wd = mod.Watchdog(fr, [flaky], node_role="data")
    wd.INITIAL_BACKOFF_S = 0.001
    cycles = [wd.poll_once() for _ in range(4)]
    state = {"role": "liaison"}
    wd2 = mod.Watchdog(mod.FlightRecorder(), [lambda: [mod.RawMetric("x", (), 1.0)]],
                       node_role="")
    wd2.set_node_info_provider(lambda: (state["role"], {"zone": "a"}))
    c1 = wd2.poll_once()
    state["role"] = "unspecified"
    c2 = wd2.poll_once()
    window = fr.window(0, time.time() + 1)
    return (
        fails["n"],
        [[(m.name, m.labels, m.value, m.type) for m in c] for c in cycles],
        len(window), [(m.name, m.value) for m in fr.latest()],
        [(m.name, m.labels) for m in c1 + c2],
    )


def test_flight_recorder_and_watchdog_match_jax():
    j, t = _fodc_cycles(jfodc), _fodc_cycles(tfodc)
    assert t == j
    assert t[0] == 6 and t[2] == 3  # two retries, then one call a cycle; ring of 3


def test_meter_source_matches_jax():
    jm, tm = _meters()
    key = lambda ms: sorted((m.name, m.labels, m.value, m.type) for m in ms)  # noqa: E731
    assert key(tfodc.meter_source(tm)()) == key(jfodc.meter_source(jm)())
    assert {m.name for m in tfodc.process_source()} == {
        m.name for m in jfodc.process_source()
    }


def test_pressure_profiler_capture_matches_jax(tmp_path):
    out = {}
    for label, mod in (("jax", jfodc), ("port", tfodc)):
        pp = mod.PressureProfiler(tmp_path / label, limit_bytes=1000, trigger_percent=75,
                                  min_interval_s=0.0, max_events=2)
        got = [pp.maybe_capture(700) is None, pp.maybe_capture(800) is not None]
        rec = pp.list_records()[0]
        assert b"thread" in pp.read_profile(rec["profile_id"], "threads")
        with pytest.raises(PermissionError):
            pp.read_profile("../..", "threads")
        pp.maybe_capture(900)
        pp.maybe_capture(950)
        out[label] = (got, sorted(rec), rec["rss_bytes"], rec["threshold_bytes"],
                      sorted(p["type"] for p in rec["profiles"]),
                      len(pp.list_records()), pp.captured)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [True, True] and out["port"][5] == 2


def test_pressure_profiler_rides_the_watchdog(tmp_path):
    pp = tfodc.PressureProfiler(tmp_path, limit_bytes=100, trigger_percent=1,
                                min_interval_s=0.0)
    wd = tfodc.Watchdog(tfodc.FlightRecorder(), [tfodc.process_source], node_role="data")
    wd.add_post_poll_hook(pp.hook)
    wd.poll_once()
    assert pp.captured == 1 and len(pp.list_records()) == 1


# -- pprof capture and the profiling endpoints -----------------------------------


def test_pprof_capture_handler_matches_jax():
    env = {"kinds": ["threads", "runtime", "cpu"], "seconds": 0.05}
    j, t = jfodc.pprof_capture_handler(env), tfodc.pprof_capture_handler(env)
    assert t.keys() == j.keys()
    assert t["profiles"].keys() == j["profiles"].keys() == {"threads", "runtime", "cpu"}
    assert "samples over" in t["profiles"]["cpu"]
    assert "rss_bytes" in t["profiles"]["runtime"]
    assert tfodc.PPROF_TOPIC == jfodc.PPROF_TOPIC


@pytest.mark.parametrize("path", ["/debug/threads", "/debug/vars", "/debug/nope"])
def test_profiling_server_on_port_zero(path):
    out = {}
    for label, mod in (("jax", jprof), ("port", tprof)):
        srv = mod.ProfilingServer(port=0)
        srv.start()
        try:
            url = f"http://127.0.0.1:{srv.port}{path}"
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    out[label] = (r.status, r.read().decode()[:20] != "")
            except urllib.error.HTTPError as e:
                out[label] = (e.code, False)
        finally:
            srv.stop()
    assert out["port"] == out["jax"]


# -- cluster/schema_plane -------------------------------------------------------


def _schema_objs(api):
    return (
        api.Group("pg", api.Catalog.MEASURE, api.ResourceOpts(shard_num=2)),
        api.Measure(group="pg", name="m", tags=(api.TagSpec("svc", api.TagType.STRING),),
                    fields=(api.FieldSpec("lat", api.FieldType.FLOAT),),
                    entity=api.Entity(("svc",))),
    )


def _write_schema(api, plane, root):
    from importlib import import_module

    prop_mod = import_module(api.__name__.rsplit(".", 1)[0] + ".models.property")
    reg = api.SchemaRegistry(None)
    prop = prop_mod.PropertyEngine(reg, root)
    store = plane.PropertySchemaStore(reg, prop)
    group, measure = _schema_objs(api)
    reg.create_group(group)
    reg.create_measure(measure)
    reg.create_measure(measure.__class__(**{**measure.__dict__, "name": "m2"}))
    reg.delete_measure("pg", "m2")
    events = store.replay_events()
    prop.close()
    return events


def _replay_schema(api, plane, root):
    from importlib import import_module

    prop_mod = import_module(api.__name__.rsplit(".", 1)[0] + ".models.property")
    reg = api.SchemaRegistry(None)
    prop = prop_mod.PropertyEngine(reg, root)
    plane.PropertySchemaStore(reg, prop)
    try:
        got = (reg.get_group("pg").resource_opts.shard_num,
               [t.name for t in reg.get_measure("pg", "m").tags])
        with pytest.raises(KeyError):
            reg.get_measure("pg", "m2")
        return got, reg.digests()
    finally:
        prop.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_property_schema_replays_across_packages(tmp_path, writer):
    pkgs = {"jax": (japi, jplane), "port": (tapi, tplane)}
    reader = "port" if writer == "jax" else "jax"
    events = _write_schema(*pkgs[writer], tmp_path)
    got, digests = _replay_schema(*pkgs[reader], tmp_path)
    assert got == (2, ["svc"])
    # the replay stream of one package applies to the other's registry
    reg = pkgs[reader][0].SchemaRegistry(None)
    for ev in events:
        pkgs[reader][1].apply_event(reg, ev)
    assert reg.digests() == digests
    assert events[-1] == {"type": tplane.EVENT_REPLAY_DONE}


def test_apply_event_and_watch_hub_match_jax():
    out = {}
    for label, (api, plane) in (("jax", (japi, jplane)), ("port", (tapi, tplane))):
        hub = plane.WatchHub()
        sid, q = hub.subscribe()
        sid2, q2 = hub.subscribe()
        for i in range(plane._QUEUE_SIZE + 1):
            hub.broadcast({"i": i})
            if i < plane._QUEUE_SIZE:
                q2.get_nowait()  # keeps up
        reg = api.SchemaRegistry(None)
        group, measure = _schema_objs(api)
        payload = json.dumps(api.schema._to_jsonable(group), sort_keys=True)
        plane.apply_event(reg, {"type": plane.EVENT_INSERT, "kind": "group",
                                "key": "pg", "payload": payload})
        plane.apply_event(reg, {"type": plane.EVENT_DELETE, "kind": "group",
                                "key": "pg", "payload": ""})
        plane.apply_event(reg, {"type": plane.EVENT_UPDATE, "kind": "nope",
                                "key": "x", "payload": "{}"})
        out[label] = (hub.is_dead(sid), hub.is_dead(sid2), q.qsize(),
                      [g.name for g in reg.list_groups()])
        hub.unsubscribe(sid)
    assert out["port"] == out["jax"] == (True, False, tplane._QUEUE_SIZE, [])
    assert tplane._BARRIER_KINDS == __import__(
        "banyandb_tpu.api.grpc_server", fromlist=["_BARRIER_KINDS"])._BARRIER_KINDS


def test_liaison_barrier_over_the_port_liaison(tmp_path):
    from banyandb_tpu_torch.cluster.data_node import DataNode
    from banyandb_tpu_torch.cluster.liaison import Liaison
    from banyandb_tpu_torch.cluster.node import NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport

    transport = LocalTransport()
    nodes, infos = [], []
    for i in range(2):
        dn = DataNode(f"dn{i}", tapi.SchemaRegistry(tmp_path / f"n{i}/schema"),
                      tmp_path / f"n{i}/data", device="cpu")
        nodes.append(dn)
        infos.append(NodeInfo(f"dn{i}", transport.register(f"dn{i}", dn.bus)))
    lreg = tapi.SchemaRegistry(tmp_path / "l/schema")
    liaison = Liaison(lreg, transport, infos)
    try:
        liaison.probe()
        barrier = tplane.LiaisonBarrier(liaison)
        lreg.create_group(tapi.Group("cg", tapi.Catalog.MEASURE,
                                     tapi.ResourceOpts(shard_num=1)))
        applied, laggards = barrier.await_applied([("group", "", "cg")], [0], 0.3)
        assert not applied
        assert {lag["node"] for lag in laggards} == {"dn0", "dn1"}
        liaison.sync_schema("group", lreg.get_group("cg"))
        applied, laggards = barrier.await_applied([("group", "", "cg")], [0], 5)
        assert applied, laggards
        assert barrier.await_revision(1, 5)[0]
        assert not barrier.await_revision(lreg.revision + 10, 0.2)[0]
        applied, laggards = barrier.await_deleted([("group", "", "cg")], 0.3)
        assert not applied
        with pytest.raises(ValueError):
            barrier.await_applied([("nope", "", "cg")], [0], 0.1)
    finally:
        for dn in nodes:
            dn.measure.close()
            dn.stream.close()
            dn.trace.close()
