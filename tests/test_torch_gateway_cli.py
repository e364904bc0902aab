"""The port's HTTP gateway, command line, server command and platform
plumbing against the JAX package's.

Gateway routes go to a JAX and a port ``HttpGateway`` (each over its
package's wire services; the port's engines on ``device="cpu"``) and
must answer the same status and JSON.  CLI and bus-topic tests run
against one JAX and one port ``StandaloneServer`` (gRPC bus on port 0):
each command runs through the JAX CLI against the JAX server and
through the port's CLI against the port's server, and the two outputs
must be the same JSON once timings (``*_ms`` keys) and clock-stamped
revisions are dropped.  The JAX test bodies replayed here
(``tests/test_http_gateway.py``, ``tests/test_server_ql.py``,
``tests/test_platform.py``) then hold the port's answers to their own
assertions.  Cross-package cases drive each package's client against
the other's server and a JAX-written root from the port's server, and
boot ``python -m banyandb_tpu_torch.server`` in a subprocess.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

import test_http_gateway as hg  # noqa: E402
import test_platform as tp  # noqa: E402
import test_server_ql as sq  # noqa: E402
from test_torch_wire import Dual, _engines, _pkg  # noqa: E402

# both CLIs bind their GrpcTransport at import: import them before any
# test patches the JAX transport (see dual_server)
from banyandb_tpu import cli as jcli  # noqa: E402
from banyandb_tpu.cluster.rpc import GrpcTransport as _JTransport  # noqa: E402
from banyandb_tpu_torch import cli as tcli  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
T0 = 1_700_000_000_000
PKGS = ("banyandb_tpu", "banyandb_tpu_torch")

# property and registry revisions stamped from the wall clock
_CLOCKED = ("mod_revision", "create_revision")


def _strip(v):
    """Drop timings: every ``*_ms`` key and the clock-stamped revisions."""
    if isinstance(v, dict):
        return {k: _strip(x) for k, x in v.items()
                if not (k.endswith("_ms") or k in _CLOCKED)}
    if isinstance(v, list):
        return [_strip(x) for x in v]
    return v


def same_json(j, t, what="", roots=("", "")):
    """The same JSON after _strip, each server's own root directory (a
    snapshot names it) read as ``<root>``."""
    a = json.dumps(_strip(j), sort_keys=True)
    b = json.dumps(_strip(t), sort_keys=True)
    if roots[0]:
        a, b = a.replace(roots[0], "<root>"), b.replace(roots[1], "<root>")
    assert a == b, f"{what}\nJAX:  {a}\nport: {b}"


# -- HTTP gateway ------------------------------------------------------------

_http_call = hg._call  # one gateway; the replayed bodies get _dual_call


class DualGateway:
    """One JAX and one port HttpGateway over fresh engines."""

    def __init__(self, tmp_path, **kw):
        self.gws, self.parts = {}, {}
        for pkg in PKGS:
            e = _engines(pkg, tmp_path / pkg, full=False)
            svcs = _pkg(f"{pkg}.api.grpc_server").WireServices(
                e["registry"], e["measure"], e["stream"])
            self.gws[pkg] = _pkg(f"{pkg}.api.http_gateway").HttpGateway(
                svcs, port=0, **kw).start()
            self.parts[pkg] = e

    def stop(self):
        for pkg, g in self.gws.items():
            g.stop()
            self.parts[pkg]["measure"].close()
            self.parts[pkg]["stream"].close()


def _dual_call(dgw, method, path, payload=None):
    """tests/test_http_gateway.py's ``_call`` against both gateways: the
    same status and JSON, then the port's."""
    outs = [_http_call(g, method, path, payload) for g in dgw.gws.values()]
    (sj, bj), (st, bt) = outs
    assert sj == st, (method, path, sj, st)
    same_json(bj, bt, f"{method} {path}")
    return st, bt


@pytest.fixture()
def dual_gw(tmp_path, monkeypatch):
    monkeypatch.setattr(hg, "_call", _dual_call)
    d = DualGateway(tmp_path)
    yield d, Dual(d.parts["banyandb_tpu"]["measure"], d.parts["banyandb_tpu_torch"]["measure"])
    d.stop()


@pytest.mark.parametrize("name", [
    "test_gateway_schema_and_query", "test_gateway_errors", "test_gateway_round3_routes",
])
def test_gateway_routes_over_both(name, dual_gw):
    """tests/test_http_gateway.py, each route to both gateways."""
    getattr(hg, name)(dual_gw)


# -- CLI and bus topics on a standalone pair ---------------------------------


def _cli_out(cli_mod, addr, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_mod.main(["--addr", addr, *argv])
    return rc, buf.getvalue()


class DualServer:
    """One JAX and one port StandaloneServer (gRPC bus on port 0).  Its
    ``registry`` and ``measure`` are Duals; ``addr`` names the pair for
    ``DualTransport``."""

    addr = "dual-pair"

    def __init__(self, root, **kw):
        from banyandb_tpu.server import StandaloneServer as JServer
        from banyandb_tpu_torch.server import StandaloneServer as TServer

        self.jax = JServer(root / "jax", port=0, **kw)
        self.port = TServer(root / "port", port=0, device="cpu", **kw)
        self.jax.start()
        self.port.start()
        self.roots = (str(self.jax.root), str(self.port.root))
        self.registry = Dual(self.jax.registry, self.port.registry)
        self.measure = Dual(self.jax.measure, self.port.measure)

    def stop(self):
        self.port.stop()
        self.jax.stop()


def _dual_cli(server, *argv):
    """tests/test_server_ql.py's ``_cli``: the JAX CLI against the JAX
    server and the port's CLI against the port's, the same JSON out."""

    rj, oj = _cli_out(jcli, server.jax.addr, argv)
    rt, ot = _cli_out(tcli, server.port.addr, argv)
    assert rj == rt == 0, (argv, rj, rt)
    same_json(json.loads(oj), json.loads(ot), " ".join(argv), server.roots)
    return json.loads(ot)


class DualTransport:
    """Stands in for the JAX ``GrpcTransport`` inside replayed test bodies:
    a call to ``DualServer.addr`` goes through the JAX transport to the
    JAX server and through the port's to the port's, and must answer
    the same JSON."""

    server: DualServer = None

    def __init__(self, **kw):
        from banyandb_tpu_torch.cluster.rpc import GrpcTransport as TTransport

        self._j, self._t = _JTransport(**kw), TTransport(**kw)

    def call(self, addr, topic, envelope, timeout=30.0):
        assert addr == DualServer.addr, addr
        srv = DualTransport.server
        rj = self._j.call(srv.jax.addr, topic, envelope, timeout=timeout)
        rt = self._t.call(srv.port.addr, topic, envelope, timeout=timeout)
        same_json(rj, rt, topic, srv.roots)
        return rt

    def close(self):
        self._j.close()
        self._t.close()


@pytest.fixture(scope="module")
def pair_server(tmp_path_factory):
    srv = DualServer(tmp_path_factory.mktemp("cli-pair"))
    yield srv
    srv.stop()


@pytest.fixture()
def dual_server(pair_server, monkeypatch):
    import banyandb_tpu.cluster.rpc as jrpc

    monkeypatch.setattr(sq, "_cli", _dual_cli)
    monkeypatch.setattr(jrpc, "GrpcTransport", DualTransport)
    monkeypatch.setattr(DualTransport, "server", pair_server)
    return pair_server


@pytest.mark.parametrize("name", [
    "test_server_cli_end_to_end", "test_server_topn_topic", "test_server_stream_and_trace_topics",
])
def test_server_cli_and_topics_over_both(name, dual_server):
    """tests/test_server_ql.py's CLI, TopN and stream/trace topic tests:
    every CLI command and transport call to both servers."""
    getattr(sq, name)(dual_server)


def _seed_measure(registry, measure, api):
    registry.create_group(api.Group("g", api.Catalog.MEASURE, api.ResourceOpts(shard_num=1)))
    registry.create_measure(api.Measure(
        "g", "m", (api.TagSpec("svc", api.TagType.STRING),),
        (api.FieldSpec("v", api.FieldType.INT),), api.Entity(("svc",))))
    measure.write(api.WriteRequest("g", "m", tuple(
        api.DataPointValue(T0 + i, {"svc": f"s{i % 3}"}, {"v": i}, version=1)
        for i in range(50))))


def test_slow_query_reaches_flight_recorder_and_cli(tmp_path):
    """tests/test_obs.py's slowlog over the CLI: with a 0 ms threshold a
    query's record (its QL, plan and span tree) reaches each server's
    flight recorder and each package's ``cli slowlog``; ``--clear``
    drains the ring.  Both servers list the same QL and threshold."""
    from banyandb_tpu import api as japi
    from banyandb_tpu_torch.obs.tracer import find_span

    srv = DualServer(tmp_path, slow_query_ms=0.0)
    try:
        _seed_measure(srv.registry, srv.measure, japi)
        ql = f"SELECT sum(v) FROM MEASURE m IN g TIME BETWEEN {T0} AND {T0 + 100} GROUP BY svc"
        for s in (srv.jax, srv.port):
            s.bus.handle("bydbql", {"ql": ql})
        entries = srv.port.bus.handle("slowlog", {})["entries"]
        assert entries and entries[0]["ql"] == ql and entries[0]["duration_ms"] > 0
        tree = entries[0]["span_tree"]
        assert tree["name"] == "standalone:measure"
        assert find_span(tree, "part_gather") is not None
        assert find_span(tree, "reduce") is not None
        assert "GroupByAggregate" in (entries[0]["plan"] or "")
        outs = {}
        for mod, s in ((jcli, srv.jax), (tcli, srv.port)):
            rc, out = _cli_out(mod, s.addr, ["slowlog", "--limit", "5"])
            assert rc == 0
            outs[mod.__name__] = json.loads(out)
        for out in outs.values():
            assert out["entries"][0]["ql"] == ql
            assert out["threshold_ms"] == 0.0
        assert [e["ql"] for e in outs["banyandb_tpu.cli"]["entries"]] == \
            [e["ql"] for e in outs["banyandb_tpu_torch.cli"]["entries"]]
        assert _cli_out(tcli, srv.port.addr, ["slowlog", "--clear"])[0] == 0
        assert srv.port.bus.handle("slowlog", {})["entries"] == []
    finally:
        srv.stop()


# -- cli dump ----------------------------------------------------------------


def _dump(cli_mod, argv, capsys):
    rc = cli_mod.main(argv)
    return rc, capsys.readouterr().out


def test_dump_sidx_part(tmp_path, capsys):
    """``cli dump sidx`` on a part the port's SidxStore wrote: the port's
    CLI and the JAX CLI print the same document, and an sidx part is
    refused as a measure part by both."""
    from banyandb_tpu_torch.index.sidx import SidxStore, encode_ref

    store = SidxStore(tmp_path / "sidx")
    for i in range(40):
        store.insert(i, encode_ref(f"trace-{i}", T0 + i))
    part_dir = tmp_path / "sidx" / store.flush()
    (rj, oj), (rt, ot) = (_dump(m, ["dump", "sidx", str(part_dir)], capsys) for m in (jcli, tcli))
    assert rj in (0, None) and rt in (0, None)
    doc = json.loads(ot)
    assert doc == json.loads(oj)
    assert doc["meta"]["sidx"] is True
    assert sum(b["count"] for b in doc["blocks"]) == 40
    assert tcli.main(["dump", "measure", str(part_dir)]) == 2
    assert jcli.main(["dump", "measure", str(part_dir)]) == 2


def test_dump_property_shard_index(tmp_path, capsys):
    """``cli dump property`` on a shard index the port's PropertyEngine
    wrote: the same document from both CLIs; a non-index directory is
    refused with 2 by both."""
    from banyandb_tpu_torch import api
    from banyandb_tpu_torch.models.property import Property, PropertyEngine

    reg = api.SchemaRegistry(tmp_path)
    reg.create_group(api.Group("pg", api.Catalog.MEASURE, api.ResourceOpts(shard_num=1)))
    eng = PropertyEngine(reg, tmp_path / "data")
    for i in range(12):
        eng.apply(Property(group="pg", name="settings", id=f"p{i}", tags={"k": f"v{i}"}))
    eng.persist()
    eng.close()
    idx_dir = tmp_path / "data" / "property" / "pg" / "shard-0.idx"
    (rj, oj), (rt, ot) = (_dump(m, ["dump", "property", str(idx_dir)], capsys) for m in (jcli, tcli))
    assert rj in (0, None) and rt in (0, None)
    doc = json.loads(ot)
    assert doc == json.loads(oj)
    assert doc["docs"] == 12 and doc["alive"] == 12 and doc["segments"]
    assert "k" in doc["segments"][0]["keyword_fields"]
    assert tcli.main(["dump", "property", str(tmp_path)]) == 2
    assert jcli.main(["dump", "property", str(tmp_path)]) == 2


# -- platform: config, run group, console, supervisor ------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_config_resolution_order(pkg, tmp_path, monkeypatch):
    """tests/test_platform.py's flag order (CLI > BYDB_* env > --config
    file > default) on each package's ``Config``."""
    monkeypatch.setattr(tp, "Config", _pkg(f"{pkg}.config").Config)
    tp.test_config_resolution_order(tmp_path, monkeypatch)


@pytest.mark.parametrize("pkg", PKGS)
def test_run_group_phases_and_unwind(pkg, monkeypatch):
    """tests/test_platform.py's run-group phases and unwind on each
    package's ``Group``/``FuncUnit``."""
    run = _pkg(f"{pkg}.run")
    monkeypatch.setattr(tp, "Group", run.Group)
    monkeypatch.setattr(tp, "FuncUnit", run.FuncUnit)
    tp.test_run_group_phases_and_unwind()


def test_console_served_and_no_thread_leaks(tmp_path):
    """The port's standalone server with every tier (bus, wire, HTTP,
    pprof) serves the console page as the JAX server does, and a start
    and stop leaves no non-daemon thread behind."""
    from banyandb_tpu.server import StandaloneServer as JServer
    from banyandb_tpu_torch.server import StandaloneServer as TServer

    before = {t.ident for t in threading.enumerate() if not t.daemon}
    heads = {}
    for name, make in (("jax", lambda: JServer(tmp_path / "j", port=0, wire_port=0, http_port=0,
                                                pprof_port=0)),
                       ("port", lambda: TServer(tmp_path / "t", port=0, wire_port=0, http_port=0,
                                                pprof_port=0, device="cpu"))):
        srv = make()
        srv.start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.http.port}/console") as r:
                body = r.read().decode()
                heads[name] = (r.status, r.headers["Content-Type"])
            assert "BydbQL workspace" in body and "BanyanDB-TPU" in body
        finally:
            srv.stop()
    assert heads["jax"] == heads["port"] == (200, "text/html; charset=utf-8")
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if {t.ident for t in threading.enumerate() if not t.daemon} <= before:
            break
        time.sleep(0.05)
    leaked = [t.name for t in threading.enumerate() if not t.daemon and t.ident not in before]
    assert not leaked, f"non-daemon threads leaked: {leaked}"


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("pkg", PKGS)
def test_supervisor_captures_thread_crash(pkg, tmp_path):
    """An uncaught exception on a thread writes a crash artifact and
    stops the run group once, in each package's ``Supervisor``."""
    Supervisor = _pkg(f"{pkg}.admin.supervisor").Supervisor
    stops = []
    sup = Supervisor(tmp_path, on_crash=lambda: stops.append(1)).install()
    try:
        t = threading.Thread(target=lambda: (_ for _ in ()).throw(RuntimeError("boom")),
                             name="crasher")
        t.start()
        t.join()
        deadline = time.monotonic() + 3
        while time.monotonic() < deadline and sup.crashes == 0:
            time.sleep(0.02)
        assert sup.crashes == 1 and stops == [1]
        assert list((tmp_path / "crash").glob("*")) or list(tmp_path.rglob("crash*"))
    finally:
        sup.uninstall()


# -- across packages ---------------------------------------------------------

_SCRIPT = [
    ["health"],
    ["group", "create", "xg", "--shards", "2"],
    ["measure", "create", "xg", "cpm", "--tags", "svc:string,region:string",
     "--fields", "value:float", "--entity", "svc"],
    ["write", "xg", "cpm", *sum((["--point", json.dumps(
        {"ts": T0 + i, "tags": {"svc": f"s{i % 3}", "region": f"r{i % 2}"},
         "fields": {"value": i}, "version": 1})] for i in range(24)), [])],
    ["query", f"SELECT sum(value) FROM MEASURE cpm IN xg TIME > {T0 - 1} "
              f"AND TIME < {T0 + 100} WHERE region != 'r1' GROUP BY svc"],
    ["measure", "list", "xg"],
]


def test_each_client_against_the_other_servers(tmp_path):
    """The JAX CLI (over the JAX GrpcTransport) drives the port's server
    and the port's CLI drives the JAX server through one command script;
    every command answers the same JSON.  The two transports then ask
    one topic of the other package's server directly."""
    from banyandb_tpu_torch.cluster.rpc import GrpcTransport as TTransport

    srv = DualServer(tmp_path)
    try:
        for argv in _SCRIPT:
            rj, oj = _cli_out(jcli, srv.port.addr, argv)
            rt, ot = _cli_out(tcli, srv.jax.addr, argv)
            assert rj == rt == 0, argv
            same_json(json.loads(oj), json.loads(ot), " ".join(argv[:2]), srv.roots[::-1])
        ql = {"ql": _SCRIPT[4][1]}
        tj, tt = _JTransport(), TTransport()
        try:
            same_json(tj.call(srv.port.addr, "bydbql", ql), tt.call(srv.jax.addr, "bydbql", ql))
            got = tj.call(srv.port.addr, "bydbql", ql)["result"]
        finally:
            tj.close(), tt.close()
        sums = dict(zip((g[0] for g in got["groups"]), got["values"]["sum(value)"]))
        assert sums == {f"s{s}": float(sum(i for i in range(24) if i % 3 == s and i % 2 == 0))
                        for s in range(3)}
    finally:
        srv.stop()


def _wire_seed_and_query(addr, seed_data: bool):
    """Over the reference-proto wire: (optionally) a group, a measure and
    96 seeded points through MeasureService/Write, then one aggregate
    query.  -> the QueryResponse."""
    import test_wire_api as wa
    from banyandb_tpu_torch.api import pb

    chan = grpc.insecure_channel(addr)
    try:
        if seed_data:
            wa._create_group(chan)
            wa._create_measure(chan)
            rng = np.random.default_rng(3)
            vals = rng.integers(1, 50, 96)

            def gen():
                for i in range(96):
                    w = pb.measure_write_pb2.WriteRequest()
                    w.metadata.group, w.metadata.name = "wg", "cpm"
                    w.message_id = i + 1
                    dp = w.data_point
                    dp.timestamp.CopyFrom(wa._ts(T0 + i))
                    fam = dp.tag_families.add()
                    fam.tags.add().str.value = f"s{i % 4}"
                    fam.tags.add().str.value = "eu" if i % 3 else "us"
                    dp.fields.add().float.value = float(vals[i])
                    dp.version = 1
                    yield w

            write = wa._method(chan, "banyandb.measure.v1.MeasureService", "Write",
                               pb.measure_write_pb2.WriteRequest,
                               pb.measure_write_pb2.WriteResponse, kind="stream")
            assert all(r.status == "STATUS_SUCCEED" for r in write(gen()))
        q = pb.measure_query_pb2.QueryRequest(groups=["wg"], name="cpm")
        q.time_range.begin.CopyFrom(wa._ts(T0))
        q.time_range.end.CopyFrom(wa._ts(T0 + 10_000))
        q.group_by.tag_projection.tag_families.add(name="default").tags.append("svc")
        q.agg.function, q.agg.field_name = 5, "value"  # SUM
        q.criteria.condition.name, q.criteria.condition.op = "region", 1
        q.criteria.condition.value.str.value = "eu"
        return wa._method(chan, "banyandb.measure.v1.MeasureService", "Query",
                          pb.measure_query_pb2.QueryRequest,
                          pb.measure_query_pb2.QueryResponse)(q)
    finally:
        chan.close()


@pytest.mark.parametrize("writer", PKGS)
def test_root_written_by_one_package_serves_from_the_other(writer, tmp_path):
    """A root that one package's server wrote over the wire (schema and
    points, flushed at stop) opens in the other package's server, which
    answers the same wire query with the same bytes."""
    from test_torch_wire import same_bytes

    from banyandb_tpu.server import StandaloneServer as JServer
    from banyandb_tpu_torch.server import StandaloneServer as TServer

    make = {
        "banyandb_tpu": lambda: JServer(tmp_path, port=0, wire_port=0),
        "banyandb_tpu_torch": lambda: TServer(tmp_path, port=0, wire_port=0, device="cpu"),
    }
    reader = next(p for p in PKGS if p != writer)
    srv = make[writer]()
    srv.start()
    try:
        first = _wire_seed_and_query(f"127.0.0.1:{srv.wire.port}", seed_data=True)
        srv.bus.handle("snapshot", {})
    finally:
        srv.stop()
    assert len(first.data_points) == 4
    srv = make[reader]()
    srv.start()
    try:
        again = _wire_seed_and_query(f"127.0.0.1:{srv.wire.port}", seed_data=False)
    finally:
        srv.stop()
    same_bytes(first, again, f"{writer} root read by {reader}")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_server_command_serves_the_cli(tmp_path):
    """``python -m banyandb_tpu_torch.server --device cpu`` boots the
    standalone role in a subprocess (bus, wire and HTTP on free ports),
    answers the port's CLI and the JAX CLI, and exits 0 on SIGTERM."""
    import signal

    proc = subprocess.Popen(
        [sys.executable, "-m", "banyandb_tpu_torch.server", "--root", str(tmp_path),
         "--port", "0", "--wire-port", "0", "--http-port", "0", "--workers", "0",
         "--device", "cpu"],
        env=_env(), cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        lines = []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
            if line.startswith("HTTP gateway"):
                break
        head = "\n".join(lines)
        assert lines and lines[0].startswith("banyandb-tpu standalone listening on "), (
            head, proc.stderr.read() if proc.poll() is not None else "")
        addr = lines[0].rsplit(" ", 1)[1]
        assert "device: cpu" in lines
        assert any(ln.startswith("wire gRPC (banyandb.*.v1) on :") for ln in lines), head
        for cli_mod in (tcli, jcli):
            rc, out = _cli_out(cli_mod, addr, ["health"])
            assert rc == 0 and json.loads(out)["status"] == "ok"
        rc, out = _cli_out(tcli, addr, ["group", "list"])
        assert rc == 0 and "_monitoring" in out
        http = int(next(ln for ln in lines if ln.startswith("HTTP gateway")).rsplit(":", 1)[1])
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/api/healthz") as r:
            assert json.loads(r.read()) == {"status": "ok"}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def test_server_command_refuses_without_cuda_or_cpu(tmp_path, monkeypatch):
    """Without CUDA, ``main()`` refuses unless ``--device cpu`` was
    asked for (no silent host fallback), before it binds or writes
    anything; ``BYDB_DEVICE`` is the flag's env form."""
    import torch

    from banyandb_tpu_torch import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BYDB_DEVICE", raising=False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        server.main(["--root", str(tmp_path / "r"), "--port", "0"])
    monkeypatch.setenv("BYDB_DEVICE", "cuda")
    with pytest.raises(SystemExit, match="--device cpu"):
        server.main(["--root", str(tmp_path / "r"), "--port", "0"])
    assert not (tmp_path / "r").exists()
    assert server.build_config().load(["--root", "x"]).device == "cuda"
    monkeypatch.setenv("BYDB_DEVICE", "cpu")
    assert server.build_config().load(["--root", "x"]).device == "cpu"


# -- the slice's configuration at full width (not tier-1) --------------------


def _jax_server_command(root):
    """``python -m banyandb_tpu.server`` (bus and wire on free ports) in a
    subprocess.  -> (process, {"bus": addr, "wire": addr})."""
    env = _env()
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-m", "banyandb_tpu.server", "--root", str(root), "--port", "0",
         "--wire-port", "0", "--http-port", "-1", "--workers", "0"],
        env=env, cwd=root.parent, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    addrs = {}
    deadline = time.monotonic() + 300
    while len(addrs) < 2 and time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("banyandb-tpu standalone listening on "):
            addrs["bus"] = line.strip().rsplit(" ", 1)[1]
        elif line.startswith("wire gRPC (banyandb.*.v1) on :"):
            addrs["wire"] = "127.0.0.1:" + line.strip().rsplit(":", 1)[1]
    assert len(addrs) == 2, (addrs, proc.poll())
    return proc, addrs


@pytest.mark.slow
def test_full_width_wire_http_bus_against_jax_and_numpy(tmp_path):
    """Phase 13's measure configuration (1,024 services x 8 regions,
    gamma(2, 40) latency, integer calls), cut to 1,048,576 points as
    phase 10 was: the points go through MeasureService/Write in streams
    of 65,536 into one port server (``device="cpu"``) and, at the same
    time, into the JAX package's server command; the TOP 10 by mean
    latency and p50/p99 by svc over region != 'r3' are asked over
    BydbQLService/Query, MeasureService/Query (TOP 10), the HTTP gateway
    and the bus of the port's server (chip_smoke.wire_path holds those
    against each other and against numpy), and over the JAX server's
    wire: the same groups in the same order, counts and percentiles
    exact, means within the precision contract (rtol 1e-5)."""
    from banyandb_tpu import sanitize

    # minutes of wire ingest: the suite's 180 s hang dump would fire
    # mid-run (re-arming replaces the conftest's timer)
    sanitize.arm_watchdog(3000)
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(REPO))
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    (tmp_path / "jax").mkdir()
    proc, peer = _jax_server_command(tmp_path / "jax")
    try:
        _, fig, answers, theirs = cs.wire_path(hk, cs.WIRE_N, "cpu", str(tmp_path / "port"),
                                               peer=peer)
    finally:
        proc.terminate()
        proc.wait(timeout=120)
        proc.stdout.close()
    print(json.dumps({"wire": fig}))
    for name, key in (("topn", ("topn", "wire_ql")), ("topn_query", ("topn", "wire_query")),
                      ("percentile", ("percentile", "wire_ql"))):
        ours = answers[key]
        ours = ours.measure_result if name != "topn_query" else ours
        jax = theirs[name].measure_result if name != "topn_query" else theirs[name]
        a, b = cs.wire_rows(ours), cs.wire_rows(jax)
        assert [s for s, _ in a] == [s for s, _ in b], name
        for (_, va), (_, vb) in zip(a, b):
            assert sorted(va) == sorted(vb), name
            for f in va:
                if name == "percentile":
                    assert va[f] == vb[f], (name, f)
                else:
                    np.testing.assert_allclose(va[f], vb[f], rtol=1e-5, atol=0, err_msg=name)
