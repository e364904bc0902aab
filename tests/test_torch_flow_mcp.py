"""The port's streaming flow (``flow.py``) and MCP server
(``mcp_server.py``) against the JAX package's.

- **Flow:** mirrors of the four flow tests of ``tests/test_flow_fodc.py``
  (tumbling counts, sliding overlap, filter/map/lateness, TopN), and a
  seeded out-of-order stream with allowed lateness through both
  packages' ``Flow`` for each window kind and aggregate: the same
  ``WindowResult``s in the same order and the same accepted counts.  The
  aggregation is numpy on the host in both.
- **MCP:** mirrors of the two MCP tests of ``tests/test_platform.py``
  (the JSON-RPC protocol and tools, the stdio loop) over
  ``McpServer(root, device="cpu")``, and one script of requests
  (``initialize``, ``tools/list``, every tool, errors) through a JAX and a
  port server over the same seeded data: equal replies.  The server
  builds its measure and stream engines on CUDA by default and raises
  without it unless ``"cpu"`` was asked for.

Tolerance: exact (window values are float sums of the same values in
the same order; reply JSON compared whole).
"""

import io
import json
import types

import numpy as np
import pytest
import torch

from banyandb_tpu import api as japi
from banyandb_tpu import flow as jflow
from banyandb_tpu import mcp_server as jmcp
from banyandb_tpu.api import schema as jschema
from banyandb_tpu.models import stream as jstream
from banyandb_tpu_torch import api as tapi
from banyandb_tpu_torch import flow as tflow
from banyandb_tpu_torch import mcp_server as tmcp
from banyandb_tpu_torch.api import schema as tschema
from banyandb_tpu_torch.models import stream as tstream
from banyandb_tpu_torch.flow import (
    Element,
    Flow,
    SlidingEventTimeWindow,
    TumblingEventTimeWindow,
)

T0 = 1_700_000_000_000


# -- flow (tests/test_flow_fodc.py) ---------------------------------------------


def test_tumbling_window_counts():
    out = []
    f = (
        Flow("t")
        .key_by(lambda e: e.tags["svc"])
        .window(TumblingEventTimeWindow(1000))
        .aggregate("count")
        .to(out.append)
    )
    f.feed(
        Element(T0 + i * 100, 1.0, {"svc": "a" if i % 2 else "b"})
        for i in range(20)
    )
    f.advance_watermark(T0 + 1000)
    assert {(r.key, r.value) for r in out} == {("a", 5.0), ("b", 5.0)}
    out.clear()
    f.advance_watermark(T0 + 2000)
    assert {(r.key, r.value) for r in out} == {("a", 5.0), ("b", 5.0)}


def test_sliding_windows_overlap():
    out = []
    f = (
        Flow("s")
        .window(SlidingEventTimeWindow(size_ms=2000, slide_ms=1000))
        .aggregate("sum")
        .to(out.append)
    )
    f.feed(Element(T0 + s * 1000, float(s)) for s in range(4))
    f.advance_watermark(T0 + 4000)
    sums = {(r.start_ms - T0): r.value for r in out}
    assert sums == {-1000: 0.0, 0: 1.0, 1000: 3.0, 2000: 5.0}


def test_filter_map_and_lateness():
    out = []
    f = (
        Flow("fl")
        .filter(lambda e: e.value >= 0)
        .map(lambda e: e._replace(value=e.value * 10))
        .window(TumblingEventTimeWindow(1000))
        .aggregate("sum")
        .allowed_lateness(500)
        .to(out.append)
    )
    f.feed([Element(T0 + 100, 1.0), Element(T0 + 200, -5.0)])
    f.advance_watermark(T0 + 1000)  # lateness holds the window open
    assert out == []
    f.feed([Element(T0 + 300, 2.0)])  # within lateness: still accepted
    f.advance_watermark(T0 + 1500)  # now end+lateness passed -> fires
    assert len(out) == 1 and out[0].value == 30.0
    assert f.feed([Element(T0 + 400, 9.0)]) == 0


def test_topn_operator():
    out = []
    f = (
        Flow("top")
        .key_by(lambda e: e.tags["svc"])
        .window(TumblingEventTimeWindow(1000))
        .aggregate("sum")
        .top_n(2)
        .to(out.append)
    )
    f.feed([
        Element(T0 + 1, 10.0, {"svc": "a"}),
        Element(T0 + 2, 30.0, {"svc": "b"}),
        Element(T0 + 3, 20.0, {"svc": "c"}),
        Element(T0 + 4, 5.0, {"svc": "b"}),
    ])
    f.advance_watermark(T0 + 1000)
    assert len(out) == 1
    assert out[0].value == [("b", 35.0), ("c", 20.0)]


def _seeded_stream(seed, n=3000):
    """Out-of-order events: 10 ms apart with up to 700 ms of jitter, a
    gamma value and one of 6 services."""
    rng = np.random.default_rng(seed)
    ts = T0 + np.arange(n) * 10 + rng.integers(0, 700, n)
    return list(zip(ts.tolist(), rng.gamma(2.0, 40.0, n).tolist(),
                    rng.integers(0, 6, n).tolist()))


def _run_flow(mod, window, agg, topn, events):
    out = []
    f = (mod.Flow("p")
         .filter(lambda e: e.value > 5.0)
         .map(lambda e: e._replace(value=round(e.value, 3)))
         .key_by(lambda e: e.tags["svc"])
         .window(window)
         .aggregate(agg)
         .allowed_lateness(300)
         .to(out.append))
    if topn:
        f.top_n(3, desc=agg != "min")
    accepted, fired = [], []
    for lo in range(0, len(events), 250):
        chunk = events[lo: lo + 250]
        accepted.append(f.feed(mod.Element(t, v, {"svc": f"s{s}"}) for t, v, s in chunk))
        fired.append(len(f.advance_watermark(chunk[-1][0] - 200)))
    fired.append(len(f.advance_watermark(events[-1][0] + 10_000)))
    return accepted, fired, [(r.start_ms, r.end_ms, r.key, r.value) for r in out]


@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
@pytest.mark.parametrize("agg,topn", [
    ("count", False), ("sum", False), ("mean", False), ("min", False), ("max", False),
    ("sum", True), ("min", True),
])
def test_flow_equal_across_packages(kind, agg, topn):
    events = _seeded_stream(21)
    got = []
    for mod in (jflow, tflow):
        window = (mod.TumblingEventTimeWindow(500) if kind == "tumbling"
                  else mod.SlidingEventTimeWindow(size_ms=1000, slide_ms=250))
        got.append(_run_flow(mod, window, agg, topn, events))
    assert got[0] == got[1]
    accepted, fired, results = got[1]
    assert sum(accepted) < len(events)  # lateness dropped some late events
    assert sum(fired) == len(results) > 0


# -- MCP server (tests/test_platform.py) ----------------------------------------

PKGS = {
    "jax": types.SimpleNamespace(mcp=jmcp, api=japi, schema=jschema, stream=jstream, kw={}),
    "port": types.SimpleNamespace(mcp=tmcp, api=tapi, schema=tschema, stream=tstream,
                                  kw={"device": "cpu"}),
}


def _server(pkg, root, seed=None):
    """The JAX test's group, measure and 30 points (value 1 + i), or with
    a seed 600 seeded points, a TopN rule over them and a small stream."""
    srv = pkg.mcp.McpServer(root, **pkg.kw)
    api = pkg.api
    srv.registry.create_group(api.Group("g", api.Catalog.MEASURE, api.ResourceOpts()))
    srv.registry.create_measure(api.Measure(
        group="g", name="m",
        tags=(api.TagSpec("svc", api.TagType.STRING),),
        fields=(api.FieldSpec("v", api.FieldType.FLOAT),),
        entity=api.Entity(("svc",)),
    ))
    if seed is None:
        vals = [(T0 + i, f"s{i % 3}", 1.0 + i) for i in range(30)]
    else:
        srv.registry.create_topn(pkg.schema.TopNAggregation(
            group="g", name="top_svc", source_measure="m", field_name="v",
            group_by_tag_names=("svc",)))
        srv.registry.create_group(api.Group("sg", api.Catalog.STREAM, api.ResourceOpts()))
        srv.registry.create_stream(api.Stream(
            group="sg", name="logs",
            tags=(api.TagSpec("svc", api.TagType.STRING),
                  api.TagSpec("level", api.TagType.STRING)),
            entity=("svc",)))
        rng = np.random.default_rng(seed)
        svc, v = rng.integers(0, 9, 600), rng.integers(0, 500, 600)
        vals = [(T0 + 50 * i, f"s{s}", float(x))
                for i, (s, x) in enumerate(zip(svc.tolist(), v.tolist()))]
        srv.stream.write("sg", "logs", [
            pkg.stream.ElementValue(f"e{i}", T0 + i, {"svc": f"s{i % 4}",
                                                      "level": ("INFO", "WARN")[i % 2]})
            for i in range(200)
        ])
        srv.stream.flush()
    srv.measure.write(api.WriteRequest("g", "m", tuple(
        api.DataPointValue(t, {"svc": s}, {"v": x}, version=1) for t, s, x in vals)))
    if seed is not None:
        srv.measure.flush()
        srv.measure.topn.flush_all_windows()
    return srv


@pytest.fixture()
def mcp(tmp_path):
    return _server(PKGS["port"], tmp_path)


def _call(srv, method, params=None, mid=1):
    return srv.handle(
        {"jsonrpc": "2.0", "id": mid, "method": method, "params": params or {}}
    )


def test_mcp_protocol_and_tools(mcp):
    init = _call(mcp, "initialize")
    assert init["result"]["serverInfo"]["name"] == "banyandb-tpu-mcp"
    assert _call(mcp, "notifications/initialized") is None

    tools = _call(mcp, "tools/list")["result"]["tools"]
    assert {t["name"] for t in tools} >= {
        "list_groups_schemas", "list_resources", "validate_bydbql",
        "execute_bydbql", "topn_query",
    }

    r = _call(mcp, "tools/call", {"name": "list_groups_schemas", "arguments": {}})
    assert json.loads(r["result"]["content"][0]["text"])["g"]["measures"] == ["m"]

    r = _call(mcp, "tools/call",
              {"name": "validate_bydbql", "arguments": {"query": "SELECT bogus FROM"}})
    assert json.loads(r["result"]["content"][0]["text"])["valid"] is False

    r = _call(mcp, "tools/call", {"name": "execute_bydbql", "arguments": {"query": (
        "SELECT sum(v) FROM MEASURE m IN g "
        f"TIME >= {T0} AND TIME < {T0 + 100} GROUP BY svc")}})
    payload = json.loads(r["result"]["content"][0]["text"])
    assert len(payload["result"]["groups"]) == 3

    err = _call(mcp, "tools/call", {"name": "nope", "arguments": {}})
    assert "error" in err
    assert _call(mcp, "no/such/method")["error"]["code"] == -32601


def test_mcp_stdio_loop(mcp):
    lines = "\n".join(json.dumps(m) for m in [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        {"jsonrpc": "2.0", "method": "notifications/initialized"},
        {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
    ])
    out = io.StringIO()
    mcp.serve_stdio(stdin=io.StringIO(lines), stdout=out)
    resps = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [r["id"] for r in resps] == [1, 2]


def test_mcp_server_needs_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmcp.McpServer(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmcp.main(["--root", str(tmp_path)])
    assert tmcp.McpServer(tmp_path, device="cpu").measure.device.type == "cpu"


_SPAN = f"TIME >= {T0} AND TIME < {T0 + 30_000}"
_SCRIPT = [
    ("initialize", {}),
    ("tools/list", {}),
    ("ping", {}),
    ("tools/call", {"name": "list_groups_schemas", "arguments": {}}),
    ("tools/call", {"name": "list_resources", "arguments": {"group": "g"}}),
    ("tools/call", {"name": "validate_bydbql", "arguments": {
        "query": f"SELECT sum(v) FROM MEASURE m IN g {_SPAN} GROUP BY svc"}}),
    ("tools/call", {"name": "validate_bydbql", "arguments": {"query": "SELECT FROM"}}),
] + [
    ("tools/call", {"name": "execute_bydbql", "arguments": {"query": q}})
    for q in (
        f"SELECT sum(v) FROM MEASURE m IN g {_SPAN} GROUP BY svc",
        f"SELECT count(v) FROM MEASURE m IN g {_SPAN} WHERE svc != 's3' GROUP BY svc",
        f"SELECT min(v) FROM MEASURE m IN g {_SPAN} GROUP BY svc",
        f"SELECT max(v) FROM MEASURE m IN g {_SPAN} GROUP BY svc",
        f"SELECT v FROM MEASURE m IN g {_SPAN} GROUP BY svc TOP 4 BY v",
        f"SELECT * FROM STREAM logs IN sg TIME >= {T0} AND TIME < {T0 + 200} "
        "WHERE level = 'WARN' LIMIT 7",
        "SELECT * FROM TRACE t IN g LIMIT 1",
    )
] + [
    ("tools/call", {"name": "topn_query", "arguments": {
        "group": "g", "rule": "top_svc", "begin_millis": T0 - 3_600_000,
        "end_millis": T0 + 3_600_000, "n": n}})
    for n in (3, 9)
] + [
    ("tools/call", {"name": "nope", "arguments": {}}),
    ("no/such/method", {}),
]


def test_mcp_replies_equal_across_packages(tmp_path):
    replies = {}
    for name, pkg in PKGS.items():
        srv = _server(pkg, tmp_path / name, seed=5)
        replies[name] = [_call(srv, m, p, mid=i) for i, (m, p) in enumerate(_SCRIPT)]
        srv.measure.close()
        srv.stream.close()
    for (method, params), j, t in zip(_SCRIPT, replies["jax"], replies["port"]):
        assert t == j, (method, params)
    texts = [r["result"]["content"][0]["text"] for r in replies["port"][7:13]]
    assert all(json.loads(t)["result"] for t in texts)
    assert "error" in replies["port"][13]  # trace QL is not served here
    for r, n in zip(replies["port"][14:16], (3, 9)):
        top = json.loads(r["result"]["content"][0]["text"])["items"]
        assert len(top) == n
        assert [i["value"] for i in top] == sorted((i["value"] for i in top), reverse=True)
