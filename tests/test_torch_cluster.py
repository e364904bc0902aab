"""The port's in-process cluster (liaison + data nodes) against the JAX
package's.

Every cluster here is a ``Liaison`` over ``LocalTransport`` with two
``DataNode``s (``shard_num=4``, as in ``tests/test_fixture_cases.py``);
the port's data nodes run on ``device="cpu"``, where the kernels' plain
versions stand in.

- **Fixture cases:** the 10 cases of ``tests/cases/measure_cases.json``
  through the port's cluster equal the port's standalone engine (the
  comparison ``tests/test_fixture_cases.py`` makes) and the JAX
  package's 2-node cluster (the precision contract below).
- **Wire:** over a transport that round-trips every envelope and reply
  through ``json.dumps``/``json.loads``, as the gRPC bus does, a port
  liaison with JAX data nodes and a JAX liaison with port data nodes
  give the JAX cluster's results: one build can serve the other's
  nodes through a rolling migration.
- **Mesh fast path:** the mesh queries of ``tests/test_mesh_fastpath.py``
  (count, eq predicate with min/max, mean, two-step percentile) on a
  ``make_mesh(4, 2)`` of 8 CPU slots, legacy and fused (one chunk and
  four), run once on the mesh (``executions``) and equal the port's and
  the JAX package's host combine; an unsupported shape falls back.
- **Stream and trace:** the stream cases and the by-id / ordered trace
  cases of ``tests/test_fixture_cases_stream_trace.py`` through the
  port's liaison equal the JAX package's cluster.

Tolerance (the precision contract of ``tests/test_precision.py``):
groups, counts, min/max, percentiles and rows are equal; sums and means
equal where integer-valued, else within rtol 1e-5.  The mesh path, as in
the JAX package, reduces extremes in f32 where the host combine keeps
f64: its min/max equal the host's rounded to f32, and its percentiles,
histogrammed over that f32 range, agree within rtol 1e-5.
"""

import base64
import json
import types

import numpy as np
import pytest
import torch

import test_fixture_cases as fx
import test_fixture_cases_stream_trace as st
from banyandb_tpu import api as japi
from banyandb_tpu import bydbql as jql
from banyandb_tpu import cluster as jcluster
from banyandb_tpu.cluster import rpc as jrpc
from banyandb_tpu_torch import api as tapi
from banyandb_tpu_torch import bydbql as tql
from banyandb_tpu_torch import cluster as tcluster
from banyandb_tpu_torch.cluster import rpc as trpc
from banyandb_tpu_torch.models.measure import MeasureEngine as TEngine
from banyandb_tpu_torch.parallel import make_mesh
from banyandb_tpu_torch.parallel import mesh_query
from test_torch_engine import _assert_same

RTOL = 1e-5

JAX = types.SimpleNamespace(
    api=japi, cluster=jcluster, transport=jrpc.LocalTransport, node_kw={}
)
PORT = types.SimpleNamespace(
    api=tapi, cluster=tcluster, transport=trpc.LocalTransport,
    node_kw={"device": "cpu"},
)


class JsonTransport(trpc.LocalTransport):
    """In-process transport whose envelopes and replies cross a JSON
    round trip, as the gRPC bus's do."""

    def call(self, addr, topic, envelope, timeout=30.0):
        env = json.loads(json.dumps(envelope))
        return json.loads(json.dumps(super().call(addr, topic, env, timeout)))


def _measure_schema(api, reg, shard_num):
    reg.create_group(
        api.Group("sw", api.Catalog.MEASURE, api.ResourceOpts(shard_num=shard_num))
    )
    reg.create_measure(
        api.Measure(
            group="sw", name="cpm",
            tags=(
                api.TagSpec("svc", api.TagType.STRING),
                api.TagSpec("region", api.TagType.STRING),
                api.TagSpec("status", api.TagType.INT),
            ),
            fields=(api.FieldSpec("value", api.FieldType.INT),),
            entity=api.Entity(("svc",)),
        )
    )


def _fixture_points(api):
    statuses = (200, 404, 500)
    return tuple(
        api.DataPointValue(
            fx.T0 + i,
            {"svc": f"s{i % 10}", "region": f"r{i % 3}", "status": statuses[i % 3]},
            {"value": i % 997},
            version=1,
        )
        for i in range(fx.N)
    )


def _data_nodes(pkg, root, schema, transport, n=2):
    nodes, infos = [], []
    for i in range(n):
        reg = pkg.api.SchemaRegistry(root / f"n{i}")
        schema(pkg.api, reg)
        dn = pkg.cluster.DataNode(f"d{i}", reg, root / f"n{i}" / "data", **pkg.node_kw)
        nodes.append(dn)
        infos.append((dn.name, transport.register(dn.name, dn.bus)))
    return nodes, infos


def _liaison(pkg, root, schema, transport, infos):
    reg = pkg.api.SchemaRegistry(root / "l")
    schema(pkg.api, reg)
    return pkg.cluster.Liaison(
        reg, transport, [pkg.cluster.NodeInfo(n, a) for n, a in infos]
    )


def _close(nodes):
    for dn in nodes:
        dn.measure.close()
        dn.stream.close()
        dn.trace.close()


def _measure_cluster(liaison_pkg, node_pkg, root, transport):
    schema = lambda api, reg: _measure_schema(api, reg, 4)  # noqa: E731
    nodes, infos = _data_nodes(node_pkg, root, schema, transport)
    liaison = _liaison(liaison_pkg, root, schema, transport, infos)
    api = liaison_pkg.api
    liaison.write_measure(api.WriteRequest("sw", "cpm", _fixture_points(api)))
    return liaison, nodes


@pytest.fixture(scope="module")
def fixture_clusters(tmp_path_factory):
    """-> {name: (liaison, its package)} plus the port's standalone
    engine, all over the fixture dataset."""
    out, nodes = {}, []
    for name, lpkg, npkg, transport in (
        ("jax", JAX, JAX, jrpc.LocalTransport()),
        ("port", PORT, PORT, trpc.LocalTransport()),
        ("port_liaison_jax_nodes", PORT, JAX, JsonTransport()),
        ("jax_liaison_port_nodes", JAX, PORT, JsonTransport()),
    ):
        liaison, dns = _measure_cluster(
            lpkg, npkg, tmp_path_factory.mktemp(name), transport
        )
        out[name] = (liaison, lpkg)
        nodes += dns
    root = tmp_path_factory.mktemp("standalone")
    reg = tapi.SchemaRegistry(root)
    _measure_schema(tapi, reg, 2)
    standalone = TEngine(reg, root / "data", device="cpu")
    standalone.write(tapi.WriteRequest("sw", "cpm", _fixture_points(tapi)))
    standalone.flush()
    yield out, standalone
    standalone.close()
    _close(nodes)


def _flat(v) -> list:
    out = []
    for x in v:
        out.extend(_flat(x) if isinstance(x, tuple) else [float(x)])
    return out


def _query(liaison, pkg, case):
    ql = fx._subst(case["ql"])
    parse = jql.parse if pkg is JAX else tql.parse
    return liaison.query_measure(parse(ql))


@pytest.mark.parametrize("case", fx.CASES, ids=[c["name"] for c in fx.CASES])
def test_fixture_case_port_cluster(case, fixture_clusters):
    clusters, standalone = fixture_clusters
    liaison, pkg = clusters["port"]
    got = _query(liaison, pkg, case)
    _assert_same(got, _query(*clusters["jax"], case))
    # against the standalone engine, as tests/test_fixture_cases.py
    # compares the JAX package's cluster with its standalone engine
    a, b = fx._norm(standalone.query(tql.parse(fx._subst(case["ql"])))), fx._norm(got)
    if case["name"] == "percentiles_by_region":
        for (ga, va), (gb, vb) in zip(a["groups"], b["groups"]):
            assert ga == gb
            np.testing.assert_allclose(_flat(va), _flat(vb), atol=5.0)
    else:
        assert a == b


@pytest.mark.parametrize(
    "mixed", ["port_liaison_jax_nodes", "jax_liaison_port_nodes"]
)
@pytest.mark.parametrize("case", fx.CASES, ids=[c["name"] for c in fx.CASES])
def test_fixture_case_over_json_wire_mixed_builds(case, mixed, fixture_clusters):
    clusters, _standalone = fixture_clusters
    _assert_same(_query(*clusters[mixed], case), _query(*clusters["jax"], case))


# -- mesh fast path ------------------------------------------------------------

MESH_N = 20_000


def _mesh_schema(api, reg):
    reg.create_group(api.Group("mf", api.Catalog.MEASURE, api.ResourceOpts(shard_num=4)))
    reg.create_measure(
        api.Measure(
            group="mf", name="m",
            tags=(api.TagSpec("svc", api.TagType.STRING),
                  api.TagSpec("region", api.TagType.STRING)),
            fields=(api.FieldSpec("v", api.FieldType.FLOAT),),
            entity=api.Entity(("svc",)),
        )
    )


@pytest.fixture(scope="module")
def mesh_clusters(tmp_path_factory):
    """The dataset of tests/test_mesh_fastpath.py in a JAX and a port
    cluster, flushed.  -> ({"jax": liaison, "port": liaison}, port
    engines by node)."""
    rng = np.random.default_rng(11)
    svc = rng.integers(0, 12, MESH_N)
    region = rng.integers(0, 3, MESH_N)
    val = rng.gamma(2.0, 50.0, MESH_N).astype(np.float64)
    out, all_nodes = {}, []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        root = tmp_path_factory.mktemp(f"mesh-{name}")
        transport = pkg.transport()
        nodes, infos = _data_nodes(pkg, root, _mesh_schema, transport)
        liaison = _liaison(pkg, root, _mesh_schema, transport, infos)
        api = pkg.api
        liaison.write_measure(api.WriteRequest("mf", "m", tuple(
            api.DataPointValue(
                fx.T0 + i, {"svc": f"svc-{svc[i]}", "region": f"r{region[i]}"},
                {"v": float(val[i])}, version=1,
            )
            for i in range(MESH_N)
        )))
        for dn in nodes:
            dn.measure.flush()
        out[name] = liaison
        all_nodes += nodes
        if name == "port":
            engines = {dn.name: dn.measure for dn in nodes}
    yield out, engines
    _close(all_nodes)


def _mesh_req(api, **kw):
    base = dict(
        groups=("mf",), name="m",
        time_range=api.TimeRange(fx.T0, fx.T0 + MESH_N + 1),
        group_by=api.GroupBy(("svc",)),
        agg=api.Aggregation("count", "v"),
    )
    for k, v in kw.items():
        base[k] = v(api) if callable(v) else v
    return api.QueryRequest(**base)


MESH_QUERIES = {
    "count": {},
    "eq_predicate_max": dict(
        criteria=lambda api: api.Condition("region", "eq", "r1"),
        agg=lambda api: api.Aggregation("max", "v"),
    ),
    "eq_predicate_min": dict(
        criteria=lambda api: api.Condition("region", "eq", "r2"),
        agg=lambda api: api.Aggregation("min", "v"),
    ),
    "mean": dict(agg=lambda api: api.Aggregation("mean", "v")),
    "percentile_two_step": dict(agg=lambda api: api.Aggregation("percentile", "v")),
}

# BYDB_FUSED and the fused chunk width: one chunk (the chunk holds a
# slot's 2,500 rows) and four (1,024-row chunks)
MESH_LAYOUTS = {"legacy": ("0", 1 << 16), "fused": ("1", 1 << 16),
                "fused_4_chunks": ("1", 1 << 10)}


def _assert_mesh_same(mesh, host, exact_values: bool):
    """Same groups with the same values.  As in the JAX package, the
    mesh lists groups in global-dictionary order (the host combine in
    scan order) and its extremes are the f32 values the device reduced
    (the host combine reads them from the f64 columns), so the
    percentile range it agrees on is the f32 one: percentiles agree
    within the rtol of non-integer sums."""
    assert sorted(mesh.groups) == sorted(host.groups)
    assert sorted(mesh.values) == sorted(host.values)
    for key in host.values:
        got = dict(zip(mesh.groups, mesh.values[key]))
        want = dict(zip(host.groups, host.values[key]))
        if key.startswith(("min", "max")) and not exact_values:
            assert got == {g: float(np.float32(w)) for g, w in want.items()}, key
        elif exact_values or key.startswith("count"):
            assert got == want, key
        else:
            for g in want:
                np.testing.assert_allclose(got[g], want[g], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("layout", sorted(MESH_LAYOUTS))
@pytest.mark.parametrize("query", sorted(MESH_QUERIES))
def test_mesh_fastpath_matches_host_combine(query, layout, mesh_clusters, monkeypatch):
    liaisons, engines = mesh_clusters
    fused, chunk = MESH_LAYOUTS[layout]
    monkeypatch.setenv("BYDB_FUSED", fused)
    monkeypatch.setattr(mesh_query, "_FUSED_DIST_CHUNK", chunk)
    treq = _mesh_req(tapi, **MESH_QUERIES[query])
    host = liaisons["port"].query_measure(treq)
    jhost = liaisons["jax"].query_measure(_mesh_req(japi, **MESH_QUERIES[query]))
    liaison = liaisons["port"]
    liaison.enable_mesh_fastpath(make_mesh(4, 2, devices=["cpu"] * 8), engines)
    try:
        mesh = liaison.query_measure(treq)
        assert liaison.mesh_exec.executions == 1, "the mesh step must run"
        stats = liaison.mesh_exec.last_stats
        assert stats["num_chunks"] == (4 if layout == "fused_4_chunks" else 1)
        assert stats["h2d_bytes"] == 0  # CPU slots: nothing crosses to a card
    finally:
        del liaison.mesh_exec
    _assert_mesh_same(mesh, host, exact_values=False)
    _assert_mesh_same(mesh, jhost, exact_values=False)
    if query == "count":
        assert sum(mesh.values["count"]) == MESH_N


def test_mesh_fastpath_falls_back_on_unsupported(mesh_clusters):
    liaisons, engines = mesh_clusters
    liaison = liaisons["port"]
    req = _mesh_req(tapi, criteria=tapi.Condition("region", "in", ["r0", "r2"]))
    host = liaison.query_measure(req)
    liaison.enable_mesh_fastpath(make_mesh(4, 2, devices=["cpu"] * 8), engines)
    try:
        res = liaison.query_measure(req)
        assert liaison.mesh_exec.executions == 0
    finally:
        del liaison.mesh_exec
    _assert_mesh_same(res, host, exact_values=True)
    assert sum(res.values["count"]) > 0


# -- stream and trace ----------------------------------------------------------


@pytest.fixture(scope="module")
def stream_trace_clusters(tmp_path_factory):
    out, all_nodes = {}, []
    schema = lambda api, reg: st._make_group(reg, shard_num=4)  # noqa: E731
    for name, pkg in (("jax", JAX), ("port", PORT)):
        root = tmp_path_factory.mktemp(f"st-{name}")
        transport = pkg.transport()
        nodes, infos = _data_nodes(pkg, root, schema, transport)
        liaison = _liaison(pkg, root, schema, transport, infos)
        liaison.write_stream("sw", "logs", st._stream_schema_dict(), st._elements_json())
        liaison.write_trace(
            "sw", "spans", st.TRACE_SCHEMA,
            [{"ts": ts, "tags": tags, "span": base64.b64encode(p).decode()}
             for ts, tags, p in st._span_rows()],
            ordered_tags=("duration",),
        )
        out[name] = liaison
        all_nodes += nodes
    yield out
    _close(all_nodes)


@pytest.mark.parametrize("case", st.STREAM_CASES, ids=[c["name"] for c in st.STREAM_CASES])
def test_stream_case_port_cluster(case, stream_trace_clusters):
    ql = st._subst(case["ql"])
    got = st._norm_stream(stream_trace_clusters["port"].query_stream(tql.parse(ql)))
    want = st._norm_stream(stream_trace_clusters["jax"].query_stream(jql.parse(ql)))
    assert got == want and got


@pytest.mark.parametrize("case", st.TRACE_CASES, ids=[c["name"] for c in st.TRACE_CASES])
def test_trace_case_port_cluster(case, stream_trace_clusters):
    port, jax_ = stream_trace_clusters["port"], stream_trace_clusters["jax"]
    if case["kind"] == "by_id":
        def norm(spans):
            return [(s["timestamp"], bytes(s["span"]),
                     tuple(sorted((k, str(v)) for k, v in s["tags"].items())))
                    for s in spans]

        got = norm(port.query_trace_by_id("sw", "spans", case["trace_id"]))
        want = norm(jax_.query_trace_by_id("sw", "spans", case["trace_id"]))
    else:
        kw = dict(lo=case.get("lo"), hi=case.get("hi"), asc=case["asc"],
                  limit=case["limit"])
        tr = st.T0, st.T0 + st.N_TRACES * 10 + 10
        got = port.query_trace_ordered("sw", "spans", "duration", tapi.TimeRange(*tr), **kw)
        want = jax_.query_trace_ordered("sw", "spans", "duration", japi.TimeRange(*tr), **kw)
    assert got == want
    assert bool(got) == (case["name"] != "by_id_missing")


# -- device policy and the parts left for the serving slice --------------------


def test_data_node_needs_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = tapi.SchemaRegistry(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcluster.DataNode("d0", reg, tmp_path / "data")
    dn = tcluster.DataNode("d0", reg, tmp_path / "data", device="cpu")
    assert dn.measure.device == dn.stream.device == torch.device("cpu")
    _close([dn])


def test_write_queue_is_not_a_silent_no_op(tmp_path):
    liaison = tcluster.Liaison(tapi.SchemaRegistry(tmp_path), trpc.LocalTransport(), [])
    with pytest.raises(NotImplementedError, match="wqueue"):
        liaison.enable_write_queue(tmp_path / "spool")
