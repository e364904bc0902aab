"""Port parity for the slice as a whole: write -> flush -> part read ->
execute_aggregate, banyandb_tpu_torch against banyandb_tpu on the CPU.

State crosses between the packages only through the on-disk part
format and the numpy ``ColumnData`` boundary: each package reads the
other's parts, and both run the query over the same parts.

Tolerances: ``Partials.content_bytes()`` is byte-identical wherever the
sums are integer-valued (counts, min/max, histograms, rep keys and
codes always are); the one scenario with a non-integer field
(percentile-hist) compares its sums within rtol=1e-5
(tests/test_precision.py) and everything else exactly.
"""

import dataclasses
import enum
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from banyandb_tpu.query import measure_exec as jme
from banyandb_tpu.storage.memtable import MemTable as JMemTable
from banyandb_tpu.storage.part import ColumnData as JColumnData
from banyandb_tpu.storage.part import Part as JPart
from banyandb_tpu.storage.part import PartWriter as JPartWriter
from banyandb_tpu_torch.api import model as tmodel
from banyandb_tpu_torch.api import schema as tschema
from banyandb_tpu_torch.query import measure_exec as tme
from banyandb_tpu_torch.storage.memtable import MemTable as TMemTable
from banyandb_tpu_torch.storage.part import Part as TPart
from banyandb_tpu_torch.storage.part import PartWriter as TPartWriter
from test_fused_exec import _scenarios

RTOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


def _to_port(obj):
    """Rebuild a banyandb_tpu.api dataclass tree with the port's classes."""
    if isinstance(obj, enum.Enum):
        return getattr(tschema, type(obj).__name__)[obj.name]
    if dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        cls = getattr(tmodel, name, None) or getattr(tschema, name)
        return cls(**{
            f.name: _to_port(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_port(x) for x in obj)
    return obj


def _flush(mem_cls, writer_cls, part_dir, src):
    """Points of one in-memory source -> memtable -> PartWriter."""
    tags = sorted(src.tags)
    fields = sorted(src.fields)
    mem = mem_cls(tags, fields)
    for i in range(src.ts.shape[0]):
        mem.append(
            int(src.ts[i]), int(src.series[i]), int(src.version[i]),
            {t: src.dicts[t][src.tags[t][i]] for t in tags},
            {f: float(src.fields[f][i]) for f in fields},
        )
    ((_s, cols, extra),) = mem.drain()
    writer_cls.write(
        part_dir, ts=cols.ts, series=cols.series, version=cols.version,
        tag_codes=dict(cols.tags), tag_dicts=dict(cols.dicts),
        fields=dict(cols.fields), extra_meta=extra,
    )


def _read(part_cls, part_dir, narrow):
    p = part_cls(part_dir)
    return p.read(
        range(len(p.blocks)), tags=p.meta["tags"], fields=p.meta["fields"],
        narrow_codes=narrow, cached=False,
    )


def _column_bytes(cd) -> list:
    out = [cd.ts.tobytes(), cd.series.tobytes(), cd.version.tobytes()]
    for t in sorted(cd.tags):
        out += [t, cd.tags[t].dtype.str, cd.tags[t].tobytes(), tuple(cd.dicts[t])]
    for f in sorted(cd.fields):
        out += [f, cd.fields[f].dtype.str, cd.fields[f].tobytes()]
    return out


@pytest.mark.parametrize("narrow", [False, True])
def test_parts_cross_read_byte_identical(tmp_path, narrow):
    """Each package flushes the same points through its memtable and
    PartWriter; each package's Part.read of the other's part yields
    byte-identical ColumnData."""
    rng = np.random.default_rng(1)
    n = 20000  # three blocks
    src = JColumnData(
        ts=1_700_000_000_000 + rng.permutation(n).astype(np.int64),
        series=rng.integers(0, 50, n).astype(np.int64),
        version=np.ones(n, np.int64),
        tags={"svc": rng.integers(0, 300, n).astype(np.int32),
              "region": rng.integers(0, 4, n).astype(np.int32)},
        fields={"v": rng.integers(0, 1000, n).astype(np.float64),
                "lat": rng.gamma(2.0, 40.0, n)},
        dicts={"svc": [b"s%03d" % i for i in range(300)],
               "region": [b"r%d" % i for i in range(4)]},
    )
    _flush(JMemTable, JPartWriter, tmp_path / "jax", src)
    _flush(TMemTable, TPartWriter, tmp_path / "torch", src)
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "jax" / name).read_bytes() == (
            tmp_path / "torch" / name
        ).read_bytes(), name
    want = _column_bytes(_read(JPart, tmp_path / "jax", narrow))
    assert _column_bytes(_read(TPart, tmp_path / "jax", narrow)) == want
    assert _column_bytes(_read(JPart, tmp_path / "torch", narrow)) == want


@pytest.fixture(scope="module")
def scenario_parts(tmp_path_factory):
    """Every fused-exec scenario's source flushed to a part by the JAX
    package: name -> (jax measure, jax request, part dir)."""
    root = tmp_path_factory.mktemp("scenario_parts")
    out = {}
    for name, m, req, srcs in _scenarios():
        (src,) = srcs
        d = root / name
        JPartWriter.write(
            d, ts=src.ts, series=src.series, version=src.version,
            tag_codes=dict(src.tags), tag_dicts=dict(src.dicts),
            fields=dict(src.fields),
        )
        out[name] = (m, req, d)
    return out


def _assert_partials_match(tp, jp, exact: bool):
    if exact:
        assert tp.content_bytes() == jp.content_bytes()
        return
    assert np.array_equal(tp.codes, jp.codes)
    assert np.array_equal(tp.count, jp.count)
    for f in jp.sums:
        np.testing.assert_allclose(tp.sums[f], jp.sums[f], rtol=RTOL, atol=0)
        assert np.array_equal(tp.mins[f], jp.mins[f])
        assert np.array_equal(tp.maxs[f], jp.maxs[f])
    assert np.array_equal(tp.hist, jp.hist)


def _same_result(a, b) -> bool:
    return (a.groups, a.values, a.rep_tags) == (b.groups, b.values, b.rep_tags)


@pytest.mark.parametrize("name", [s[0] for s in _scenarios()])
@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("device_decode", ["1", "0"])
def test_aggregate_matches_jax(
    scenario_parts, name, fused, device_decode, monkeypatch
):
    monkeypatch.setenv("BYDB_FUSED", fused)
    monkeypatch.setenv("BYDB_DEVICE_DECODE", device_decode)
    m, req, d = scenario_parts[name]
    narrow = device_decode == "1"
    jsrc = [_read(JPart, d, narrow)]
    tsrc = [_read(TPart, d, narrow)]
    tm, treq = _to_port(m), _to_port(req)
    jp = jme.compute_partials(m, req, jsrc)
    tp = tme.compute_partials(tm, treq, tsrc, device="cpu")
    _assert_partials_match(tp, jp, exact=name != "percentile-hist")
    jres = jme.execute_aggregate(m, req, jsrc)
    tres = tme.execute_aggregate(tm, treq, tsrc, device="cpu")
    assert _same_result(tres, jres)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_multichunk_matches_jax(scenario_parts, fused, monkeypatch):
    """A part-batch over four scan chunks: staged and fused, compressed
    ship form, byte-identical to the JAX package."""
    monkeypatch.setenv("BYDB_FUSED", fused)
    monkeypatch.setenv("BYDB_DEVICE_DECODE", "1")
    monkeypatch.setattr(jme, "SCAN_CHUNK", 2048)
    monkeypatch.setattr(tme, "SCAN_CHUNK", 2048)
    m, req, d = scenario_parts["group-eq-lut"]
    jp = jme.compute_partials(m, req, [_read(JPart, d, True)])
    tp = tme.compute_partials(_to_port(m), _to_port(req), [_read(TPart, d, True)], device="cpu")
    assert tp.content_bytes() == jp.content_bytes()


def test_entry_points_need_cuda_or_explicit_cpu(scenario_parts, monkeypatch):
    from banyandb_tpu_torch.query import fused_exec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, req, d = scenario_parts["flat-count"]
    src = [_read(TPart, d, False)]
    for fn in (tme.compute_partials, tme.execute_aggregate):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(_to_port(m), _to_port(req), src)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_exec.run_fused({}, [(0, 1)], None, {}, 0.0, 1.0, 0)


_ISOLATION = textwrap.dedent(
    """
    import sys
    import numpy as np
    from banyandb_tpu_torch.api.model import GroupBy, QueryRequest, TimeRange
    from banyandb_tpu_torch.api.schema import (
        Entity, FieldSpec, FieldType, Measure, TagSpec, TagType)
    from banyandb_tpu_torch.query.measure_exec import execute_aggregate
    from banyandb_tpu_torch.storage.part import ColumnData

    n = 4096
    m = Measure("g", "m", (TagSpec("svc", TagType.STRING),),
                (FieldSpec("v", FieldType.INT),), Entity(("svc",)))
    src = ColumnData(
        ts=np.arange(n, dtype=np.int64), series=np.zeros(n, np.int64),
        version=np.ones(n, np.int64),
        tags={"svc": (np.arange(n) % 3).astype(np.int32)},
        fields={"v": np.ones(n)}, dicts={"svc": [b"a", b"b", b"c"]})
    req = QueryRequest(("g",), "m", TimeRange(0, n), group_by=GroupBy(("svc",)),
                       field_projection=("v",))
    res = execute_aggregate(m, req, [src], device="cpu")
    assert res.values["count"] == [1366.0, 1365.0, 1365.0], res.values

    import tempfile
    from pathlib import Path
    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import Catalog, Group, ResourceOpts, SchemaRegistry
    from banyandb_tpu_torch.models.measure import MeasureEngine
    import banyandb_tpu_torch.admin.protector, banyandb_tpu_torch.index
    import banyandb_tpu_torch.qos.plane, banyandb_tpu_torch.storage.loops
    import banyandb_tpu_torch.storage.merge, banyandb_tpu_torch.ops.hopper_kernels

    with tempfile.TemporaryDirectory() as root:
        reg = SchemaRegistry(Path(root))
        reg.create_group(Group("g", Catalog.MEASURE, ResourceOpts(shard_num=2)))
        reg.create_measure(m)
        eng = MeasureEngine(reg, Path(root) / "data", device="cpu")
        eng.write_columns("g", "m", ts_millis=np.arange(n, dtype=np.int64),
                          tags={"svc": [("a", "b", "c")[i % 3] for i in range(n)]},
                          fields={"v": np.ones(n)})
        eng.flush()
        res = eng.query(bydbql.parse(
            "SELECT count(v) FROM MEASURE m IN g TIME BETWEEN 0 AND 4095 GROUP BY svc"))
        assert sorted(res.values["count"]) == [1365.0, 1365.0, 1366.0], res.values
        eng.close()

    import torch
    from banyandb_tpu_torch.api import IndexRule, Stream, TagSpec, TagType
    from banyandb_tpu_torch.api.schema import Trace
    from banyandb_tpu_torch.models.property import Property, PropertyEngine
    from banyandb_tpu_torch.models.stream import ElementValue, StreamEngine
    from banyandb_tpu_torch.models.trace import SpanValue, TraceEngine
    from banyandb_tpu_torch.query import ql_exec, stream_exec
    import banyandb_tpu_torch.models.property_repair, banyandb_tpu_torch.models.trace_pipeline

    with tempfile.TemporaryDirectory() as root:
        reg = SchemaRegistry(Path(root))
        reg.create_group(Group("s", Catalog.STREAM, ResourceOpts(shard_num=1)))
        reg.create_group(Group("p", Catalog.PROPERTY, ResourceOpts(shard_num=2)))
        reg.create_stream(Stream("s", "logs", (TagSpec("svc", TagType.STRING),
                                               TagSpec("lvl", TagType.STRING)), ("svc",)))
        reg.create_index_rule(IndexRule(group="s", name="i", tags=("lvl",), type="skipping"))
        available = torch.cuda.is_available
        torch.cuda.is_available = lambda: False
        try:
            StreamEngine(reg, Path(root) / "data")
            raise AssertionError("StreamEngine ran without CUDA or device='cpu'")
        except RuntimeError:
            pass
        torch.cuda.is_available = available
        st = StreamEngine(reg, Path(root) / "data", device="cpu")
        st.write("s", "logs", [ElementValue(f"e{i}", i, {"svc": "abc"[i % 3], "lvl": "EW"[i % 2]})
                               for i in range(40000)])
        st.flush()
        stream_exec.reset_stats()
        res = st.query(bydbql.parse(
            "SELECT lvl FROM STREAM logs IN s TIME BETWEEN 0 AND 40000 "
            "WHERE lvl = 'E' AND svc != 'c' LIMIT 3"))
        assert [d["element_id"] for d in res.data_points] == ["e39996", "e39994", "e39990"]
        assert stream_exec.STATS["device_masks"] == 1, stream_exec.STATS
        st.close()
        reg.create_trace(Trace("s", "spans", (TagSpec("trace_id", TagType.STRING),
                                              TagSpec("d", TagType.INT)), "trace_id"))
        tr = TraceEngine(reg, Path(root) / "data")
        tr.write("s", "spans", [SpanValue(i, {"trace_id": f"t{i % 4}", "d": i}, b"x%d" % i)
                                for i in range(40)], ordered_tags=("d",))
        tr.flush()
        assert [s["timestamp"] for s in tr.query_by_trace_id("s", "spans", "t1")] == list(range(1, 40, 4))
        _cat, req = bydbql.parse_with_catalog(
            "SELECT * FROM TRACE spans IN s WHERE d >= 38 LIMIT 10")
        assert [d["timestamp"] for d in ql_exec.execute_trace_ql(tr, req).data_points] == [38, 39]
        tr.close()
        pe = PropertyEngine(reg, Path(root) / "data")
        p1 = pe.apply(Property("p", "node", "n1", {"role": "data"}))
        p2 = pe.apply(Property("p", "node", "n1", {"zone": "z"}))
        assert p2.tags == {"role": "data", "zone": "z"} and p2.mod_revision > p1.mod_revision
        assert [p.id for p in pe.query("p", "node", tag_filters={"zone": "z"})] == ["n1"]
        pe.close()

    # the in-process cluster: two data nodes and a liaison over
    # LocalTransport, a scatter query and the mesh fast path
    from banyandb_tpu_torch.api import DataPointValue, WriteRequest
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport
    from banyandb_tpu_torch.parallel import make_mesh
    import banyandb_tpu_torch.admin.diagnostics, banyandb_tpu_torch.admin.inspect
    import banyandb_tpu_torch.cluster.faults, banyandb_tpu_torch.cluster.handoff
    import banyandb_tpu_torch.cluster.schema_gossip, banyandb_tpu_torch.parallel.mesh_query

    with tempfile.TemporaryDirectory() as root:
        transport, infos, nodes = LocalTransport(), [], []
        for i in range(3):
            reg = SchemaRegistry(Path(root) / f"n{i}")
            reg.create_group(Group("g", Catalog.MEASURE, ResourceOpts(shard_num=4)))
            reg.create_measure(m)
            if i < 2:
                dn = DataNode(f"d{i}", reg, Path(root) / f"n{i}" / "data", device="cpu")
                nodes.append(dn)
                infos.append(NodeInfo(dn.name, transport.register(dn.name, dn.bus)))
        liaison = Liaison(reg, transport, infos)
        liaison.write_measure(WriteRequest("g", "m", tuple(
            DataPointValue(i, {"svc": "abcdef"[i % 6]}, {"v": 1}) for i in range(600))))
        req = bydbql.parse(
            "SELECT count(v) FROM MEASURE m IN g TIME BETWEEN 0 AND 600 GROUP BY svc")
        host = liaison.query_measure(req)
        liaison.enable_mesh_fastpath(make_mesh(4, 2, devices=["cpu"] * 8),
                                     {dn.name: dn.measure for dn in nodes})
        mesh = liaison.query_measure(req)
        assert liaison.mesh_exec.executions == 1
        assert (sorted(zip(mesh.groups, mesh.values["count"]))
                == sorted(zip(host.groups, host.values["count"]))
                == [((s,), 100.0) for s in "abcdef"]), (host, mesh)
        for dn in nodes:
            dn.measure.close(), dn.stream.close(), dn.trace.close()

    # the precompile registry, the build cache, ColumnBatch and the audits
    import os
    os.environ["BYDB_PRECOMPILE"] = "1"
    from banyandb_tpu_torch.lint.kernel import run_kernel_audit
    from banyandb_tpu_torch.lint.whole_program.plan_audit import run_plan_audit
    from banyandb_tpu_torch.ops import ColumnBatch
    from banyandb_tpu_torch.query import precompile
    from banyandb_tpu_torch.utils import compile_cache
    import banyandb_tpu_torch.lint
    with tempfile.TemporaryDirectory() as root:
        assert compile_cache.enable_at(root) == root
        assert banyandb_tpu_torch.ops.hopper_kernels._library_path().parent == Path(root)
        reg = precompile.PrecompileRegistry(device="cpu")
        reg.attach_store(Path(root) / "plan-registry.json")
        assert reg.warm(sigs=[("measure", precompile.builtin_plans()[0][1])]) == 1
        reg.shutdown()
    ColumnBatch.build(ts_millis=np.arange(10), epoch_millis=0, series_ordinal=np.zeros(10),
                      fields={}, tag_codes={}, device="cpu")
    assert run_plan_audit() == [] and run_kernel_audit(fast=True) == []

    # the standalone server over its bus, with its serving planes
    from banyandb_tpu_torch.server import StandaloneServer
    with tempfile.TemporaryDirectory() as root:
        srv = StandaloneServer(root, device="cpu")
        srv.start()
        assert srv.bus.handle("health", {})["status"] == "ok"
        for topic in ("metrics", "slowlog", "qos", "diagnostics", "snapshot"):
            srv.bus.handle(topic, {})
        assert srv.bus.handle("fodc-pprof", {"kinds": ["threads"]})["profiles"]
        srv.stop()

    # the multi-process data plane and the elastic cluster
    from banyandb_tpu_torch.cluster import rebalance, workers
    from banyandb_tpu_torch.cluster.placement import PlacementMap
    from banyandb_tpu_torch.sanitize import leaks
    from banyandb_tpu_torch.utils import procreg
    import banyandb_tpu_torch.sanitize
    plan = rebalance.plan_rebalance(PlacementMap.initial(["a", "b"], 0), ["a", "b", "c"],
                                    num_shards=3)
    assert plan.new_epoch == 2 and plan.moves, plan
    assert leaks.leaked_processes(procreg.snapshot(), grace_s=0.0) == []
    assert workers.relabel_exposition("x 1", {"worker": "w0"}) == 'x{worker="w0"} 1'

    # the data lifecycle: archive, format migration, backup, object
    # stores, tier migration, the streaming flow and the MCP server
    import banyandb_tpu_torch.admin.backup, banyandb_tpu_torch.admin.lifecycle
    import banyandb_tpu_torch.admin.migration, banyandb_tpu_torch.admin.tier_migration
    import banyandb_tpu_torch.utils.object_store
    from banyandb_tpu_torch import flow, mcp_server
    f = flow.Flow("f").window(flow.TumblingEventTimeWindow(10)).aggregate("count")
    f.feed([flow.Element(1, 1.0), flow.Element(2, 1.0)])
    assert f.advance_watermark(10)[0].value == 2.0
    with tempfile.TemporaryDirectory() as root:
        mcp = mcp_server.McpServer(root, device="cpu")
        assert mcp.handle({"jsonrpc": "2.0", "id": 1, "method": "ping"})["result"] == {}
        mcp.measure.close(), mcp.stream.close()
    bad = sorted(k for k in sys.modules
                 if k in ("jax", "grpc") or k.startswith(
                     ("jax.", "banyandb_tpu.", "grpc.", "google.protobuf")))
    assert not bad, bad
    print("isolated")
    """
)


def test_port_imports_neither_jax_nor_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"
    offenders = []
    for path in [*sorted((REPO / "banyandb_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")) and (
                s.split()[1].split(".")[0] in ("jax", "jaxlib", "banyandb_tpu", "grpc")
                or s.split()[1].startswith("google.protobuf")
            ):
                offenders.append(f"{path.relative_to(REPO)}:{i}: {s}")
    assert not offenders, offenders


def test_smoke_lifecycle_path_on_cpu(tmp_path, monkeypatch):
    """Phase 16 of chip_smoke.py (archive and restore, format migration,
    backup and restore, hot -> warm tier migration, MCP) at 65,536
    points on a device="cpu" engine: every step's answers equal numpy and
    the answers before the move (the smoke checks both itself), and the
    launch counts it returns are every kernel's, read in each step."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    # each query of a step empties the caches just before it runs: count
    # one "launch" of every kernel there, so that the totals show which
    # queries the returned counts were read over
    clear = chip_smoke.clear_serving_caches

    def clear_and_count():
        clear()
        for k in hk.LAUNCHES:
            hk.LAUNCHES[k] += 1

    monkeypatch.setattr(chip_smoke, "clear_serving_caches", clear_and_count)
    lifecycle, tier, fig = chip_smoke.lifecycle_path(hk, 1 << 16, "cpu", str(tmp_path))
    steps = fig["steps"]
    assert list(steps) == ["archive", "format", "backup", "tier", "mcp"]
    assert steps["archive"]["archived"] == ["seg-20231114", "seg-20231115"]
    assert steps["format"]["rewritten"] == 8
    assert steps["tier"]["shipped_parts"] == 2 and steps["tier"]["second_run_shipped"] == 0
    assert steps["tier"]["migrated"] == ["measure/sw/seg-20231114"]
    # CPU tensors take the kernels' plain versions and launch nothing: the
    # counts are the queries' own, 6 in each of 5 lifecycle steps (the MCP
    # step empties the caches before it resets the counts) and 3 in each of
    # the 3 stage-routed tier steps
    assert lifecycle == {k: 30 for k in hk.LAUNCHES}
    assert tier == {k: 9 for k in hk.LAUNCHES}
    assert steps["archive"]["fused_group_multi"] == [6, 6, 6]
