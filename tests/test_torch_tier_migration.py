"""The port's hot -> warm tier migration (``admin/tier_migration``)
against the JAX package's.

A hot and a warm ``DataNode`` (the port's on ``device="cpu"``) and a
liaison over ``LocalTransport``; group ``sw`` has ``shard_num=2``, day
segments and stages ``("hot", "warm")``.  ``TierMigrator`` seals the
expired day, ships its measure, stream and trace parts over the
``SYNC_PART`` chunked protocol and drops it from the hot node, and
queries naming ``stages=("warm",)`` then resolve to the warm node.

- **Mirrors** of the six tests of ``tests/test_tier_migration.py`` on the
  port: stage-routed queries after a migration, resume after a crash,
  merges frozen under the migrating marker, a late write shipped not
  lost, a second run ships nothing, an offline agent attaches on-disk
  groups.
- **Across the packages:** the same seeded rows through a JAX cluster
  and a port cluster give the same migration stats, the same stage-routed
  answers (``("warm",)``, ``("hot",)``, ``()``) and a byte-identical
  ``.tier-migration.json``, after a whole run and after an interrupted
  run and its resume.

Tolerance: exact (rows, counts, integer sums, file bytes).
"""

import types

import numpy as np
import pytest

from banyandb_tpu import api as japi
from banyandb_tpu import cluster as jcluster
from banyandb_tpu.admin import tier_migration as jtier
from banyandb_tpu.api import schema as jschema
from banyandb_tpu.cluster import rpc as jrpc
from banyandb_tpu.models import stream as jstream
from banyandb_tpu.models import trace as jtrace
from banyandb_tpu_torch import api as tapi
from banyandb_tpu_torch import cluster as tcluster
from banyandb_tpu_torch.admin import tier_migration as ttier
from banyandb_tpu_torch.api import schema as tschema
from banyandb_tpu_torch.cluster import rpc as trpc
from banyandb_tpu_torch.models import stream as tstream
from banyandb_tpu_torch.models import trace as ttrace

JAX = types.SimpleNamespace(
    name="jax", api=japi, schema=jschema, cluster=jcluster, rpc=jrpc, tier=jtier,
    stream=jstream, trace=jtrace, kw={},
)
PORT = types.SimpleNamespace(
    name="port", api=tapi, schema=tschema, cluster=tcluster, rpc=trpc, tier=ttier,
    stream=tstream, trace=ttrace, kw={"device": "cpu"},
)

DAY = 86_400_000
T_OLD = 1_700_006_400_000  # day-aligned: the expired window
T_NEW = T_OLD + 2 * DAY  # current window, stays hot
N_OLD, N_NEW = 120, 40


def _schema(pkg, reg):
    a, s = pkg.api, pkg.schema
    reg.create_group(a.Group(
        "sw", a.Catalog.MEASURE,
        a.ResourceOpts(shard_num=2, segment_interval=s.IntervalRule(1, "day"),
                       stages=("hot", "warm")),
    ))
    reg.create_measure(a.Measure(
        group="sw", name="cpm",
        tags=(a.TagSpec("svc", a.TagType.STRING),),
        fields=(a.FieldSpec("value", a.FieldType.INT),),
        entity=a.Entity(("svc",)),
    ))
    reg.create_stream(a.Stream(
        group="sw", name="logs",
        tags=(a.TagSpec("svc", a.TagType.STRING), a.TagSpec("level", a.TagType.STRING)),
        entity=("svc",),
    ))
    reg.create_trace(s.Trace(
        group="sw", name="spans",
        tags=(a.TagSpec("trace_id", a.TagType.STRING),
              a.TagSpec("duration", a.TagType.INT)),
        trace_id_tag="trace_id",
    ))


def _cluster(pkg, root):
    transport = pkg.rpc.LocalTransport()
    nodes, infos = {}, []
    for name in ("hot", "warm"):
        reg = pkg.api.SchemaRegistry(root / name)
        _schema(pkg, reg)
        dn = pkg.cluster.DataNode(name, reg, root / name / "data", **pkg.kw)
        nodes[name] = dn
        infos.append(pkg.cluster.NodeInfo(
            name, transport.register(name, dn.bus), stages=(name,)))
    lreg = pkg.api.SchemaRegistry(root / "l")
    _schema(pkg, lreg)
    liaison = pkg.cluster.Liaison(lreg, transport, infos)
    return types.SimpleNamespace(
        pkg=pkg, transport=transport, hot=nodes["hot"], warm=nodes["warm"],
        liaison=liaison, warm_addr=infos[1].addr,
    )


def _close(c):
    for dn in (c.hot, c.warm):
        dn.measure.close()
        dn.stream.close()
        dn.trace.close()


@pytest.fixture()
def cluster(tmp_path):
    c = _cluster(PORT, tmp_path)
    yield c
    _close(c)


def _values(seed, n):
    return np.random.default_rng(seed).integers(0, 1000, n)


def _ingest(c, seed=None):
    """The JAX test's rows (value = i) or, with a seed, seeded values."""
    a, hot = c.pkg.api, c.hot
    for t0, n, s in ((T_OLD, N_OLD, seed), (T_NEW, N_NEW, None if seed is None else seed + 1)):
        vals = range(n) if s is None else _values(s, n).tolist()
        hot.measure.write(a.WriteRequest("sw", "cpm", tuple(
            a.DataPointValue(t0 + i, {"svc": f"s{i % 3}"}, {"value": float(v)}, version=1)
            for i, v in enumerate(vals)
        )))
    hot.stream.write("sw", "logs", [
        c.pkg.stream.ElementValue(f"e{i}", T_OLD + i, {"svc": f"s{i % 3}", "level": "INFO"}, b"x")
        for i in range(N_OLD)
    ])
    hot.trace.write(
        "sw", "spans",
        [c.pkg.trace.SpanValue(T_OLD + t, {"trace_id": f"t{t}", "duration": 100 + t}, b"sp")
         for t in range(30)],
        ordered_tags=("duration",),
    )
    hot.measure.flush()
    hot.stream.flush()
    hot.trace.maintain()


def _measure_rows(c, stages, begin=T_OLD, end=T_NEW + DAY):
    a = c.pkg.api
    res = c.liaison.query_measure(a.QueryRequest(
        ("sw",), "cpm", a.TimeRange(begin, end),
        tag_projection=("svc",), field_projection=("value",),
        limit=1000, stages=stages,
    ))
    return sorted(dp["fields"]["value"] for dp in res.data_points)


def _sums(c, stages):
    """count and sum of value by svc through the liaison."""
    a = c.pkg.api
    res = c.liaison.query_measure(a.QueryRequest(
        ("sw",), "cpm", a.TimeRange(T_OLD, T_NEW + DAY),
        group_by=a.GroupBy(("svc",)), agg=a.Aggregation("sum", "value"),
        stages=stages,
    ))
    return sorted(zip(res.groups, res.values["count"], res.values["sum(value)"]))


class FlakyTransport:
    """Fails the Nth SYNC_PART finish, simulating a mid-run crash."""

    def __init__(self, inner, fail_after):
        self.inner = inner
        self.calls = 0
        self.fail_after = fail_after

    def call(self, addr, topic, env, timeout=30.0):
        if topic == "sync-part" and env.get("phase") == "finish":
            self.calls += 1
            if self.calls == self.fail_after:
                raise ConnectionError("injected mid-migration crash")
        return self.inner.call(addr, topic, env, timeout=timeout)


# -- mirrors of tests/test_tier_migration.py -------------------------------------


def test_migrate_then_stage_routed_queries(cluster):
    c = cluster
    _ingest(c)
    stats = ttier.TierMigrator(c.hot, c.transport, c.warm_addr).run(T_OLD + DAY)
    assert stats["shipped_parts"] > 0
    assert len(stats["migrated_segments"]) == 3  # measure + stream + trace

    assert all(seg.start != T_OLD for seg in c.hot.measure._tsdbs["sw"].segments)
    assert _measure_rows(c, ("warm",)) == [float(i) for i in range(N_OLD)]
    assert _measure_rows(c, ("hot",)) == [float(i) for i in range(N_NEW)]
    assert len(_measure_rows(c, ())) == N_OLD + N_NEW

    a = tapi
    sres = c.liaison.query_stream(a.QueryRequest(
        ("sw",), "logs", a.TimeRange(T_OLD, T_OLD + DAY), limit=1000, stages=("warm",)))
    assert len(sres.data_points) == N_OLD
    assert {dp["element_id"] for dp in sres.data_points} == {f"e{i}" for i in range(N_OLD)}

    got = c.liaison.query_trace_ordered(
        "sw", "spans", "duration", a.TimeRange(T_OLD, T_OLD + DAY),
        limit=5, stages=("warm",),
    )
    assert got == ["t29", "t28", "t27", "t26", "t25"]


def test_migration_resumes_after_failure(cluster):
    c = cluster
    _ingest(c)
    flaky = FlakyTransport(c.transport, fail_after=2)
    with pytest.raises(ConnectionError):
        ttier.TierMigrator(c.hot, flaky, c.warm_addr).run(T_OLD + DAY)
    resumed = ttier.TierMigrator(c.hot, c.transport, c.warm_addr).run(T_OLD + DAY)
    assert resumed["resumed"] >= 1  # progress file skipped re-ships
    assert len(resumed["migrated_segments"]) == 3
    assert _measure_rows(c, ("warm",)) == [float(i) for i in range(N_OLD)]


def test_merges_frozen_while_migrating(cluster):
    from banyandb_tpu_torch.storage.loops import LifecycleLoops
    from banyandb_tpu_torch.storage.tsdb import MIGRATING_MARKER

    c = cluster
    _ingest(c)
    c.hot.measure.flush()
    c.hot.measure.flush()
    db = c.hot.measure._tsdbs["sw"]
    seg = next(s for s in db.segments if s.start == T_OLD)
    (seg.root / MIGRATING_MARKER).touch()
    loops = LifecycleLoops(lambda: [db])
    assert sum(loops.merge_shard(sh) for sh in seg.shards) == 0
    (seg.root / MIGRATING_MARKER).unlink()


def test_late_write_during_migration_is_shipped_not_lost(cluster):
    c = cluster
    _ingest(c)
    a = tapi

    class LateWriteTransport:
        def __init__(self, inner):
            self.inner = inner
            self.fired = False

        def call(self, addr, topic, env, timeout=30.0):
            if topic == "sync-part" and env.get("phase") == "finish" and not self.fired:
                self.fired = True
                c.hot.measure.write(a.WriteRequest("sw", "cpm", (
                    a.DataPointValue(T_OLD + 99_999, {"svc": "late"},
                                     {"value": 777.0}, version=1),
                )))
            return self.inner.call(addr, topic, env, timeout=timeout)

    lt = LateWriteTransport(c.transport)
    stats = ttier.TierMigrator(c.hot, lt, c.warm_addr).run(T_OLD + DAY)
    assert lt.fired
    rows = _measure_rows(c, ("warm",))
    assert rows == sorted([float(i) for i in range(N_OLD)] + [777.0])
    assert stats["shipped_parts"] >= 2


def test_migration_is_idempotent_when_nothing_expired(cluster):
    c = cluster
    _ingest(c)
    m = ttier.TierMigrator(c.hot, c.transport, c.warm_addr)
    m.run(T_OLD + DAY)
    assert m.run(T_OLD + DAY)["shipped_parts"] == 0
    assert _measure_rows(c, ("warm",)) == [float(i) for i in range(N_OLD)]


def test_offline_agent_attaches_disk_groups(cluster):
    c = cluster
    _ingest(c)
    reg = tapi.SchemaRegistry(c.hot.root.parent)
    cold_open = tcluster.DataNode("agent", reg, c.hot.root, device="cpu")
    assert cold_open.measure._tsdbs == {}  # lazy: nothing attached yet
    stats = ttier.TierMigrator(cold_open, c.transport, c.warm_addr).run(T_OLD + DAY)
    assert len(stats["migrated_segments"]) == 3
    assert _measure_rows(c, ("warm",)) == [float(i) for i in range(N_OLD)]
    cold_open.measure.close()
    cold_open.stream.close()
    cold_open.trace.close()


# -- across the packages -----------------------------------------------------------


def _progress(c) -> bytes:
    return (c.hot.root / ttier.PROGRESS_FILE).read_bytes()


@pytest.mark.parametrize("interrupted", [False, True], ids=["whole", "resumed"])
def test_jax_and_port_clusters_migrate_alike(tmp_path, interrupted):
    """Seeded rows through a JAX and a port cluster: the same stats, the
    same stage-routed answers and the same progress file bytes (after
    the crash too, when interrupted)."""
    got = {}
    for pkg in (JAX, PORT):
        c = _cluster(pkg, tmp_path / pkg.name)
        try:
            _ingest(c, seed=11)
            out = {"before": [_sums(c, st) for st in (("hot",), ())]}
            if interrupted:
                with pytest.raises(ConnectionError):
                    pkg.tier.TierMigrator(
                        c.hot, FlakyTransport(c.transport, 2), c.warm_addr,
                    ).run(T_OLD + DAY)
                out["crash progress"] = _progress(c)
            out["stats"] = pkg.tier.TierMigrator(
                c.hot, c.transport, c.warm_addr).run(T_OLD + DAY)
            out["progress"] = _progress(c)
            out["after"] = [_sums(c, st) for st in (("warm",), ("hot",), ())]
            out["again"] = pkg.tier.TierMigrator(
                c.hot, c.transport, c.warm_addr).run(T_OLD + DAY)["shipped_parts"]
            got[pkg.name] = out
        finally:
            _close(c)
    j, t = got["jax"], got["port"]
    assert j == t
    # stage-less answers are the same before and after the move, and the
    # warm and hot tiers split them by day
    assert t["after"][2] == t["before"][1]
    old, new = _values(11, N_OLD), _values(12, N_NEW)
    for sums, vals, n in ((t["after"][0], old, N_OLD), (t["after"][1], new, N_NEW)):
        want = sorted(((f"s{k}",), float(len(range(k, n, 3))), float(vals[k::3].sum()))
                      for k in range(3))
        assert sums == want
    assert t["again"] == 0
    if interrupted:
        assert t["stats"]["resumed"] >= 1
        assert b'"measure/sw/seg-20231115/shard-0/part-' in t["crash progress"]
    else:
        assert t["stats"]["resumed"] == 0
