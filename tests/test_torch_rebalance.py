"""The port's elastic cluster against the JAX package's.

``banyandb_tpu_torch/cluster/rebalance.py`` moves shards between the
port's data nodes under live ingest (``Rebalancer.plan``/``apply``:
dual-route window, bulk and delta ship rounds over ``Topic.SYNC_PART``,
cutover with epoch + 1, epoch broadcast) and converges replicas
(``ReplicaRepairer.run_once``).  This file mirrors
``tests/test_rebalance.py`` on the port (its streaming-ship fence test
needs the gRPC chunked sync and waits for that slice), each cluster of
``DataNode(device="cpu")`` over ``LocalTransport`` beside the same JAX
cluster fed the same writes:

- the plans equal the JAX ``plan_rebalance``'s on the golden topologies;
- a stale plan is refused and leaves no dual route open;
- a live move under ingest answers byte-identical to the JAX cluster's
  before, during and after the move, with the epoch bumped on every node;
- a mid-move re-ship is a digest-dedup no-op;
- repair converges after a replica is wiped;
- read failover walks the whole chain, and degrades once it is gone;
- a placement map and epoch record that either package persisted load
  in the other's liaison and data nodes.

Counts are exact, so every comparison is byte equality of the result
JSON (``server.result_to_json``, keys sorted).
"""

from __future__ import annotations

import json
import types

import pytest

import banyandb_tpu.api as japi
import banyandb_tpu.cluster as jcluster
import banyandb_tpu.cluster.placement as jplacement
import banyandb_tpu.cluster.rebalance as jrebalance
import banyandb_tpu.cluster.rpc as jrpc
import banyandb_tpu.server as jserver
import banyandb_tpu_torch.api as tapi
import banyandb_tpu_torch.cluster as tcluster
import banyandb_tpu_torch.cluster.placement as tplacement
import banyandb_tpu_torch.cluster.rebalance as trebalance
import banyandb_tpu_torch.cluster.rpc as trpc
import banyandb_tpu_torch.server as tserver

T0 = 1_700_000_000_000

JAX = types.SimpleNamespace(
    name="jax", api=japi, cluster=jcluster, placement=jplacement,
    rebalance=jrebalance, rpc=jrpc, result_to_json=jserver.result_to_json, dn_kw={},
)
PORT = types.SimpleNamespace(
    name="port", api=tapi, cluster=tcluster, placement=tplacement,
    rebalance=trebalance, rpc=trpc, result_to_json=tserver.result_to_json,
    dn_kw={"device": "cpu"},
)


def _schema(pkg, reg, shard_num=4, replicas=0):
    a = pkg.api
    reg.create_group(a.Group("sw", a.Catalog.MEASURE,
                             a.ResourceOpts(shard_num=shard_num, replicas=replicas)))
    reg.create_measure(a.Measure(
        group="sw", name="cpm", tags=(a.TagSpec("svc", a.TagType.STRING),),
        fields=(a.FieldSpec("v", a.FieldType.FLOAT),), entity=a.Entity(("svc",)),
    ))


def _points(pkg, base, n, mod=16):
    return tuple(
        pkg.api.DataPointValue(ts_millis=T0 + base + i, tags={"svc": f"s{(base + i) % mod}"},
                               fields={"v": 1.0}, version=1)
        for i in range(n)
    )


def _write(pkg, liaison, base, n) -> int:
    return liaison.write_measure(pkg.api.WriteRequest("sw", "cpm", _points(pkg, base, n)))


def _count_req(pkg, trace=False):
    a = pkg.api
    return a.QueryRequest(
        groups=("sw",), name="cpm", time_range=a.TimeRange(T0, T0 + 50_000_000),
        group_by=a.GroupBy(("svc",)), agg=a.Aggregation("count", "v"), trace=trace,
    )


def _total(res) -> int:
    return int(sum(res.values.get("count", [])))


def _bytes(pkg, res) -> str:
    return json.dumps(pkg.result_to_json(res), sort_keys=True)


def _node(pkg, root, name, shard_num, replicas):
    reg = pkg.api.SchemaRegistry(root / name)
    _schema(pkg, reg, shard_num, replicas)
    return pkg.cluster.DataNode(name, reg, root / name / "data", **pkg.dn_kw)


def _cluster(pkg, root, n_nodes=2, shard_num=4, replicas=0, store=None):
    transport = pkg.rpc.LocalTransport()
    nodes, datanodes = [], {}
    for i in range(n_nodes):
        dn = _node(pkg, root, f"n{i}", shard_num, replicas)
        nodes.append(pkg.cluster.NodeInfo(dn.name, transport.register(dn.name, dn.bus)))
        datanodes[dn.name] = dn
    lreg = pkg.api.SchemaRegistry(root / "liaison")
    _schema(pkg, lreg, shard_num, replicas)
    liaison = pkg.cluster.Liaison(lreg, transport, nodes, replicas=replicas,
                                  placement_store=store)
    return transport, liaison, datanodes


def _add_node(pkg, root, transport, liaison, name, shard_num=4, replicas=0):
    """Join a fresh node: register its bus and widen the addr book the
    way refresh_nodes would (without re-placing)."""
    dn = _node(pkg, root, name, shard_num, replicas)
    addr = transport.register(name, dn.bus)
    nodes = list(liaison.selector.nodes) + [pkg.cluster.NodeInfo(name, addr)]
    with liaison._placement_lock:
        liaison.selector = pkg.placement.PlacementSelector(nodes, liaison.placement)
    liaison.probe()
    return dn


def _close(datanodes):
    for dn in datanodes.values():
        dn.measure.close()
        dn.stream.close()
        dn.trace.close()


# -- plans ---------------------------------------------------------------------

TOPOLOGIES = {
    # name: (nodes, replicas, target, num_shards, replicas override)
    "join 3 -> 4, replicas 1": (["n0", "n1", "n2"], 1, ["n0", "n1", "n2", "n3"], 8, None),
    "stable target": (["n0", "n1", "n2"], 1, ["n0", "n1", "n2"], 6, None),
    "join 2 -> 3, replicas 0": (["n0", "n1"], 0, ["n0", "n1", "n2"], 4, None),
    "leave 4 -> 3, replicas 2": (["a", "b", "c", "d"], 2, ["a", "b", "d"], 9, None),
    "replicas raised 0 -> 1": (["n0", "n1", "n2"], 0, ["n0", "n1", "n2"], 6, 1),
    "shrink to one node": (["n0", "n1", "n2"], 1, ["n1"], 5, None),
}


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_plans_equal_jax_on_golden_topologies(topo):
    nodes, replicas, target, num_shards, override = TOPOLOGIES[topo]
    plans = [
        pkg.rebalance.plan_rebalance(
            pkg.placement.PlacementMap.initial(nodes, replicas), target,
            num_shards=num_shards, replicas=override,
        )
        for pkg in (JAX, PORT)
    ]
    assert plans[1].to_json() == plans[0].to_json()
    assert trebalance.RebalancePlan.from_json(plans[1].to_json()) == plans[1]
    assert plans[1].placement().to_json() == plans[0].placement().to_json()


def test_plan_golden_three_to_four_nodes():
    pm = tplacement.PlacementMap.initial(["n0", "n1", "n2"], replicas=1)
    plan = trebalance.plan_rebalance(pm, ["n0", "n1", "n2", "n3"], num_shards=8)
    assert plan.base_epoch == 1 and plan.new_epoch == 2
    assert plan.chains == (
        ("n0", "n3"), ("n1", "n3"), ("n2", "n3"), ("n0", "n3"),
        ("n1", "n2"), ("n2", "n0"), ("n0", "n1"), ("n1", "n2"),
    )
    moves = {m.shard: m for m in plan.moves}
    assert sorted(moves) == [0, 1, 2, 3]
    assert all(m.add == ("n3",) for m in plan.moves)
    assert [moves[s].remove for s in range(4)] == [("n1",), ("n2",), ("n0",), ("n1",)]


def test_apply_refuses_stale_plan(tmp_path):
    transport, liaison, datanodes = _cluster(PORT, tmp_path, n_nodes=2)
    try:
        reb = trebalance.Rebalancer(liaison)
        plan = reb.plan(["n0"])
        other = reb.plan(["n0", "n1"])
        # a concurrent cutover bumps the epoch under the plan
        liaison.cutover(trebalance.RebalancePlan(
            base_epoch=1, target_nodes=other.target_nodes, replicas=0, chains=other.chains))
        with pytest.raises(RuntimeError, match="stale plan"):
            reb.apply(plan)
        assert not liaison.dual_route_shards()
        assert reb.status()["last_apply"].get("ok") is None
    finally:
        _close(datanodes)


# -- live rebalance --------------------------------------------------------------


def _live_move(pkg, root):
    """Ingest, join n2, move under ingest; -> (answers before, during,
    after the move; the stats; the cluster)."""
    transport, liaison, datanodes = _cluster(pkg, root, n_nodes=2, replicas=0)
    acked = _write(pkg, liaison, 0, 200)
    before = _bytes(pkg, liaison.query_measure(_count_req(pkg)))
    datanodes["n2"] = _add_node(pkg, root, transport, liaison, "n2")
    reb = pkg.rebalance.Rebalancer(liaison)
    plan = reb.plan()  # target = addr book = n0, n1, n2
    assert plan.moves, "join produced no moves"
    during = []

    def mid_move():
        # ingest DURING the catch-up window: dual-routed to old + new
        assert liaison.dual_route_shards(), "window not open mid-move"
        during.append(_write(pkg, liaison, acked, 60))
        during.append(_bytes(pkg, liaison.query_measure(_count_req(pkg))))

    stats = reb.apply(plan, mid_move=mid_move)
    after = _bytes(pkg, liaison.query_measure(_count_req(pkg)))
    return (before, during, after), stats, (transport, liaison, datanodes), plan


def test_live_rebalance_matches_jax_before_during_after(tmp_path):
    answers, clusters = {}, {}
    try:
        for pkg in (JAX, PORT):
            answers[pkg.name], stats, clusters[pkg.name], plan = _live_move(
                pkg, tmp_path / pkg.name)
            assert stats["ok"] and stats["parts_moved"] > 0, stats
            answers[pkg.name + " plan"] = plan.to_json()
        assert answers["port plan"] == answers["jax plan"]
        assert answers["port"] == answers["jax"], "port replies differ from the JAX cluster's"
        before, during, after = answers["port"]
        assert json.loads(before)["groups"], "vacuous answer"
        transport, liaison, datanodes = clusters["port"]
        assert liaison.placement.epoch == 2
        assert not liaison.dual_route_shards()
        # every node is fenced at the new epoch, the joiner included
        assert {dn.name: dn.epoch_record.epoch for dn in datanodes.values()} == {
            "n0": 2, "n1": 2, "n2": 2}
        # zero acked loss: the 200 before and the 60 during the window
        res = liaison.query_measure(_count_req(PORT))
        assert not res.degraded and _total(res) == 260
        want = {f"s{k}": sum(1 for i in range(260) if i % 16 == k) for k in range(16)}
        assert {g[0]: int(v) for g, v in zip(res.groups, res.values["count"])} == want
        # the new owner serves its shards: drop it and the query degrades
        transport.unregister("n2")
        liaison.probe()
        res = liaison.query_measure(_count_req(PORT))
        assert res.degraded and "n2" in res.unavailable_nodes
    finally:
        for _t, _l, datanodes in clusters.values():
            _close(datanodes)


def test_midmove_reship_is_digest_dedup_noop(tmp_path):
    transport, liaison, datanodes = _cluster(PORT, tmp_path, n_nodes=1, shard_num=2)
    try:
        _write(PORT, liaison, 0, 100)
        datanodes["n0"].measure.flush()
        datanodes["nx"] = _add_node(PORT, tmp_path, transport, liaison, "nx", shard_num=2)
        src = liaison.selector.node_by_name("n0")
        dst = liaison.selector.node_by_name("nx")
        moved = 0
        for shard in range(2):
            for entry in trebalance.shard_manifest(transport, src, shard)[0].values():
                assert trebalance.ship_part(transport, src, dst, entry, epoch=1) == "moved"
                # the re-ship after a "crash": byte-identical, deduped
                assert trebalance.ship_part(transport, src, dst, entry, epoch=1) == "deduped"
                moved += 1
        assert moved > 0
        for shard in range(2):
            src_keys = set(trebalance.shard_manifest(transport, src, shard)[0])
            dst_keys = set(trebalance.shard_manifest(transport, dst, shard)[0])
            assert src_keys <= dst_keys
        assert _total(datanodes["nx"].measure.query(_count_req(PORT))) == 100
    finally:
        _close(datanodes)


# -- replica repair ----------------------------------------------------------------


def test_repair_converges_after_replica_wipe(tmp_path):
    transport, liaison, datanodes = _cluster(
        PORT, tmp_path, n_nodes=3, shard_num=3, replicas=1)
    try:
        acked = _write(PORT, liaison, 0, 300)
        for dn in datanodes.values():
            dn.measure.flush()
        full = _bytes(PORT, liaison.query_measure(_count_req(PORT)))
        # the outage: n1 gone; every shard still answers from a replica
        transport.unregister("n1")
        res = liaison.query_measure(_count_req(PORT))
        assert not res.degraded and _bytes(PORT, res) == full
        # "restored from loss": same name and addr, an EMPTY root
        old = datanodes["n1"]
        datanodes["n1"] = tcluster.DataNode(
            "n1", old.registry, tmp_path / "n1-restored" / "data", device="cpu")
        _close({"n1": old})
        transport.register("n1", datanodes["n1"].bus)
        liaison.probe()
        rep = trebalance.ReplicaRepairer(liaison)
        stats = rep.run_once()
        assert stats["parts_shipped"] > 0 and stats["errors"] == 0, stats
        for shard in range(3):
            keys = [
                set(trebalance.shard_manifest(
                    transport, liaison.selector.node_by_name(nm), shard)[0])
                for nm in liaison.placement.chain(shard)
            ]
            assert keys[0] == keys[1], f"shard {shard} diverged after repair"
        assert rep.run_once()["parts_shipped"] == 0
        # the restored replica serves alone what it holds a replica of
        transport.unregister("n0")
        transport.unregister("n2")
        liaison.probe()
        res = liaison.query_measure(_count_req(PORT))
        assert res.degraded and 0 < _total(res) < acked
    finally:
        _close(datanodes)


# -- read failover -------------------------------------------------------------------


def test_multi_round_failover_walks_whole_chain(tmp_path):
    from banyandb_tpu_torch.obs.metrics import global_meter

    transport, liaison, datanodes = _cluster(
        PORT, tmp_path, n_nodes=4, shard_num=1, replicas=2)
    try:
        acked = _write(PORT, liaison, 0, 240)
        assert _total(liaison.query_measure(_count_req(PORT))) == acked
        # primary and first replica die without a probe: the one leg
        # fails live and must fail over round after round
        transport.unregister("n0")
        transport.unregister("n1")
        key = ("failover_attempts", ())
        before = global_meter().snapshot()["counters"].get(key, 0.0)
        res = liaison.query_measure(_count_req(PORT, trace=True))
        after = global_meter().snapshot()["counters"].get(key, 0.0)
        assert not res.degraded, res.unavailable_nodes
        assert _total(res) == acked
        assert after - before >= 2, "expected at least two failover rounds"

        def attempts(node):
            own = [node["tags"]["attempt"]] if (node.get("tags") or {}).get("attempt") else []
            return own + [a for c in node.get("children", ()) for a in attempts(c)]

        assert attempts((res.trace or {}).get("span_tree") or {})
    finally:
        _close(datanodes)


def test_failover_degrades_after_chain_exhausted_like_jax(tmp_path):
    out = {}
    clusters = []
    try:
        for pkg in (JAX, PORT):
            transport, liaison, datanodes = _cluster(
                pkg, tmp_path / pkg.name, n_nodes=3, shard_num=3, replicas=1)
            clusters.append(datanodes)
            acked = _write(pkg, liaison, 0, 120)
            transport.unregister("n0")
            transport.unregister("n1")
            res = liaison.query_measure(_count_req(pkg))
            assert res.degraded and set(res.unavailable_nodes) & {"n0", "n1"}
            assert 0 < _total(res) < acked
            out[pkg.name] = _bytes(pkg, res)
        assert out["port"] == out["jax"]
    finally:
        for datanodes in clusters:
            _close(datanodes)


# -- placement state across packages -----------------------------------------------


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_placement_store_and_epoch_records_cross_packages(tmp_path, writer, reader):
    """One package's Rebalancer cuts over and persists the placement map
    (the liaison's store) and the nodes' epoch records; the other
    package's liaison and data nodes, opened over the same files, load
    the same map and epochs and answer the same bytes."""
    store = tmp_path / "placement.json"
    transport, liaison, datanodes = _cluster(writer, tmp_path, n_nodes=2, store=store)
    try:
        _write(writer, liaison, 0, 200)
        datanodes["n2"] = _add_node(writer, tmp_path, transport, liaison, "n2")
        reb = writer.rebalance.Rebalancer(liaison)
        assert reb.apply(reb.plan())["ok"]
        for dn in datanodes.values():
            dn.measure.flush()
        want = _bytes(writer, liaison.query_measure(_count_req(writer)))
        written = liaison.placement.to_json()
    finally:
        _close(datanodes)
    assert written["epoch"] == 2 and written["chains"]
    rtransport = reader.rpc.LocalTransport()
    nodes, rnodes = [], {}
    try:
        for name in ("n0", "n1", "n2"):
            reg = reader.api.SchemaRegistry(tmp_path / name)
            dn = reader.cluster.DataNode(name, reg, tmp_path / name / "data", **reader.dn_kw)
            rnodes[name] = dn
            assert dn.epoch_record.epoch == 2, f"{name} lost its epoch record"
            nodes.append(reader.cluster.NodeInfo(name, rtransport.register(name, dn.bus)))
        lreg = reader.api.SchemaRegistry(tmp_path / "liaison")
        rl = reader.cluster.Liaison(lreg, rtransport, nodes, placement_store=store)
        assert rl.placement.to_json() == written
        assert _bytes(reader, rl.query_measure(_count_req(reader))) == want
        # the reader fences at the loaded epoch: a write goes through
        assert _write(reader, rl, 200, 16) == 16
    finally:
        _close(rnodes)
