"""Chaos harness: sustained write+query load under data-node kills and a
deterministic fault schedule (docs/robustness.md).

Modes:

  --smoke        in-process, five phases: (A) liaison write-queue replay
                 across THREE data-node kill/restart cycles over the
                 real chunked-sync wire, (B) graceful query degradation
                 with explicit ``degraded`` / ``unavailable_nodes``
                 markers and the per-query deadline bound, (C) a seeded
                 BYDB_FAULTS schedule (rpc/sync/disk boundaries) under
                 which ingest still converges with zero acked loss,
                 (D) shard-worker SIGKILL cycles under ingest, (E) a
                 live rebalance whose part source is killed mid-move.

  --soak SECONDS real subprocess cluster (``python -m
                 banyandb_tpu_torch.server`` per role), SIGKILL
                 kill/restart cycles under sustained write+query load;
                 one double-kill window forces degraded responses.

Invariants asserted in both modes:

  1. zero acked-write loss — every acked row is queryable after
     recovery (acked = the write call returned success);
  2. no query runs past its deadline budget (+ scheduling slack);
  3. responses during partial outages carry explicit ``degraded`` +
     ``unavailable_nodes`` markers — partial must never look complete.

Data nodes, shard workers and data-role children run on ``--device``:
CUDA by default, the CPU only when asked for.

Usage:
    python -m banyandb_tpu_torch.harness.chaos --smoke [--seed N] [--device cpu]
    python -m banyandb_tpu_torch.harness.chaos --soak 120 [--seed N] \
        [--artifact out.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from banyandb_tpu_torch.backend import resolve_device
from banyandb_tpu_torch.harness import env_scope

# the checkout's root: the soak's children import the package from it
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T0 = 1_700_000_000_000


# -- shared bits -------------------------------------------------------------


def _schema(reg, group="cg", shard_num=3):
    from banyandb_tpu_torch.api import (
        Catalog,
        Entity,
        FieldSpec,
        FieldType,
        Group,
        Measure,
        ResourceOpts,
        TagSpec,
        TagType,
    )

    reg.create_group(Group(group, Catalog.MEASURE, ResourceOpts(shard_num=shard_num)))
    reg.create_measure(
        Measure(
            group=group, name="m",
            tags=(TagSpec("svc", TagType.STRING),),
            fields=(FieldSpec("v", FieldType.FLOAT),),
            entity=Entity(("svc",)),
        )
    )


def _points(base: int, n: int, mod: int = 8):
    from banyandb_tpu_torch.api import DataPointValue

    return tuple(
        DataPointValue(
            ts_millis=T0 + base + i,
            tags={"svc": f"s{(base + i) % mod}"},
            fields={"v": 1.0},
            version=1,
        )
        for i in range(n)
    )


def _count_req(trace=False):
    from banyandb_tpu_torch.api import (
        Aggregation,
        GroupBy,
        QueryRequest,
        TimeRange,
    )

    return QueryRequest(
        groups=("cg",), name="m",
        time_range=TimeRange(T0, T0 + 50_000_000),
        group_by=GroupBy(("svc",)),
        agg=Aggregation("count", "v"),
        trace=trace,
    )


def _total(res) -> int:
    return int(sum(res.values.get("count", [])))


def _bind_server(bus, port, sync_install=None, attempts=40):
    """GrpcBusServer on a FIXED port, retrying while the previous
    incarnation's socket drains (restart-on-same-port, the address every
    cached liaison channel and discovery entry still points at)."""
    from banyandb_tpu_torch.cluster.rpc import GrpcBusServer

    for i in range(attempts):
        srv = GrpcBusServer(bus, port=port, sync_install=sync_install)
        if srv.port == port or port == 0:
            srv.start()
            return srv
        srv.stop(grace=0)
        time.sleep(0.1)
    raise RuntimeError(f"could not rebind port {port}")


def _retrying(fn, attempts: int, pause_s: float = 0.01):
    """fn() until it returns: a transport or disk rejection (an injected
    fault) is retried after `pause_s`, `attempts` calls in all.  -> fn's
    result, or None when every call was rejected."""
    from banyandb_tpu_torch.cluster.rpc import TransportError

    for _attempt in range(attempts):
        try:
            return fn()
        except (TransportError, OSError):
            time.sleep(pause_s)
            continue  # the retry
    return None


# -- smoke scenario A: wqueue replay across kill/restart cycles --------------


def _smoke_wqueue_cycles(tmp, budget_s: float, stats: dict, device) -> None:
    from banyandb_tpu_torch.api import SchemaRegistry, WriteRequest
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import GrpcTransport

    nodes, servers, ports = [], {}, {}
    for i in range(2):
        reg = SchemaRegistry(tmp / f"a-n{i}" / "schema")
        _schema(reg, shard_num=2)
        dn = DataNode(f"n{i}", reg, tmp / f"a-n{i}" / "data", device=device)
        srv = _bind_server(dn.bus, 0, sync_install=dn.install_synced_parts)
        servers[f"n{i}"] = (dn, srv)
        ports[f"n{i}"] = srv.port
        nodes.append(NodeInfo(f"n{i}", srv.addr))

    lreg = SchemaRegistry(tmp / "a-liaison" / "schema")
    _schema(lreg, shard_num=2)
    transport = GrpcTransport()
    liaison = Liaison(
        lreg, transport, nodes, replicas=1, query_budget_s=budget_s
    )
    liaison.probe()
    wq = liaison.enable_write_queue(
        tmp / "a-liaison" / "wqueue", flush_interval_s=30.0,
        retry_base_s=0.01,
    )
    acked = 0

    def write(n=120):
        nonlocal acked
        acked += liaison.write_measure_queued(
            WriteRequest("cg", "m", _points(acked, n))
        )

    def query_total() -> int:
        t0 = time.perf_counter()
        res = liaison.query_measure(_count_req())
        wall = time.perf_counter() - t0
        stats["max_query_wall_s"] = max(stats["max_query_wall_s"], wall)
        assert wall <= budget_s + 1.0, f"query ran {wall:.2f}s past budget"
        assert not res.degraded, "replicated cluster must not degrade"
        return _total(res)

    def drain(deadline_s=20.0):
        end = time.monotonic() + deadline_s
        while time.monotonic() < end:
            liaison.probe()  # the production probe loop runs periodically
            wq.flush(force=True)
            if wq.pending_parts() == 0:
                return
            time.sleep(0.05)
        raise AssertionError(
            f"wqueue never drained: {wq.pending_parts()} parts pending"
        )

    try:
        write()
        drain()
        assert query_total() == acked

        for cycle in range(3):
            victim = f"n{cycle % 2}"
            dn, srv = servers[victim]
            srv.stop(grace=0)  # the "kill": node unreachable, state kept
            write()            # acked into the spool-backed queue
            wq.flush(force=True)  # ships to the survivor, victim pends
            # acked rows stay queryable from the survivor mid-outage
            assert query_total() == acked, "acked rows lost mid-outage"
            # restart on the SAME port (discovery addresses are stable)
            srv2 = _bind_server(
                dn.bus, ports[victim], sync_install=dn.install_synced_parts
            )
            servers[victim] = (dn, srv2)
            liaison.probe()
            drain()  # re-ship: delivered.json + part uuid keep it single
            assert query_total() == acked, (
                f"cycle {cycle}: {query_total()} != acked {acked}"
            )
            stats["kill_cycles"] += 1
    finally:
        wq.stop(final_flush=False)
        transport.close()
        for dn, srv in servers.values():
            srv.stop(grace=0)
            dn.measure.close()
            dn.stream.close()
            dn.trace.close()
    stats["acked_a"] = acked


# -- smoke scenario B: graceful degradation + deadline -----------------------


def _smoke_degradation(tmp, budget_s: float, stats: dict, device) -> None:
    from banyandb_tpu_torch.api import SchemaRegistry, WriteRequest
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport
    from banyandb_tpu_torch.obs.metrics import global_meter

    transport = LocalTransport()
    dns, infos = {}, []
    for i in range(3):
        reg = SchemaRegistry(tmp / f"b-n{i}" / "schema")
        _schema(reg)
        dn = DataNode(f"n{i}", reg, tmp / f"b-n{i}" / "data", device=device)
        dns[f"n{i}"] = dn
        infos.append(NodeInfo(f"n{i}", transport.register(f"n{i}", dn.bus)))
    lreg = SchemaRegistry(tmp / "b-liaison" / "schema")
    _schema(lreg)
    # replicas=0: every shard lives on exactly one node — losing a node
    # MUST degrade (not fail) queries, naming the unavailable node
    liaison = Liaison(lreg, transport, infos, replicas=0,
                      query_budget_s=budget_s)
    liaison.probe()

    total = 240
    liaison.write_measure(WriteRequest("cg", "m", _points(0, total)))
    for dn in dns.values():
        dn.measure.flush()

    res = liaison.query_measure(_count_req())
    assert _total(res) == total and not res.degraded

    before = global_meter().snapshot()["counters"].get(
        ("query_degraded", (("engine", "measure"),)), 0.0
    )
    transport.unregister("n1")  # mid-query node loss (probe not yet run)
    t0 = time.perf_counter()
    res = liaison.query_measure(_count_req(trace=True))
    wall = time.perf_counter() - t0
    stats["max_query_wall_s"] = max(stats["max_query_wall_s"], wall)
    assert wall <= budget_s + 1.0, f"degraded query ran {wall:.2f}s"
    assert res.degraded, "partial answer not marked degraded"
    assert res.unavailable_nodes == ["n1"], res.unavailable_nodes
    assert 0 < _total(res) < total, "degraded result should be partial"
    after = global_meter().snapshot()["counters"].get(
        ("query_degraded", (("engine", "measure"),)), 0.0
    )
    assert after > before, "query_degraded_total did not move"
    stats["degraded_seen"] += 1

    # recovery: node re-registers, probe restores, result completes
    transport.register("n1", dns["n1"].bus)
    liaison.probe()
    res = liaison.query_measure(_count_req())
    assert _total(res) == total and not res.degraded
    for dn in dns.values():
        dn.measure.close()
        dn.stream.close()
        dn.trace.close()


# -- smoke scenario C: seeded fault schedule under ingest --------------------


def _smoke_fault_schedule(tmp, seed: int, stats: dict, device) -> None:
    from banyandb_tpu_torch.api import SchemaRegistry, WriteRequest
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo, faults
    from banyandb_tpu_torch.cluster.rpc import GrpcTransport, TransportError

    spec = (
        f"seed={seed};"
        "rpc=delay:p=0.2:ms=5;rpc=error:every=17:after=5;"
        "sync=corrupt:every=9:count=2;"
        "disk=enospc:every=7:after=1:count=2"
    )
    plane = faults.configure(spec)
    reg = SchemaRegistry(tmp / "c-n0" / "schema")
    _schema(reg, shard_num=2)
    dn = DataNode("n0", reg, tmp / "c-n0" / "data", device=device)
    srv = _bind_server(dn.bus, 0, sync_install=dn.install_synced_parts)
    lreg = SchemaRegistry(tmp / "c-liaison" / "schema")
    _schema(lreg, shard_num=2)
    transport = GrpcTransport()
    liaison = Liaison(lreg, transport, [NodeInfo("n0", srv.addr)])
    liaison.probe()
    wq = liaison.enable_write_queue(
        tmp / "c-liaison" / "wqueue", flush_interval_s=30.0,
        retry_base_s=0.01,
    )
    acked = 0
    try:
        for _ in range(6):
            # the rpc/disk boundaries may reject an append (shed) or a
            # seal (ENOSPC) — the caller retries; acked = returned count
            acked += _retrying(
                lambda: liaison.write_measure_queued(
                    WriteRequest("cg", "m", _points(acked, 40))
                ),
                attempts=20,
            ) or 0
            # an injected seal/ship fault: the drain below re-drives it
            _retrying(lambda: wq.flush(force=True), attempts=1)
        faults.clear()  # drain cleanly: the schedule already fired
        end = time.monotonic() + 20
        while wq.pending_parts() and time.monotonic() < end:
            liaison.probe()  # a faulted ship may have marked n0 dead
            wq.flush(force=True)
            time.sleep(0.02)
        assert wq.pending_parts() == 0, "faulted spool never drained"
        liaison.probe()
        got = _total(liaison.query_measure(_count_req()))
        assert got == acked, f"fault schedule lost rows: {got} != {acked}"
    finally:
        faults.clear()
        wq.stop(final_flush=False)
        transport.close()
        srv.stop(grace=0)
        dn.measure.close()
        dn.stream.close()
        dn.trace.close()
    stats["faults_injected"] = len(plane.history)
    stats["fault_sites"] = plane.counters()
    stats["acked_c"] = acked
    assert plane.history, "schedule ran but injected nothing"
    # determinism: the same seed+schedule replays the same per-site
    # decision sequence (tests/test_faults.py pins exact sequences)
    p1, p2 = faults.FaultPlane(spec), faults.FaultPlane(spec)
    for site, n in sorted(plane.counters().items()):
        for _ in range(n):
            p1.decide(site)
            p2.decide(site)
    assert p1.history == p2.history, "fault plane is not deterministic"


def _smoke_worker_cycles(tmp, seed: int, stats: dict, device) -> None:
    """Multi-process data plane crash contract (docs/performance.md):
    SIGKILL shard-owning workers mid-ingest per a ``worker``-site kill
    schedule, assert zero acked-write loss after journal replay and a
    BOUNDED degraded window with explicit markers."""
    from banyandb_tpu_torch.cluster import faults
    from banyandb_tpu_torch.cluster.bus import Topic
    from banyandb_tpu_torch.server import TOPIC_QL, StandaloneServer

    # the kill-schedule plane carries WHICH worker dies at WHICH cycle;
    # the harness performs the kill (site=worker)
    plane = faults.configure(f"seed={seed};worker=w000:at=1;worker=w001:at=2")
    srv = StandaloneServer(tmp / "workers", port=0, workers=2, device=device)
    srv.start()
    acked = 0
    degraded_windows = []
    try:
        _schema(srv.registry, group="cg", shard_num=4)

        def write(n=60):
            nonlocal acked
            from banyandb_tpu_torch.cluster import serde as _serde
            from banyandb_tpu_torch.api import WriteRequest

            r = srv.bus.handle(
                Topic.MEASURE_WRITE.value,
                {
                    "request": _serde.write_request_to_json(
                        WriteRequest("cg", "m", _points(acked, n))
                    )
                },
            )
            acked += r["written"]

        ql = (
            "SELECT count(v) FROM MEASURE m IN cg "
            f"TIME BETWEEN {T0} AND {T0 + 50_000_000}"
        )

        def probe() -> tuple[int, bool]:
            res = srv.bus.handle(TOPIC_QL, {"ql": ql})["result"]
            total = int(sum(res["values"].get("count", [])))
            if res.get("degraded"):
                assert res["unavailable_nodes"], "degraded without markers"
            return total, bool(res.get("degraded"))

        write(200)
        srv.pool.flush()  # journal trim: replay covers only the window
        write(100)
        for cycle in (1, 2):
            for victim in plane.kills_for_cycle(cycle, site="worker"):
                widx = srv.pool._names.index(victim)
                srv.pool.kill_worker(widx)
                t_kill = time.monotonic()
                write(80)  # acked DURING the dead window (journal spool)
                saw_degraded = False
                deadline = time.monotonic() + 45
                while time.monotonic() < deadline:
                    total, degraded = probe()
                    if degraded:
                        saw_degraded = True
                    if not degraded and total == acked:
                        break
                    time.sleep(0.2)
                window_s = time.monotonic() - t_kill
                degraded_windows.append(round(window_s, 2))
                assert saw_degraded, (
                    f"cycle {cycle}: no explicit degraded answer while "
                    f"{victim} was down"
                )
                total, degraded = probe()
                assert not degraded and total == acked, (
                    f"cycle {cycle}: acked-write loss or unbounded "
                    f"degradation ({total} != {acked}, degraded={degraded})"
                )
                stats["worker_kill_cycles"] = (
                    stats.get("worker_kill_cycles", 0) + 1
                )
        assert max(degraded_windows) < 45, degraded_windows
        stats["worker_degraded_windows_s"] = degraded_windows
        stats["worker_restarts"] = srv.pool.restarts
        stats["worker_acked"] = acked
    finally:
        faults.clear()
        srv.stop()


def _smoke_rebalance_under_kill(tmp, seed: int, stats: dict, device) -> None:
    """Elastic-cluster chaos (docs/robustness.md "Elastic cluster"):
    a join/kill schedule drives a LIVE rebalance whose preferred part
    source is SIGKILLed mid-move — the mover's holder failover pulls
    from the surviving replica, installs stay digest-deduped, the
    cutover bumps the epoch, and zero acked writes are lost."""
    from banyandb_tpu_torch.api import SchemaRegistry, WriteRequest
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo, faults
    from banyandb_tpu_torch.cluster.placement import PlacementSelector
    from banyandb_tpu_torch.cluster.rebalance import Rebalancer
    from banyandb_tpu_torch.cluster.rpc import GrpcTransport

    # the schedule carries WHO joins and WHO dies mid-move; the harness
    # performs both (join/leave satellite: events_for_cycle)
    plane = faults.configure(f"seed={seed};join=r3:at=1;kill=r0:at=1")
    events = plane.events_for_cycle(1)
    assert events["join"] == ["r3"] and events["kill"] == ["r0"]

    nodes, servers, dns, ports = [], {}, {}, {}
    for i in range(3):
        reg = SchemaRegistry(tmp / f"e-r{i}" / "schema")
        _schema(reg, group="rg", shard_num=3)
        dn = DataNode(f"r{i}", reg, tmp / f"e-r{i}" / "data", device=device)
        srv = _bind_server(dn.bus, 0, sync_install=dn.install_synced_parts)
        servers[f"r{i}"], dns[f"r{i}"], ports[f"r{i}"] = srv, dn, srv.port
        nodes.append(NodeInfo(f"r{i}", srv.addr))
    lreg = SchemaRegistry(tmp / "e-liaison" / "schema")
    _schema(lreg, group="rg", shard_num=3)
    transport = GrpcTransport()
    # handoff: the kill window's writes spool the dead replica's copies
    # and replay them (epoch re-stamped) once it rejoins
    liaison = Liaison(
        lreg, transport, nodes, replicas=1,
        handoff_root=str(tmp / "e-liaison" / "handoff"),
    )
    liaison.probe()
    acked = [0]

    def write(n=90):
        from banyandb_tpu_torch.api import DataPointValue

        pts = tuple(
            DataPointValue(
                ts_millis=T0 + acked[0] + i,
                tags={"svc": f"s{(acked[0] + i) % 8}"},
                fields={"v": 1.0}, version=1,
            )
            for i in range(n)
        )
        acked[0] += liaison.write_measure(WriteRequest("rg", "m", pts))

    def total() -> int:
        from banyandb_tpu_torch.api import (
            Aggregation, GroupBy, QueryRequest, TimeRange,
        )

        res = liaison.query_measure(QueryRequest(
            groups=("rg",), name="m",
            time_range=TimeRange(T0, T0 + 50_000_000),
            group_by=GroupBy(("svc",)), agg=Aggregation("count", "v"),
        ))
        return int(sum(res.values.get("count", [])))

    try:
        write(240)
        # the scheduled JOIN: r3 appears in the addr book only
        for name in events["join"]:
            reg = SchemaRegistry(tmp / f"e-{name}" / "schema")
            _schema(reg, group="rg", shard_num=3)
            dn = DataNode(name, reg, tmp / f"e-{name}" / "data", device=device)
            srv = _bind_server(
                dn.bus, 0, sync_install=dn.install_synced_parts
            )
            servers[name], dns[name], ports[name] = srv, dn, srv.port
            with liaison._placement_lock:
                liaison.selector = PlacementSelector(
                    list(liaison.selector.nodes)
                    + [NodeInfo(name, srv.addr)],
                    liaison.placement,
                )
        liaison.probe()
        reb = Rebalancer(liaison)
        plan = reb.plan()
        assert plan.moves, "scheduled join produced no moves"

        def mid_move():
            # the scheduled KILL lands exactly mid-move: a part source
            # goes away between the bulk and delta ship rounds
            for victim in events["kill"]:
                servers[victim].stop(grace=0)
            write(90)  # acked during the kill window (replica covers)

        st = reb.apply(plan, mid_move=mid_move)
        assert st["ok"], st
        assert liaison.placement.epoch == 2
        stats["rebalance_parts_moved"] = st["parts_moved"]
        # restart the victim on its port; it learns the epoch from the
        # placement broadcast riding the next probe-visible traffic
        for victim in events["kill"]:
            servers[victim] = _bind_server(
                dns[victim].bus, ports[victim],
                sync_install=dns[victim].install_synced_parts,
            )
        liaison.probe()
        liaison.broadcast_placement()
        got = total()
        assert got == acked[0], (
            f"rebalance-under-kill lost acked writes: {got} != {acked[0]}"
        )
        for name, dn in dns.items():
            assert dn.epoch_record.epoch == 2, (name, dn.epoch_record.epoch)
        stats["rebalance_under_kill"] = 1
        stats["rebalance_acked"] = acked[0]
    finally:
        faults.clear()
        transport.close()
        for srv in servers.values():
            srv.stop(grace=0)
        for dn in dns.values():
            dn.measure.close()
            dn.stream.close()
            dn.trace.close()


def run_smoke(tmp_root, seed: int = 42, budget_s: float = 3.0, device=None) -> dict:
    """The five in-process phases on `device` (CUDA unless ``"cpu"`` is
    asked for), with the QoS plane armed.  -> the invariants' figures."""
    from pathlib import Path

    dev = resolve_device(device)
    tmp = Path(tmp_root)
    tmp.mkdir(parents=True, exist_ok=True)
    stats = {
        "mode": "smoke", "seed": seed, "kill_cycles": 0,
        "degraded_seen": 0, "max_query_wall_s": 0.0,
    }
    # QoS armed for every cycle (docs/robustness.md "Multi-tenant
    # QoS"): the admission plane runs live with a configured tenant
    # table; the chaos traffic is untenanted (default tenant, generous
    # limits), so the kill/degradation cycles must stay green — zero
    # acked loss, zero spurious sheds — THROUGH the armed plane.
    from banyandb_tpu_torch.qos.plane import reset_qos

    qos = {
        "BYDB_QOS": "1",
        "BYDB_QOS_TENANTS": json.dumps(
            {"chaos": {"write_rate": 1_000_000, "max_concurrent": 64}}
        ),
    }
    t0 = time.perf_counter()
    try:
        with env_scope(qos):
            reset_qos()
            stats["qos_armed"] = 1
            _smoke_wqueue_cycles(tmp, budget_s, stats, dev)
            _smoke_degradation(tmp, budget_s, stats, dev)
            _smoke_fault_schedule(tmp, seed, stats, dev)
            _smoke_worker_cycles(tmp, seed, stats, dev)
            _smoke_rebalance_under_kill(tmp, seed, stats, dev)
    finally:
        reset_qos()  # the plane as the restored environment configures it
    stats["wall_s"] = round(time.perf_counter() - t0, 2)
    assert stats["kill_cycles"] >= 3
    assert stats["degraded_seen"] >= 1
    assert stats["worker_kill_cycles"] >= 2
    assert stats["rebalance_under_kill"] >= 1
    return stats


# -- soak: real subprocess cluster, SIGKILL cycles ---------------------------


def _child_env() -> dict:
    env = dict(os.environ)
    env["BYDB_QUERY_DEADLINE_S"] = "10"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO]
        + [
            p
            for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p and p != REPO
        ]
    )
    return env


def run_soak(
    tmp_root, seconds: float = 120.0, seed: int = 42, n_nodes: int = 3,
    device=None,
) -> dict:
    """`n_nodes` data-role children on `device` (CUDA unless ``"cpu"`` is
    asked for) and a liaison child, under SIGKILL cycles for about
    `seconds`.  -> the invariants' figures."""
    import signal
    import socket
    import subprocess
    from pathlib import Path

    from banyandb_tpu_torch.cluster.bus import Topic
    from banyandb_tpu_torch.cluster.rpc import GrpcTransport
    from banyandb_tpu_torch.server import TOPIC_QL, TOPIC_REGISTRY

    dev = resolve_device(device)
    tmp = Path(tmp_root)
    tmp.mkdir(parents=True, exist_ok=True)

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    ports = [free_port() for _ in range(n_nodes + 1)]
    nodes_file = tmp / "nodes.json"
    nodes_file.write_text(json.dumps([
        {"name": f"n{i}", "addr": f"127.0.0.1:{ports[i]}", "roles": ["data"]}
        for i in range(n_nodes)
    ]))
    logs = [(tmp / f"proc{i}.log").open("w") for i in range(n_nodes + 1)]
    procs: dict[str, subprocess.Popen] = {}
    transport = GrpcTransport()
    laddr = f"127.0.0.1:{ports[n_nodes]}"

    def spawn(args, logf):
        return subprocess.Popen(
            [sys.executable, "-m", "banyandb_tpu_torch.server", *args],
            env=_child_env(), stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True,
        )

    def spawn_data(i):
        procs[f"n{i}"] = spawn(
            ["--role", "data", "--root", str(tmp / f"n{i}"),
             "--name", f"n{i}", "--port", str(ports[i]),
             "--device", dev.type], logs[i],
        )

    def wait_banner(i, timeout_s=120.0):
        path = tmp / f"proc{i}.log"
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            try:
                if "banyandb-tpu" in path.read_text(errors="replace"):
                    return
            except OSError:
                pass
            time.sleep(0.25)
        raise TimeoutError(f"proc{i} never printed its banner")

    def wait_health(addr, timeout_s=60.0):
        end = time.monotonic() + timeout_s
        last = None
        while time.monotonic() < end:
            try:
                r = transport.call(addr, Topic.HEALTH.value, {}, timeout=5)
                if r.get("status") == "ok":
                    return r
            except Exception as exc:  # noqa: BLE001 - still booting
                last = exc
            time.sleep(0.5)
        raise TimeoutError(f"{addr} never became healthy: {last}")

    stats = {
        "mode": "soak", "seed": seed, "kill_cycles": 0,
        "degraded_seen": 0, "max_query_wall_s": 0.0,
        "write_retries": 0, "acked": 0,
    }
    acked = 0

    def write_batch(n=200):
        nonlocal acked
        pts = [{
            "ts": T0 + acked + j, "tags": {"svc": f"s{(acked + j) % 8}"},
            "fields": {"v": 1.0}, "version": 1,
        } for j in range(n)]
        transport.call(
            laddr, Topic.MEASURE_WRITE.value,
            {"request": {"group": "cg", "name": "m", "points": pts}},
            timeout=15,
        )
        acked += n

    def write_with_retry():
        for _ in range(30):
            try:
                write_batch()
                return True
            except Exception:  # noqa: BLE001 - outage window
                stats["write_retries"] += 1
                time.sleep(0.2)
        return False

    def query() -> dict:
        t0 = time.perf_counter()
        r = transport.call(laddr, TOPIC_QL, {
            "ql": ("SELECT count(v) FROM MEASURE m IN cg "
                   f"TIME BETWEEN {T0} AND {T0 + 50_000_000}")
        }, timeout=30.0)["result"]
        wall = time.perf_counter() - t0
        stats["max_query_wall_s"] = max(stats["max_query_wall_s"], wall)
        # liaison budget is 10s (BYDB_QUERY_DEADLINE_S): the bound plus
        # scheduling slack
        assert wall <= 15.0, f"query ran {wall:.1f}s past its deadline"
        if r.get("degraded"):
            stats["degraded_seen"] += 1
            assert r.get("unavailable_nodes"), "degraded without names"
        return r

    def count_of(r) -> int:
        return int(sum(r["values"].get("count", [0])))

    def flush_all(names):
        for name in names:
            i = int(name[1:])
            try:
                transport.call(
                    f"127.0.0.1:{ports[i]}", "flush", {}, timeout=15
                )
            except Exception:  # noqa: BLE001 - node may be the victim
                pass

    def kill(name):
        p = procs[name]
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()

    try:
        for i in range(n_nodes):
            spawn_data(i)
        procs["liaison"] = spawn(
            ["--role", "liaison", "--root", str(tmp / "l"),
             "--discovery", str(nodes_file), "--replicas", "1",
             "--port", str(ports[n_nodes])], logs[n_nodes],
        )
        for i in range(n_nodes):
            wait_banner(i)
            wait_health(f"127.0.0.1:{ports[i]}")
        wait_banner(n_nodes)
        wait_health(laddr)
        transport.call(laddr, TOPIC_REGISTRY, {
            "op": "create", "kind": "group", "item": {
                "name": "cg", "catalog": "measure",
                "resource_opts": {
                    "shard_num": 4, "replicas": 1,
                    "segment_interval": {"num": 1, "unit": "day"},
                    "ttl": {"num": 7, "unit": "day"}, "stages": [],
                },
            }}, timeout=15)
        transport.call(laddr, TOPIC_REGISTRY, {
            "op": "create", "kind": "measure", "item": {
                "group": "cg", "name": "m",
                "tags": [{"name": "svc", "type": "string"}],
                "fields": [{"name": "v", "type": "float"}],
                "entity": {"tag_names": ["svc"]}, "interval": "",
                "index_mode": False,
            }}, timeout=15)

        cycles = max(3, n_nodes)
        slice_s = max(seconds / (cycles + 1), 5.0)
        write_with_retry()
        assert count_of(query()) == acked

        for cycle in range(cycles):
            victims = [f"n{cycle % n_nodes}"]
            if cycle == cycles - 1:
                # the double-kill window: adjacent replicas down means
                # some shard loses its whole chain -> degraded answers
                victims.append(f"n{(cycle + 1) % n_nodes}")
            # bound the direct-write plane's documented crash window:
            # flush memtables before the kill (chaos measures replication
            # + replay, not WAL-less crash durability)
            flush_all([f"n{i}" for i in range(n_nodes)])
            for v in victims:
                kill(v)
            end = time.monotonic() + slice_s
            while time.monotonic() < end:
                write_with_retry()
                query()
                time.sleep(0.1)
            for v in victims:
                spawn_data(int(v[1:]))
            for v in victims:
                wait_health(f"127.0.0.1:{ports[int(v[1:])]}")
            stats["kill_cycles"] += 1

        # convergence: every acked row queryable after recovery
        end = time.monotonic() + 90
        got = -1
        while time.monotonic() < end:
            write_with_retry()
            got = count_of(query())
            if got >= acked:
                break
            time.sleep(2)
        assert got >= acked, f"acked-write loss: {got} < {acked}"
        stats["acked"] = acked
        assert stats["degraded_seen"] >= 1, (
            "double-kill window produced no degraded response"
        )
    finally:
        transport.close()
        for p in procs.values():
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    p.kill()
                p.wait()
        for f in logs:
            f.close()
    return stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--soak", type=float, default=0.0, metavar="SECONDS")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--artifact", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without CUDA only cpu runs")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    import tempfile

    tmp = tempfile.mkdtemp(prefix="bydb-chaos-")
    if args.smoke:
        stats = run_smoke(tmp, seed=args.seed, device=dev)
    elif args.soak:
        stats = run_soak(tmp, seconds=args.soak, seed=args.seed, device=dev)
    else:
        print(__doc__)
        return 2
    print(json.dumps(stats, indent=2, default=str))
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump(stats, f, indent=2, default=str)
    print("chaos: all invariants held")
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # grpc's C++ worker threads can abort ("terminate called without an
    # active exception") during ordinary interpreter teardown AFTER every
    # invariant already passed — same exit contract as server.py main():
    # skip C++ teardown entirely
    os._exit(rc)
