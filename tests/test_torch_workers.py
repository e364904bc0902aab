"""The port's multi-process data plane against the JAX package's.

``banyandb_tpu_torch.server.StandaloneServer(root, device="cpu",
workers=N)`` partitions shards over N worker subprocesses, each a port
``DataNode`` on the CPU (``cluster/workers.py``).  This file mirrors the
contract of ``tests/test_workers.py`` on the port:

- A/B: the same envelope script through the port with ``workers=0``,
  the port with ``workers=2`` and the JAX ``StandaloneServer(port=0)``
  (``workers=0``, in-process); ``reply["result"]`` of every query in
  ``QUERIES`` (the JAX file's list: measure aggregate, grouped,
  filtered, percentile, raw limit/offset, stream) is byte-identical as
  JSON across the three (the values are integer-valued, so no sum needs
  a tolerance); the streamagg-covered shape, TopN, the ``write-columns``
  codec, row/columnar routing and ``relabel_exposition`` likewise;
- failure: a SIGKILLed worker's dead window answers ``degraded`` with
  ``unavailable_nodes``, and after the restart's journal replay every
  acked measure, stream and trace write is served; a dead worker's
  journal sheds past its cap (``ServerBusy``); no worker-local flush
  turns the replay into duplicates; the flush watermark skips rows a
  worker had flushed;
- processes: workers register in ``utils.procreg`` and ``stop()`` reaps
  them (``sanitize.leaks``); each child runs
  ``banyandb_tpu_torch.cluster.workers`` on the asked device;
- state carried across packages: a root the JAX server wrote with
  ``workers=2`` opens in the port with ``workers=2`` and answers the same;
- serde: every reply a worker sends crosses ``json.dumps`` as plain JSON
  (no tensor, numpy scalar or bytes), ±inf and NaN included.

A worker boot imports torch (~3 s here), so the A/B trio is built once
per module and read-mostly tests share it.
"""

from __future__ import annotations

import base64
import json
import math
import time

import numpy as np
import pytest

from banyandb_tpu.api import schema as jschema

T0 = 1_700_000_000_000
HI = T0 + 1_000_000_000

QUERIES = [
    # aggregate / grouped / filtered / percentile / raw limit-offset
    f"SELECT count(v) FROM MEASURE m IN g TIME BETWEEN {T0} AND {HI} GROUP BY svc",
    f"SELECT sum(v) FROM MEASURE m IN g TIME BETWEEN {T0} AND {HI} "
    f"WHERE region = 'r1' GROUP BY svc",
    f"SELECT mean(v) FROM MEASURE m IN g TIME BETWEEN {T0} AND {HI}",
    f"SELECT max(v) FROM MEASURE m IN g TIME BETWEEN {T0} AND {HI} "
    f"WHERE svc IN ('s1', 's3') GROUP BY region",
    f"SELECT percentile(v, 95) FROM MEASURE m IN g TIME BETWEEN {T0} AND {HI}",
    f"SELECT * FROM MEASURE m IN g TIME BETWEEN {T0} AND {HI} LIMIT 13",
    f"SELECT * FROM MEASURE m IN g TIME BETWEEN {T0} AND {HI} LIMIT 7 OFFSET 5",
    # stream
    f"SELECT svc, level FROM STREAM logs IN g TIME BETWEEN {T0} AND {HI} "
    f"WHERE level = 'ERROR' LIMIT 100",
]
COUNT_QL = f"SELECT count(v) FROM MEASURE m IN g TIME BETWEEN {T0} AND {HI}"
STREAMAGG = {
    "op": "register", "group": "g", "measure": "m",
    "key_tags": ["region", "svc"], "fields": ["v"], "window_millis": 60_000,
}


def _item(obj) -> dict:
    return json.loads(json.dumps(jschema._to_jsonable(obj)))


def _schema(srv) -> None:
    """The JAX file's schema, through the registry topic (both packages'
    servers take the same envelopes)."""
    S = jschema
    h = srv.bus.handle
    h("registry", {"op": "create", "kind": "group", "item": _item(
        S.Group("g", S.Catalog.MEASURE, S.ResourceOpts(shard_num=4)))})
    h("registry", {"op": "create", "kind": "measure", "item": _item(S.Measure(
        group="g", name="m",
        tags=(S.TagSpec("svc", S.TagType.STRING), S.TagSpec("region", S.TagType.STRING)),
        fields=(S.FieldSpec("v", S.FieldType.FLOAT),),
        entity=S.Entity(("svc",)),
    ))})
    h("registry", {"op": "create", "kind": "topn", "item": _item(S.TopNAggregation(
        group="g", name="top_svc", source_measure="m", field_name="v",
        field_value_sort="desc", group_by_tag_names=("svc",), counters_number=100,
    ))})
    h("registry", {"op": "create_stream", "kind": "stream", "item": {
        "group": "g", "name": "logs",
        "tags": [{"name": "svc", "type": "string"}, {"name": "level", "type": "string"}],
        "entity": ["svc"],
    }})


def _write_rows(srv, n=240) -> None:
    pts = [
        {"ts": T0 + i * 10, "tags": {"svc": f"s{i % 7}", "region": f"r{i % 3}"},
         "fields": {"v": float((i * 7) % 23)}, "version": 1}
        for i in range(n)
    ]
    r = srv.bus.handle("measure-write", {"request": {"group": "g", "name": "m", "points": pts}})
    assert r["written"] == n
    elems = [
        {"element_id": f"e{i}", "ts": T0 + i * 10,
         "tags": {"svc": f"s{i % 7}", "level": "ERROR" if i % 5 == 0 else "INFO"},
         "body": base64.b64encode(f"l{i}".encode()).decode()}
        for i in range(60)
    ]
    r = srv.bus.handle("stream-write", {"group": "g", "name": "logs", "elements": elems})
    assert r["written"] == 60


def _cols_env(base, n, version=1) -> dict:
    idx = base + np.arange(n)
    b64 = lambda a: base64.b64encode(a.tobytes()).decode()  # noqa: E731
    return {
        "group": "g", "name": "m",
        "ts": b64((T0 + idx * 10).astype("<i8")),
        "versions": b64(np.full(n, version, dtype="<i8")),
        "tags": {
            "svc": {"dict": [f"s{i}" for i in range(9)], "codes": b64((idx % 9).astype("<i4"))},
            "region": {"dict": ["r0", "r1", "r2"], "codes": b64((idx % 3).astype("<i4"))},
        },
        "fields": {"v": b64(((idx * 3) % 17).astype("<f8"))},
    }


def _write_cols(srv, base, n, version=1) -> dict:
    return srv.bus.handle("measure-write-cols", _cols_env(base, n, version))


def _boot(srv) -> None:
    srv.start()
    _schema(srv)
    # one covering streamagg signature (region, svc superset of both
    # query shapes), registered before ingest like a real deployment
    srv.bus.handle("streamagg", dict(STREAMAGG))
    _write_rows(srv)
    assert _write_cols(srv, 1000, 300)["written"] == 300
    srv.bus.handle("snapshot", {})


def _port(root, workers):
    from banyandb_tpu_torch.server import StandaloneServer

    return StandaloneServer(root, device="cpu", workers=workers or None)


def _result(srv, ql) -> str:
    return json.dumps(srv.bus.handle("bydbql", {"ql": ql})["result"], sort_keys=True)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    from banyandb_tpu.server import StandaloneServer as JServer

    tmp = tmp_path_factory.mktemp("torch-workers-ab")
    started = []
    try:
        for srv in (JServer(tmp / "jax", port=0), _port(tmp / "w0", 0), _port(tmp / "w2", 2)):
            started.append(srv)
            _boot(srv)
        yield tuple(started)
    finally:
        for srv in reversed(started):
            srv.stop()


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_ab_result_json_byte_identical(trio, qi):
    jsrv, srv0, srv2 = trio
    ql = QUERIES[qi]
    want = _result(jsrv, ql)
    assert json.loads(want)["groups"] or json.loads(want)["data_points"], "vacuous query"
    assert _result(srv0, ql) == want, f"port workers=0 differs from JAX for {ql}"
    assert _result(srv2, ql) == want, f"port workers=2 differs from JAX for {ql}"


def test_ab_streamagg_covered_parity_and_materialized(trio):
    ql = f"SELECT sum(v) FROM MEASURE m IN g TIME BETWEEN {T0} AND {HI} GROUP BY svc"
    replies = [srv.bus.handle("bydbql", {"ql": ql}) for srv in trio]
    docs = {json.dumps(r["result"], sort_keys=True) for r in replies}
    assert len(docs) == 1, docs
    # every mode folds materialized windows (the serve-path marker walks
    # the grafted worker subtrees with workers=2)
    assert [r["served"] for r in replies] == ["materialized"] * 3


def test_ab_topn_parity(trio):
    jsrv, srv0, srv2 = trio
    # emit pending windows on the single-process engines the way the
    # worker ctl flush already did, then re-snapshot all three
    jsrv.measure.topn.flush_all_windows()
    srv0.measure.topn.flush_all_windows()
    for srv in trio:
        srv.bus.handle("snapshot", {})
    env = {"group": "g", "name": "top_svc", "time_range": [T0 - 120_000, HI],
           "n": 5, "agg": "max"}
    a, b, c = (srv.bus.handle("topn", dict(env)) for srv in trio)
    assert a["items"], "TopN returned no items — vacuous parity"
    assert a == b == c, f"TopN divergence:\njax: {a}\n0: {b}\nN: {c}"
    # agg="count" flattens values to 1.0 AFTER ranking: the workers'
    # concat re-rank must still pick the same entities in the same order
    cenv = dict(env, agg="count", n=3)
    a, b, c = (srv.bus.handle("topn", dict(cenv)) for srv in trio)
    assert a == b == c
    assert a["items"] and all(it["value"] == 1.0 for it in a["items"])
    # the pool's measure facade scatters TopN the same way
    from banyandb_tpu_torch.api.model import TimeRange
    from banyandb_tpu_torch.models import topn as topn_mod

    got = [(tuple(it["entity"]), it["value"])
           for it in srv2._pool_measure.topn_scatter(dict(env))["items"]]
    want = topn_mod.query_topn(srv0.measure, "g", "top_svc",
                               TimeRange(T0 - 120_000, HI), n=5, agg="max")
    assert got and got == want


def test_worker_metrics_labels_launches_and_build_cache(trio):
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    _, _, srv2 = trio
    before = dict(hk.LAUNCHES)
    srv2.bus.handle("bydbql", {"ql": QUERIES[0]})
    text = srv2.bus.handle("metrics", {})["prometheus"]
    assert 'worker="w000"' in text and 'worker="w001"' in text
    assert "banyandb_workers_alive 2" in text
    # per-worker write instrumentation made it into the merged text
    assert 'banyandb_write_ms_count{model="measure",worker=' in text
    # each worker's own kernel launch counts and build cache, relabeled
    # (CPU tensors take the plain versions: no launch, no library)
    for w in ("w000", "w001"):
        for k in hk.LAUNCHES:
            assert f'banyandb_kernel_launches{{kernel="{k}",worker="{w}"}} 0.0' in text
        for k in ("builds", "loads", "enabled"):
            assert f'banyandb_compile_cache_{k}{{worker="{w}"}}' in text
    # the parent launched nothing for the workers' query
    assert hk.LAUNCHES == before
    st = srv2.pool.stats()
    assert st["workers"] == 2 and sorted(st["alive"]) == ["w000", "w001"]


def test_worker_children_run_the_port_on_the_asked_device(trio):
    _, _, srv2 = trio
    for c in srv2.pool._clients:
        args = list(c.proc.args)
        assert args[1:3] == ["-m", "banyandb_tpu_torch.cluster.workers"], args
        assert args[args.index("--device") + 1] == "cpu"
        assert c.ready_info["device"] == "cpu"
        # the fleet shares one build cache under the pool's root
        assert c.ready_info["compile_cache"]["dir"] == str(srv2.pool.root / "compile-cache")
        assert c.ready_info["compile_cache"]["builds"] == 0


def test_pool_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    import torch

    from banyandb_tpu_torch.api import SchemaRegistry
    from banyandb_tpu_torch.cluster.workers import WorkerPool
    from banyandb_tpu_torch.utils import procreg

    before = procreg.snapshot()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkerPool(tmp_path, SchemaRegistry(tmp_path), 1)
    assert procreg.snapshot() == before, "a refused pool spawned a worker"


def test_worker_that_cannot_reach_its_device_fails_the_start(tmp_path):
    """A worker whose device does not come up exits before its ready
    banner; the parent raises with the tail of the worker's log and
    reaps it — it never carries on on the CPU."""
    from banyandb_tpu_torch.cluster.rpc import TransportError
    from banyandb_tpu_torch.cluster.workers import WorkerClient
    from banyandb_tpu_torch.utils import procreg

    before = procreg.snapshot()
    # no machine has a 100th card: the child's device cannot come up
    c = WorkerClient("w000", tmp_path / "w000", "cuda:99")
    try:
        with pytest.raises(TransportError, match="failed to start on cuda:99") as ei:
            c.wait_ready(timeout=60)
        # the worker's own traceback rides the error
        assert "Error" in str(ei.value).split("\n", 1)[1]
        assert c.proc.poll() not in (None, 0)
    finally:
        c.kill()
        c.close(timeout=5)
    assert procreg.snapshot() == before


# -- failure: kill, replay, shed ---------------------------------------------


def _wait_served(fn, done, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    out = fn()
    while not done(out) and time.monotonic() < deadline:
        time.sleep(0.25)
        out = fn()
    return out


def test_kill_degrades_then_replay_loses_nothing_and_reaps(tmp_path):
    """SIGKILL w000 with measure, stream and trace rows in its memtable
    and more acked during the dead window: the window answers degraded
    with the dead worker named, the restart replays the parent journal,
    every acked row is served, and stop() reaps both incarnations."""
    from banyandb_tpu_torch.api.model import QueryRequest, TimeRange
    from banyandb_tpu_torch.cluster.workers import PoolStreamAdapter, PoolTraceAdapter
    from banyandb_tpu_torch.models.stream import ElementValue
    from banyandb_tpu_torch.models.trace import SpanValue
    from banyandb_tpu_torch.sanitize import leaks
    from banyandb_tpu_torch.utils import procreg

    before = procreg.snapshot()
    srv = _port(tmp_path / "kill", 2)
    try:
        assert len(procreg.snapshot() - before) == 2, "workers must register in procreg"
        srv.start()
        _schema(srv)
        srv.bus.handle("registry", {"op": "create_trace", "kind": "trace", "item": {
            "group": "g", "name": "sw", "trace_id_tag": "trace_id",
            "tags": [{"name": "trace_id", "type": "string"}, {"name": "dur", "type": "int"}],
        }})
        srv.bus.handle("streamagg", dict(STREAMAGG))
        streams, traces = PoolStreamAdapter(srv.pool), PoolTraceAdapter(srv.pool)

        def other_models(base, n):
            streams.write("g", "logs", [
                ElementValue(element_id=f"e{base + i}", ts_millis=T0 + base + i,
                             tags={"svc": f"s{(base + i) % 8}", "level": "INFO"},
                             body=f"b{base + i}".encode())
                for i in range(n)])
            traces.write("g", "sw", [
                SpanValue(ts_millis=T0 + base + i,
                          tags={"trace_id": f"t{(base + i) % 4}", "dur": base + i},
                          span=f"sp{base + i}".encode())
                for i in range(n)], ordered_tags=("dur",))

        assert _write_cols(srv, 0, 400)["written"] == 400
        # flush trims the journal; later writes live in journal + memtable
        srv.pool.flush()
        assert srv.pool.stats()["journal_entries"] == [0, 0]
        assert _write_cols(srv, 400, 200)["written"] == 200
        other_models(0, 40)
        old_pid = srv.pool.kill_worker(0)
        # writes during the dead window: journal-acked, replay delivers
        assert _write_cols(srv, 600, 100)["written"] == 100
        other_models(40, 24)
        acked = 700

        saw = []

        def ask():
            res = srv.bus.handle("bydbql", {"ql": COUNT_QL})["result"]
            if res.get("degraded"):
                saw.append(res["unavailable_nodes"])
            return res

        res = _wait_served(ask, lambda r: not r.get("degraded")
                           and int(sum(r["values"].get("count", []))) == acked)
        assert saw and all(u == ["w000"] for u in saw), f"dead window markers: {saw}"
        assert not res.get("degraded")
        assert int(sum(res["values"]["count"])) == acked, "acked-write loss across SIGKILL"
        assert srv.pool.restarts >= 1
        assert srv.pool._clients[0].proc.pid != old_pid
        assert "banyandb_worker_restarts_total" in srv.bus.handle("metrics", {})["prometheus"]
        # streamagg windows rebuilt after the replay without double folds
        assert srv.bus.handle("bydbql", {"ql": COUNT_QL})["served"] == "materialized"
        sreq = QueryRequest(groups=("g",), name="logs",
                            time_range=TimeRange(T0, T0 + 1_000_000), limit=1000)
        sres = _wait_served(lambda: srv.pool.query_stream(sreq),
                            lambda r: not r.degraded and len(r.data_points) == 64)
        assert not sres.degraded and len(sres.data_points) == 64, "stream acked-write loss"
        assert len(srv.pool.query_trace_by_id("g", "sw", "t1")) == 16, "trace acked-write loss"
    finally:
        srv.stop()
    assert procreg.snapshot() - before == frozenset(), "stop() must reap every worker"
    assert leaks.leaked_processes(before, grace_s=0.1) == []


def _freeze_and_kill(srv):
    """Freeze the supervisor (no restart or flush ticks) and SIGKILL the
    only worker so later writes take the journal-spooled path."""
    srv.pool._stopping.set()
    srv.pool._supervisor.join(timeout=30)
    srv.pool.kill_worker(0)
    deadline = time.monotonic() + 30
    while srv.pool._clients[0].alive and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not srv.pool._clients[0].alive


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    """A one-worker server whose worker is dead and whose supervisor is
    frozen: the dead window held open for the journal tests."""
    srv = _port(tmp_path_factory.mktemp("torch-workers-frozen"), 1)
    try:
        srv.start()
        _schema(srv)
        assert _write_cols(srv, 0, 50)["written"] == 50
        _freeze_and_kill(srv)
        yield srv
    finally:
        srv.stop()


@pytest.fixture()
def journal(frozen):
    """The frozen worker's journal, emptied again after the test."""
    yield frozen.pool
    frozen.pool._journal[0].clear()
    frozen.pool._jbytes[0] = 0


def test_dead_worker_journal_cap_sheds(frozen, journal):
    from banyandb_tpu_torch.admin.protector import ServerBusy

    cap = journal._journal_cap
    journal._journal_cap = 4096
    try:
        with pytest.raises(ServerBusy):
            for i in range(256):
                _write_cols(frozen, 1000 + i * 10, 10)
    finally:
        journal._journal_cap = cap
    assert journal._jbytes[0] <= 4096


def test_replay_keeps_transient_shed_rejections(frozen, journal):
    from banyandb_tpu_torch.cluster.rpc import TransportError

    for base in (1000, 2000, 3000):
        assert _write_cols(frozen, base, 5)["written"] == 5
    seqs = [e[0] for e in journal._journal[0]]
    assert len(seqs) == 3

    class _Client:
        flush_wm = 0

        def __init__(self, reject_seq, kind):
            self.reject_seq, self.kind = reject_seq, kind

        def call(self, topic, env, timeout=None, env_json=None):
            if json.loads(env_json)["_seq"] == self.reject_seq:
                e = TransportError("rejected", kind=self.kind)
                e.remote = True
                raise e
            return {}

    with pytest.raises(TransportError):
        journal._replay_locked(0, _Client(seqs[1], "shed"))
    assert [e[0] for e in journal._journal[0]] == seqs
    assert journal._replay_locked(0, _Client(seqs[1], "error")) == 2
    assert [e[0] for e in journal._journal[0]] == [seqs[0], seqs[2]]
    assert journal._jbytes[0] == sum(e[3] for e in journal._journal[0])


def test_columnar_validation_parity_when_worker_down(frozen, journal):
    """An envelope the engine would reject errors in the parent before
    the ack, though the owning worker is down."""
    env = _cols_env(0, 8)
    ragged = dict(env, tags={"svc": [f"s{i}" for i in range(8)], "region": ["r0"] * 7})
    codes = base64.b64encode(np.full(8, 7, dtype="<i4").tobytes()).decode()
    bad_codes = dict(env, tags={"svc": [f"s{i}" for i in range(8)],
                                "region": {"dict": ["r0"], "codes": codes}})
    short = dict(env, fields={"v": base64.b64encode(np.ones(5, "<f8").tobytes()).decode()})
    for bad in (ragged, bad_codes, short):
        with pytest.raises(ValueError):
            frozen.bus.handle("measure-write-cols", bad)
    assert journal._journal[0] == [], "a rejected envelope reached the journal"


def test_live_rejection_removed_from_journal_by_seq(frozen, journal):
    from banyandb_tpu_torch.cluster.rpc import TransportError

    class _Rejecting:
        alive = True

        def begin_call(self, topic, envelope, env_json=None):
            return ("h",)

        def wait_reply(self, handle, topic, timeout):
            # a concurrent write lands behind ours mid-flight
            journal._journal[0].append((10**9, "t", "{}", 2))
            journal._jbytes[0] += 2
            e = TransportError("bad write", kind="error")
            e.remote = True
            raise e

    real = journal._clients[0]
    journal._clients[0] = _Rejecting()
    try:
        with pytest.raises(TransportError):
            journal._forward_write(0, "measure-write-cols", {"group": "g"})
        assert [e[0] for e in journal._journal[0]] == [10**9]
        assert journal._jbytes[0] == 2
    finally:
        journal._clients[0] = real


def test_replay_after_kill_neither_duplicates_nor_replays_flushed_rows(
    tmp_path, monkeypatch,
):
    """Stream appends have no version dedup.  w000 dies with its rows
    only in its memtable: without a worker-local flush the replay
    restores each row once.  w001 flushed (worker side, no parent trim)
    before it died: its flush.wm makes the replay skip those rows.  The
    supervisor's flush tick is frozen so both journals stay untrimmed;
    timestamps are recent so retention keeps the flushed part."""
    from banyandb_tpu_torch.api.model import QueryRequest, TimeRange
    from banyandb_tpu_torch.cluster.rpc import TransportError

    monkeypatch.setenv("BYDB_WORKER_FLUSH_S", "3600")
    t1 = int(time.time() * 1000) - 60_000
    srv = _port(tmp_path / "dup", 2)
    try:
        srv.start()
        _schema(srv)
        n = 120
        srv.pool.write_stream("g", "logs", [
            {"ts": t1 + i, "element_id": f"e{i}",
             "tags": {"svc": f"s{i % 16}", "level": f"l{i % 3}"}}
            for i in range(n)])
        # a worker-local drain would have fired within a second
        time.sleep(1.5)
        assert all(e > 0 for e in srv.pool.stats()["journal_entries"])
        srv.pool._ctl(1, {"op": "flush"})
        srv.pool.kill_worker(0)
        srv.pool.kill_worker(1)
        req = QueryRequest(groups=("g",), name="logs",
                           time_range=TimeRange(t1, t1 + 1_000_000), limit=10_000)

        def ask():
            try:
                return srv.pool.query_stream(req)
            except TransportError:  # both workers down at once
                return None

        res = _wait_served(ask, lambda r: r is not None and not r.degraded
                           and len(r.data_points) == n and srv.pool.restarts >= 2)
        assert res is not None
        assert not res.degraded
        assert len(res.data_points) == n, (
            f"{len(res.data_points)} elements after SIGKILL + replay, wrote {n}")
        assert srv.pool.restarts >= 2
        assert srv.pool._clients[1].flush_wm > 0, "the replay-skip path never engaged"
        assert srv.pool._clients[0].flush_wm == 0
    finally:
        srv.stop()


# -- process-free units ------------------------------------------------------


def test_write_columns_env_codec_round_trip_matches_jax():
    from banyandb_tpu.cluster import serde as jserde
    from banyandb_tpu_torch.cluster import serde
    from banyandb_tpu_torch.models.measure import DictColumn

    n = 10
    env = _cols_env(3, n)
    env["tags"]["plain"] = [f"p{i}" for i in range(n)]
    cols = serde.write_columns_env_decode(env)
    assert isinstance(cols["tags"]["svc"], DictColumn)
    idx = np.array([1, 3, 4, 8])
    sliced = serde.write_columns_env_slice(cols, idx)
    jsliced = jserde.write_columns_env_slice(jserde.write_columns_env_decode(env), idx)
    assert json.dumps(sliced, sort_keys=True) == json.dumps(jsliced, sort_keys=True)
    back = serde.write_columns_env_decode(json.loads(json.dumps(sliced)))
    assert back["ts_millis"].tolist() == cols["ts_millis"][idx].tolist()
    assert back["versions"].tolist() == [1] * 4
    assert np.asarray(back["tags"]["svc"].codes).tolist() == ((3 + idx) % 9).tolist()
    assert back["tags"]["plain"] == ["p1", "p3", "p4", "p8"]
    assert back["fields"]["v"].tolist() == (((3 + idx) * 3) % 17).astype(float).tolist()


def test_row_and_columnar_routing_agree_with_jax():
    from banyandb_tpu.models.measure import series_ids_for_columns as jsids
    from banyandb_tpu_torch.models.measure import DictColumn, series_ids_for_columns
    from banyandb_tpu_torch.utils import hashing

    values = [b"a", b"bb", b"ccc"]
    codes = np.array([0, 1, 2, 1, 0, 2, 2, 1], dtype=np.int64)
    sids, _ = series_ids_for_columns("m", [DictColumn(values, codes)], len(codes))
    from banyandb_tpu.models.measure import DictColumn as JDict

    want, _ = jsids("m", [JDict(values, codes)], len(codes))
    assert np.asarray(sids).tolist() == np.asarray(want).tolist()
    for i, c in enumerate(codes.tolist()):
        assert int(sids[i]) == hashing.series_id([b"m", values[c]])


def test_relabel_exposition_matches_jax():
    from banyandb_tpu.cluster.workers import relabel_exposition as jrelabel
    from banyandb_tpu_torch.cluster.workers import relabel_exposition

    text = (
        "# HELP x y\n"
        'banyandb_write_ms_count{model="measure"} 3\n'
        "banyandb_rss_bytes 12.5\n"
        'banyandb_kernel_launches{kernel="fused_group_multi"} 4.0\n'
    )
    out = relabel_exposition(text, {"worker": "w007"})
    assert out == jrelabel(text, {"worker": "w007"})
    assert 'banyandb_write_ms_count{model="measure",worker="w007"} 3' in out
    assert 'banyandb_rss_bytes{worker="w007"} 12.5' in out
    assert 'banyandb_kernel_launches{kernel="fused_group_multi",worker="w007"} 4.0' in out
    assert "# HELP" not in out


# -- serde: every reply a worker sends is plain JSON ---------------------------


def _plain(v, path="reply"):
    """Every leaf a JSON-native Python value: no tensor, numpy scalar or
    bytes (``type(...) is``: numpy's float64 subclasses float)."""
    if isinstance(v, dict):
        for k, x in v.items():
            assert type(k) is str, f"{path}: key {k!r}"
            _plain(x, f"{path}.{k}")
    elif isinstance(v, list):
        for i, x in enumerate(v):
            _plain(x, f"{path}[{i}]")
    else:
        assert type(v) in (str, int, float, bool, type(None)), f"{path}: {type(v)}"


def _same_json(a, b) -> bool:
    """Equal JSON values, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_json(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_same_json, a, b))
    return type(a) is type(b) and a == b


def _round_trip(reply) -> dict:
    _plain(reply)
    back = json.loads(json.dumps(reply))
    assert _same_json(back, reply)
    return back


@pytest.mark.parametrize("frame", ["v2", "v1"])
def test_serde_round_trip_of_every_worker_reply(tmp_path, monkeypatch, frame):
    """A port DataNode answers every topic a worker serves; each reply
    crosses json.dumps/json.loads unchanged.  ``v`` holds NaN in one
    group and the IN filter leaves empty groups whose min/max are ±inf:
    the partials frame (binary v2 and per-value JSON v1) keeps both."""
    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import SchemaRegistry
    from banyandb_tpu_torch.api import schema as S
    from banyandb_tpu_torch.cluster import DataNode, serde
    from banyandb_tpu_torch.cluster.workers import _ctl_handler, _metrics_reply

    if frame == "v1":
        monkeypatch.setenv("BYDB_PARTIALS_FRAME_V1", "1")
    reg = SchemaRegistry(tmp_path)
    dn = DataNode("w000", reg, tmp_path / "data", device="cpu")
    try:
        sync = lambda kind, obj: _round_trip(dn.bus.handle(  # noqa: E731
            "schema-sync", {"kind": kind, "item": _item(obj)}))
        sync("group", jschema.Group("g", jschema.Catalog.MEASURE,
                                    jschema.ResourceOpts(shard_num=2)))
        sync("measure", jschema.Measure(
            group="g", name="m",
            tags=(jschema.TagSpec("svc", jschema.TagType.STRING),
                  jschema.TagSpec("region", jschema.TagType.STRING)),
            fields=(jschema.FieldSpec("v", jschema.FieldType.FLOAT),),
            entity=jschema.Entity(("svc",))))
        sync("topn", jschema.TopNAggregation(
            group="g", name="top_svc", source_measure="m", field_name="v",
            group_by_tag_names=("svc",)))
        dn.stream.create_stream(S.Stream(
            group="g", name="logs", tags=(S.TagSpec("svc", S.TagType.STRING),),
            entity=("svc",)))
        dn.trace.create_trace(S.Trace(
            group="g", name="sw", tags=(S.TagSpec("trace_id", S.TagType.STRING),
                                        S.TagSpec("dur", S.TagType.INT)),
            trace_id_tag="trace_id"))
        # region r0 (even i): NaN in s2, +inf in s0 at i = 0, -inf in s4
        special = {0: float("inf"), 4: float("-inf")}
        pts = [{"ts": T0 + i, "tags": {"svc": f"s{i % 6}", "region": f"r{i % 2}"},
                "fields": {"v": float("nan") if i % 6 == 2 else special.get(i, float(i))},
                "version": 1}
               for i in range(64)]
        _round_trip(dn.bus.handle("streamagg", dict(STREAMAGG)))
        _round_trip(dn.bus.handle("measure-write", {"request": {
            "group": "g", "name": "m", "points": pts}}))
        _round_trip(dn.bus.handle("measure-write-cols", _cols_env(100, 16)))
        _round_trip(dn.bus.handle("stream-write", {"group": "g", "name": "logs", "elements": [
            {"element_id": f"e{i}", "ts": T0 + i, "tags": {"svc": f"s{i % 3}"},
             "body": base64.b64encode(bytes([i, 0, 255])).decode()} for i in range(12)]}))
        _round_trip(dn.bus.handle("trace-write", {"group": "g", "name": "sw", "spans": [
            {"ts": T0 + i, "tags": {"trace_id": f"t{i % 2}", "dur": i},
             "span": base64.b64encode(bytes([i, 1])).decode()} for i in range(8)],
            "ordered_tags": ["dur"]}))
        server = type("S", (), {"wm_path": None, "applied_seq": 0})()
        _round_trip(_ctl_handler(dn, server, {"op": "flush"}))
        span = f"TIME BETWEEN {T0} AND {HI}"
        for ql in (f"SELECT max(v) FROM MEASURE m IN g {span} "
                   "WHERE region IN ('r0', 'r9') GROUP BY svc",
                   f"SELECT percentile(v, 50) FROM MEASURE m IN g {span} GROUP BY region"):
            req = serde.query_request_to_json(bydbql.parse(ql))
            reply = _round_trip(dn.bus.handle("measure-query-partial", {
                "request": req, "hist_range": [0.0, 200.0] if "percentile" in ql else None}))
            got = serde.partials_from_json(reply["partials"])
            direct = dn.measure.query_partials(
                bydbql.parse(ql), hist_range=(0.0, 200.0) if "percentile" in ql else None)
            for part in ("sums", "mins", "maxs"):
                for f, col in getattr(direct, part).items():
                    np.testing.assert_array_equal(getattr(got, part)[f], np.asarray(col))
            if "max(v)" in ql:
                mins, maxs = np.asarray(got.mins["v"]), np.asarray(got.maxs["v"])
                sums = np.asarray(got.sums["v"])
                assert np.isposinf(maxs).any() and np.isneginf(mins).any(), (mins, maxs)
                assert np.isnan(sums).any(), sums
            _round_trip(dn.bus.handle("measure-query-raw", {"request": req}))
        raw = serde.query_request_to_json(bydbql.parse(
            f"SELECT * FROM MEASURE m IN g {span} LIMIT 100"))
        rows = _round_trip(dn.bus.handle("measure-query-raw", {"request": raw}))
        assert any(math.isnan(dp["fields"]["v"]) for dp in rows["data_points"])
        _round_trip(dn.bus.handle("stream-query", {"request": {
            "groups": ["g"], "name": "logs", "time_range": [T0, HI], "limit": 20}}))
        _round_trip(dn.bus.handle("trace-query-by-id", {
            "group": "g", "name": "sw", "trace_id": "t1"}))
        dn.measure.topn.flush_all_windows()
        _round_trip(dn.bus.handle("topn", {
            "group": "g", "name": "top_svc", "time_range": [T0 - 120_000, HI], "n": 3}))
        _round_trip(dn.bus.handle("streamagg", {"op": "stats"}))
        _round_trip(dn.bus.handle("health", {}))
        _round_trip(_metrics_reply({}))
        # an empty group's extremes (count 0: min +inf, max -inf) beside
        # a NaN sum, as a combine of partials can carry them
        from banyandb_tpu_torch.query.measure_exec import Partials

        p = Partials(("svc",), [(b"s0",), (b"s1",)], count=np.array([0.0, 3.0]),
                     sums={"v": np.array([0.0, np.nan])},
                     mins={"v": np.array([np.inf, 1.0])},
                     maxs={"v": np.array([-np.inf, np.nan])})
        back = serde.partials_from_json(_round_trip(serde.partials_to_json(p)))
        for part in ("count", "sums", "mins", "maxs"):
            a, b = getattr(back, part), getattr(p, part)
            if part == "count":
                a, b = {"": a}, {"": b}
            for f in b:
                np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]))
        assert back.groups == p.groups
    finally:
        dn.measure.close()
        dn.stream.close()
        dn.trace.close()


# -- state carried across packages ---------------------------------------------


def test_jax_written_worker_root_opens_in_the_port(tmp_path):
    """A root the JAX server wrote with workers=2 (each worker's
    ``workers/w00i/data``, its flush.wm, the schema and the streamagg
    registrations) opens in the port with workers=2 and answers every
    query with the same bytes."""
    from banyandb_tpu.server import StandaloneServer as JServer

    root = tmp_path / "carry"
    jsrv = JServer(root, port=0, workers=2)
    try:
        _boot(jsrv)
        want = [_result(jsrv, ql) for ql in QUERIES]
    finally:
        jsrv.stop()
    assert (root / "workers" / "w000" / "data").is_dir()
    assert (root / "workers" / "w001" / "flush.wm").is_file()
    srv = _port(root, 2)
    try:
        srv.start()
        assert [_result(srv, ql) for ql in QUERIES] == want
    finally:
        srv.stop()
