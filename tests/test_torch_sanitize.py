"""bdsan for the port: the runtime sanitizers of tests/test_sanitize.py
over banyandb_tpu_torch.

- seeded-violation proofs: the lock wrapper catches an out-of-order
  acquisition against a declared graph (and records the same edges and
  violations as the reference's on the same acquisition sequences); the
  leak tracker catches a seeded leaked thread and fd;
- identity mapping: package-created locks carry their static
  declaration ids, over the port's own call graph;
- the one-shard concurrency stress: concurrent writes + queries +
  flush/merge/retention loops + TopN accumulation on a CPU engine, with
  every runtime lock-order edge required to be in the port's declared
  graph and zero leaked threads/fds afterwards.

The suite runs under the reference's sanitizers (tests/conftest.py
installs them for the whole run, so ``threading.Lock`` is already the
reference's factory here).  Every case that installs the port's
sanitizers therefore runs in a fresh child process started with
``BYDB_SANITIZE=1``; ``LockWatch`` cases with an explicit ``declared``
set run in-process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from banyandb_tpu_torch import sanitize
from banyandb_tpu_torch.sanitize import leaks, lockwatch
from test_torch_mirror_support import hang_limit

REPO = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def _child(code: str, tmp_path: Path, timeout: float = 240) -> dict:
    """Run `code` in a fresh interpreter with the port's sanitizers
    installed first; its last stdout line is a JSON object."""
    prelude = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(HERE)!r}]\n"
        "from banyandb_tpu_torch import sanitize\n"
        "assert sanitize.enabled()\n"
        "assert sanitize.install() is True\n"
    )
    env = dict(os.environ, BYDB_SANITIZE="1", PYTHONPATH=str(REPO))
    env.pop("BYDB_SANITIZE_WATCHDOG_S", None)
    with hang_limit(timeout + 30):
        out = subprocess.run(
            [sys.executable, "-c", prelude + code],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=timeout,
        )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# -- gate ---------------------------------------------------------------


def test_enabled_gate(monkeypatch):
    monkeypatch.setenv("BYDB_SANITIZE", "0")
    assert not sanitize.enabled()
    monkeypatch.setenv("BYDB_SANITIZE", "1")
    assert sanitize.enabled()
    monkeypatch.setenv("BYDB_SANITIZE", "yes")
    assert sanitize.enabled()
    monkeypatch.delenv("BYDB_SANITIZE")
    assert not sanitize.enabled()


def test_install_in_child_process(tmp_path):
    res = _child(
        "import threading\n"
        "from banyandb_tpu_torch.sanitize import lockwatch\n"
        "assert sanitize.installed() and lockwatch.installed()\n"
        "assert sanitize.install() is True\n"  # idempotent
        "print(json.dumps({'lock': threading.Lock.__name__,\n"
        "                  'rlock': threading.RLock.__name__}))\n",
        tmp_path,
    )
    assert res == {"lock": "_lock_factory", "rlock": "_rlock_factory"}


# -- lock wrapper -------------------------------------------------------


def _traced_pair(declared):
    w = lockwatch.LockWatch(declared=declared)
    a = lockwatch.TracedLock(lockwatch._REAL_LOCK(), "A", w)
    b = lockwatch.TracedLock(lockwatch._REAL_LOCK(), "B", w)
    return w, a, b


def test_traced_lock_behaves_like_a_lock():
    w, a, _b = _traced_pair(declared=None)
    assert not a.locked()
    with a:
        assert a.locked()
        # non-blocking re-acquire of a plain lock fails, like the real one
        assert a.acquire(blocking=False) is False
    assert not a.locked()
    assert a.acquire(timeout=0.1) is True
    a.release()
    assert ("A", "A") not in w.snapshot_edges()


def test_declared_order_records_edge_without_violation():
    w, a, b = _traced_pair(declared=frozenset({("A", "B")}))
    with a:
        with b:
            pass
    assert ("A", "B") in w.snapshot_edges()
    assert w.snapshot_violations() == []


def test_seeded_out_of_order_acquisition_flagged():
    w, a, b = _traced_pair(declared=frozenset({("A", "B")}))
    with b:
        with a:  # inverted: B held while acquiring A
            pass
    vs = w.snapshot_violations()
    assert [(v.held, v.acquired) for v in vs] == [("B", "A")]
    assert vs[0].thread and vs[0].site  # a witness, not just a boolean


def test_same_declaration_reacquire_records_no_edge():
    # two instances of one class share a declaration id: their nesting is
    # the static self-edge rule's business, not a runtime order edge
    w = lockwatch.LockWatch(declared=frozenset())
    a1 = lockwatch.TracedLock(lockwatch._REAL_LOCK(), "X", w)
    a2 = lockwatch.TracedLock(lockwatch._REAL_LOCK(), "X", w)
    with a1:
        with a2:
            pass
    assert w.snapshot_edges() == {}
    assert w.snapshot_violations() == []


def test_fallback_ids_are_exempt_from_validation():
    # unmapped (test-created, "path:line"-identified) locks record edges
    # but never violations: the declared graph knows nothing about them
    w = lockwatch.LockWatch(declared=frozenset())
    a = lockwatch.TracedLock(lockwatch._REAL_LOCK(), "tests/x.py:1", w)
    b = lockwatch.TracedLock(lockwatch._REAL_LOCK(), "tests/x.py:2", w)
    with a:
        with b:
            pass
    assert len(w.snapshot_edges()) == 1
    assert w.snapshot_violations() == []


# (declared set, acquisition script): "+X" acquires X, "-X" releases it
_SEQUENCES = [
    (frozenset({("A", "B")}), "+A +B -B -A"),
    (frozenset({("A", "B")}), "+B +A -A -B"),
    (frozenset({("A", "B"), ("B", "C")}), "+A +B +C -C -B -A +C +A -A -C"),
    (frozenset(), "+X +X -X -X +a:1 +b:2 -b:2 -a:1"),
    (None, "+A +B +C -B -C -A +C +B -B -C"),
    (frozenset({("A", "C")}), "+A +B -A +C -C -B"),
]


@pytest.mark.parametrize("declared,script", _SEQUENCES)
def test_lockwatch_parity_with_reference(declared, script):
    """The same acquisition sequence through both packages' LockWatch
    records the same edges (with the same witness thread) and the same
    violations."""
    from banyandb_tpu.sanitize import lockwatch as ref

    def run(mod):
        w = mod.LockWatch(declared=declared)
        locks: dict = {}
        for step in script.split():
            op, lid = step[0], step[1:]
            if lid not in locks:
                locks[lid] = []
            if op == "+":
                lk = mod.TracedLock(threading.RLock(), lid, w)
                lk.acquire()
                locks[lid].append(lk)
            else:
                locks[lid].pop().release()
        edges = {
            k: (v.held, v.acquired, v.thread)
            for k, v in w.snapshot_edges().items()
        }
        vs = [(v.held, v.acquired) for v in w.snapshot_violations()]
        return edges, vs

    assert run(lockwatch) == run(ref)


def test_package_locks_carry_declaration_ids(tmp_path):
    res = _child(
        "import tempfile\n"
        "from banyandb_tpu_torch.sanitize import lockwatch\n"
        "from banyandb_tpu_torch.cluster.handoff import HandoffController\n"
        "from banyandb_tpu_torch.storage.memtable import MemTable\n"
        "h = HandoffController(tempfile.mkdtemp())\n"
        "mt = MemTable(['t'], ['f'])\n"
        "print(json.dumps({\n"
        "  'traced': [isinstance(x, lockwatch.TracedLock)\n"
        "             for x in (h._lock, mt._lock)],\n"
        "  'ids': [h._lock.lock_id, mt._lock.lock_id]}))\n",
        tmp_path,
    )
    assert res["traced"] == [True, True]
    assert res["ids"] == [
        "banyandb_tpu_torch.cluster.handoff.HandoffController._lock",
        "banyandb_tpu_torch.storage.memtable.MemTable._lock",
    ]


def test_static_model_covers_known_declarations():
    m = lockwatch.load_static()
    ids = set(m.decl_sites.values())
    for want in (
        "banyandb_tpu_torch.cluster.wqueue.WriteQueue._lock",
        "banyandb_tpu_torch.cluster.wqueue.WriteQueue._pass_lock",
        "banyandb_tpu_torch.cluster.handoff.HandoffController._lock",
        "banyandb_tpu_torch.storage.memtable.MemTable._lock",
        "banyandb_tpu_torch.models.topn.TopNProcessorManager._obs_lock",
        "banyandb_tpu_torch.cluster.liaison.Liaison._alive_lock",
        "banyandb_tpu_torch.ops.hopper_kernels._lib_lock",
        "banyandb_tpu_torch.ops.hopper_kernels._scan_lock",
    ):
        assert want in ids, want
    # the TopN observation lock is an RLock (reentrant by design)
    assert "banyandb_tpu_torch.models.topn.TopNProcessorManager._obs_lock" in (
        m.reentrant
    )
    # every declaration lives in the port, never in the reference
    assert all("banyandb_tpu_torch" in p for p, _ln in m.decl_sites)


def test_declared_graph_with_extras_is_acyclic():
    """DECLARED_EXTRA_EDGES are reviewed additions to the static graph:
    the union must stay free of deadlock cycles, and every extra names
    two locks the port declares."""
    from banyandb_tpu_torch.lint.whole_program.lockorder import _cycles

    m = lockwatch.load_static()
    adj: dict = {}
    for a, b in m.declared:
        if a != b:
            adj.setdefault(a, set()).add(b)
    assert _cycles(adj) == []
    ids = set(m.decl_sites.values())
    for a, b in lockwatch.DECLARED_EXTRA_EDGES:
        assert a in ids and b in ids, (a, b)


# -- leak tracker -------------------------------------------------------


def test_leak_tracker_catches_seeded_thread():
    tr = leaks.LeakTracker(track_fds=False).snapshot()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="bdsan-seeded-leak")
    t.start()
    try:
        rep = tr.check(grace_s=0.2)
        assert [x.name for x in rep.threads] == ["bdsan-seeded-leak"]
        assert not rep.clean() and "bdsan-seeded-leak" in rep.render()
    finally:
        stop.set()
        t.join()
    assert tr.check(grace_s=2.0).clean()


def test_leak_tracker_allowlist_spares_named_daemons():
    tr = leaks.LeakTracker(
        thread_allowlist=(r"^spared-",), track_fds=False
    ).snapshot()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="spared-daemon")
    t.start()
    try:
        assert tr.check(grace_s=0.2).clean()
    finally:
        stop.set()
        t.join()


@pytest.mark.skipif(
    not os.path.isdir("/proc/self/fd"), reason="no /proc fd table"
)
def test_leak_tracker_catches_seeded_fd(tmp_path):
    tr = leaks.LeakTracker().snapshot()
    fd = os.open(tmp_path / "leak.bin", os.O_CREAT | os.O_WRONLY)
    # fd numbers recycle: if the number was open at snapshot time (and
    # closed since), evict it from the baseline so the leak is visible
    tr._fds.discard(fd)
    try:
        rep = tr.check(grace_s=0.2)
        assert any(f == fd for f, _target in rep.fds), rep.render()
    finally:
        os.close(fd)
    assert tr.check(grace_s=1.0).clean()


def test_thread_grace_window_tolerates_finishing_threads():
    before = leaks.thread_snapshot()
    t = threading.Thread(target=lambda: time.sleep(0.3), name="short-lived")
    t.start()
    # the thread outlives the check start but dies inside the grace
    assert leaks.leaked_threads(before, grace_s=2.0) == []
    t.join()


# -- the capstone stress ------------------------------------------------


def _build_stress_engine(root):
    from banyandb_tpu_torch.api import (
        Catalog,
        Entity,
        FieldSpec,
        FieldType,
        Group,
        IntervalRule,
        Measure,
        ResourceOpts,
        SchemaRegistry,
        TagSpec,
        TagType,
    )
    from banyandb_tpu_torch.api.schema import TopNAggregation
    from banyandb_tpu_torch.models.measure import MeasureEngine

    reg = SchemaRegistry(root)
    reg.create_group(
        Group(
            "stress",
            Catalog.MEASURE,
            ResourceOpts(
                shard_num=1,
                segment_interval=IntervalRule(1, "hour"),
                ttl=IntervalRule(2, "hour"),
            ),
        )
    )
    reg.create_measure(
        Measure(
            group="stress",
            name="cpm",
            tags=(
                TagSpec("svc", TagType.STRING),
                TagSpec("region", TagType.STRING),
            ),
            fields=(FieldSpec("value", FieldType.FLOAT),),
            entity=Entity(("svc",)),
        )
    )
    # a TopN rule so ingest drives the TopNProcessorManager concurrently
    reg.create_topn(
        TopNAggregation(
            group="stress",
            name="top-cpm",
            source_measure="cpm",
            field_name="value",
            group_by_tag_names=(),
            counters_number=50,
            lru_size=4,
        )
    )
    return MeasureEngine(reg, root / "data", device="cpu")


def run_stress(root: Path, seconds: float, writers: int = 2, queriers: int = 2):
    """One-shard concurrency stress on a CPU engine: N writer threads
    (row ingest with advancing event time, feeding flush/merge and a TopN
    rule), M query threads over the trailing window, while the real
    lifecycle loops flush/merge/retire underneath.  -> worker errors,
    counts, the lock-order witness edges new in the run that the
    declared graph lacks, and the leak report."""
    import numpy as np

    from banyandb_tpu_torch.api import (
        Aggregation,
        DataPointValue,
        GroupBy,
        QueryRequest,
        TimeRange,
        WriteRequest,
    )

    engine = _build_stress_engine(root)
    HOUR = 3_600_000
    now_ms = int(time.time() * 1000)
    t_start = now_ms - 5 * HOUR  # old enough that retention retires tails

    edges_before = (
        set(lockwatch.watch().snapshot_edges()) if sanitize.installed() else set()
    )
    tracker = leaks.LeakTracker().snapshot()

    engine.write(
        WriteRequest(
            "stress",
            "cpm",
            (
                DataPointValue(
                    ts_millis=t_start,
                    tags={"svc": "svc-0", "region": "r0"},
                    fields={"value": 1.0},
                    version=1,
                ),
            ),
        )
    )
    engine.query(
        QueryRequest(
            groups=("stress",),
            name="cpm",
            time_range=TimeRange(t_start - HOUR, t_start + HOUR),
            agg=Aggregation("sum", "value"),
            group_by=GroupBy(("svc",)),
        )
    )

    engine.start_lifecycle(
        flush_interval_s=0.05,
        flush_min_rows=1,
        retention_interval_s=0.3,
        merge_sweep_interval_s=0.2,
        idle_timeout_s=600.0,
    )
    stop = threading.Event()
    errors: list = []
    written = [0] * writers
    queried = [0] * queriers
    hw = [t_start]

    def writer(wid: int):
        rng = np.random.default_rng(100 + wid)
        batch = 200
        try:
            while not stop.is_set():
                base = hw[0]
                points = tuple(
                    DataPointValue(
                        ts_millis=int(base + (i * writers + wid) * 20),
                        tags={
                            "svc": f"svc-{int(rng.integers(0, 8))}",
                            "region": f"r{int(rng.integers(0, 3))}",
                        },
                        fields={"value": float(rng.integers(0, 1000))},
                        version=1,
                    )
                    for i in range(batch)
                )
                engine.write(WriteRequest("stress", "cpm", points))
                written[wid] += batch
                if wid == 0:
                    # ~4 minutes of event time per batch: the run
                    # crosses hourly segments and TTL horizons
                    hw[0] = base + 240_000
        except Exception as e:  # noqa: BLE001 - surfaced by the test
            errors.append(("writer", wid, repr(e)))

    def querier(qid: int):
        rng = np.random.default_rng(900 + qid)
        try:
            while not stop.is_set():
                end = hw[0]
                req = QueryRequest(
                    groups=("stress",),
                    name="cpm",
                    time_range=TimeRange(end - HOUR, end + HOUR),
                    agg=Aggregation(
                        ("sum", "mean", "count", "max")[int(rng.integers(0, 4))],
                        "value",
                    ),
                    group_by=(
                        GroupBy(("svc",)) if rng.integers(0, 2) else None
                    ),
                )
                engine.query(req)
                queried[qid] += 1
        except Exception as e:  # noqa: BLE001 - surfaced by the test
            errors.append(("querier", qid, repr(e)))

    threads = [
        threading.Thread(target=writer, args=(w,), name=f"stress-writer-{w}")
        for w in range(writers)
    ] + [
        threading.Thread(target=querier, args=(q,), name=f"stress-querier-{q}")
        for q in range(queriers)
    ]
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    # one forced synchronous tick proves the loops' stage bodies still
    # run clean after the storm, then stop everything
    engine._loops.tick()
    engine.topn.flush_all_windows()
    engine.close()

    new_edges = {}
    if sanitize.installed():
        all_edges = lockwatch.watch().snapshot_edges()
        new_edges = {e: w for e, w in all_edges.items() if e not in edges_before}
    report = tracker.check(grace_s=5.0)
    return {
        "errors": errors,
        "written": sum(written),
        "queried": sum(queried),
        "edges": len(new_edges),
        "undeclared": [
            f"{w.held} -> {w.acquired} at {w.site} [{w.thread}]"
            for w in lockwatch.undeclared_edges(new_edges)
        ],
        "leaks_clean": report.clean(),
        "leaks": report.render(),
    }


_STRESS = (
    "import pathlib, tempfile\n"
    "import test_torch_sanitize as t\n"
    "res = t.run_stress(pathlib.Path(tempfile.mkdtemp()), {seconds},\n"
    "                   writers={w}, queriers={q})\n"
    "print(json.dumps(res))\n"
)


def _assert_stress_clean(res):
    assert res["errors"] == [], res["errors"]
    assert res["written"] > 0 and res["queried"] > 0
    # acceptance: every runtime-observed edge between declared locks is
    # present in the static lock-order graph (+ reviewed extras)
    assert res["edges"] > 0  # the witness saw the package's locks nest
    assert res["undeclared"] == [], "\n".join(res["undeclared"])
    assert res["leaks_clean"], res["leaks"]


def test_stress_smoke_one_shard(tmp_path):
    """Tier-1 slice of the capstone stress (~4 s of load in a child)."""
    _assert_stress_clean(
        _child(_STRESS.format(seconds=3.0, w=2, q=2), tmp_path, timeout=180)
    )


@pytest.mark.slow
def test_stress_one_shard_sustained(tmp_path):
    """Minutes-long stress (BYDB_STRESS_SECONDS overrides, default 180)."""
    seconds = float(os.environ.get("BYDB_STRESS_SECONDS", "180"))
    _assert_stress_clean(
        _child(
            _STRESS.format(seconds=seconds, w=3, q=3), tmp_path,
            timeout=seconds + 300,
        )
    )


def test_smoke_lint_sanitize_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 19 of chip_smoke.py on the CPU at 131,072 points: the gate
    child exits 0 with no finding, and the sanitized server child (its
    own process, ``BYDB_SANITIZE=1``) answers as phase 13's server did,
    with every runtime lock edge declared and nothing leaked (the smoke
    checks all of it itself)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from banyandb_tpu_torch.obs import metrics as obs_metrics
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    # the smoke's process starts with an empty process-global meter, and
    # phase 13 checks its counters exactly; earlier tests in this worker
    # have counted into the shared one
    monkeypatch.setattr(obs_metrics, "_GLOBAL", None)

    n = 1 << 17
    for d in ("engine", "server", "sanitize"):
        (tmp_path / d).mkdir()
    with hang_limit(600):
        _, want = chip_smoke.engine_path(hk, n, "cpu", str(tmp_path / "engine"))
        _, server_fig, docs = chip_smoke.server_path(
            hk, n, "cpu", str(tmp_path / "server"), want
        )
        launches, fig = chip_smoke.lint_sanitize_phase(
            str(tmp_path / "sanitize"), n, "cpu", docs, server_fig
        )
    assert launches == dict.fromkeys(hk.LAUNCHES, 0)
    gate = fig["gate"]
    assert gate["findings"] == {}
    assert gate["suppressed"] == {
        "host-sync": 8, "resource-hygiene": 5, "retry-backoff": 2,
        "wp-lock-blocking": 1, "wp-shared-state": 7,
    }
    assert fig["undeclared_edges"] == [] and fig["leaks"] == "clean"
    assert fig["runtime_edges"] > 0 and fig["traced_locks"] > fig["traced_lock_ids"] > 0
    assert sorted(fig["walls_ms"]) == ["percentile", "topn"]
    assert fig["phase13"]["walls_ms"] == server_fig["walls_ms"]
