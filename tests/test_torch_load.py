"""The port's load/SLO harness (``banyandb_tpu_torch/harness/load.py``)
against the JAX package's (``scripts/load.py``).

- A short mixed write+query burst against a real gRPC-served
  standalone server on ``"cpu"`` completes with zero errors and sane
  counters (the assertions of ``tests/test_load_smoke.py``).
- The artifact of the same tiny run has the JAX ``run_load``'s keys,
  and ``_columns_env`` builds the reference's envelopes byte for byte
  from the same generator.
- A short CPU run of each other mode: ``run_expand``, ``run_scaling``,
  ``run_selftrace``, and (``slow``: its two phases last at least 10 s
  each) ``run_tenants``; the load command through ``main``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import load as jload  # noqa: E402

from banyandb_tpu_torch.harness import load  # noqa: E402
from test_torch_mirror_support import hang_limit  # noqa: E402


@pytest.fixture(autouse=True)
def _test_limit():
    with hang_limit(300):
        yield


def test_load_smoke(tmp_path):
    stats = load.run_load(
        seconds=4.0, writers=1, queriers=2, batch=200, seed=3,
        tmp_root=str(tmp_path / "srv"), device="cpu",
    )
    assert stats["write_errors"] == 0
    assert stats["query_errors"] == 0
    assert stats["points_written"] >= 200
    assert stats["queries"] >= 4
    assert stats["latency_ms"]["p99"] >= stats["latency_ms"]["p50"] > 0


def _keys(doc: dict) -> dict:
    """The artifact's key tree (dicts only; list items by their first)."""
    out = {}
    for k, v in doc.items():
        if isinstance(v, dict):
            out[k] = _keys(v)
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out[k] = [_keys(v[0])]
        else:
            out[k] = None
    return out


def test_artifact_keys_equal_the_references(tmp_path):
    kw = dict(seconds=2.0, writers=1, queriers=1, batch=200, seed=3)
    want = jload.run_load(tmp_root=str(tmp_path / "jax"), **kw)
    got = load.run_load(tmp_root=str(tmp_path / "port"), device="cpu", **kw)
    # the stages seen depend on which queries ran in the window
    stages = set(got.pop("stage_breakdown")) | set(want.pop("stage_breakdown"))
    assert {"gather", "merge"} <= stages
    assert _keys(got) == _keys(want)
    assert got["write_errors"] == want["write_errors"] == 0
    assert got["query_errors"] == want["query_errors"] == 0


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_columns_env_equals_the_references(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for batch in (1, 200, 500):
        ts = load.T0 + np.arange(batch, dtype=np.int64) * 10
        got = load._columns_env("load", "cpm", ts, b, batch)
        want = jload._columns_env("load", "cpm", ts, a, batch)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_run_expand_short():
    out = load.run_expand(
        seconds=6, writers=1, queriers=1, batch=100, start_nodes=2,
        end_nodes=3, shard_num=3, allow_small_host=True, device="cpu",
    )
    assert out["acked"] > 0 and out["acked_loss"] == 0
    assert out["served_after_move"] == out["acked"]
    assert out["write_errors"] == 0 and out["query_errors"] == 0
    assert out["rebalance"]["ok"] and out["epoch"] == 2
    assert set(out["p99_ms"]) == {"steady", "move_window", "post_cutover"}


def test_run_scaling_short():
    out = load.run_scaling(
        seconds=2, writers=1, queriers=1, batch=200, steps=(1, 2),
        allow_small_host=True, device="cpu",
    )
    assert set(out["phases"]) == {"workers_1", "workers_2"}
    assert out["write_errors"] == 0
    for p in out["phases"].values():
        assert p["query_errors"] == 0 and p["queries"] > 0
    assert out["phases"]["workers_2"]["workers"] == 2
    assert out["qps_scaling"] > 0


def test_run_selftrace_short(monkeypatch):
    # the sink flushes every 5 s by default: flush well inside the run
    monkeypatch.setenv("BYDB_SELF_TRACE_INTERVAL_S", "0.5")
    out = load.run_selftrace(seconds=2, writers=1, queriers=1, batch=200, device="cpu")
    assert out["write_errors"] == 0 and out["query_errors"] == 0
    assert out["selftrace_spans_off"] == 0
    assert out["selftrace_spans_on"] > 0
    assert out["selftrace_overhead_x"] is not None


@pytest.mark.slow  # two tenant phases of at least 10 s each, ~25 s here
def test_run_tenants_short():
    out = load.run_tenants(
        seconds=4, quota=500, abuse_x=10, batch=100, allow_small_host=True,
        query_interval_ms=250, device="cpu",
    )
    assert out["abuser_sheds"] > 0
    assert out["silent_drops"] == 0
    assert out["write_errors"] == 0 and out["query_errors"] == 0


def test_load_command_through_main(capsys):
    rc = load.main(["--device", "cpu", "--seconds", "2", "--writers", "1",
                    "--queriers", "1", "--batch", "200", "--max-p99-ms", "100000"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, stats["slo_fail"]
    assert stats["slo_fail"] == [] and stats["points_written"] > 0


def test_load_command_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load.main(["--seconds", "1"])


def _count_after_reopen(server_cls, root, device_kw) -> int:
    from banyandb_tpu_torch.server import TOPIC_QL

    srv = server_cls(root, **device_kw)
    srv.start()
    try:
        r = srv.bus.handle(TOPIC_QL, {"ql": (
            f"SELECT count(value) FROM MEASURE {load.MEASURE} IN {load.GROUP} "
            f"TIME BETWEEN {load.T0} AND {load.T0 + (1 << 40)}")})
        return int(sum(r["result"]["values"].get("count", ())))
    finally:
        srv.stop()


def test_graceful_stop_keeps_acked_memtable_rows(tmp_path):
    """Writes acked into the memtable survive ``stop()`` and a reopen in
    the port; the reference closes its engines without a flush and the
    reopened server answers none of them (its behaviour, pinned)."""
    from banyandb_tpu.server import StandaloneServer as JServer
    from banyandb_tpu_torch.cluster.bus import Topic
    from banyandb_tpu_torch.server import TOPIC_REGISTRY
    from banyandb_tpu_torch.server import StandaloneServer as TServer

    group = {"op": "create", "kind": "group", "item": {
        "name": load.GROUP, "catalog": "measure",
        "resource_opts": {"shard_num": 2, "replicas": 0,
                          "segment_interval": {"num": 1, "unit": "day"},
                          "ttl": {"num": 7, "unit": "day"}, "stages": []}}}
    measure = {"op": "create", "kind": "measure", "item": {
        "group": load.GROUP, "name": load.MEASURE,
        "tags": [{"name": "svc", "type": "string"}, {"name": "region", "type": "string"},
                 {"name": "status", "type": "int"}],
        "fields": [{"name": "value", "type": "float"}],
        "entity": {"tag_names": ["svc"]}, "interval": "", "index_mode": False}}
    got = {}
    for name, cls, kw in (("jax", JServer, {}), ("port", TServer, {"device": "cpu"})):
        root = tmp_path / name
        srv = cls(root, **kw)
        srv.start()
        try:
            srv.bus.handle(TOPIC_REGISTRY, group)
            srv.bus.handle(TOPIC_REGISTRY, measure)
            env = load._columns_env(load.GROUP, load.MEASURE,
                                    load.T0 + np.arange(500, dtype=np.int64) * 10,
                                    np.random.default_rng(0), 500)
            assert srv.bus.handle(Topic.MEASURE_WRITE_COLUMNS.value, env)["written"] == 500
        finally:
            srv.stop()
        got[name] = _count_after_reopen(cls, root, kw)
    assert got == {"jax": 0, "port": 500}
