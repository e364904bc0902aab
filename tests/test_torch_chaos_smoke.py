"""The port's chaos harness (``banyandb_tpu_torch/harness/chaos.py``)
against the JAX package's (``scripts/chaos.py``).

- ``run_smoke`` on ``"cpu"`` (data nodes, shard workers and the
  rebalance cluster on the host) with the assertions of
  ``tests/test_chaos.py::test_chaos_smoke``.
- The smoke's seeded fault schedules (``FaultPlane``) decide the same
  faults, site by site, in both packages; other seeds decide others.
- The subprocess soak (``run_soak``), ``slow`` as in the reference:
  three ``python -m banyandb_tpu_torch.server --role data --device cpu``
  children and a liaison under SIGKILL cycles.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import chaos as jchaos  # noqa: E402

from banyandb_tpu.cluster.faults import FaultPlane as JPlane  # noqa: E402
from banyandb_tpu_torch.cluster.faults import FaultPlane as TPlane  # noqa: E402
from banyandb_tpu_torch.harness import chaos  # noqa: E402
from test_torch_mirror_support import hang_limit  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def test_chaos_smoke(tmp_path):
    with hang_limit(300):
        stats = chaos.run_smoke(tmp_path / "chaos", seed=7, device="cpu")
    assert stats["kill_cycles"] >= 3
    assert stats["degraded_seen"] >= 1
    assert stats["faults_injected"] > 0
    assert stats["acked_a"] > 0 and stats["acked_c"] > 0
    # deadline invariant: asserted per-query inside the harness too
    assert stats["max_query_wall_s"] <= 4.0
    assert stats["worker_kill_cycles"] >= 2
    assert stats["worker_restarts"] >= 2
    assert stats["worker_acked"] > 0
    assert max(stats["worker_degraded_windows_s"]) < 45
    assert stats["rebalance_under_kill"] >= 1
    assert stats["qos_armed"] == 1


@pytest.mark.parametrize("spec", [
    # the smoke's fault schedule (phase C), its worker kill plan (D) and
    # its join/kill plan (E), at two seeds each
    "seed={};rpc=delay:p=0.2:ms=5;rpc=error:every=17:after=5;"
    "sync=corrupt:every=9:count=2;disk=enospc:every=7:after=1:count=2",
    "seed={};worker=w000:at=1;worker=w001:at=2",
    "seed={};join=r3:at=1;kill=r0:at=1",
    "seed={};rpc=error:p=0.3",
])
@pytest.mark.parametrize("seed", [7, 42])
def test_fault_schedules_equal_across_packages(spec, seed):
    text = spec.format(seed)
    j, t = JPlane(text), TPlane(text)
    for site in ("rpc", "sync", "disk", "worker", "rpc", "disk"):
        for _ in range(40):
            a, b = j.decide(site), t.decide(site)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.kind, a.params) == (b.kind, b.params)
    assert t.history == j.history
    assert t.counters() == j.counters()
    for cycle in (1, 2, 3):
        assert t.kills_for_cycle(cycle, site="worker") == j.kills_for_cycle(cycle, site="worker")
        assert t.events_for_cycle(cycle) == j.events_for_cycle(cycle)


def test_chaos_smoke_seed_changes_schedule():
    spec = "seed={};rpc=error:p=0.3"
    a, b = TPlane(spec.format(3)), TPlane(spec.format(4))
    assert [i for i in range(64) if a.decide("rpc")] != [
        i for i in range(64) if b.decide("rpc")]


def test_smoke_phases_share_the_references_shape():
    """The port's harness keeps the reference's phases and helpers."""
    for name in ("_schema", "_points", "_count_req", "_total", "_bind_server",
                 "_smoke_wqueue_cycles", "_smoke_degradation",
                 "_smoke_fault_schedule", "_smoke_worker_cycles",
                 "_smoke_rebalance_under_kill", "run_smoke", "_child_env",
                 "run_soak", "main"):
        assert callable(getattr(chaos, name)), name
        assert callable(getattr(jchaos, name)), name
    assert chaos._points(5, 3)[0].tags == jchaos._points(5, 3)[0].tags
    env = chaos._child_env()
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(REPO)
    assert env["BYDB_QUERY_DEADLINE_S"] == "10"


def test_chaos_module_without_a_mode_prints_usage():
    run = subprocess.run(
        [sys.executable, "-m", "banyandb_tpu_torch.harness.chaos", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert run.returncode == 2
    assert "--smoke" in run.stdout and "--soak SECONDS" in run.stdout


@pytest.mark.slow  # real subprocess cluster: boots + kill/restart cycles
def test_chaos_soak(tmp_path):
    seconds = float(os.environ.get("BYDB_CHAOS_SECONDS", "90"))
    with hang_limit(seconds + 600):
        stats = chaos.run_soak(tmp_path / "soak", seconds=seconds, device="cpu")
    assert stats["kill_cycles"] >= 3
    assert stats["degraded_seen"] >= 1
    assert stats["acked"] > 0
    assert stats["max_query_wall_s"] <= 15.0
