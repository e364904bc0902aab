"""Phases 20-23 of ``chip_smoke.py`` rehearsed on the CPU at a small
size: the entry step against itself on the host and the multi-slot
dryruns (20), the replay soak over three topologies (21), the chaos
smoke (22) and the load run with its count-back through a reopened
server (23).  Each phase checks its own invariants and raises
``chip_smoke.Failed`` when one fails; here every launch count is 0
(the kernels' plain versions run on the CPU)."""

import sys
from pathlib import Path

from test_torch_mirror_support import hang_limit

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_smoke_driver_and_harness_phases_on_cpu(tmp_path):
    cs = _chip_smoke()
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    zero = dict.fromkeys(hk.LAUNCHES, 0)
    with hang_limit(600):
        entry, dryrun, fig = cs.entry_phase(hk, "cpu")
        assert entry == dryrun == zero
        assert fig["entry"]["outputs"] == {"count": [64], "hist": [64, 512]}
        assert sorted(fig["dryrun"]) == ["4", "8"]
        assert fig["dryrun"]["8"]["slots"] == ["cpu"] * 8

        launches, soak = cs.soak_phase(hk, "cpu", str(tmp_path / "soak"), seconds=4)
        assert launches == zero
        assert soak["queries"] > 0 and soak["divergences"] == soak["errors"] == 0
        assert set(soak["launches"]) == {"standalone", "cluster", "mesh"}

        launches, chaos = cs.chaos_phase(hk, "cpu", str(tmp_path / "chaos"))
        assert launches == zero
        assert chaos["kill_cycles"] >= 3 and chaos["worker_kill_cycles"] >= 2

        launches, load = cs.load_phase(hk, "cpu", str(tmp_path / "load"), seconds=3)
        assert launches == zero
        assert load["write_errors"] == load["query_errors"] == 0
        assert load["cores"] > 0
        for c in load["count_back"].values():
            assert c["count"] == load["points_written"]
        assert load["count_back"]["rescan"]["served"] == "scan"
