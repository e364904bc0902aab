"""The port's replay soak (``banyandb_tpu_torch/harness/soak.py``)
against the JAX package's (``scripts/soak.py``).

- The query stream (``_random_ql``) and the data (``_points``) are
  byte-equal to the reference's for three seeds.
- A short ``run_soak`` over three topologies on ``"cpu"`` (standalone,
  two-node cluster, a 2 x 2 mesh of CPU slots) ends with 0 divergences
  and 0 errors.
- The same writes, flushes, merges and queries through the port's
  standalone engine, the JAX standalone engine and the JAX cluster give
  equal answers under ``_norm`` (the JAX soak's own mesh topology does
  not trace under the installed JAX, ROADMAP Queue 3, so it is not run).
- A mesh topology asked for that cannot be built fails the run.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import soak as jsoak  # noqa: E402

from banyandb_tpu_torch.harness import soak as tsoak  # noqa: E402


def _point_doc(p) -> tuple:
    return (p.ts_millis, sorted(p.tags.items()), sorted(p.fields.items()), p.version)


@pytest.mark.parametrize("seed", [0, 11, 1234])
def test_query_stream_and_data_are_the_references(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for epoch in range(40):
        if epoch % 5 == 0:
            jp, tp = jsoak._points(a, epoch, 50), tsoak._points(b, epoch, 50)
            assert json.dumps([_point_doc(p) for p in tp]) == json.dumps(
                [_point_doc(p) for p in jp])
        assert tsoak._random_ql(b, epoch).encode() == jsoak._random_ql(a, epoch).encode()
    # both generators end in the same state
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


def test_run_soak_three_topologies_on_cpu(tmp_path):
    report = tmp_path / "report.jsonl"
    stats = tsoak.run_soak(
        iterations=120, seed=11, report_path=str(report),
        tmp_root=str(tmp_path / "soak"), device="cpu", mesh_slots=["cpu"] * 4,
    )
    text = report.read_text() if report.exists() else ""
    assert stats["queries"] == 120
    assert stats["writes"] > 0
    assert stats["errors"] == 0, text
    assert stats["divergences"] == 0, text
    assert set(stats["launches"]) == {"standalone", "cluster", "mesh"}
    # the mesh ran some queries itself (the others fell back)
    assert 0 < stats["mesh_executions"] <= 120


def test_run_soak_two_topologies_other_seed(tmp_path):
    stats = tsoak.run_soak(iterations=80, seed=1234, tmp_root=str(tmp_path / "soak"),
                           device="cpu")
    assert stats["divergences"] == 0 and stats["errors"] == 0
    assert set(stats["launches"]) == {"standalone", "cluster"}
    assert "mesh_executions" not in stats


@pytest.mark.parametrize("slots,match", [
    (["meta"] * 4, "unsupported device"),
    (["cpu"] * 3, "an even count >= 2"),
    (["cpu"], "an even count >= 2"),
])
def test_a_mesh_that_cannot_be_built_fails_the_run(tmp_path, slots, match):
    with pytest.raises(ValueError, match=match):
        tsoak.run_soak(iterations=5, tmp_root=str(tmp_path / "soak"), device="cpu",
                       mesh_slots=slots)


def test_answers_equal_the_jax_standalone_engine_and_cluster(tmp_path):
    from banyandb_tpu import bydbql as jql
    from banyandb_tpu.api import SchemaRegistry as JReg
    from banyandb_tpu.api import WriteRequest as JWrite
    from banyandb_tpu.cluster import DataNode as JNode
    from banyandb_tpu.cluster import Liaison as JLiaison
    from banyandb_tpu.cluster import NodeInfo as JInfo
    from banyandb_tpu.cluster.rpc import LocalTransport as JTransport
    from banyandb_tpu.models.measure import MeasureEngine as JEngine
    from banyandb_tpu_torch import bydbql as tql
    from banyandb_tpu_torch.api import SchemaRegistry as TReg
    from banyandb_tpu_torch.api import WriteRequest as TWrite
    from banyandb_tpu_torch.models.measure import MeasureEngine as TEngine

    jreg = JReg(tmp_path / "j")
    jsoak._schema(jreg, shard_num=2)
    jeng = JEngine(jreg, tmp_path / "j" / "data")
    treg = TReg(tmp_path / "t")
    tsoak._schema(treg, shard_num=2)
    teng = TEngine(treg, tmp_path / "t" / "data", device="cpu")
    transport, infos, nodes = JTransport(), [], []
    for i in range(2):
        reg = JReg(tmp_path / f"jn{i}")
        jsoak._schema(reg, shard_num=4)
        dn = JNode(f"d{i}", reg, tmp_path / f"jn{i}" / "data")
        nodes.append(dn)
        infos.append(JInfo(dn.name, transport.register(dn.name, dn.bus)))
    lreg = JReg(tmp_path / "jl")
    jsoak._schema(lreg, shard_num=4)
    jliaison = JLiaison(lreg, transport, infos)

    rng = np.random.default_rng(5)
    epoch, asked, grouped = 0, 0, 0
    try:
        for q in range(60):
            if q % 5 == 0:
                pts = tsoak._points(rng, epoch, 400)
                docs = [_point_doc(p) for p in pts]
                from banyandb_tpu.api import DataPointValue as JPoint

                jpts = tuple(JPoint(ts, dict(tags), dict(fields), version=v)
                             for ts, tags, fields, v in docs)
                teng.write(TWrite(tsoak.GROUP, tsoak.MEASURE, pts))
                jeng.write(JWrite(jsoak.GROUP, jsoak.MEASURE, jpts))
                jliaison.write_measure(JWrite(jsoak.GROUP, jsoak.MEASURE, jpts))
                if epoch % 2 == 0:
                    teng.flush()
                    jeng.flush()
                if epoch % 3 == 0:
                    for eng in (teng, jeng):
                        for db in eng._tsdbs.values():
                            for seg in db.segments:
                                for shard in seg.shards:
                                    shard.merge()
                epoch += 1
            ql = tsoak._random_ql(rng, epoch)
            got = tsoak._norm(teng.query(tql.parse(ql)))
            want = jsoak._norm(jeng.query(jql.parse(ql)))
            assert got == want, ql
            assert jsoak._norm(jliaison.query_measure(jql.parse(ql))) == want, ql
            asked += 1
            grouped += "GROUP BY" in ql
    finally:
        teng.close()
        jeng.close()
        for dn in nodes:
            dn.measure.close()
            dn.stream.close()
            dn.trace.close()
    assert asked == 60 and grouped > 0


def test_soak_module_runs_with_python_m(tmp_path):
    import os
    import subprocess

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    run = subprocess.run(
        [sys.executable, "-m", "banyandb_tpu_torch.harness.soak", "--device", "cpu",
         "--iterations", "20", "--seed", "3", "--report", str(tmp_path / "r.jsonl")],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr
    stats = json.loads(run.stdout.strip().splitlines()[-1])
    assert stats["queries"] == 20 and stats["divergences"] == stats["errors"] == 0
    assert "mesh" in stats["launches"]
