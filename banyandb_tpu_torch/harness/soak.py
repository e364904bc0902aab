"""Standalone-vs-cluster replay soak.

A standalone engine, a two-node cluster and, when asked for, a
mesh-fastpath liaison over the same data nodes hold identical data
while randomized BydbQL queries, interleaved with fresh writes, flushes
and merges so snapshots move underneath, must return identical results
from every topology.

    python -m banyandb_tpu_torch.harness.soak --seconds 300 --seed 7 \\
        --report soak-report.jsonl [--device cpu] [--mesh-slots 4]

Every divergence and every failed query is appended to the report as
one JSON line (the query, each topology's normalized result or the
error, and the dataset epoch); the exit code is 1 if any divergence or
error occurred.  ``run_soak()`` is importable.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from banyandb_tpu_torch.backend import resolve_device

T0 = 1_700_000_000_000
GROUP, MEASURE = "sw", "cpm"
SVCS = 8
REGIONS = 3


def _schema(reg, shard_num):
    from banyandb_tpu_torch.api import (
        Catalog, Entity, FieldSpec, FieldType, Group, Measure,
        ResourceOpts, TagSpec, TagType,
    )

    reg.create_group(
        Group(GROUP, Catalog.MEASURE, ResourceOpts(shard_num=shard_num))
    )
    reg.create_measure(
        Measure(
            group=GROUP, name=MEASURE,
            tags=(
                TagSpec("svc", TagType.STRING),
                TagSpec("region", TagType.STRING),
                TagSpec("status", TagType.INT),
            ),
            fields=(FieldSpec("value", FieldType.INT),),
            entity=Entity(("svc",)),
        )
    )


def _points(rng, epoch, n):
    from banyandb_tpu_torch.api import DataPointValue

    return tuple(
        DataPointValue(
            T0 + epoch * 100_000 + i,
            {
                "svc": f"s{rng.integers(0, SVCS)}",
                "region": f"r{rng.integers(0, REGIONS)}",
                "status": int((200, 404, 500)[rng.integers(0, 3)]),
            },
            {"value": int(rng.integers(0, 1000))},
            version=1,
        )
        for i in range(n)
    )


def _random_ql(rng, epoch) -> str:
    """One random query over everything written so far."""
    t_end = T0 + (epoch + 1) * 100_000
    agg = rng.choice(["count", "sum", "min", "max", "mean"])
    parts = [f"SELECT {agg}(value) FROM MEASURE {MEASURE} IN {GROUP}"]
    parts.append(f"TIME BETWEEN {T0} AND {t_end}")
    r = rng.integers(0, 4)
    if r == 1:
        parts.append(f"WHERE region = 'r{rng.integers(0, REGIONS)}'")
    elif r == 2:
        parts.append(f"WHERE status >= {int(rng.choice([200, 404, 500]))}")
    elif r == 3:
        parts.append(
            f"WHERE svc IN ('s{rng.integers(0, SVCS)}', 's{rng.integers(0, SVCS)}') "
            f"OR region = 'r{rng.integers(0, REGIONS)}'"
        )
    if rng.integers(0, 2):
        parts.append("GROUP BY " + rng.choice(["svc", "region", "svc, region"]))
        if rng.integers(0, 3) == 0:
            parts.append(f"TOP {int(rng.integers(2, 5))} BY value")
    parts.append("LIMIT 200")
    return " ".join(parts)


def _norm(res) -> list:
    """Order-independent comparable form.

    Floats round to 4 SIGNIFICANT digits: the device kernels accumulate
    in f32 (Kahan-bounded per tile), the topologies partition chunks
    differently and the mesh's min/max are f32 where the host combine's
    are f64, so float aggregates differ by accumulation order.  Counts
    compare exactly."""

    def r(v):
        if isinstance(v, (list, tuple)):
            return tuple(r(x) for x in v)
        if isinstance(v, float):
            return float(f"{v:.4g}") if v == v else v
        return v

    if res.data_points:
        return sorted(
            (dp["timestamp"], tuple(sorted(dp["tags"].items())))
            for dp in res.data_points
        )
    return sorted(
        (tuple(g), tuple(r(res.values[k][i]) for k in sorted(res.values)))
        for i, g in enumerate(res.groups)
    )


def run_soak(
    *,
    seconds: float = 0.0,
    iterations: int = 0,
    seed: int = 0,
    report_path: str | None = None,
    tmp_root: str | None = None,
    write_every: int = 5,
    batch: int = 400,
    device=None,
    mesh_slots=None,
) -> dict:
    """Soak for `seconds` (or `iterations` queries) on `device` (CUDA
    unless ``"cpu"`` is asked for).  `mesh_slots`: the devices of a
    third topology's ``len // 2`` x 2 mesh (e.g. ``["cuda"] * 4``);
    None soaks two topologies.  A mesh asked for that cannot be built
    raises.  -> {queries, writes, divergences, errors, launches} and,
    with a mesh, ``mesh_executions`` (the queries the mesh step ran;
    the others fell back to its liaison's scatter partials);
    ``launches`` counts the hand kernels each topology's queries
    launched in this process."""
    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import SchemaRegistry, WriteRequest
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport
    from banyandb_tpu_torch.models.measure import MeasureEngine
    from banyandb_tpu_torch.ops.hopper_kernels import LAUNCHES

    dev = resolve_device(device)
    root = tmp_root or tempfile.mkdtemp(prefix="bydb-soak-")
    rng = np.random.default_rng(seed)

    sreg = SchemaRegistry(f"{root}/standalone")
    _schema(sreg, shard_num=2)
    standalone = MeasureEngine(sreg, f"{root}/standalone/data", device=dev)

    transport = LocalTransport()
    nodes = []
    datanodes = []
    for i in range(2):
        reg = SchemaRegistry(f"{root}/n{i}")
        _schema(reg, shard_num=4)
        dn = DataNode(f"d{i}", reg, f"{root}/n{i}/data", device=dev)
        datanodes.append(dn)
        nodes.append(NodeInfo(dn.name, transport.register(dn.name, dn.bus)))
    lreg = SchemaRegistry(f"{root}/l")
    _schema(lreg, shard_num=4)
    liaison = Liaison(lreg, transport, nodes)
    topologies = {
        "standalone": standalone.query,
        "cluster": liaison.query_measure,
    }
    if mesh_slots is not None:
        # third topology: a mesh-fastpath liaison over the SAME data-node
        # engines (the slots' collective reduce, parallel/mesh_query.py)
        from banyandb_tpu_torch.parallel import make_mesh

        if len(mesh_slots) < 2 or len(mesh_slots) % 2:
            raise ValueError(f"mesh_slots: an even count >= 2, not {len(mesh_slots)}")
        mreg = SchemaRegistry(f"{root}/lm")
        _schema(mreg, shard_num=4)
        mesh_liaison = Liaison(mreg, transport, nodes)
        mesh_liaison.enable_mesh_fastpath(
            make_mesh(len(mesh_slots) // 2, 2, devices=list(mesh_slots)),
            {dn.name: dn.measure for dn in datanodes},
        )
        topologies["mesh"] = mesh_liaison.query_measure

    stats = {"queries": 0, "writes": 0, "divergences": 0, "errors": 0,
             "launches": {name: 0 for name in topologies}}
    deadline = time.time() + seconds if seconds else None
    epoch = 0
    try:
        while True:
            if deadline and time.time() >= deadline:
                break
            if iterations and stats["queries"] >= iterations:
                break
            # mutate both topologies identically, keep snapshots moving
            if stats["queries"] % write_every == 0:
                pts = _points(rng, epoch, batch)
                standalone.write(WriteRequest(GROUP, MEASURE, pts))
                liaison.write_measure(WriteRequest(GROUP, MEASURE, pts))
                if epoch % 2 == 0:
                    standalone.flush()
                if epoch % 3 == 0:
                    for db in standalone._tsdbs.values():
                        for seg in db.segments:
                            for shard in seg.shards:
                                shard.merge()
                stats["writes"] += batch
                epoch += 1
            ql = _random_ql(rng, epoch)
            # bdlint: disable=retry-backoff -- not a retry: a failed query
            # is counted and reported, and the soak asks the next one
            try:
                req = bydbql.parse(ql)
                results = {}
                for name, ask in topologies.items():
                    before = sum(LAUNCHES.values())
                    results[name] = _norm(ask(req))
                    stats["launches"][name] += sum(LAUNCHES.values()) - before
            except Exception as e:  # noqa: BLE001 - soak must survive
                stats["errors"] += 1
                _report(report_path, {"ql": ql, "error": repr(e)})
                stats["queries"] += 1
                continue
            base_topo = results["standalone"]
            if any(v != base_topo for v in results.values()):
                stats["divergences"] += 1
                _report(report_path, {"ql": ql, "epoch": epoch,
                                      **{k: v[:50] for k, v in results.items()}})
            stats["queries"] += 1
        if mesh_slots is not None:
            stats["mesh_executions"] = mesh_liaison.mesh_exec.executions
    finally:
        standalone.close()
        for dn in datanodes:
            dn.measure.close()
            dn.stream.close()
            dn.trace.close()
    return stats


def _report(path: str | None, doc: dict) -> None:
    """Append one JSON line to the report at `path` (none without one)."""
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(doc, default=str) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bydb soak (replay-diff harness)")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--iterations", type=int, default=0,
                    help="stop after N queries instead of a time budget")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default="soak-report.jsonl")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without CUDA only cpu runs")
    ap.add_argument("--mesh-slots", type=int, default=4,
                    help="slots of the mesh topology on --device (even, "
                    ">= 2); 0 soaks the standalone and cluster topologies only")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    stats = run_soak(
        seconds=0 if args.iterations else args.seconds,
        iterations=args.iterations,
        seed=args.seed,
        report_path=args.report,
        device=dev,
        mesh_slots=[dev] * args.mesh_slots if args.mesh_slots else None,
    )
    print(json.dumps(stats))
    return 1 if stats["divergences"] or stats["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
