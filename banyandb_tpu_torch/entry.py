"""Driver entry points of the port.

- ``entry(device=None)``: the flagship per-chunk step (the fused measure
  scan -> filter -> group-by -> aggregate -> histogram function of one
  plan signature) and its example arguments on `device`.
- ``dryrun_multichip(n, devices=None)``: one full distributed query
  step over an n-slot ('shard', 'seg') mesh (``n_seg = 2`` when n is
  even), checked against the host union, then the same collective plane
  reached through a liaison's mesh fast path over two in-process data
  nodes.

Slots are devices.  With ``devices=None`` the mesh takes one slot per
CUDA card and raises when there are fewer than n; a caller that wants
several slots on one device (the tests on the CPU, the smoke on one
card) passes them: ``devices=["cuda"] * 8``.

    python -m banyandb_tpu_torch.entry [--device cpu] [--slots N]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from banyandb_tpu_torch.backend import resolve_device


def _example_chunk(nrows: int, device, seed: int = 0) -> dict:
    """The example chunk of `nrows` rows, drawn from `seed` as the
    reference draws it, as tensors on `device`."""
    rng = np.random.default_rng(seed)
    host = {
        "valid": np.ones(nrows, dtype=bool),
        "series": rng.integers(0, 1000, nrows).astype(np.int32),
        "ts": np.sort(rng.integers(0, 3_600_000, nrows)).astype(np.int32),
        "tags_code": {
            "svc": rng.integers(0, 64, nrows).astype(np.int32),
            "region": rng.integers(0, 4, nrows).astype(np.int32),
        },
        "fields": {
            "latency": rng.gamma(2.0, 40.0, nrows).astype(np.float32)
        },
    }

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return torch.from_numpy(x).to(device)

    return put(host)


def entry_spec():
    """The flagship plan signature: tags (region, svc), ``latency``,
    ``region != 3``, 64 groups by svc, min/max and a histogram, 8,192
    rows a chunk."""
    from banyandb_tpu_torch.query.measure_exec import PlanSpec, _PredSpec

    return PlanSpec(
        tags_code=("region", "svc"),
        fields=("latency",),
        preds=(_PredSpec("code", "region", "ne"),),
        group_tags=("svc",),
        radices=(64,),
        num_groups=64,
        want_minmax=True,
        hist_field="latency",
        nrows=8192,
    )


def entry(device=None):
    """-> (step, example_args): the single-device measure-query step and
    its arguments on `device` (CUDA unless ``"cpu"`` is asked for)."""
    from banyandb_tpu_torch.query.measure_exec import kernel_for, ship

    dev = resolve_device(device)
    spec = entry_spec()
    step = kernel_for(spec)
    chunk = _example_chunk(spec.nrows, dev)
    pred_vals = {"p0": ship(np.int32(3), dev)}
    args = (chunk, pred_vals, ship(np.float32(0.0), dev),
            ship(np.float32(1000.0), dev))
    return step, args


def dryrun_multichip(n_devices: int, *, devices=None) -> dict:
    """Run one full distributed query step on an `n_devices`-slot mesh
    over `devices` (default: the CUDA cards; too few raise), then the
    liaison's mesh fast path over the same mesh.  -> what ran: the
    mesh's slots and shape, the collective count against the host
    union, and the fast path's count against the points written."""
    from banyandb_tpu_torch.parallel import make_mesh

    if devices is not None:
        devices = list(devices)[:n_devices]
    n_seg = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices // n_seg, n_seg, devices=devices)
    out = _dryrun_impl(mesh)
    out["cluster"] = _dryrun_cluster_fastpath(mesh)
    return out


def _dryrun_impl(mesh) -> dict:
    from banyandb_tpu_torch.parallel import (
        DistPlan,
        distributed_aggregate,
        stack_shard_chunks,
    )
    from banyandb_tpu_torch.query.measure_exec import device_get

    rng = np.random.default_rng(7)
    nrows = 256
    per_device = [
        {
            "tags": {
                "svc": rng.integers(0, 8, nrows).astype(np.int32),
                "region": rng.integers(0, 3, nrows).astype(np.int32),
            },
            "fields": {"latency": rng.gamma(2.0, 40.0, nrows).astype(np.float32)},
        }
        for _ in range(mesh.size)
    ]
    plan = DistPlan(
        tags_code=("region", "svc"),
        fields=("latency",),
        group_tags=("svc",),
        radices=(8,),
        num_groups=8,
        eq_preds=("region",),
        topn=3,
        want_hist="latency",
    )
    chunks = stack_shard_chunks(mesh, per_device, plan.tags_code, plan.fields, nrows)
    out = distributed_aggregate(
        mesh, plan, chunks, pred_codes={"region": 1}, hist_lo=0.0, hist_span=1000.0
    )
    counts = device_get({"count": out["count"]})["count"]

    # the collective totals equal the host union
    region = np.concatenate([r["tags"]["region"] for r in per_device])
    expect = int((region == 1).sum())
    got = int(counts.sum())
    if got != expect:
        raise AssertionError(f"mesh count {got} != host union {expect}")
    return {
        "slots": [str(d) for d in mesh.devices],
        "shape": mesh.shape,
        "count": got,
        "expect": expect,
    }


def _dryrun_cluster_fastpath(mesh) -> dict:
    """The same collective plane reached through the liaison's mesh fast
    path over a two-data-node in-process cluster on the mesh's first
    slot's device."""
    from banyandb_tpu_torch.api import (
        Aggregation,
        Catalog,
        DataPointValue,
        Entity,
        FieldSpec,
        FieldType,
        Group,
        GroupBy,
        Measure,
        QueryRequest,
        ResourceOpts,
        SchemaRegistry,
        TagSpec,
        TagType,
        TimeRange,
        WriteRequest,
    )
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport

    def schema(reg):
        reg.create_group(Group("dg", Catalog.MEASURE, ResourceOpts(shard_num=2)))
        reg.create_measure(
            Measure(
                group="dg",
                name="m",
                tags=(TagSpec("svc", TagType.STRING),),
                fields=(FieldSpec("v", FieldType.FLOAT),),
                entity=Entity(("svc",)),
            )
        )

    device = mesh.devices[0]
    with tempfile.TemporaryDirectory(prefix="bydb-dryrun-") as d:
        tmp = Path(d)
        transport = LocalTransport()
        nodes, engines, dns = [], {}, []
        try:
            for i in range(2):
                reg = SchemaRegistry(tmp / f"n{i}")
                schema(reg)
                dn = DataNode(f"dn{i}", reg, tmp / f"n{i}/data", device=device)
                dns.append(dn)
                nodes.append(NodeInfo(dn.name, transport.register(dn.name, dn.bus)))
                engines[dn.name] = dn.measure
            lreg = SchemaRegistry(tmp / "l")
            schema(lreg)
            liaison = Liaison(lreg, transport, nodes)
            liaison.probe()
            t0 = 1_700_000_000_000
            n = 512
            pts = tuple(
                DataPointValue(t0 + i, {"svc": f"s{i % 4}"}, {"v": float(i % 97)},
                               version=1)
                for i in range(n)
            )
            liaison.write_measure(WriteRequest("dg", "m", pts))
            liaison.enable_mesh_fastpath(mesh, engines)
            res = liaison.query_measure(
                QueryRequest(
                    groups=("dg",),
                    name="m",
                    time_range=TimeRange(t0, t0 + n + 1),
                    group_by=GroupBy(("svc",)),
                    agg=Aggregation("count", "v"),
                )
            )
            if liaison.mesh_exec.executions != 1:
                raise AssertionError("mesh fast path did not run")
            got = int(sum(res.values["count"]))
            if got != n:
                raise AssertionError(f"mesh fast path counted {got} of {n}")
        finally:
            for dn in dns:
                dn.measure.close()
                dn.stream.close()
                dn.trace.close()
    return {"executions": 1, "count": got, "expect": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bydb entry (flagship step + multi-slot dryrun)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without CUDA only cpu runs")
    ap.add_argument("--slots", type=int, default=0,
                    help="dryrun over N slots on --device; 0 = one slot per "
                    "CUDA card (needs two or more)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    step, step_args = entry(dev)
    out = step(*step_args)
    print("entry() ok:", {k: tuple(v.shape) for k, v in out.items()
                          if isinstance(v, torch.Tensor)})
    if args.slots:
        n, devices = args.slots, [dev] * args.slots
    else:
        n, devices = torch.cuda.device_count() if dev.type == "cuda" else 0, None
        if n < 2:
            raise SystemExit("dryrun: fewer than two cards; pass --slots N")
    print(f"dryrun_multichip({n}) ok:", json.dumps(dryrun_multichip(n, devices=devices)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
