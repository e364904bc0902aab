"""The Hopper kernels on the card: each against its plain version, and
the measure aggregate query fused vs staged through them.

Marked ``cuda``: these tests need an NVIDIA card and ``nvcc`` and skip
elsewhere.  The file imports neither jax nor banyandb_tpu, so it runs
on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances as in chip_smoke.py: counts exact, sums exact on
integer-valued data and within rtol=1e-5 otherwise (the kernel and the
plain version sum a tile in different orders); widen and prefix sum
exact; the ``scatter`` and ``sort`` group reduce give the same bytes on
every run.
"""

import numpy as np
import pytest
import torch

from banyandb_tpu_torch.ops import hopper_kernels as hk

pytestmark = pytest.mark.cuda

RTOL = 1e-5


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "n,f,g,integer",
    [(0, 2, 16, True), (65536, 0, 64, True), (65536, 2, 100, True),
     (1 << 20, 2, 1024, False), (1 << 18, 1, 8192, True),
     # fewer tiles than row blocks; a tile count no block count divides
     (2048, 2, 1024, False), (6144, 2, 1024, True), (133 * 2048, 2, 1024, False),
     # several group tiles at F = 2; F = 0, 3 and 5 (two launches)
     (1 << 18, 2, 8192, False), (1 << 18, 0, 8192, True), (65536, 3, 300, False),
     (65536, 5, 64, True)],
)
def test_fused_group_multi_matches_plain(dev, n, f, g, integer):
    rng = np.random.default_rng(n + g)
    codes = torch.from_numpy(rng.integers(-1, g + 1, n).astype(np.int32)).to(dev)
    pred = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.95).to(dev)
    if integer:
        vals = rng.integers(0, 100, (f, n)).astype(np.float32)
    else:
        vals = rng.gamma(2.0, 40.0, (f, n)).astype(np.float32)
    vals = torch.from_numpy(vals).to(dev)
    before = hk.LAUNCHES["fused_group_multi"]
    kc, ks = hk.fused_group_multi(codes, pred, vals, valid, num_groups=g)
    pc, ps = hk.fused_group_multi_plain(codes, pred, vals, valid, g)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["fused_group_multi"] == before + (1 if n else 0)
    assert torch.equal(kc, pc)
    if integer:
        assert torch.equal(ks, ps)
    else:
        torch.testing.assert_close(ks, ps, rtol=RTOL, atol=0)
    # the same bits on every run
    kc2, ks2 = hk.fused_group_multi(codes, pred, vals, valid, num_groups=g)
    assert torch.equal(kc, kc2) and torch.equal(ks, ks2)


def _oracle_sums(codes, pred, vals, valid, g):
    m = pred & valid & (codes >= 0) & (codes < g)
    return np.stack([
        np.bincount(codes[m], weights=v[m].astype(np.float64), minlength=g)
        for v in vals
    ])


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,f", [(1 << 20, 2), (1 << 20, 1), (6144, 2)])
def test_fused_group_multi_series_sorted_runs(dev, n, f, integer):
    """Rows stored by (series, ts), as parts keep them: 8,192 series over
    1,024 groups (series // 8, codes permuted), runs of ~128 rows; pred
    and valid drop rows at random inside the runs."""
    rng = np.random.default_rng(21 + n + f)
    g = 1024
    series = np.sort(rng.integers(0, 8 * g, n))
    codes = rng.permutation(g).astype(np.int32)[series // 8]
    pred = rng.random(n) < 0.9
    valid = rng.random(n) < 0.95
    if integer:
        vals = rng.integers(0, 100, (f, n)).astype(np.float32)
    else:
        vals = rng.gamma(2.0, 40.0, (f, n)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (codes, pred, vals, valid)]
    kc, ks = hk.fused_group_multi(*args, num_groups=g)
    pc, ps = hk.fused_group_multi_plain(*args, g)
    assert torch.equal(kc, pc)
    kc2, ks2 = hk.fused_group_multi(*args, num_groups=g)
    assert torch.equal(kc, kc2) and torch.equal(ks, ks2)
    ks = ks.cpu().numpy()
    if integer:
        assert np.array_equal(ks, ps.cpu().numpy())
    else:
        np.testing.assert_allclose(ks, ps.cpu().numpy(), rtol=RTOL, atol=0)
    np.testing.assert_allclose(ks, _oracle_sums(codes, pred, vals, valid, g),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("n", [2048, 1 << 20])
def test_widen_narrow_matches_plain(dev, dtype, n):
    info = torch.iinfo(dtype)
    x = torch.randint(info.min, info.max + 1, (n,), dtype=dtype, device=dev)
    out = hk.widen_narrow(x)
    assert out.dtype == torch.int32
    assert torch.equal(out, hk.widen_narrow_plain(x))


def test_query_fused_and_staged_identical_on_card(dev, monkeypatch):
    from banyandb_tpu_torch.api.model import (
        Aggregation, Condition, GroupBy, QueryRequest, TimeRange,
    )
    from banyandb_tpu_torch.api.schema import (
        Entity, FieldSpec, FieldType, Measure, TagSpec, TagType,
    )
    from banyandb_tpu_torch.query import measure_exec as me
    from banyandb_tpu_torch.storage.part import ColumnData

    rng = np.random.default_rng(5)
    n = 1 << 16
    m = Measure(
        "g", "m",
        (TagSpec("svc", TagType.STRING), TagSpec("region", TagType.STRING)),
        (FieldSpec("lat", FieldType.FLOAT), FieldSpec("calls", FieldType.INT)),
        Entity(("svc",)),
    )
    src = ColumnData(
        ts=np.arange(n, dtype=np.int64),
        series=np.arange(n, dtype=np.int64) % 97,
        version=np.ones(n, np.int64),
        tags={"svc": rng.integers(0, 200, n).astype(np.int16),
              "region": rng.integers(0, 8, n).astype(np.int8)},
        fields={"lat": rng.gamma(2.0, 40.0, n), "calls": rng.integers(0, 99, n) * 1.0},
        dicts={"svc": [b"s%03d" % i for i in range(200)],
               "region": [b"r%d" % i for i in range(8)]},
    )
    req = QueryRequest(
        ("g",), "m", TimeRange(0, n), criteria=Condition("region", "ne", "r3"),
        group_by=GroupBy(("svc",)),
        agg=Aggregation("percentile", "lat", quantiles=(0.5, 0.99)),
    )
    monkeypatch.setattr(me, "SCAN_CHUNK", 1 << 14)
    monkeypatch.setenv("BYDB_DEVICE_DECODE", "1")
    out = {}
    hk.reset_launches()
    for fused in ("1", "0"):
        monkeypatch.setenv("BYDB_FUSED", fused)
        out[fused] = me.compute_partials(m, req, [src], device=dev)
    assert out["1"].content_bytes() == out["0"].content_bytes()
    assert hk.LAUNCHES["fused_group_multi"] > 0
    assert hk.LAUNCHES["widen_narrow"] > 0  # the staged path widens
    cpu = me.compute_partials(m, req, [src], device="cpu")
    assert np.array_equal(cpu.count, out["1"].count)
    assert np.array_equal(cpu.hist, out["1"].hist)


@pytest.mark.parametrize(
    "case", ["one-tile", "small", "wraps-past-2^31", "wide", "main-path",
             "2^24", "odd-window", "wraps-below-2^31"]
)
def test_prefix_sum_narrow_matches_plain(dev, case):
    rng = np.random.default_rng(11)
    # odd-window: 34 scan tiles of 4,096 rows (the last half full), not a
    # multiple of the 32-word look-back window
    n = {"one-tile": hk.TILE, "small": 2 * hk.TILE, "wraps-past-2^31": 4 * hk.TILE,
         "wide": 3 * hk.TILE, "main-path": 1 << 20, "2^24": 1 << 24,
         "odd-window": 67 * hk.TILE, "wraps-below-2^31": 2048 * hk.TILE}[case]
    if case == "wraps-past-2^31":
        x = np.full(n, 2**20, dtype=np.int32)
    elif case == "wraps-below-2^31":
        x = np.full(n, -(2**10), dtype=np.int32)
    elif case == "wide":
        x = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    else:
        x = rng.integers(-1000, 1000, n).astype(np.int32)
    xt = torch.from_numpy(x).to(dev)
    before = hk.LAUNCHES["prefix_sum_narrow"]
    out = hk.prefix_sum_narrow(xt)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["prefix_sum_narrow"] == before + 1
    assert torch.equal(out, hk.prefix_sum_narrow_plain(xt))
    assert np.array_equal(out.cpu().numpy(), np.cumsum(x, dtype=np.int32))
    # the same bits on a second run (the look-back groups tiles anew)
    assert torch.equal(hk.prefix_sum_narrow(xt), out)


def test_delta_decode_launches_the_kernel(dev):
    from banyandb_tpu_torch import ops

    rng = np.random.default_rng(12)
    deltas = rng.integers(0, 50, 2 * hk.TILE - 1).astype(np.int32)
    before = hk.LAUNCHES["prefix_sum_narrow"]
    out = ops.delta_decode(5, torch.from_numpy(deltas).to(dev))
    assert hk.LAUNCHES["prefix_sum_narrow"] == before + 1
    want = np.concatenate([[5], 5 + np.cumsum(deltas)]).astype(np.int32)
    assert np.array_equal(out.cpu().numpy(), want)


@pytest.mark.parametrize("method,g", [("scatter", 16384), ("sort", 100000)])
def test_scatter_and_sort_same_bytes_every_run(dev, method, g):
    from banyandb_tpu_torch import ops

    rng = np.random.default_rng(g)
    n = 1 << 18
    key = torch.from_numpy(rng.integers(0, g, n).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    vals = torch.from_numpy(rng.gamma(2.0, 40.0, n).astype(np.float32)).to(dev)
    runs = [
        ops.group_reduce(key, valid, {"v": vals}, g, method=method)
        for _ in range(2)
    ]
    for a, b in ((r.count, r.sums["v"]) for r in runs[1:]):
        assert torch.equal(a, runs[0].count)
        assert runs[0].sums["v"].cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
    cpu = ops.group_reduce(key.cpu(), valid.cpu(), {"v": vals.cpu()}, g, method=method)
    assert torch.equal(cpu.count, runs[0].count.cpu())
    torch.testing.assert_close(cpu.sums["v"], runs[0].sums["v"].cpu(), rtol=RTOL, atol=0)


def test_kernel_keeps_non_finite_values_in_their_group(dev):
    n, g = 1 << 16, 16
    rng = np.random.default_rng(13)
    codes = rng.integers(0, g, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    vals = rng.integers(-50, 100, (1, n)).astype(np.float32)
    for i, (grp, ok, v) in enumerate(
        [(1, True, np.nan), (2, True, np.inf), (3, True, -np.inf),
         (5, False, np.nan), (6, False, np.inf)]
    ):
        codes[97 * i], valid[97 * i], vals[0, 97 * i] = grp, ok, v
    args = [torch.from_numpy(a).to(dev) for a in (codes, np.ones(n, bool), vals, valid)]
    kc, ks = hk.fused_group_multi(*args, num_groups=g)
    pc, ps = hk.fused_group_multi_plain(*args, g)
    assert torch.equal(kc, pc)
    ks, ps = ks.cpu().numpy()[0], ps.cpu().numpy()[0]
    assert np.array_equal(ks, ps, equal_nan=True)
    assert np.array_equal(np.isfinite(ks), ~np.isin(np.arange(g), [1, 2, 3]))


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("absent", [False, True])
def test_stream_device_mask_equals_host_mask(dev, width, absent):
    """The stream tag mask built on the card equals the host mask, for
    narrow and i32 code columns, an absent column and literals missing
    from the dictionary, at sizes around DEVICE_MIN_ROWS."""
    from banyandb_tpu_torch.api.model import Condition
    from banyandb_tpu_torch.query import filter as qfilter
    from banyandb_tpu_torch.query import stream_exec
    from banyandb_tpu_torch.storage.part import ColumnData

    rng = np.random.default_rng(width + absent)
    dt = {8: np.int8, 16: np.int16, 32: np.int32}[width]
    for n in (stream_exec.DEVICE_MIN_ROWS - 1, stream_exec.DEVICE_MIN_ROWS, 1 << 19):
        tags = {"ta": rng.integers(0, 8, n).astype(dt)}
        if not absent:
            tags["tb"] = rng.integers(0, 4, n).astype(dt)
        src = ColumnData(
            ts=np.arange(n, dtype=np.int64), series=np.zeros(n, np.int64),
            version=np.zeros(n, np.int64), tags=tags, fields={},
            dicts={"ta": [b"a%d" % i for i in range(8)],
                   "tb": [b"b%d" % i for i in range(4)]},
        )
        for conds in (
            [Condition("ta", "eq", "a3"), Condition("tb", "in", ["b1", "b2", "b9"])],
            [Condition("ta", "ne", "a9"), Condition("tb", "not_in", ["b0"])],
            [Condition("ta", "in", ["a1", "a8"]), Condition("ta", "ne", "a1")],
        ):
            want = qfilter.row_mask(src, conds, 10, n - 10)
            dev_tag = stream_exec.device_tag_mask(src, conds, dev)
            np.testing.assert_array_equal((src.ts >= 10) & (src.ts < n - 10) & dev_tag, want)
            stream_exec.reset_stats()
            np.testing.assert_array_equal(stream_exec.row_mask(src, conds, 10, n - 10, dev), want)
            route = "device_masks" if n >= stream_exec.DEVICE_MIN_ROWS else "host_masks"
            assert stream_exec.STATS[route] == 1


def test_stream_engine_on_card_equals_cpu(dev, tmp_path):
    """A small StreamEngine on the card answers like one on the CPU over
    the same parts, every large source taking the card's mask."""
    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import (
        Catalog, Group, IndexRule, ResourceOpts, SchemaRegistry, Stream, TagSpec, TagType,
    )
    from banyandb_tpu_torch.models.stream import ElementValue, StreamEngine
    from banyandb_tpu_torch.query import stream_exec

    t0, n = 1_700_000_000_000, 1 << 17
    reg = SchemaRegistry(tmp_path)
    reg.create_group(Group("sg", Catalog.STREAM, ResourceOpts(shard_num=2)))
    reg.create_stream(Stream(
        group="sg", name="logs",
        tags=(TagSpec("svc", TagType.STRING), TagSpec("level", TagType.STRING)),
        entity=("svc",),
    ))
    reg.create_index_rule(IndexRule(group="sg", name="lvl", tags=("level",), type="skipping"))
    card = StreamEngine(reg, tmp_path / "data", device=dev)
    rng = np.random.default_rng(2)
    svc, lvl = rng.integers(0, 300, n), rng.integers(0, 4, n)
    card.write("sg", "logs", [
        ElementValue(f"e{i}", t0 + i, {"svc": f"s{svc[i]}", "level": f"L{lvl[i]}"},
                     b"body%d" % i)
        for i in range(n)
    ])
    card.flush()
    cpu = StreamEngine(reg, tmp_path / "data", device="cpu")
    frm = f"FROM STREAM logs IN sg TIME BETWEEN {t0} AND {t0 + n}"
    for where in ("svc = 's7' AND level != 'L0'", "svc IN ('s1', 's2', 's404')",
                  "level NOT IN ('L0', 'L1', 'L2') AND svc != 's3'"):
        req = bydbql.parse(f"SELECT svc, level {frm} WHERE {where} LIMIT 300")
        stream_exec.reset_stats()
        got = card.query(req).data_points
        assert stream_exec.STATS["device_masks"] > 0 and stream_exec.STATS["host_masks"] == 0
        assert got == cpu.query(req).data_points and got
        assert card.last_scan_stats == cpu.last_scan_stats
    card.close()
    cpu.close()


def _mesh_rows(rng, sizes):
    return [
        {
            "tags": {"svc": rng.integers(0, 1024, n).astype(np.int32),
                     "region": rng.integers(0, 8, n).astype(np.int32)},
            "fields": {"lat": rng.gamma(2.0, 40.0, n).astype(np.float32),
                       "calls": rng.integers(0, 50, n).astype(np.float32)},
        }
        for n in sizes
    ]


def _assert_card_equals_cpu(card, cpu, plan):
    def np_(t):
        return t.cpu().numpy()

    for key in ("count", "hist", "top_idx"):
        if key in cpu:
            np.testing.assert_array_equal(np_(card[key]), np_(cpu[key]), err_msg=key)
    for f in plan.fields:
        np.testing.assert_array_equal(np_(card["mins"][f]), np_(cpu["mins"][f]))
        np.testing.assert_array_equal(np_(card["maxs"][f]), np_(cpu["maxs"][f]))
        if f == "calls":
            np.testing.assert_array_equal(np_(card["sums"][f]), np_(cpu["sums"][f]))
        else:
            np.testing.assert_allclose(np_(card["sums"][f]), np_(cpu["sums"][f]), rtol=RTOL)


def _same_bits(a, b):
    if isinstance(a, dict):
        return all(_same_bits(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("num_chunks", [0, 1, 4], ids=["legacy", "fused1", "fused4"])
def test_mesh_steps_on_card_slots_equal_cpu_slots(dev, num_chunks):
    """The legacy and the fused mesh step on 8 slots of the card equal
    the same step on 8 CPU slots, with the same bits on a second run,
    launching fused_group_multi once a slot and chunk."""
    from banyandb_tpu_torch.parallel import dist_exec, make_mesh
    from banyandb_tpu_torch.query import fused_exec

    rng = np.random.default_rng(40 + num_chunks)
    nrows = 1 << 12
    width = max(num_chunks, 1) * nrows
    per_shard = _mesh_rows(rng, [width, 0, 1, width - 5, 777, width // 2, 3, width])
    plan = dist_exec.DistPlan(
        tags_code=("region", "svc"), fields=("calls", "lat"), group_tags=("svc",),
        radices=(1024,), num_groups=1024, eq_preds=("region",), topn=10,
        want_hist="lat",
    )
    outs = {}
    for name, devices in (("card", [dev] * 8), ("cpu", ["cpu"] * 8)):
        mesh = make_mesh(4, 2, devices=devices)
        chunks = dist_exec.stack_shard_chunks(
            mesh, per_shard, plan.tags_code, plan.fields, width
        )

        def run():
            kw = dict(pred_codes={"region": 3}, hist_lo=0.0, hist_span=700.0)
            if num_chunks:
                return fused_exec.fused_distributed_aggregate(
                    mesh, plan, num_chunks, chunks, **kw
                )
            return dist_exec.distributed_aggregate(mesh, plan, chunks, **kw)

        before = hk.LAUNCHES["fused_group_multi"]
        outs[name] = run()
        launched = hk.LAUNCHES["fused_group_multi"] - before
        assert launched == (8 * max(num_chunks, 1) if name == "card" else 0)
        assert _same_bits(outs[name], run()), name
    assert outs["card"]["count"].device.type == "cuda"
    _assert_card_equals_cpu(outs["card"], outs["cpu"], plan)


def test_topk_groups_ties_on_card(dev):
    from banyandb_tpu_torch import ops

    rng = np.random.default_rng(5)
    metric = torch.from_numpy(rng.integers(0, 4, 5000).astype(np.float32))
    nonempty = torch.from_numpy(rng.random(5000) < 0.8)
    for descending in (True, False):
        for n in (1, 10, 1000, 5000):
            cv, ci = ops.topk_groups(metric, nonempty, n, descending=descending)
            gv, gi = ops.topk_groups(metric.to(dev), nonempty.to(dev), n,
                                     descending=descending)
            assert torch.equal(gi.cpu(), ci) and torch.equal(gv.cpu(), cv)


def test_two_node_cluster_on_card_equals_cpu(dev, tmp_path):
    """A 2-node cluster whose data nodes run on the card answers the
    measure fixture cases like one whose nodes run on the CPU, over the
    scatter partials and over the mesh of 8 card slots."""
    import json
    from pathlib import Path

    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import (
        Catalog, DataPointValue, Entity, FieldSpec, FieldType, Group, Measure,
        ResourceOpts, SchemaRegistry, TagSpec, TagType, WriteRequest,
    )
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport
    from banyandb_tpu_torch.parallel import make_mesh

    t0, n = 1_700_000_000_000, 4000
    measure = Measure(
        group="sw", name="cpm",
        tags=(TagSpec("svc", TagType.STRING), TagSpec("region", TagType.STRING),
              TagSpec("status", TagType.INT)),
        fields=(FieldSpec("value", FieldType.INT),), entity=Entity(("svc",)),
    )
    points = tuple(
        DataPointValue(t0 + i, {"svc": f"s{i % 10}", "region": f"r{i % 3}",
                                "status": (200, 404, 500)[i % 3]},
                       {"value": i % 997}, version=1)
        for i in range(n)
    )
    clusters = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        transport, infos, nodes = LocalTransport(), [], []
        for i in range(3):
            reg = SchemaRegistry(tmp_path / name / f"n{i}")
            reg.create_group(Group("sw", Catalog.MEASURE, ResourceOpts(shard_num=4)))
            reg.create_measure(measure)
            if i < 2:
                dn = DataNode(f"d{i}", reg, tmp_path / name / f"n{i}" / "data",
                              device=device)
                nodes.append(dn)
                infos.append(NodeInfo(dn.name, transport.register(dn.name, dn.bus)))
        liaison = Liaison(reg, transport, infos)
        liaison.write_measure(WriteRequest("sw", "cpm", points))
        for dn in nodes:
            dn.measure.flush()
        clusters[name] = (liaison, nodes)
    cases = json.loads(
        (Path(__file__).parent / "cases" / "measure_cases.json").read_text()
    )["cases"]
    before = hk.LAUNCHES["fused_group_multi"]
    try:
        for case in cases:
            ql = (case["ql"].replace("{T0_500}", str(t0 + 500))
                  .replace("{T0_1500}", str(t0 + 1500))
                  .replace("{T0}", str(t0)).replace("{T1}", str(t0 + n)))
            req = bydbql.parse(ql)
            card = clusters["card"][0].query_measure(req)
            cpu = clusters["cpu"][0].query_measure(req)
            # integer-valued data: every value is exact
            assert (card.groups, card.values, card.data_points) == (
                cpu.groups, cpu.values, cpu.data_points), case["name"]
            if case["name"] in ("sum_by_service", "mean_filtered_region",
                                "min_max_by_region"):
                liaison, nodes = clusters["card"]
                liaison.enable_mesh_fastpath(
                    make_mesh(4, 2, devices=[dev] * 8),
                    {dn.name: dn.measure for dn in nodes},
                )
                try:
                    mesh = liaison.query_measure(req)
                    assert liaison.mesh_exec.executions == 1
                    assert liaison.mesh_exec.last_stats["h2d_bytes"] > 0
                finally:
                    del liaison.mesh_exec
                assert sorted(mesh.values) == sorted(cpu.values)
                for key in cpu.values:
                    assert dict(zip(mesh.groups, mesh.values[key])) == dict(
                        zip(cpu.groups, cpu.values[key])), (case["name"], key)
        # the card nodes' scatter partials and the card mesh took the
        # kernel (a repeated scan signature is a partials-cache hit)
        assert hk.LAUNCHES["fused_group_multi"] > before
    finally:
        for _liaison, nodes in clusters.values():
            for dn in nodes:
                dn.measure.close(), dn.stream.close(), dn.trace.close()


# -- the precompile registry, the build cache and the kernel audit ----------


def test_warm_on_card_launches_the_kernels(dev, monkeypatch):
    """warm() of the builtin matrix on the card launches the group
    kernel (every grouped plan) and widen_narrow (the staged compressed
    ship form), and counts no error."""
    from banyandb_tpu_torch.query import precompile

    monkeypatch.setenv("BYDB_PRECOMPILE", "1")
    monkeypatch.setenv("BYDB_DEVICE_DECODE", "1")
    r = precompile.PrecompileRegistry(device="cuda")
    hk.reset_launches()
    assert r.warm() == 11
    st = r.stats()
    assert st["errors"] == 0, st["last_error"]
    assert hk.LAUNCHES["fused_group_multi"] > 0
    assert hk.LAUNCHES["widen_narrow"] > 0


# CUDA kernels the profiler counts for one run of each dispatch scenario
# on an H100 80GB HBM3 (chip_smoke.py's kernel_audit line records the
# same); kernel_budgets' ``ops`` column is the estimate without a card beside
# it (the fused rows' torch.stack shows up as device copies, not kernels)
CUDA_LAUNCHES = {
    "measure/flat-count": 12,
    "measure/group-eq-lut": 33,
    "measure/percentile-hist": 24,
    "measure/or-expr": 12,
    "measure/topn-dashboard": 27,
    "measure+decode/flat-count": 14,
    "measure+decode/group-eq-lut": 49,
    "measure+decode/percentile-hist": 31,
    "measure+decode/or-expr": 21,
    "measure+decode/topn-dashboard": 43,
    "fused/flat-count": 12,
    "fused/group-eq-lut": 33,
    "fused/percentile-hist": 24,
    "fused/or-expr": 12,
    "fused/topn-dashboard": 27,
    "fused+decode/flat-count": 13,
    "fused+decode/group-eq-lut": 48,
    "fused+decode/percentile-hist": 31,
    "fused+decode/or-expr": 20,
    "fused+decode/topn-dashboard": 42,
    "fused/multi-chunk": 28,
    "fused+decode/multi-chunk": 29,
    "stream/mask-eq-in": 4,
    "stream+decode/mask-eq-in": 6,
    "ql/trace": 0,
    "ql/property": 0,
}


def test_card_audit_equals_budget_table(dev):
    """The dispatch scenarios on the card: host->device ships, gets and
    hand-kernel launches equal the budget table, every wrapper call is
    one launch, every ship is one host->device copy, and the profiler's
    kernel count per scenario is the pinned one."""
    from banyandb_tpu_torch.lint.kernel import dispatch, kernel_budgets

    traces, seen = dispatch.card_audit()
    got = {}
    for name, t in traces.items():
        assert not t.error, (name, t.error)
        row = kernel_budgets.BUDGETS[name]
        assert (t.puts, t.gets, t.hand_launches) == (
            row.puts, row.gets, row.hand_launches
        ), name
        counts = seen[name]
        assert sum(counts["launched"].values()) == t.hand_launches, name
        assert counts["h2d"] == t.puts, name
        got[name] = counts["cuda_launches"]
    assert got == CUDA_LAUNCHES


_LOAD_CHILD = """
import json, os, sys
from banyandb_tpu_torch.utils import compile_cache
assert compile_cache.enable_at(sys.argv[1])
from banyandb_tpu_torch.ops import hopper_kernels as hk
hk.build()
print(json.dumps(compile_cache.stats()))
"""


def test_second_process_loads_the_library_without_nvcc(dev, tmp_path):
    """A process that finds the library in the build cache's directory
    loads it: no nvcc (the second child has none on its PATH)."""
    import json
    import os
    import subprocess
    import sys

    cc = str(tmp_path / "cc")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(env):
        out = subprocess.run(
            [sys.executable, "-c", _LOAD_CHILD, cc], env=env, cwd=root,
            capture_output=True, text=True, timeout=600,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    env = dict(os.environ, PYTHONPATH=root)
    first = run(env)
    assert (first["builds"], first["hits"], first["entries"]) == (1, 0, 1)
    no_nvcc = dict(env, CUDA_HOME=str(tmp_path / "none"), PATH="/usr/bin:/bin")
    second = run(no_nvcc)
    assert (second["builds"], second["hits"], second["loads"]) == (0, 1, 1)


# -- the standalone server ----------------------------------------------------


def test_server_on_card_equals_cpu_server(dev, tmp_path, monkeypatch):
    """StandaloneServer on the card, driven over its bus (schema,
    columnar writes, snapshot, BydbQL aggregates), launches the group
    kernel and answers like a device="cpu" server over the same
    envelopes; integer-valued data, so every value is exact."""
    import base64

    from banyandb_tpu_torch.api import schema as S
    from banyandb_tpu_torch.server import StandaloneServer

    monkeypatch.setenv("BYDB_AUTOREG", "0")
    t0, n, n_svc = 1_700_000_000_000, 1 << 17, 64
    rng = np.random.default_rng(5)

    def b64(a):
        return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()

    svc = rng.integers(0, n_svc, n).astype("<i4")
    region = rng.integers(0, 4, n).astype("<i4")
    value = rng.integers(0, 1000, n).astype("<f8")
    envelopes = [
        {"group": "sw", "name": "cpm", "ts": b64((t0 + np.arange(lo, lo + 65536)).astype("<i8")),
         "tags": {"svc": {"dict": [f"s{i}" for i in range(n_svc)], "codes": b64(svc[lo:lo + 65536])},
                  "region": {"dict": [f"r{i}" for i in range(4)],
                             "codes": b64(region[lo:lo + 65536])}},
         "fields": {"value": b64(value[lo:lo + 65536])}}
        for lo in range(0, n, 65536)
    ]
    queries = [
        f"SELECT sum(value) FROM MEASURE cpm IN sw TIME BETWEEN {t0} AND {t0 + n} "
        "WHERE region != 'r3' GROUP BY svc",
        f"SELECT value FROM MEASURE cpm IN sw TIME BETWEEN {t0} AND {t0 + n} "
        "GROUP BY svc TOP 5 BY value",
        f"SELECT percentile(value, 0.5, 0.99) FROM MEASURE cpm IN sw "
        f"TIME BETWEEN {t0} AND {t0 + n} GROUP BY region",
    ]
    answers = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        srv = StandaloneServer(tmp_path / name, device=device)
        srv.start()
        try:
            for kind, obj in (
                ("group", S.Group("sw", S.Catalog.MEASURE, S.ResourceOpts(shard_num=2))),
                ("measure", S.Measure(
                    group="sw", name="cpm",
                    tags=(S.TagSpec("svc", S.TagType.STRING),
                          S.TagSpec("region", S.TagType.STRING)),
                    fields=(S.FieldSpec("value", S.FieldType.INT),),
                    entity=S.Entity(("svc", "region")))),
            ):
                srv.bus.handle("registry", {"op": "create", "kind": kind,
                                            "item": S._to_jsonable(obj)})
            for env in envelopes:
                assert srv.bus.handle("measure-write-cols", env) == {"written": 65536}
            srv.bus.handle("snapshot", {})
            before = hk.LAUNCHES["fused_group_multi"]
            answers[name] = [srv.bus.handle("bydbql", {"ql": ql})["result"] for ql in queries]
            if name == "card":
                assert hk.LAUNCHES["fused_group_multi"] >= before + len(queries)
        finally:
            srv.stop()
    assert answers["card"] == answers["cpu"]
    assert all(a["groups"] for a in answers["card"])


def test_worker_server_on_card_loads_the_library_and_launches(dev, tmp_path, monkeypatch):
    """StandaloneServer(workers=1) on the card: the parent puts the
    kernel library into the fleet's build cache, the worker loads it (no
    nvcc build), runs on the card, launches fused_group_multi for the
    measure queries (its own count, read from the merged exposition) and
    answers like a workers=0 server on the card; the parent launches
    nothing for those queries."""
    import base64

    from banyandb_tpu_torch.api import schema as S
    from banyandb_tpu_torch.obs import prom
    from banyandb_tpu_torch.server import StandaloneServer

    monkeypatch.setenv("BYDB_AUTOREG", "0")
    t0, n, n_svc = 1_700_000_000_000, 1 << 17, 64
    rng = np.random.default_rng(6)

    def b64(a):
        return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()

    svc = rng.integers(0, n_svc, n).astype("<i4")
    value = rng.integers(0, 1000, n).astype("<f8")
    envelopes = [
        {"group": "sw", "name": "cpm", "ts": b64((t0 + np.arange(lo, lo + 65536)).astype("<i8")),
         "tags": {"svc": {"dict": [f"s{i}" for i in range(n_svc)], "codes": b64(svc[lo:lo + 65536])}},
         "fields": {"value": b64(value[lo:lo + 65536])}}
        for lo in range(0, n, 65536)
    ]
    queries = [
        f"SELECT sum(value) FROM MEASURE cpm IN sw TIME BETWEEN {t0} AND {t0 + n} GROUP BY svc",
        f"SELECT value FROM MEASURE cpm IN sw TIME BETWEEN {t0} AND {t0 + n} "
        "GROUP BY svc TOP 5 BY value",
    ]
    answers = {}
    for workers in (0, 1):
        srv = StandaloneServer(tmp_path / f"w{workers}", device=dev, workers=workers)
        srv.start()
        try:
            for kind, obj in (
                ("group", S.Group("sw", S.Catalog.MEASURE, S.ResourceOpts(shard_num=2))),
                ("measure", S.Measure(
                    group="sw", name="cpm", tags=(S.TagSpec("svc", S.TagType.STRING),),
                    fields=(S.FieldSpec("value", S.FieldType.INT),),
                    entity=S.Entity(("svc",)))),
            ):
                srv.bus.handle("registry", {"op": "create", "kind": kind,
                                            "item": S._to_jsonable(obj)})
            for env in envelopes:
                assert srv.bus.handle("measure-write-cols", env) == {"written": 65536}
            srv.bus.handle("snapshot", {})
            before = dict(hk.LAUNCHES)
            answers[workers] = [srv.bus.handle("bydbql", {"ql": ql})["result"]
                                for ql in queries]
            if workers:
                assert hk.LAUNCHES == before, "the parent launched for the workers"
                w = srv.pool._clients[0]
                assert w.ready_info["device"].startswith("cuda")
                text = srv.bus.handle("metrics", {})["prometheus"]

                def gauge(name, **labels):
                    return prom.gauge_value(text, "banyandb_" + name, dict(labels, worker="w000"))

                assert gauge("compile_cache_builds") == 0.0
                assert gauge("compile_cache_loads") == 1.0
                assert gauge("kernel_launches", kernel="fused_group_multi") >= len(queries)
        finally:
            srv.stop()
    assert answers[1] == answers[0]
    assert all(a["groups"] for a in answers[0])


# -- the data lifecycle ---------------------------------------------------------

_DAY = 86_400_000
_LT0 = 1_699_920_000_000  # 2023-11-14 00:00 UTC, a day segment's start


def _life_rows(n, days, seed):
    rng = np.random.default_rng(seed)
    per = n // days
    i = np.arange(n, dtype=np.int64)
    return (_LT0 + (i // per) * _DAY + (i % per) * (_DAY // per),
            rng.integers(0, 64, n), rng.integers(0, 1000, n))


def _life_registry(root, stages=()):
    from banyandb_tpu_torch.api import (
        Catalog, Entity, FieldSpec, FieldType, Group, Measure, ResourceOpts,
        SchemaRegistry, TagSpec, TagType,
    )

    reg = SchemaRegistry(root)
    reg.create_group(Group("sw", Catalog.MEASURE,
                           ResourceOpts(shard_num=2, stages=stages)))
    reg.create_measure(Measure(
        group="sw", name="cpm", tags=(TagSpec("svc", TagType.STRING),),
        fields=(FieldSpec("value", FieldType.INT),), entity=Entity(("svc",))))
    return reg


def _life_write(eng, rows, days):
    from banyandb_tpu_torch.models.measure import DictColumn

    ts, svc, val = rows
    per = ts.shape[0] // days
    for lo in range(0, ts.shape[0], per):
        eng.write_columns(
            "sw", "cpm", ts_millis=ts[lo:lo + per],
            tags={"svc": DictColumn([f"s{i}" for i in range(64)], svc[lo:lo + per])},
            fields={"value": val[lo:lo + per].astype(np.float64)},
            versions=np.ones(per, dtype=np.int64))
        eng.flush()


def _life_ql(days, fn):
    return (f"SELECT {fn}(value) FROM MEASURE cpm IN sw TIME BETWEEN {_LT0} AND "
            f"{_LT0 + days * _DAY - 1} GROUP BY svc LIMIT 64")


def _life_answers(ask, days=4):
    """count/sum/min/max of value by svc with cold serving caches; ->
    (answers, fused_group_multi launches)."""
    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.storage.cache import device_cache, global_cache

    global_cache().clear()
    device_cache().clear()
    before = hk.LAUNCHES["fused_group_multi"]
    out = {}
    for fn in ("count", "sum", "min", "max"):
        r = ask(bydbql.parse(_life_ql(days, fn)))
        out[fn] = sorted(zip(r.groups, *(r.values[k] for k in sorted(r.values))))
    return out, hk.LAUNCHES["fused_group_multi"] - before


def test_archive_and_restore_on_card_equal_cpu(dev, tmp_path):
    """Four day segments archived two by two and restored: the card's
    answers equal a device="cpu" engine's at each step, the restored
    answers equal the first, and every step launches the group kernel."""
    from banyandb_tpu_torch.admin import lifecycle
    from banyandb_tpu_torch.models.measure import MeasureEngine

    rows = _life_rows(1 << 16, 4, 31)
    got = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        root = tmp_path / name
        eng = MeasureEngine(_life_registry(root), root / "data", device=device)
        _life_write(eng, rows, 4)
        steps = [_life_answers(eng.query)]
        db = eng._tsdb("sw")
        moved = lifecycle.migrate(db, tmp_path / f"{name}-arch", _LT0 + 2 * _DAY)
        assert len(moved) == 2
        steps.append(_life_answers(eng.query))
        for seg in moved:
            lifecycle.restore_segment(tmp_path / f"{name}-arch", db, seg)
        steps.append(_life_answers(eng.query))
        eng.close()
        got[name] = steps
    assert [a for a, _n in got["card"]] == [a for a, _n in got["cpu"]]
    assert got["card"][2][0] == got["card"][0][0] != got["card"][1][0]
    assert all(n > 0 for _a, n in got["card"])


def test_backup_restore_on_card(dev, tmp_path):
    """A backup of a card engine's root restored into an empty root: a
    fresh card engine answers as before the backup (and as a CPU engine
    over the restored root), launching the group kernel."""
    from banyandb_tpu_torch.admin import backup
    from banyandb_tpu_torch.api import SchemaRegistry
    from banyandb_tpu_torch.models.measure import MeasureEngine

    eng = MeasureEngine(_life_registry(tmp_path / "src"), tmp_path / "src" / "data",
                        device=dev)
    _life_write(eng, _life_rows(1 << 16, 4, 32), 4)
    want, _n = _life_answers(eng.query)
    remote = backup.LocalDirFS(tmp_path / "remote")
    stamp = backup.backup(tmp_path / "src", remote, flush=eng.flush)
    assert backup.restore(remote, stamp, tmp_path / "dst") > 0
    with pytest.raises(FileExistsError):
        backup.restore(remote, stamp, tmp_path / "src")
    eng.close()
    for device in (dev, "cpu"):
        e = MeasureEngine(SchemaRegistry(tmp_path / "dst"), tmp_path / "dst" / "data",
                          device=device)
        got, launched = _life_answers(e.query)
        e.close()
        assert got == want
        assert (launched > 0) == (device != "cpu")


def test_tier_migration_on_card(dev, tmp_path):
    """Hot and warm data nodes on the card: day 1 ships to the warm node,
    whose stage-routed answers equal numpy over day 1 and launch the group
    kernel there; a second run ships nothing."""
    import dataclasses

    from banyandb_tpu_torch.admin.tier_migration import TierMigrator
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport

    ts, svc, val = rows = _life_rows(1 << 16, 2, 33)
    transport, infos, nodes = LocalTransport(), [], []
    for name in ("hot", "warm"):
        dn = DataNode(name, _life_registry(tmp_path / name, ("hot", "warm")),
                      tmp_path / name / "data", device=dev)
        nodes.append(dn)
        infos.append(NodeInfo(name, transport.register(name, dn.bus), stages=(name,)))
    liaison = Liaison(_life_registry(tmp_path / "l", ("hot", "warm")), transport, infos)
    try:
        _life_write(nodes[0].measure, rows, 2)
        stats = TierMigrator(nodes[0], transport, infos[1].addr).run(_LT0 + _DAY)
        assert stats["shipped_parts"] == 2
        assert stats["migrated_segments"] == ["measure/sw/seg-20231114"]
        day1 = ts < _LT0 + _DAY
        for stages, keep in ((("warm",), day1), (("hot",), ~day1), ((), day1 | ~day1)):
            got, launched = _life_answers(lambda r, st=stages: liaison.query_measure(
                dataclasses.replace(r, stages=st)), days=2)
            assert launched > 0, stages
            s, v = svc[keep], val[keep].astype(float)
            want = sorted(((f"s{k}",), float(v[s == k].sum()), float((s == k).sum()))
                          for k in np.unique(s))
            assert [(g, sm, c) for g, c, sm in got["sum"]] == want, stages
        again = TierMigrator(nodes[0], transport, infos[1].addr).run(_LT0 + _DAY)
        assert again["shipped_parts"] == 0
    finally:
        for dn in nodes:
            dn.measure.close(), dn.stream.close(), dn.trace.close()


def test_mcp_server_on_card_launches(dev, tmp_path):
    """McpServer builds its engines on the card by default; execute_bydbql
    of an aggregate launches the group kernel and replies as a
    device="cpu" server over the same root."""
    import json

    from banyandb_tpu_torch.mcp_server import McpServer
    from banyandb_tpu_torch.storage.cache import device_cache, global_cache

    _life_registry(tmp_path)
    srv = McpServer(tmp_path)
    assert srv.measure.device.type == "cuda"
    _life_write(srv.measure, _life_rows(1 << 16, 4, 34), 4)
    call = {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
            "params": {"name": "execute_bydbql", "arguments": {"query": _life_ql(4, "sum")}}}
    replies = []
    for s in (srv, McpServer(tmp_path, device="cpu")):
        global_cache().clear()
        device_cache().clear()
        before = hk.LAUNCHES["fused_group_multi"]
        replies.append(json.loads(s.handle(call)["result"]["content"][0]["text"]))
        assert (hk.LAUNCHES["fused_group_multi"] > before) == (s is srv)
        s.measure.close()
        s.stream.close()
    assert replies[0] == replies[1] and len(replies[0]["result"]["groups"]) == 64
