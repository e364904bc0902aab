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
     (1 << 20, 2, 1024, False), (1 << 18, 1, 8192, True)],
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
    "case", ["one-tile", "small", "wraps-past-2^31", "wide", "main-path"]
)
def test_prefix_sum_narrow_matches_plain(dev, case):
    rng = np.random.default_rng(11)
    n = {"one-tile": hk.TILE, "small": 2 * hk.TILE, "wraps-past-2^31": 4 * hk.TILE,
         "wide": 3 * hk.TILE, "main-path": 1 << 20}[case]
    if case == "wraps-past-2^31":
        x = np.full(n, 2**20, dtype=np.int32)
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
