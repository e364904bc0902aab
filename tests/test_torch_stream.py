"""The port's stream model against the JAX package's, on the CPU.

Each package writes the same log elements through its own
``StreamEngine`` (the port's on ``device="cpu"``) with an inverted and a
skipping index rule, parses the same BydbQL text with its own
``bydbql`` and answers it.  Covered:

- all 6 cases of ``tests/cases/stream_cases.json``, on the host route
  and on the device route (``DEVICE_MIN_ROWS`` lowered to 1 in both
  packages), with narrow and i32 code columns: identical rows, order and
  ``last_scan_stats``;
- ``device_tag_mask`` against the JAX package's and ``row_mask`` against
  the host mask on random sources: i8, i16 and i32 columns, absent
  columns, literals missing from the dictionary, eq/ne/in/not_in;
- stream parts with their index sidecars written by one package and
  read by the other, and the sidecar bytes of both equal.

Tolerance: none — masks, rows and stats are exact.
"""

import numpy as np
import pytest
import torch

from banyandb_tpu import api as japi
from banyandb_tpu import bydbql as jql
from banyandb_tpu.models.stream import ElementValue as JElement
from banyandb_tpu.models.stream import StreamEngine as JEngine
from banyandb_tpu.query import stream_exec as jse
from banyandb_tpu.storage.part import ColumnData as JColumnData
from banyandb_tpu.utils.bloom import Bloom as JBloom
from banyandb_tpu_torch import api as tapi
from banyandb_tpu_torch import bydbql as tql
from banyandb_tpu_torch.models.stream import ElementValue as TElement
from banyandb_tpu_torch.models.stream import StreamEngine as TEngine
from banyandb_tpu_torch.query import filter as tfilter
from banyandb_tpu_torch.query import stream_exec as tse
from banyandb_tpu_torch.storage.part import ColumnData as TColumnData
from banyandb_tpu_torch.utils.bloom import Bloom as TBloom
from test_fixture_cases_stream_trace import N_ELEMENTS, STREAM_CASES, T0, _subst

N_WRITES = 3  # flushes: several parts a shard


def _schema(api, reg):
    reg.create_group(api.Group("sw", api.Catalog.STREAM, api.ResourceOpts(shard_num=2)))
    reg.create_stream(
        api.Stream(
            group="sw", name="logs",
            tags=(api.TagSpec("svc", api.TagType.STRING),
                  api.TagSpec("level", api.TagType.STRING)),
            entity=("svc",),
        )
    )
    reg.create_index_rule(
        api.IndexRule(group="sw", name="svc_idx", tags=("svc",), type="inverted")
    )
    reg.create_index_rule(
        api.IndexRule(group="sw", name="lvl_skip", tags=("level",), type="skipping")
    )


def _elements(cls, k: int):
    """Batch k of the fixture's elements: svc s0..s4, level INFO INFO
    WARN ERROR, one element a millisecond."""
    lo, hi = k * N_ELEMENTS // N_WRITES, (k + 1) * N_ELEMENTS // N_WRITES
    return [
        cls(
            element_id=f"e{i}",
            ts_millis=T0 + i,
            tags={"svc": f"s{i % 5}", "level": ("INFO", "INFO", "WARN", "ERROR")[i % 4]},
            body=f"line{i}".encode(),
        )
        for i in range(lo, hi)
    ]


def _open(api, engine, root, **kw):
    return engine(api.SchemaRegistry(root), root / "data", **kw)


def _write(api, engine, element, root, **kw):
    reg = api.SchemaRegistry(root)
    _schema(api, reg)
    eng = engine(reg, root / "data", **kw)
    for k in range(N_WRITES):
        eng.write("sw", "logs", _elements(element, k))
        eng.flush()
    return eng


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    jeng = _write(japi, JEngine, JElement, root / "jax")
    teng = _write(tapi, TEngine, TElement, root / "torch", device="cpu")
    yield jeng, teng, root
    jeng.close()
    teng.close()


def _rows(res) -> list:
    return [
        (dp["timestamp"], dp["element_id"], bytes(dp["body"]),
         tuple(sorted(dp["tags"].items())))
        for dp in res.data_points
    ]


def _both(jeng, teng, ql):
    j = jeng.query(jql.parse(ql))
    t = teng.query(tql.parse(ql))
    return _rows(j), _rows(t)


@pytest.mark.parametrize("narrow", ["1", "0"])
@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("case", STREAM_CASES, ids=[c["name"] for c in STREAM_CASES])
def test_stream_case_matches_jax(case, route, narrow, engines, monkeypatch):
    jeng, teng, _root = engines
    monkeypatch.setenv("BYDB_DEVICE_DECODE", narrow)
    if route == "device":
        monkeypatch.setattr(jse, "DEVICE_MIN_ROWS", 1)
        monkeypatch.setattr(tse, "DEVICE_MIN_ROWS", 1)
    tse.reset_stats()
    ql = _subst(case["ql"])
    j, t = _both(jeng, teng, ql)
    assert t == j, case["name"]
    assert t, f"{case['name']} matched zero rows"
    assert teng.last_scan_stats == jeng.last_scan_stats
    if route == "device":
        # every source of an AND query takes the device route; a query
        # with no criteria or an OR tree takes none
        if "WHERE" in ql and " OR " not in ql:
            assert tse.STATS["device_masks"] > 0 and tse.STATS["host_masks"] == 0
        else:
            assert tse.STATS["device_masks"] == 0


def test_index_rules_prune_blocks_as_jax(engines, monkeypatch):
    """The skipping bloom on `level` and the postings on `svc` prune the
    same blocks in both packages (a rare literal prunes every block)."""
    jeng, teng, _root = engines
    frm = f"FROM STREAM logs IN sw TIME BETWEEN {T0} AND {T0 + N_ELEMENTS}"
    for where in ("svc = 's3'", "level = 'FATAL'", "svc IN ('s1', 's4')"):
        j, t = _both(jeng, teng, f"SELECT svc, level {frm} WHERE {where} LIMIT 1000")
        assert t == j
        assert teng.last_scan_stats == jeng.last_scan_stats
        assert teng.last_scan_stats["blocks_selected"] > 0


def _source(rng, n, width, absent=False):
    """A random source with tags ta (8 values) and tb (4 values) stored
    at `width`; `absent` drops tb (its mask sees the -2 sentinel)."""
    dt = {8: np.int8, 16: np.int16, 32: np.int32}[width]
    ta = rng.integers(0, 8, n).astype(dt)
    tb = rng.integers(0, 4, n).astype(dt)
    tags = {"ta": ta} if absent else {"ta": ta, "tb": tb}
    kw = dict(
        ts=np.sort(rng.integers(0, 10_000, n)).astype(np.int64),
        series=np.zeros(n, np.int64),
        version=np.zeros(n, np.int64),
        fields={},
        dicts={"ta": [f"a{i}".encode() for i in range(8)],
               "tb": [f"b{i}".encode() for i in range(4)]},
    )
    return JColumnData(tags=tags, **kw), TColumnData(tags=dict(tags), **kw)


def _conds(rng):
    """eq/ne on ta and in/not_in on tb, with literals that may be missing
    from the dictionary (a8, a9, b4, b5)."""
    out = []
    if rng.random() < 0.8:
        out.append(("ta", str(rng.choice(["eq", "ne"])), f"a{rng.integers(0, 10)}"))
    if rng.random() < 0.8:
        out.append((
            "tb", str(rng.choice(["in", "not_in"])),
            [f"b{rng.integers(0, 6)}" for _ in range(int(rng.integers(1, 6)))],
        ))
    return out


@pytest.mark.parametrize("absent", [False, True])
@pytest.mark.parametrize("width", [8, 16, 32])
def test_device_tag_mask_matches_jax_fuzz(width, absent):
    rng = np.random.default_rng(77 + width + absent)
    for trial in range(12):
        n = int(rng.integers(1, 5000))
        jsrc, tsrc = _source(rng, n, width, absent)
        conds = _conds(rng)
        jc = [japi.Condition(*c) for c in conds]
        tc = [tapi.Condition(*c) for c in conds]
        want = jse.device_tag_mask(jsrc, jc)
        got = tse.device_tag_mask(tsrc, tc, "cpu")
        if not conds:
            assert want is None and got is None
            continue
        assert got.dtype == np.bool_ and got.shape == (n,)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"trial {trial}")
        begin, end = 100, 9000
        np.testing.assert_array_equal(
            (tsrc.ts >= begin) & (tsrc.ts < end) & got,
            tfilter.row_mask(tsrc, tc, begin, end),
        )


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("delta", [-1, 0, 1234])
def test_row_mask_routes_agree_around_device_min_rows(width, delta):
    """Sources just below, at and above DEVICE_MIN_ROWS: the host and
    device routes give the same mask, each source takes the route its
    size calls for, and the JAX package's row_mask agrees."""
    rng = np.random.default_rng(3 + width)
    n = tse.DEVICE_MIN_ROWS + delta
    jsrc, tsrc = _source(rng, n, width)
    conds = [("ta", "eq", "a2"), ("tb", "not_in", ["b1", "b9"])]
    tc = [tapi.Condition(*c) for c in conds]
    tse.reset_stats()
    got = tse.row_mask(tsrc, tc, 50, 9950, "cpu")
    route = "device_masks" if n >= tse.DEVICE_MIN_ROWS else "host_masks"
    assert tse.STATS[route] == 1 and sum(tse.STATS[k] for k in
                                         ("device_masks", "host_masks")) == 1
    np.testing.assert_array_equal(got, tfilter.row_mask(tsrc, tc, 50, 9950))
    np.testing.assert_array_equal(
        got, jse.row_mask(jsrc, [japi.Condition(*c) for c in conds], 50, 9950)
    )


def test_unsupported_ops_take_the_host_route():
    rng = np.random.default_rng(5)
    _jsrc, tsrc = _source(rng, tse.DEVICE_MIN_ROWS, 32)
    tc = [tapi.Condition("ta", "match", "a1")]
    assert tse.device_tag_mask(tsrc, tc, "cpu") is None
    tse.reset_stats()
    tc = [tapi.Condition("ta", "eq", "a1")]
    tse.row_mask(tsrc, [], 0, 10_000, "cpu")
    assert tse.STATS["host_masks"] == 1
    tse.row_mask(tsrc, tc, 0, 10_000, "cpu")
    assert tse.STATS["device_masks"] == 1
    assert tse.STATS["h2d_bytes"] == tse.DEVICE_MIN_ROWS * 4


def _sidecars(root) -> list:
    """Every stream part's index sidecars: (shard, part order, file, bytes)."""
    out = []
    for shard in sorted((root / "data" / "stream").rglob("shard-*")):
        parts = sorted(p for p in shard.iterdir() if (p / "metadata.json").exists())
        for k, part in enumerate(parts):
            for f in sorted(part.glob("eidx_*.bin")) + sorted(part.glob("tff_*.bin")):
                out.append((shard.name, k, f.name, f.read_bytes()))
    return out


def test_sidecars_byte_identical(engines):
    _jeng, _teng, root = engines
    j = _sidecars(root / "jax")
    assert j and {x[2] for x in j} == {"eidx_svc.bin", "tff_level.bin"}
    assert _sidecars(root / "torch") == j


def test_bloom_bytes_identical():
    rng = np.random.default_rng(9)
    values = [bytes(rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8))
              for _ in range(300)]
    jb, tb = JBloom(len(values)), TBloom(len(values))
    for v in values:
        jb.add(v)
        tb.add(v)
    assert tb.to_bytes() == jb.to_bytes()
    back = TBloom.from_bytes(jb.to_bytes())
    assert all(v in back for v in values)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_parts_cross_read(engines, writer, tmp_path):
    """Parts and sidecars written by one package answer every case
    through the other's engine with the writer's rows and stats."""
    jeng, teng, root = engines
    if writer == "jax":
        reader = _open(tapi, TEngine, root / "jax", device="cpu")
        native = jeng
    else:
        reader = _open(japi, JEngine, root / "torch")
        native = teng
    try:
        for case in STREAM_CASES:
            ql = _subst(case["ql"])
            parse = tql.parse if writer == "jax" else jql.parse
            own = jql.parse if writer == "jax" else tql.parse
            got = _rows(reader.query(parse(ql)))
            assert got == _rows(native.query(own(ql))), case["name"]
            assert reader.last_scan_stats == native.last_scan_stats
    finally:
        reader.close()


def test_engine_needs_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = tapi.SchemaRegistry(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(reg, tmp_path / "data")
    assert TEngine(reg, tmp_path / "data", device="cpu").device == torch.device("cpu")
