"""The port's MeasureEngine and BydbQL front end against the JAX package's.

Each package parses the same BydbQL text with its own ``bydbql`` and runs
it through its own standalone ``MeasureEngine`` over the same points; the
port's engine runs on ``device="cpu"``, where the kernels' plain versions
stand in.  Two corpora:

- the 10 cases of ``tests/cases/measure_cases.json`` over the dataset of
  ``tests/test_fixture_cases.py`` (4,000 points, ``shard_num=2``);
- one seeded run of the ``tests/test_fuzz_parity.py`` request generator.

Tolerance (the precision contract of ``tests/test_precision.py``):
groups and their order, counts, min/max, percentiles, representative
tags and data points are equal; sums and means equal where the JAX
value is integer-valued, else within rtol 1e-5.
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import test_fixture_cases as fx
import test_fuzz_parity as fz
from banyandb_tpu import api as japi
from banyandb_tpu import bydbql as jql
from banyandb_tpu.models.measure import MeasureEngine as JEngine
from banyandb_tpu_torch import api as tapi
from banyandb_tpu_torch import bydbql as tql
from banyandb_tpu_torch.models.measure import MeasureEngine as TEngine

RTOL = 1e-5
FUZZ_SEED = 1234


def _fixture_schema(api, reg):
    reg.create_group(
        api.Group("sw", api.Catalog.MEASURE, api.ResourceOpts(shard_num=2))
    )
    reg.create_measure(
        api.Measure(
            group="sw", name="cpm",
            tags=(
                api.TagSpec("svc", api.TagType.STRING),
                api.TagSpec("region", api.TagType.STRING),
                api.TagSpec("status", api.TagType.INT),
            ),
            fields=(api.FieldSpec("value", api.FieldType.INT),),
            entity=api.Entity(("svc",)),
        )
    )


def _fixture_points(api):
    statuses = (200, 404, 500)
    return tuple(
        api.DataPointValue(
            fx.T0 + i,
            {"svc": f"s{i % 10}", "region": f"r{i % 3}",
             "status": statuses[i % 3]},
            {"value": i % 997},
            version=1,
        )
        for i in range(fx.N)
    )


def _engines(tmp_path, schema, points):
    """-> (JAX engine, port engine on the CPU) over the same points."""
    out = []
    for tag, api, engine, kw in (
        ("jax", japi, JEngine, {}),
        ("torch", tapi, TEngine, {"device": "cpu"}),
    ):
        reg = api.SchemaRegistry(tmp_path / tag)
        schema(api, reg)
        eng = engine(reg, tmp_path / tag / "data", **kw)
        for group, name, pts in points(api):
            eng.write(api.WriteRequest(group, name, pts))
        eng.flush()
        out.append(eng)
    return out


def _integral(x) -> bool:
    return isinstance(x, float) and np.isfinite(x) and x == int(x)


def _assert_same(t, j):
    """Port result `t` against JAX result `j` under the stated contract."""
    assert t.groups == j.groups
    assert t.rep_tags == j.rep_tags
    assert t.data_points == j.data_points
    assert sorted(t.values) == sorted(j.values)
    for key, want in j.values.items():
        got = t.values[key]
        assert len(got) == len(want), key
        inexact = key.startswith(("sum", "mean"))
        for g, w in zip(got, want):
            if inexact and not _integral(w):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=key)
            else:
                assert g == w or (g != g and w != w), (key, g, w)


@pytest.fixture(scope="module")
def corpus_engines(tmp_path_factory):
    jeng, teng = _engines(
        tmp_path_factory.mktemp("corpus"),
        _fixture_schema,
        lambda api: [("sw", "cpm", _fixture_points(api))],
    )
    yield jeng, teng
    jeng.close()
    teng.close()


@pytest.mark.parametrize("case", fx.CASES, ids=[c["name"] for c in fx.CASES])
def test_corpus_case_matches_jax(case, corpus_engines):
    jeng, teng = corpus_engines
    ql = fx._subst(case["ql"])
    jreq, treq = jql.parse(ql), tql.parse(ql)
    assert _rebuild(treq, japi) == jreq
    _assert_same(teng.query(treq), jeng.query(jreq))


def _rebuild(obj, api):
    """Rebuild an api dataclass tree of one package with the classes of
    the other package's ``api`` module."""
    if isinstance(obj, enum.Enum):
        return getattr(api, type(obj).__name__)[obj.name]
    if dataclasses.is_dataclass(obj):
        return getattr(api, type(obj).__name__)(**{
            f.name: _rebuild(getattr(obj, f.name), api)
            for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(x, api) for x in obj)
    return obj


def test_fuzz_run_matches_jax(tmp_path, monkeypatch):
    """One seeded run of the fuzz generator: its dataset recipe and its
    random requests, through both engines."""
    rng = np.random.default_rng(FUZZ_SEED)
    # the generator draws from its module's RNG: give it a private one
    monkeypatch.setattr(fz, "RNG", rng)
    n = fz.N
    data = {
        "svc": rng.integers(0, 8, n),
        "region": rng.integers(0, 4, n),
        "code": rng.choice([200, 301, 404, 500, 503], n),
        "v": np.round(rng.gamma(2.0, 40.0, n), 3),
        "ts": fz.T0 + rng.permutation(n),
    }

    def schema(api, reg):
        reg.create_group(
            api.Group("g", api.Catalog.MEASURE, api.ResourceOpts(shard_num=2))
        )
        reg.create_measure(
            api.Measure(
                group="g", name="m",
                tags=(
                    api.TagSpec("svc", api.TagType.STRING),
                    api.TagSpec("region", api.TagType.STRING),
                    api.TagSpec("code", api.TagType.INT),
                ),
                fields=(api.FieldSpec("v", api.FieldType.FLOAT),),
                entity=api.Entity(("svc",)),
            )
        )

    def points(api):
        return [("g", "m", tuple(
            api.DataPointValue(
                int(data["ts"][i]),
                {"svc": f"s{data['svc'][i]}",
                 "region": f"r{data['region'][i]}",
                 "code": int(data["code"][i])},
                {"v": float(data["v"][i])},
                version=1,
            )
            for i in range(n)
        ))]

    jeng, teng = _engines(tmp_path, schema, points)
    try:
        for _ in range(fz.N_QUERIES):
            jreq = fz._random_request()[0]
            _assert_same(teng.query(_rebuild(jreq, tapi)), jeng.query(jreq))
    finally:
        jeng.close()
        teng.close()


def test_engine_needs_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = tapi.SchemaRegistry(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(reg, tmp_path / "data")
    eng = TEngine(reg, tmp_path / "data", device="cpu")
    assert eng.device == torch.device("cpu")
    eng.close()
