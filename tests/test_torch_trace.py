"""The port's trace model against the JAX package's, on the CPU.

Both packages write the same spans through their own ``TraceEngine``
(trace-id blooms, zone maps, the sidx ordered index) and answer:

- the 3 ``by_id`` and 4 ``ordered`` cases of ``tests/cases/trace_cases.json``
  over the dataset of ``tests/test_fixture_cases_stream_trace.py``;
- its 42 ``ql`` cases through each package's BydbQL and
  ``ql_exec.execute_trace_ql`` over the multi-part, cross-segment dataset
  of ``tests/test_goldens_trace.py``, also held against that file's
  numpy oracle, with the bloom and zone block-skip counts of both;
- one tail-sampling pipeline case (``keep_slow_traces`` at merge);
- trace parts with their blooms and the sidx written by one package and
  read by the other.

Tolerance: none — span lists, their order and skip counts are exact.
"""

import json
from pathlib import Path

import pytest

import test_goldens_trace as gt
from banyandb_tpu import api as japi
from banyandb_tpu import bydbql as jql
from banyandb_tpu.api.schema import Trace as JTrace
from banyandb_tpu.models import trace_pipeline as jpipe
from banyandb_tpu.models.trace import SpanValue as JSpan
from banyandb_tpu.models.trace import TraceEngine as JEngine
from banyandb_tpu.query import ql_exec as jqe
from banyandb_tpu_torch import api as tapi
from banyandb_tpu_torch import bydbql as tql
from banyandb_tpu_torch.api.schema import Trace as TTrace
from banyandb_tpu_torch.models import trace_pipeline as tpipe
from banyandb_tpu_torch.models.trace import BLOOM_FILE
from banyandb_tpu_torch.models.trace import SpanValue as TSpan
from banyandb_tpu_torch.models.trace import TraceEngine as TEngine
from banyandb_tpu_torch.query import ql_exec as tqe
from test_fixture_cases_stream_trace import N_TRACES, T0, TRACE_CASES, _span_rows

ALL_CASES = json.loads(
    (Path(__file__).parent / "cases" / "trace_cases.json").read_text()
)["cases"]
PKGS = {
    "jax": (japi, JTrace, JSpan, JEngine, jql, jqe),
    "torch": (tapi, TTrace, TSpan, TEngine, tql, tqe),
}


def _trace_schema(api, trace_cls, group, tags):
    return trace_cls(
        group=group, name="spans",
        tags=tuple(
            api.TagSpec(n, api.TagType.INT if t == "int" else api.TagType.STRING)
            for n, t in tags
        ),
        trace_id_tag="trace_id",
    )


def _engine(pkg, root, group, tags, batches, flush_each=True):
    api, trace_cls, span_cls, engine, _parse, _exec = PKGS[pkg]
    reg = api.SchemaRegistry(root)
    reg.create_group(api.Group(group, api.Catalog.STREAM, api.ResourceOpts(shard_num=2)))
    eng = engine(reg, root / "data")
    eng.create_trace(_trace_schema(api, trace_cls, group, tags))
    for batch in batches:
        eng.write(group, "spans", [span_cls(ts, tags_, p) for ts, tags_, p in batch],
                  ordered_tags=("duration",))
        if flush_each:
            eng.flush()
    if not flush_each:
        eng.maintain()
    return eng


FIXTURE_TAGS = (("trace_id", "string"), ("svc", "string"), ("duration", "int"))


@pytest.fixture(scope="module")
def fixture_engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace_fixture")
    out = {
        pkg: _engine(pkg, root / pkg, "sw", FIXTURE_TAGS, [_span_rows()], flush_each=False)
        for pkg in PKGS
    }
    yield out
    for eng in out.values():
        eng.close()


@pytest.fixture(scope="module")
def golden_engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace_golden")
    out = {pkg: _engine(pkg, root / pkg, "gold", gt.SCHEMA_TAGS, gt.BATCHES)
           for pkg in PKGS}
    yield out, root
    for eng in out.values():
        eng.close()


def _norm(spans) -> list:
    return [
        (s["timestamp"], bytes(s["span"]), tuple(sorted(s["tags"].items())))
        for s in spans
    ]


def _fixture_case(eng, case):
    if case["kind"] == "by_id":
        return _norm(eng.query_by_trace_id("sw", "spans", case["trace_id"]))
    tr_cls = japi.TimeRange if isinstance(eng, JEngine) else tapi.TimeRange
    return eng.query_ordered(
        "sw", "spans", "duration", tr_cls(T0, T0 + N_TRACES * 10 + 10),
        lo=case.get("lo"), hi=case.get("hi"), asc=case["asc"], limit=case["limit"],
    )


@pytest.mark.parametrize("case", TRACE_CASES, ids=[c["name"] for c in TRACE_CASES])
def test_fixture_case_matches_jax(case, fixture_engines):
    got = _fixture_case(fixture_engines["torch"], case)
    want = _fixture_case(fixture_engines["jax"], case)
    assert got == want, case["name"]
    assert bool(got) == (case["name"] != "by_id_missing"), case["name"]


def _ql(pkg, eng, case):
    """-> (rows, blocks skipped by bloom in this query's trace-id lookup,
    None when it made none)."""
    _api, _t, _s, _e, ql, qe = PKGS[pkg]
    _cat, req = ql.parse_with_catalog(gt.case_ql(case))
    eng.last_bloom_blocks_skipped = None
    rows = qe.execute_trace_ql(eng, req).data_points
    return rows, eng.last_bloom_blocks_skipped


@pytest.mark.parametrize("case", gt.QL_CASES, ids=[c["name"] for c in gt.QL_CASES])
def test_ql_case_matches_jax(case, golden_engines):
    engines, _root = golden_engines
    got = _ql("torch", engines["torch"], case)
    assert got == _ql("jax", engines["jax"], case), case["name"]
    assert got[0] == gt.oracle(case), case["name"]


def test_every_trace_case_is_covered():
    names = {c["name"] for c in TRACE_CASES} | {c["name"] for c in gt.QL_CASES}
    assert names == {c["name"] for c in ALL_CASES} and len(ALL_CASES) == 49


def _skipped(meter, reason: str) -> float:
    return meter.global_meter().snapshot()["counters"].get(
        ("blocks_skipped", (("reason", reason),)), 0.0
    )


@pytest.mark.parametrize("name,reason", [("scan_zone_skip", "zone"),
                                         ("ql_by_id_eq_seg2", "bloom")])
def test_block_skips_match_jax(name, reason, golden_engines):
    """Zone maps and trace-id blooms skip the same number of blocks in
    both packages, each counted on its own package's meter."""
    from banyandb_tpu.obs import metrics as jmetrics
    from banyandb_tpu_torch.obs import metrics as tmetrics

    engines, _root = golden_engines
    case = next(c for c in gt.QL_CASES if c["name"] == name)
    counts = {}
    for pkg, meter in (("jax", jmetrics), ("torch", tmetrics)):
        before = _skipped(meter, reason)
        _ql(pkg, engines[pkg], case)
        counts[pkg] = _skipped(meter, reason) - before
    assert counts["torch"] == counts["jax"] > 0


def test_blooms_byte_identical(golden_engines):
    _engines, root = golden_engines

    def blooms(pkg):
        files = sorted((root / pkg / "data").rglob(BLOOM_FILE))
        return [f.read_bytes() for f in files]

    assert blooms("jax") and blooms("torch") == blooms("jax")


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_parts_cross_read(writer, reader, golden_engines):
    """Parts, blooms and the sidx written by one package answer every QL
    case through the other's engine."""
    engines, root = golden_engines
    api, _t, _s, engine, _parse, _exec = PKGS[reader]
    eng = engine(api.SchemaRegistry(root / writer), root / writer / "data")
    try:
        for case in gt.QL_CASES:
            assert _ql(reader, eng, case) == _ql(writer, engines[writer], case), case["name"]
    finally:
        eng.close()


PIPE_TAGS = (("trace_id", "string"), ("status", "string"), ("duration", "int"))


def _pipeline_spans(n_traces=20, spans_per=4):
    return [
        (T0 + t * 100 + s,
         {"trace_id": f"tr{t}", "status": "error" if (t == 3 and s == 0) else "ok",
          "duration": 900 + s if t >= 15 else 10 + s},
         f"{t}-{s}".encode())
        for t in range(n_traces) for s in range(spans_per)
    ]


def test_pipeline_sampler_at_merge_matches_jax(tmp_path):
    """Keep error spans or whole slow traces: after merges both packages
    keep the same spans of every trace."""
    out = {}
    for pkg, pipe in (("jax", jpipe), ("torch", tpipe)):
        eng = _engine(pkg, tmp_path / pkg, "g", PIPE_TAGS, [_pipeline_spans()] * 6)
        slow = pipe.keep_slow_traces("duration", 900)
        errors = pipe.keep_tag_values("status", {b"error"})
        eng.pipeline.register("g", "spans", lambda b, s=slow, e=errors: s(b) | e(b))
        assert eng.finalize_segments("g") > 0
        out[pkg] = {f"tr{t}": _norm(eng.query_by_trace_id("g", "spans", f"tr{t}"))
                    for t in range(20)}
        eng.close()
    assert out["torch"] == out["jax"]
    assert out["torch"]["tr17"] and out["torch"]["tr5"] == []
    assert all(dict(s[2])["status"] == "error" for s in out["torch"]["tr3"])
