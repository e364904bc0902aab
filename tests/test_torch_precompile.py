"""The port's plan precompile registry, build cache and ColumnBatch,
held against the JAX package on the CPU.

- the builtin signature matrix: names and every PlanSpec / FusedSpec /
  _MaskSpec field equal the reference's;
- the JSON codec: ``spec_to_json`` equal for every builtin signature,
  and a ``plan-registry.json`` written by either package's registry
  loads into the other's (the same queries over the same data record
  the same signatures in both);
- the registry's semantics, mirroring tests/test_cold_path.py's seven
  registry tests (warming here runs on ``device="cpu"``, through the
  kernels' plain versions);
- ``utils/compile_cache``: precedence, off-values, and the kernel
  library's path inside the enabled directory (no nvcc needed);
- ``ops/blocks``: ``pad_rows_bucket`` and ``ColumnBatch`` equal the
  reference's on the same inputs (exact: the same padded values).
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from banyandb_tpu.query import precompile as jprecompile
from banyandb_tpu_torch.query import precompile

T0 = 1_700_000_000_000


def _asdict(spec):
    return dataclasses.asdict(spec)


# -- the builtin matrix and the JSON codec -------------------------------------


@pytest.mark.parametrize(
    "fn", ["builtin_plans", "builtin_fused", "builtin_fused_decode", "builtin_masks"]
)
def test_builtin_matrix_equals_reference(fn):
    port = getattr(precompile, fn)()
    ref = getattr(jprecompile, fn)()
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (_, p), (_, r) in zip(port, ref):
        assert type(p).__name__ == type(r).__name__
        assert _asdict(p) == _asdict(r)


def _builtin_sigs(mod):
    return (
        [("measure", s) for _, s in mod.builtin_plans()]
        + [("fused", s) for _, s in mod.builtin_fused()]
        + [("stream_mask", s) for _, s in mod.builtin_masks()]
    )


def test_spec_json_equals_reference_and_round_trips():
    for (kind, p), (_, r) in zip(
        _builtin_sigs(precompile), _builtin_sigs(jprecompile)
    ):
        doc = precompile.spec_to_json(kind, p)
        assert json.dumps(doc, sort_keys=True) == json.dumps(
            jprecompile.spec_to_json(kind, r), sort_keys=True
        )
        kind2, p2 = precompile.spec_from_json(json.loads(json.dumps(doc)))
        assert kind2 == kind and p2 == p and hash(p2) == hash(p)


def _schema_objs(api):
    return (
        api.Group("g", api.Catalog.MEASURE, api.ResourceOpts(shard_num=2)),
        api.Measure(
            group="g",
            name="m",
            tags=(
                api.TagSpec("svc", api.TagType.STRING),
                api.TagSpec("region", api.TagType.STRING),
            ),
            fields=(api.FieldSpec("value", api.FieldType.FLOAT),),
            entity=api.Entity(("svc",)),
        ),
    )


def _engine(pkg, root):
    """A 2-shard measure store with two flushed parts per shard and
    memtable rows, in `pkg` (banyandb_tpu or banyandb_tpu_torch)."""
    import importlib

    api = importlib.import_module(f"{pkg}.api")
    mm = importlib.import_module(f"{pkg}.models.measure")
    reg = api.SchemaRegistry(root)
    group, measure = _schema_objs(api)
    reg.create_group(group)
    reg.create_measure(measure)
    kw = {"device": "cpu"} if pkg == "banyandb_tpu_torch" else {}
    eng = mm.MeasureEngine(reg, root / "data", **kw)
    rng = np.random.default_rng(7)
    for b in range(3):
        n = 15_000
        eng.write_columns(
            "g",
            "m",
            ts_millis=T0 + b * n + np.arange(n, dtype=np.int64),
            tags={
                "svc": mm.DictColumn(
                    [b"s%02d" % i for i in range(30)],
                    rng.integers(0, 30, n).astype(np.int32),
                ),
                "region": mm.DictColumn(
                    [b"r%d" % i for i in range(4)],
                    rng.integers(0, 4, n).astype(np.int32),
                ),
            },
            fields={"value": rng.gamma(2.0, 40.0, n)},
            versions=np.ones(n, dtype=np.int64),
        )
        if b < 2:
            eng.flush()
    return eng


QUERIES = (
    "SELECT sum(value) FROM MEASURE m IN g TIME BETWEEN {b} AND {e} "
    "WHERE region != 'r3' GROUP BY svc TOP 7 BY value",
    "SELECT percentile(value, 0.5, 0.99) FROM MEASURE m IN g "
    "TIME BETWEEN {b} AND {e} GROUP BY region",
    "SELECT count(value) FROM MEASURE m IN g TIME BETWEEN {b} AND {e} "
    "WHERE region = 'r1' OR svc = 's05' GROUP BY svc, region",
)


@pytest.fixture()
def recorded(tmp_path, monkeypatch):
    """The same queries over the same data through both packages'
    engines, each recording into a fresh registry of its own."""
    from banyandb_tpu import bydbql as jbydbql
    from banyandb_tpu_torch import bydbql

    monkeypatch.setenv("BYDB_PRECOMPILE", "1")
    regs = {}
    for pkg, mod, parse in (
        ("banyandb_tpu", jprecompile, jbydbql.parse),
        ("banyandb_tpu_torch", precompile, bydbql.parse),
    ):
        r = mod.PrecompileRegistry()
        monkeypatch.setattr(mod, "_registry", r)
        eng = _engine(pkg, tmp_path / pkg)
        for ql in QUERIES:
            eng.query(parse(ql.format(b=T0, e=T0 + 50_000)))
        eng.close()
        regs[pkg] = r
    yield regs["banyandb_tpu"], regs["banyandb_tpu_torch"]
    for r in regs.values():
        r.shutdown()


def test_registry_records_and_roundtrips(recorded, tmp_path):
    _jr, r = recorded
    assert r.stats()["recorded"] >= 2, r.stats()
    for kind, spec in r.signatures():
        kind2, spec2 = precompile.spec_from_json(
            json.loads(json.dumps(precompile.spec_to_json(kind, spec)))
        )
        assert kind2 == kind and spec2 == spec and hash(spec2) == hash(spec)
    store_path = tmp_path / "plan-registry.json"
    r.attach_store(store_path)
    assert store_path.exists()
    r2 = precompile.PrecompileRegistry()
    r2.attach_store(store_path)
    assert set(r2.signatures()) == set(r.signatures())


def test_store_loads_across_packages(recorded, tmp_path):
    """A store written by the JAX package's registry loads into the
    port's, and the reverse; both hold the same signatures, because the
    two executors resolved the same plans — up to the planner's
    group-method override, which follows each package's backend policy
    (the JAX package's picks "matmul" for small operands on the CPU, so
    its planner overrides the static choice there; on a TPU it keeps
    "auto", as the port's device-independent policy does)."""
    jr, r = recorded
    jstore, pstore = tmp_path / "jax.json", tmp_path / "port.json"
    jr.attach_store(jstore)
    r.attach_store(pstore)

    into_port = precompile.PrecompileRegistry()
    into_port.attach_store(jstore)
    into_ref = jprecompile.PrecompileRegistry()
    into_ref.attach_store(pstore)

    def as_json(reg, mod):
        return sorted(
            json.dumps(mod.spec_to_json(k, s), sort_keys=True)
            for k, s in reg.signatures()
        )

    assert as_json(into_port, precompile) == as_json(jr, jprecompile)
    assert as_json(into_ref, jprecompile) == as_json(r, precompile)
    assert len(into_port.signatures()) >= 2

    def plan_docs(reg, mod):
        out = []
        for k, s in reg.signatures():
            d = mod.spec_to_json(k, s)
            plan = d["plan"] if k == "fused" else d
            assert k != "fused" or plan.pop("kind", None) is None
            plan.pop("group_method")
            out.append(json.dumps(d, sort_keys=True))
        return sorted(out)

    assert plan_docs(r, precompile) == plan_docs(jr, jprecompile)
    assert {
        (s.plan if k == "fused" else s).group_method
        for k, s in r.signatures()
    } == {"auto"}


# -- registry semantics (tests/test_cold_path.py's registry tests) -------------


def test_registry_warm_runs_every_signature(monkeypatch):
    monkeypatch.setenv("BYDB_PRECOMPILE", "1")
    r = precompile.PrecompileRegistry(device="cpu")
    sigs = _builtin_sigs(precompile)
    assert r.warm(sigs=sigs) == len(sigs) == 11
    st = r.stats()
    assert st["errors"] == 0 and st["last_error"] is None, st
    assert st["device"] == "cpu"


def test_registry_warm_error_is_counted_not_raised(monkeypatch):
    """No CUDA here: the default device raises at warm time (never at
    import or in record()), and the warm counts it with its text."""
    monkeypatch.setenv("BYDB_PRECOMPILE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = precompile.PrecompileRegistry()
    r.record("measure", precompile.builtin_plans()[0][1])
    assert r.warm(include_builtin=False) == 0
    st = r.stats()
    assert st["errors"] == 1 and "CUDA is not available" in st["last_error"]


def test_registry_disabled_records_nothing(monkeypatch):
    monkeypatch.setenv("BYDB_PRECOMPILE", "0")
    r = precompile.PrecompileRegistry()
    r.record("measure", precompile.builtin_plans()[0][1])
    assert r.stats()["recorded"] == 0
    assert r.warm_async() is None


def test_warm_async_queues_round_for_midwarm_signatures(monkeypatch):
    import threading

    monkeypatch.setenv("BYDB_PRECOMPILE", "1")
    r = precompile.PrecompileRegistry(device="cpu")
    started, release = threading.Event(), threading.Event()
    compiled = []

    def fake_compile(kind, spec):
        started.set()
        release.wait(10)
        compiled.append(spec)

    monkeypatch.setattr(r, "_compile_one", fake_compile)
    spec0, spec1 = (
        precompile.builtin_plans()[0][1],
        precompile.builtin_plans()[1][1],
    )
    r.record("measure", spec0)
    t1 = r.warm_async(include_builtin=False)
    assert started.wait(10)
    r.record("measure", spec1)  # lands mid-round
    assert r.warm_async(include_builtin=False) is t1  # queued, not dropped
    release.set()
    t1.join(15)
    assert not t1.is_alive()
    assert spec1 in compiled, "mid-warm signature never warmed"


def test_shutdown_stops_warm_at_kernel_boundary(monkeypatch):
    import threading

    monkeypatch.setenv("BYDB_PRECOMPILE", "1")
    r = precompile.PrecompileRegistry(device="cpu")
    base = precompile.builtin_plans()[0][1]
    for i in range(50):
        r._recorded[("measure", dataclasses.replace(base, num_groups=i + 2))] = 1
    started = threading.Event()

    def slow_compile(kind, spec):
        started.set()
        time.sleep(0.02)

    monkeypatch.setattr(r, "_compile_one", slow_compile)
    t = r.warm_async(include_builtin=False)
    assert started.wait(10)
    r.shutdown(timeout=30)
    assert not t.is_alive()
    assert r.compiled < 50, "shutdown did not cancel the warm round"


def test_record_save_is_debounced_off_hot_path(tmp_path, monkeypatch):
    monkeypatch.setenv("BYDB_PRECOMPILE", "1")
    r = precompile.PrecompileRegistry()
    store = tmp_path / "plan-registry.json"
    r.attach_store(store)
    assert not store.exists()  # nothing recorded yet, nothing to save
    r.record("measure", precompile.builtin_plans()[0][1])
    assert not store.exists()  # record() itself never writes inline
    deadline = time.time() + 10
    while time.time() < deadline and not store.exists():
        time.sleep(0.05)
    assert store.exists(), "debounced save never fired"
    r.shutdown()


def test_registry_and_plan_audit_agree():
    """The plan auditor's matrix IS the registry's builtin signature
    set: a signature warmed is a signature contract-audited."""
    from banyandb_tpu_torch.lint.whole_program.plan_audit import default_entries

    audit_names = {e.name for e in default_entries()}
    builtin_names = (
        {n for n, _ in precompile.builtin_plans()}
        | {n for n, _ in precompile.builtin_fused()}
        | {n for n, _ in precompile.builtin_fused_decode()}
        | {n for n, _ in precompile.builtin_masks()}
    )
    assert not builtin_names - audit_names
    extras = audit_names - builtin_names
    assert all(n.startswith("ops/") for n in extras), extras
    keyed = [e for e in default_entries() if e.cache_key is not None]
    assert len(keyed) >= 6  # 5 measure plans + 1 stream mask (+ fused)


def test_warm_args_match_the_executors_ship_forms():
    """The warm's dense and compressed staged args have the keys,
    shapes and dtypes of the reference's warm args."""
    from banyandb_tpu_torch.lint.whole_program.plan_audit import dtype_name

    def shape_tree(tree):
        if isinstance(tree, dict):
            return {k: shape_tree(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return [shape_tree(v) for v in tree]
        return (dtype_name(tree.dtype) if hasattr(tree.dtype, "is_floating_point")
                else str(tree.dtype), tuple(tree.shape))

    for _, spec in precompile.builtin_plans():
        for port, ref in (
            (precompile.measure_warm_args(spec, "cpu"),
             jprecompile.measure_warm_args(spec)),
            (precompile.measure_decode_warm_args(spec, "cpu"),
             jprecompile.measure_decode_warm_args(spec)),
        ):
            assert shape_tree(list(port)) == shape_tree(list(ref))
    for _, fspec in precompile.builtin_fused():
        port = precompile.fused_decode_warm_args(fspec, "cpu")
        ref = jprecompile.fused_decode_warm_args(fspec)
        assert shape_tree(list(port)) == shape_tree(list(ref))


# -- the build cache -------------------------------------------------------------


@pytest.fixture()
def fresh_cache(monkeypatch):
    from banyandb_tpu_torch.utils import compile_cache

    state = {k: (0 if isinstance(v, int) and not isinstance(v, bool) else v)
             for k, v in compile_cache._state.items()}
    state.update(enabled=False, dir=None, error=None, build_s=0.0, load_s=0.0)
    monkeypatch.setattr(compile_cache, "_state", state)
    monkeypatch.delenv("BYDB_COMPILE_CACHE_DIR", raising=False)
    return compile_cache


def test_compile_cache_precedence_and_off_values(fresh_cache, tmp_path, monkeypatch):
    cc = fresh_cache
    assert cc.enable() is None and cc.active_dir() is None
    for off in ("0", "off", "No", " none ", "false", "disabled"):
        monkeypatch.setenv("BYDB_COMPILE_CACHE_DIR", off)
        assert cc.enable(tmp_path / "default") is None
        assert cc.enable_at(off) is None
    assert not cc.stats()["enabled"]
    # env beats the computed default
    monkeypatch.setenv("BYDB_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert cc.enable(tmp_path / "default") == str(tmp_path / "env")
    # first wiring wins, even over the explicit form
    assert cc.enable_at(tmp_path / "flag") == str(tmp_path / "env")
    st = cc.stats()
    assert st["enabled"] and st["dir"] == str(tmp_path / "env")
    assert {k: st[k] for k in ("hits", "misses", "builds", "loads", "entries")} == {
        "hits": 0, "misses": 0, "builds": 0, "loads": 0, "entries": 0
    }


def test_compile_cache_explicit_path_and_default(fresh_cache, tmp_path, monkeypatch):
    cc = fresh_cache
    assert cc.enable_at(tmp_path / "flag") == str(tmp_path / "flag")
    assert (tmp_path / "flag").is_dir()
    monkeypatch.setattr(cc, "_state", dict(cc._state, enabled=False, dir=None))
    assert cc.enable(tmp_path / "default") == str(tmp_path / "default")


def test_library_path_resolves_into_the_enabled_dir(fresh_cache, tmp_path):
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    default = hk._library_path()
    assert default.parent == hk.BUILD_DIR
    fresh_cache.enable_at(tmp_path / "cc")
    so = hk._library_path()
    assert so.parent == tmp_path / "cc"
    # the name is the hash of the sources and flags, wherever it lives
    assert so.name == default.name and so.name.startswith("libbydb_hopper-")
    fresh_cache.note_build(2.5)
    fresh_cache.note_load(0.01, hit=False)
    fresh_cache.note_load(0.02, hit=True)
    st = fresh_cache.stats()
    assert (st["misses"], st["builds"], st["hits"], st["loads"]) == (1, 1, 1, 2)
    assert st["build_s"] == 2.5 and st["load_s"] == pytest.approx(0.03)


# -- ops/blocks ------------------------------------------------------------------


def test_pad_rows_bucket_equals_reference():
    from banyandb_tpu.ops.blocks import pad_rows_bucket as jbucket
    from banyandb_tpu_torch.ops import pad_rows_bucket

    for n in (0, 1, 63, 64, 65, 100, 4096, 4097, 8191, 8192):
        assert pad_rows_bucket(n) == jbucket(n)
    for bad in (8193, 1 << 20):
        with pytest.raises(ValueError):
            pad_rows_bucket(bad)


@pytest.mark.parametrize("n", [1, 100, 8192])
def test_column_batch_equals_reference(n):
    import torch.utils._pytree as pytree

    from banyandb_tpu.ops.blocks import ColumnBatch as JBatch
    from banyandb_tpu_torch.ops import ColumnBatch

    rng = np.random.default_rng(n)
    epoch = T0
    kw = dict(
        ts_millis=epoch + rng.integers(0, 86_400_000, n),
        epoch_millis=epoch,
        series_ordinal=rng.integers(0, 50, n),
        fields={"v": rng.gamma(2.0, 40.0, n), "calls": rng.integers(0, 9, n)},
        tag_codes={"svc": rng.integers(0, 30, n)},
        version=T0 + rng.integers(0, 1000, n),
    )
    b = ColumnBatch.build(**kw, device="cpu")
    j = JBatch.build(**kw)
    assert b.nrows == j.nrows and b.device == torch.device("cpu")
    for name in ("ts", "series", "valid", "version"):
        got, want = getattr(b, name), np.asarray(getattr(j, name))
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)
    for group in ("fields", "tags"):
        gb, gj = getattr(b, group), getattr(j, group)
        assert sorted(gb) == sorted(gj)
        for k in gb:
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(gj[k]))
    # a pytree node: maps over its tensors and keeps its type
    doubled = pytree.tree_map(lambda t: t * 2, b)
    assert isinstance(doubled, ColumnBatch)
    np.testing.assert_array_equal(doubled.ts.numpy(), 2 * b.ts.numpy())
    assert len(pytree.tree_leaves(b)) == 4 + len(b.fields) + len(b.tags)


def test_column_batch_rejects_wide_offsets_and_needs_a_device(monkeypatch):
    from banyandb_tpu_torch.ops import ColumnBatch

    kw = dict(
        epoch_millis=0,
        series_ordinal=np.zeros(2),
        fields={},
        tag_codes={},
    )
    with pytest.raises(ValueError, match="exceed int32"):
        ColumnBatch.build(ts_millis=np.array([0, 2**31]), device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ColumnBatch.build(ts_millis=np.array([0, 1]), **kw)
