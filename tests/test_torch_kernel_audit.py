"""The port's kernel audit and plan audit, held against the JAX
package on the CPU, with seeded-fault proofs for every analyzer
(mirrors tests/test_kernel_audit.py and the plan-audit half of
tests/test_whole_program.py).

- plan audit: for each builtin signature, the output shapes and dtypes
  of the port's per-chunk function on fake tensors equal
  ``jax.eval_shape`` of the reference's (exact: names, dtypes, shapes);
- dispatch: the port's ``gets`` equal the reference's for the same
  scenario; ``puts`` differ by a rule stated below (and in PERF.md),
  which the test pins rather than forces; the ql rows are zero in both;
- planted faults: an extra launch fails the budget, a loosened row
  fails as stale, a missing row fails, a planted ``.item()``, f64 and
  bf16 narrowing are each flagged, the real matrix is clean, and the
  counting patches are restored.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from banyandb_tpu_torch.lint.core import apply_ratchet, ratchet_value
from banyandb_tpu_torch.lint.kernel import (
    KERNEL_RULES,
    kernel_entries,
    run_kernel_audit,
)
from banyandb_tpu_torch.lint.kernel import dispatch as kdispatch
from banyandb_tpu_torch.lint.kernel import kernel_budgets, lowering, op_audit
from banyandb_tpu_torch.lint.whole_program import plan_audit
from banyandb_tpu_torch.lint.whole_program.plan_audit import KernelAudit
from banyandb_tpu_torch.query.precompile import TensorSpec


@pytest.fixture(scope="module")
def traces():
    return kdispatch.audit_dispatch()


@pytest.fixture(scope="module")
def ref_traces():
    from banyandb_tpu.lint.kernel import dispatch as jdispatch

    return jdispatch.audit_dispatch()


def _entry(fn, args=None, name="seeded"):
    if args is None:
        args = (TensorSpec((64,), torch.float32),)
    return KernelAudit(
        name=name, path="query/x.py", line=1, fn=fn, args=args, expect=None
    )


# -- plan audit against jax.eval_shape -------------------------------------------


def test_plan_audit_shapes_equal_reference_eval_shape():
    from banyandb_tpu.lint.whole_program import plan_audit as jplan

    ref = {e.name: e for e in jplan.default_entries()}
    port = plan_audit.default_entries()
    assert [e.name for e in port] == list(ref)
    for e in port:
        r = ref[e.name]
        want = jplan._flat_spec(jax.eval_shape(r.fn, *r.args, **r.kwargs))
        got = plan_audit.flat_spec(plan_audit.fake_call(e))
        assert got == want, e.name
        assert e.expect == r.expect, e.name


def test_plan_audit_clean_tree():
    fs = plan_audit.run_plan_audit()
    assert fs == [], "\n".join(f.render() for f in fs)


def test_plan_audit_flags_seeded_promotion_and_mutable_key():
    def promoting(x):
        return {"count": x.to(torch.float64)}

    entry = _entry(promoting)
    entry.expect = {"['count']": ("float32", (64,))}
    entry.cache_key = {"not": "frozen"}
    msgs = [f.message for f in plan_audit.audit_kernel(entry)]
    assert any("is float64" in m for m in msgs), msgs
    assert any("dtype=float64" in m and "contract says" in m for m in msgs), msgs
    assert any("not deeply immutable" in m for m in msgs), msgs


def test_plan_audit_flags_broken_trace():
    entry = _entry(lambda x: x.view(7, -1))
    msgs = [f.message for f in plan_audit.audit_kernel(entry)]
    assert len(msgs) == 1 and "fake-tensor trace failed" in msgs[0]


def test_hand_kernels_are_one_op_under_fake_tensors():
    """The wrappers' custom ops take part in the fake trace (their fake
    implementations give the shapes): ops/group_reduce dispatches the
    group kernel as one op and never runs its real implementation."""
    entry = next(e for e in kernel_entries() if e.name == "ops/group_reduce")
    trace = op_audit.trace_entry(entry)
    names = [op.name for op in trace.ops]
    assert names.count("bydb.fused_group_multi") == 1, names


# -- kernel-ops ------------------------------------------------------------------


def test_op_audit_item_sync_flagged():
    def k(x):
        s = x.sum().item()
        return x * s

    fs, cols = op_audit.audit_entry(_entry(k))
    assert cols["syncs"] == 1
    assert any(
        f.rule == "kernel-ops" and "host sync `aten._local_scalar_dense`" in f.message
        for f in fs
    ), [f.message for f in fs]


def test_op_audit_nonzero_sync_flagged():
    fs, cols = op_audit.audit_entry(_entry(lambda x: torch.nonzero(x > 0)))
    assert cols is None  # a data-dependent shape stops the trace
    assert any("host sync `aten.nonzero`" in f.message for f in fs), [
        f.message for f in fs
    ]


def test_op_audit_f64_flagged():
    fs, cols = op_audit.audit_entry(_entry(lambda x: x.to(torch.float64) * 2.0))
    assert cols["widest"] == 8
    assert any(
        "64-bit value `torch.float64`" in f.message and "op #" in f.message
        for f in fs
    ), [f.message for f in fs]


def test_op_audit_i64_value_flagged_but_index_not():
    """An int64 VALUE (summed as int64) is a finding; the int64 index
    operand of a segment sum is counted in index64 and is none."""
    fs, cols = op_audit.audit_entry(
        _entry(lambda x: x.to(torch.int64).sum().to(torch.int32),
               (TensorSpec((64,), torch.int32),))
    )
    assert any("64-bit value `torch.int64`" in f.message for f in fs)

    def segment_sum(key, v):
        out = torch.zeros(9, dtype=torch.float32, device=v.device)
        return out.index_put_((key.long(),), v, accumulate=True)

    fs, cols = op_audit.audit_entry(
        _entry(segment_sum, (TensorSpec((64,), torch.int32),
                             TensorSpec((64,), torch.float32)))
    )
    assert fs == [] and cols == {"widest": 4, "index64": 1, "syncs": 0}


def test_op_audit_narrowing_flagged():
    fs, _ = op_audit.audit_entry(
        _entry(lambda x: x.to(torch.bfloat16).to(torch.float32))
    )
    assert any(
        "accumulator narrowed" in f.message and "bfloat16" in f.message
        for f in fs
    ), [f.message for f in fs]


def test_op_audit_clean_function():
    fs, cols = op_audit.audit_entry(_entry(lambda x: (x * 2.0).sum()))
    assert fs == [] and cols == {"widest": 4, "index64": 0, "syncs": 0}


def test_op_audit_real_matrix_clean():
    for entry in kernel_entries():
        fs, cols = op_audit.audit_entry(entry)
        assert fs == [], "\n".join(f.render() for f in fs)
        assert cols["widest"] == 4 and cols["syncs"] == 0, (entry.name, cols)


def test_stored_signatures_audited():
    from banyandb_tpu_torch.lint.kernel import stored_entries
    from banyandb_tpu_torch.query import precompile

    reg = precompile.PrecompileRegistry()
    reg._recorded[("measure", precompile.builtin_plans()[0][1])] = 3
    reg._recorded[("stream_mask", precompile.builtin_masks()[0][1])] = 1
    entries = stored_entries(registry=reg)
    assert len(entries) == 2
    for e in entries:
        assert e.name.startswith("stored/")
        fs, cols = op_audit.audit_entry(e)
        assert fs == [] and cols["widest"] == 4
    assert stored_entries(registry=precompile.PrecompileRegistry()) == []


# -- kernel-lowering -------------------------------------------------------------


def test_lowering_collectives_only_on_the_mesh_steps():
    for entry in kernel_entries():
        fs, cols = lowering.audit_entry(entry)
        assert fs == [] and cols["ops"] > 0 and cols["bytes_class"] > 0
        want = 4 if entry.name.endswith("dist-step") else 0
        assert cols["collectives"] == want, (entry.name, cols)


# -- kernel-dispatch -------------------------------------------------------------


def test_dispatch_real_scenarios_match_builtins_and_budgets(traces):
    assert kdispatch.dispatch_findings(traces) == []
    for name, t in traces.items():
        assert not t.error, (name, t.error)
        row = kernel_budgets.BUDGETS[name]
        assert (t.gets, t.puts, t.hand_launches) == (
            row.gets, row.puts, row.hand_launches
        ), name
        if t.builtin is not None:
            assert tuple(dict.fromkeys(t.specs)) == (t.builtin,), name


def _code_preds(builtin) -> int:
    plan = getattr(builtin, "plan", builtin)
    return sum(
        1 for p in getattr(plan, "preds", ())
        if p.kind == "code" and p.op in ("eq", "ne")
    )


def test_dispatch_counts_against_the_reference(traces, ref_traces):
    """gets equal the reference's measured columns, scenario for
    scenario.  puts differ by one rule: the port ships the two
    histogram scalars and each eq/ne predicate code as a 0-d tensor (a
    4-byte host->device copy each), where the JAX executor passes them
    as scalar arguments of the jitted call, outside ``jnp.asarray``.
    The ql rows are zero in both."""
    from banyandb_tpu.lint.kernel import dispatch as jdispatch

    common = set(traces) & set(ref_traces)
    assert common == set(ref_traces)  # the port's rows cover the reference's
    assert set(traces) - common == {
        f"measure+decode/{n}" for n in
        ("flat-count", "group-eq-lut", "percentile-hist", "or-expr", "topn-dashboard")
    }
    for name in sorted(common):
        t, r = traces[name], ref_traces[name]
        ref_cols = jdispatch.measured_columns(r)
        assert t.gets == ref_cols["gets"], name
        assert t.dispatches == ref_cols["dispatches"], name
        if t.kind == "measure":
            builtin = t.builtin or traces["fused/flat-count"].builtin
            extra = 2 + _code_preds(builtin)
        else:
            extra = 0
        assert t.puts == ref_cols["puts"] + extra, name
    for name in ("ql/trace", "ql/property"):
        t, r = traces[name], ref_traces[name]
        assert (t.gets, t.puts, t.hand_launches) == (0, 0, 0)
        assert (r.dispatches, r.gets, r.puts) == (0, 0, 0)


def test_dispatch_counting_restores_patches():
    from banyandb_tpu_torch.ops import hopper_kernels
    from banyandb_tpu_torch.query import (
        fused_exec,
        measure_exec,
        precompile,
        stream_exec,
    )

    def snapshot():
        return (
            measure_exec.ship,
            measure_exec.device_get,
            measure_exec._build_kernel,
            fused_exec._build_kernel,
            stream_exec._build_kernel,
            precompile.default_registry,
            *(getattr(hopper_kernels, k) for k in kdispatch.HAND_KERNELS),
        )

    before = snapshot()
    with kdispatch.counting():
        during = snapshot()
        assert all(a is not b for a, b in zip(before, during))
    assert snapshot() == before


def test_dispatch_planted_extra_launch_fails_budget(traces):
    t = traces["measure/flat-count"]
    planted = dataclasses.replace(t, hand_launches=t.hand_launches + 1)
    fs = kernel_budgets.audit_budgets(
        traces={"measure/flat-count": planted},
        budgets={
            "measure/flat-count": kernel_budgets.BUDGETS["measure/flat-count"]
        },
    )
    assert any(
        f.rule == "kernel-budget"
        and "hand_launches regression" in f.message
        and "measured 2" in f.message
        for f in fs
    ), [f.message for f in fs]


def test_dispatch_signature_drift_flagged(traces):
    t = traces["measure/flat-count"]
    drifted = dataclasses.replace(
        t, builtin=dataclasses.replace(t.builtin, num_groups=2)
    )
    fs = kdispatch.dispatch_findings({"measure/flat-count": drifted})
    assert len(fs) == 1 and "plan signature drift" in fs[0].message
    assert "num_groups" in fs[0].message


def test_dispatch_widens_through_the_kernel_on_the_staged_decode_path(traces):
    """The staged compressed ship form calls widen_narrow once per 1-D
    narrow column; the fused batches and the stream mask never do."""
    for name, t in traces.items():
        kernels = dict(t.by_kernel)
        if name.startswith("measure+decode/"):
            assert kernels.get("widen_narrow", 0) >= 1, name
        else:
            assert "widen_narrow" not in kernels, name


# -- kernel-budget / shared ratchet mechanics ------------------------------------


def test_ratchet_value_semantics():
    kw = dict(rule="kernel-budget", path="a.py", line=3, budget_path="b.py")
    assert ratchet_value("sig", "puts", 1, 1, **kw) == []
    up = ratchet_value("sig", "puts", 3, 1, **kw)
    assert len(up) == 1 and "regression" in up[0].message
    assert up[0].path == "a.py" and up[0].line == 3
    down = ratchet_value("sig", "puts", 1, 3, **kw)
    assert len(down) == 1 and "stale budget entry" in down[0].message
    assert "tighten" in down[0].message and down[0].path == "b.py"


def test_apply_ratchet_semantics():
    from banyandb_tpu_torch.lint.core import Finding

    def v(key):
        return (key, Finding(path="x.py", line=1, col=0, rule="r", message=key))

    fs = apply_ratchet([v("a"), v("b")], frozenset({"a", "c"}),
                       rule="r", baseline_path="base.py")
    msgs = [f.message for f in fs]
    assert "b" in msgs
    assert any("stale baseline entry `c`" in m for m in msgs)
    assert not any(m == "a" for m in msgs)


def test_budget_loosened_entry_fails_stale(traces):
    loose = {
        "measure/flat-count": dataclasses.replace(
            kernel_budgets.BUDGETS["measure/flat-count"], puts=99
        )
    }
    fs = kernel_budgets.audit_budgets(
        traces={"measure/flat-count": traces["measure/flat-count"]},
        budgets=loose,
    )
    assert any(
        "stale budget entry" in f.message and "tighten" in f.message
        for f in fs
    ), [f.message for f in fs]


def test_budget_missing_row_and_unmeasured_row_fail(traces):
    fs = kernel_budgets.audit_budgets(
        traces={"measure/flat-count": traces["measure/flat-count"]},
        budgets={"ghost/row": kernel_budgets.KernelBudget(puts=1)},
    )
    msgs = [f.message for f in fs]
    assert any("no budget row" in m for m in msgs), msgs
    assert any("stale baseline entry `ghost/row`" in m for m in msgs), msgs


def test_failed_measurement_does_not_cascade_into_budget_findings():
    fs = kernel_budgets.audit_budgets(
        traces={},
        budgets={"measure/flat-count": kernel_budgets.BUDGETS["measure/flat-count"]},
        failed={"measure/flat-count"},
    )
    assert fs == [], [f.message for f in fs]


def test_budget_table_rows_pinned():
    """One row per audited signature: the reference's 25 names plus the
    staged compressed-form rows the port adds."""
    from banyandb_tpu.lint.kernel import kernel_budgets as jbudgets

    extra = {
        f"measure+decode/{n}" for n in
        ("flat-count", "group-eq-lut", "percentile-hist", "or-expr", "topn-dashboard")
    }
    assert set(kernel_budgets.BUDGETS) == set(jbudgets.BUDGETS) | extra
    assert len(kernel_budgets.BUDGETS) == 30


def test_budget_table_agrees_with_plan_audit_matrix():
    audited = {e.name for e in plan_audit.default_entries()}
    assert audited <= set(kernel_budgets.BUDGETS)


def test_kernel_rules_catalogued():
    from banyandb_tpu_torch.lint.core import _rule_catalog
    from banyandb_tpu_torch.lint.whole_program import WP_RULES

    names = {n for n, _ in WP_RULES}
    assert {n for n, _ in KERNEL_RULES} <= names
    assert "plan-audit" in names
    assert {n for n, _ in _rule_catalog()} == names | {"parse-error"}


def test_publish_budgets_to_meter():
    from banyandb_tpu_torch.obs.metrics import Meter

    meter = Meter()
    n = kernel_budgets.publish_to_meter(meter)
    assert n == sum(1 for r in kernel_budgets.BUDGETS.values() if r.ops is not None)
    text = meter.prometheus_text()
    row = kernel_budgets.BUDGETS["measure/flat-count"]
    assert f'kernel_launch_budget{{signature="measure/flat-count"}} {row.ops}' in text
    assert kernel_budgets.dispatch_budget("measure") == max(
        r.ops for k, r in kernel_budgets.BUDGETS.items()
        if k.startswith("measure/")
    )
    with pytest.raises(KeyError):
        kernel_budgets.dispatch_budget("ql")


# -- the audited tree ------------------------------------------------------------


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_kernel_audit_clean_tree(fast):
    fs = run_kernel_audit(fast=fast)
    assert fs == [], "\n".join(f.render() for f in fs)


def test_kernel_stats():
    from banyandb_tpu_torch.lint.kernel import kernel_stats

    assert kernel_stats(fast=True) == {
        "kernel_signatures": 30, "kernel_lowering": False
    }
    assert np.all([r.widest in (None, 4) for r in kernel_budgets.BUDGETS.values()])
