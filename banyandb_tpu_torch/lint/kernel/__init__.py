"""bdjit for the port: the kernel audit family (the counterpart of
banyandb_tpu/lint/kernel).

The executors are ratcheted against *countable* properties of the work
one part-batch costs: how many ops and hand-kernel launches it takes,
what crosses the PCIe bus, and which dtypes ride the device.  Four
analyzers state those properties with no card:

- ``kernel-ops``       walk the ATen ops every audited per-chunk function
                       dispatches on fake CUDA tensors (op_audit.py):
                       host syncs, 64-bit values, f32 -> f16/bf16
                       narrowing, int64 index operands, widest itemsize
- ``kernel-dispatch``  drive the real executor entry paths
                       (measure_exec.compute_partials staged and fused,
                       stream_exec.device_tag_mask, ql_exec trace/
                       property) and count host->device ships,
                       device->host gets and hand-kernel wrapper calls
                       per builtin plan signature — also proving the
                       executor resolves EXACTLY the signature the
                       precompile registry warms (dispatch.py)
- ``kernel-lowering``  op count (the launch estimate), bytes class and
                       cross-slot combines per signature, including the
                       mesh steps of parallel/dist_exec and fused_exec
                       (lowering.py)
- ``kernel-budget``    the checked-in per-signature budget table
                       (kernel_budgets.BUDGETS) with the reference's
                       ratchet: regressions fail, improvements fail the
                       now-stale entry until it is tightened

On the card, chip_smoke.py runs the same dispatch scenarios on CUDA
tensors under ``torch.profiler`` and holds the ships, gets and launches
it counts to the same table.
"""

from __future__ import annotations

# (name, summary) catalog for the SARIF driver rules
KERNEL_RULES = (
    ("kernel-ops", "host sync / 64-bit value / narrowing inside a device plan"),
    ("kernel-dispatch", "ship/get/hand-kernel counts per plan signature"),
    ("kernel-lowering", "op count / bytes / cross-slot combines per signature"),
    ("kernel-budget", "ratcheted per-signature launch/transfer/dtype budgets"),
)


def kernel_entries():
    """The audited kernel matrix: the plan_audit entries (ONE list feeds
    the shape contracts, precompile warming and this audit) plus the
    two mesh steps."""
    from banyandb_tpu_torch.lint.kernel.lowering import fused_mesh_entry, mesh_entry
    from banyandb_tpu_torch.lint.whole_program.plan_audit import default_entries

    return list(default_entries()) + [mesh_entry(), fused_mesh_entry()]


def stored_entries(registry=None, limit: int = 16):
    """Audit entries for the top stored/recorded plan signatures — the
    live population the precompile registry warms beyond the builtin
    matrix.  Empty in a fresh process (no store bound); in an embedded
    run the hottest production signatures get the same op audit the
    builtins do.  They carry no checked-in budget rows."""
    import inspect

    from banyandb_tpu_torch.lint.whole_program.plan_audit import (
        KernelAudit,
        _rel_path,
    )
    from banyandb_tpu_torch.query import (
        fused_exec,
        measure_exec,
        precompile,
        stream_exec,
    )

    if registry is None:
        registry = precompile.default_registry()
    entries = []
    for i, (kind, spec) in enumerate(registry.signatures()[:limit]):
        try:
            if kind == "measure":
                mod, anchor = measure_exec, measure_exec._build_kernel
                args = (
                    precompile.chunk_struct(spec),
                    precompile.pred_struct(spec),
                    *precompile.scalar_struct(),
                )
            elif kind == "fused":
                mod, anchor = fused_exec, fused_exec._build_kernel
                args = (
                    precompile.fused_chunk_struct(spec),
                    precompile.pred_struct(spec.plan),
                    *precompile.scalar_struct(),
                )
            elif kind == "stream_mask":
                mod, anchor = stream_exec, stream_exec._build_kernel
                args = precompile.mask_structs(spec)
            else:
                continue
            fn = mod.kernel_for(spec)
        except Exception:  # noqa: BLE001 — a stale stored signature is
            continue  # skipped here exactly like warming skips it
        entries.append(
            KernelAudit(
                name=f"stored/{kind}#{i}",
                path=_rel_path(inspect.getsourcefile(mod)),
                line=inspect.getsourcelines(anchor)[1],
                fn=fn,
                args=args,
                cache_key=spec,
            )
        )
    return entries


def run_kernel_audit(fast: bool = False) -> list:
    """Run the kernel analyzers -> findings (empty = budgets hold).

    ``fast=True`` skips the lowering facts (op count, bytes class,
    collectives); the op walk, the dispatch scenarios and their budget
    columns still run."""
    from banyandb_tpu_torch.lint.kernel import dispatch, kernel_budgets, op_audit

    entries = kernel_entries()
    findings = []
    anchors = {e.name: (e.path, e.line) for e in entries}
    # signatures whose measurement itself failed: they already carry a
    # failure finding and must NOT be judged against the budget table
    failed: set[str] = set()
    measured: dict[str, dict] = {}
    for entry in entries:
        fs, cols = op_audit.audit_entry(entry)
        findings += fs
        if cols is None:
            failed.add(entry.name)
        else:
            measured[entry.name] = cols
    for entry in stored_entries():
        # dynamic (recorded) signatures: op invariants only — no
        # checked-in budget row to ratchet against
        fs, _cols = op_audit.audit_entry(entry)
        findings += fs
    traces = dispatch.audit_dispatch()
    findings += dispatch.dispatch_findings(traces)
    failed |= {t.name for t in traces.values() if t.error}
    anchors.update(
        {t.name: (t.path, t.line) for t in traces.values() if t.path}
    )
    lowered = None
    if not fast:
        from banyandb_tpu_torch.lint.kernel import lowering

        lowered = {}
        for entry in entries:
            fs, meas = lowering.audit_entry(entry)
            findings += fs
            lowered[entry.name] = meas
            if meas is None:
                failed.add(entry.name)
    findings += kernel_budgets.audit_budgets(
        op_cols=measured,
        traces=traces,
        lowered=lowered,
        anchors=anchors,
        failed=failed,
    )
    return findings


def kernel_stats(fast: bool = False) -> dict:
    """Summary keys for a run's stats."""
    from banyandb_tpu_torch.lint.kernel.kernel_budgets import BUDGETS

    return {
        "kernel_signatures": len(BUDGETS),
        "kernel_lowering": not fast,
    }
