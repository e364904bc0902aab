"""Whole-program analyses: the cross-module invariants bdlint's per-file
rules cannot see (the port's copy of banyandb_tpu/lint/whole_program).

Surfaced through ``python -m banyandb_tpu_torch.lint`` (``--check`` runs
them; ``--whole-program`` runs them report-only):

- ``layering``          import-graph enforcement of the L0-L6 layer map
                        (layer_config.py is the checked-in policy;
                        pre-existing violations ride a ratcheted
                        baseline that only shrinks)
- ``wp-sync-in-kernel`` interprocedural "performs host sync / blocks"
                        facts: a function transitively reaching
                        ``measure_exec.device_get``, a stream
                        ``synchronize`` or a blocking call from inside a
                        device region (``kernel``/``step``/``jitted``,
                        the body a builder returns) is flagged across
                        files.  The reference's ``wp-sync-in-jit``,
                        renamed: eager PyTorch has no jit region
- ``wp-lock-blocking``  the cross-file extension of lock-across-rpc: a
                        call made while holding a lock whose CALLEE
                        (transitively) blocks
- ``lock-order``        potential deadlock cycles in the
                        acquires-while-holding lock graph
- ``wp-shared-state``   cross-thread race analysis: attributes written
                        from >= 2 discovered thread roots with no common
                        lock guard (shared_state.py; the static half of
                        bdsan — ``sanitize/`` is the runtime half)
- ``plan-audit``        fake-tensor shape/dtype trace of every builtin
                        measure/stream/fused plan signature, cache-key
                        and row-bucket audits, zero device execution
- ``wire-*``            the bdwire wire-contract family (lint/wire):
                        role/topic exhaustiveness, wire-kind taxonomy,
                        envelope producer/consumer matching, fault-site
                        coverage, retryable handling, BYDB_* flag
                        registry and the obs contract (wire_config.py is
                        the checked-in policy)
- ``kernel-*``          the kernel audit family (lint/kernel): the
                        ATen-op walk (``kernel-ops``, the reference's
                        ``kernel-jaxpr``), dispatch/transfer/hand-kernel
                        counts, lowering facts, and the ratcheted
                        per-signature budget table (kernel_budgets.py)

Findings reuse bdlint's Finding/suppression machinery: a whole-program
finding anchors at a real source line and honors the same
``# bdlint: disable=<rule> -- reason`` comments.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from banyandb_tpu_torch.lint.core import Finding, parse_suppressions

# (name, summary) catalog for --list-rules; checks live in the sibling
# modules, not in per-file rule objects.  The kernel-audit family
# (lint/kernel) rides the same surface.
from banyandb_tpu_torch.lint.kernel import KERNEL_RULES
from banyandb_tpu_torch.lint.wire import WIRE_RULES

WP_RULES = (
    ("layering", "import respects the SURVEY L0-L6 layer map"),
    ("wp-sync-in-kernel", "transitive host sync/block inside a device region"),
    ("wp-lock-blocking", "callee transitively blocks while a lock is held"),
    ("lock-order", "potential deadlock cycle in the lock-order graph"),
    ("wp-shared-state", "attribute written from >=2 thread roots unguarded"),
    ("plan-audit", "fake-tensor shape/dtype/cache-key audit of every builtin plan"),
) + WIRE_RULES + KERNEL_RULES


def apply_suppressions(
    findings: list[Finding],
    tally: Optional[dict] = None,
) -> tuple[list[Finding], int]:
    """Filter whole-program findings through per-file bdlint suppressions.

    -> (kept findings, suppressed count).  Files are read lazily and only
    when they actually carry findings.  ``tally`` (optional) counts the
    suppressed findings per rule.
    """
    kept: list[Finding] = []
    suppressed = 0
    cache: dict[str, tuple[dict, frozenset]] = {}
    for f in findings:
        maps = cache.get(f.path)
        if maps is None:
            try:
                lines = Path(f.path).read_text(encoding="utf-8").splitlines()
                maps = parse_suppressions(lines)
            except OSError:
                maps = ({}, frozenset())
            cache[f.path] = maps
        per_line, file_wide = maps
        sup = per_line.get(f.line, frozenset()) | file_wide
        if f.rule in sup or "all" in sup:
            suppressed += 1
            if tally is not None:
                tally[f.rule] = tally.get(f.rule, 0) + 1
        else:
            kept.append(f)
    return kept, suppressed


# --only analyzer families -> the rules each family emits
FAMILIES = {
    "layering": ("layering",),
    "sync": ("wp-sync-in-kernel", "wp-lock-blocking"),
    "lock-order": ("lock-order",),
    "shared-state": ("wp-shared-state",),
    "plan-audit": ("plan-audit",),
    "wire": tuple(name for name, _ in WIRE_RULES),
    "kernel": tuple(name for name, _ in KERNEL_RULES),
}


def family_of_rule(rule: str) -> Optional[str]:
    for fam, rules in FAMILIES.items():
        if rule in rules:
            return fam
    return None


def run_whole_program(
    pkg_root: Path,
    plan_audit: bool = True,
    only: Optional[set] = None,
    fast: bool = False,
) -> tuple[list[Finding], dict]:
    """Run the whole-program analyzers against the banyandb_tpu_torch
    package rooted at ``pkg_root`` -> (findings after suppressions,
    stats).

    ``only`` (family names from FAMILIES) restricts which analyzers run
    — the CLI's ``--only`` so local iteration pays only the pass under
    edit; None = everything.  ``plan_audit=False`` opts out of BOTH
    torch-backed families (plan audit and the kernel audit) — the "AST
    analyses only" switch the meta-tests use.  ``fast`` skips the kernel
    lowering facts (op count, bytes class, collectives).
    """
    from banyandb_tpu_torch.lint.whole_program import layer_config
    from banyandb_tpu_torch.lint.whole_program.layers import parse_package

    def want(fam: str) -> bool:
        return only is None or fam in only

    findings: list[Finding] = []
    stats = {"wp_functions": 0, "wp_roots": 0}
    need_program = any(
        want(f) for f in ("sync", "lock-order", "shared-state", "wire")
    )
    trees = (
        parse_package(pkg_root, layer_config.PACKAGE)
        if need_program or want("layering")
        else None
    )

    if want("layering"):
        from banyandb_tpu_torch.lint.whole_program.layers import analyze_layers

        findings += analyze_layers(
            pkg_root,
            layer_config.PACKAGE,
            layer_config.CONFIG,
            baseline=layer_config.BASELINE,
            trees=trees,
        )
    if need_program:
        from banyandb_tpu_torch.lint.whole_program.callgraph import (
            Program,
            analyze_lock_blocking,
            analyze_sync_in_kernel,
        )

        program = Program.build(pkg_root, layer_config.PACKAGE, trees=trees)
        stats["wp_functions"] = len(program.functions)
        if want("sync"):
            findings += analyze_sync_in_kernel(program)
            findings += analyze_lock_blocking(program)
        if want("lock-order"):
            from banyandb_tpu_torch.lint.whole_program.lockorder import (
                analyze_lock_order,
            )

            findings += analyze_lock_order(program)
        if want("shared-state"):
            from banyandb_tpu_torch.lint.whole_program.shared_state import (
                BASELINE as SHARED_STATE_BASELINE,
            )
            from banyandb_tpu_torch.lint.whole_program.shared_state import (
                analyze_shared_state,
                discover_roots,
            )

            roots = discover_roots(program)
            stats["wp_roots"] = len(roots)
            findings += analyze_shared_state(
                program,
                baseline=SHARED_STATE_BASELINE,
                baseline_path=str(
                    pkg_root / "lint" / "whole_program" / "shared_state.py"
                ),
                roots=roots,
            )
        if want("wire"):
            from banyandb_tpu_torch.lint.wire import run_wire

            wire_findings, wire_stats = run_wire(program, trees, pkg_root)
            findings += wire_findings
            stats.update(wire_stats)
    if plan_audit and want("plan-audit"):
        from banyandb_tpu_torch.lint.whole_program.plan_audit import run_plan_audit

        findings += run_plan_audit()
    if plan_audit and want("kernel"):
        from banyandb_tpu_torch.lint.kernel import kernel_stats, run_kernel_audit

        findings += run_kernel_audit(fast=fast)
        stats.update(kernel_stats(fast=fast))
    tally: dict[str, int] = {}
    findings, suppressed = apply_suppressions(findings, tally)
    findings.sort()
    stats.update(
        {
            "wp_findings": len(findings),
            "wp_suppressed": suppressed,
            "wp_suppressed_by_rule": dict(sorted(tally.items())),
        }
    )
    return findings, stats
