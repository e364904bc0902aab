"""CLI: ``python -m banyandb_tpu_torch.lint [--check] [--format json] PATH...``

Exit codes: without ``--check`` the run is report-only (exit 0 even
with findings — the editor/exploration mode); ``--check`` is the CI
gate (exit 1 on any finding); 2 on usage error.

``--check`` also runs the whole-program analyses (layering, call-graph
sync/lock propagation, lock-order cycles, shared state, the wire
contract, the fake-tensor plan audit, the kernel audit) when a target
path is — or contains — the real ``banyandb_tpu_torch`` package;
``--whole-program`` runs them report-only without the gate.
``--only=FAMILY,...`` restricts the run to named analyzer families
(``rules`` = the per-file rules, plus ``kernel``, ``layering``,
``shared-state``, ``lock-order``, ``plan-audit``, ``sync``, ``wire``)
so local iteration does not pay the full whole-program pass; ``--fast``
skips the kernel lowering facts.  The gate imports torch and numpy,
never JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

from banyandb_tpu_torch.lint.core import (
    all_rules,
    lint_paths,
    render_json,
    render_text,
)


def _find_pkg_root(paths: list[str]) -> Optional[Path]:
    """The banyandb_tpu_torch package dir among the CLI targets, if any.
    Whole-program analyses need the whole package, so a single-file or
    out-of-package target runs the per-file rules only."""
    for p in paths:
        pth = Path(p)
        if pth.name == "banyandb_tpu_torch" and (pth / "__init__.py").is_file():
            return pth
        cand = pth / "banyandb_tpu_torch"
        if pth.is_dir() and (cand / "__init__.py").is_file():
            return cand
    return None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="bdlint",
        description="banyandb-tpu project-native static analysis",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=["banyandb_tpu_torch"],
        help="files or directories (default: banyandb_tpu_torch)",
    )
    ap.add_argument(
        "--check",
        action="store_true",
        help="CI mode: exit 1 on any finding; includes the whole-program "
        "analyses (default: report-only)",
    )
    ap.add_argument(
        "--whole-program",
        action="store_true",
        help="run the whole-program analyses (layering, call-graph facts, "
        "lock-order, plan audit, kernel audit) report-only",
    )
    ap.add_argument(
        "--only",
        default="",
        help="comma-separated analyzer families to run: rules, kernel, "
        "layering, shared-state, lock-order, plan-audit, sync, wire "
        "(default: all; implies running the named whole-program "
        "analyses)",
    )
    ap.add_argument(
        "--fast",
        action="store_true",
        help="skip the kernel lowering facts (op count, bytes class, "
        "collectives; the op walk and dispatch budgets still run)",
    )
    ap.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format (json is SARIF 2.1.0, deterministic)",
    )
    ap.add_argument(
        "--rules",
        default="",
        help="comma-separated rule names to run (default: all)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    args = ap.parse_args(argv)

    from banyandb_tpu_torch.lint.whole_program import (
        FAMILIES,
        WP_RULES,
        family_of_rule,
    )

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            scope = ",".join(r.scope) or "(package)"
            print(f"{r.name:18s} [{scope}] {r.summary}")
        for name, summary in WP_RULES:
            print(f"{name:18s} [whole-program] {summary}")
        return 0

    only: Optional[set] = None
    if args.only:
        only = {n.strip() for n in args.only.split(",") if n.strip()}
        known_families = set(FAMILIES) | {"rules"}
        unknown = only - known_families
        if unknown:
            print(
                f"bdlint: unknown --only famil{'y' if len(unknown) == 1 else 'ies'}:"
                f" {sorted(unknown)} (choose from {sorted(known_families)})",
                file=sys.stderr,
            )
            return 2

    wanted = None
    if args.rules:
        wanted = {n.strip() for n in args.rules.split(",") if n.strip()}
        known = {r.name for r in rules} | {n for n, _ in WP_RULES}
        unknown = wanted - known
        if unknown:
            print(f"bdlint: unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in wanted]

    run_file_rules = only is None or "rules" in only
    if run_file_rules:
        findings, summary = lint_paths(args.paths, rules=rules)
    else:
        findings, summary = [], {"files": 0, "findings": 0, "suppressed": 0}

    wp_root = _find_pkg_root(args.paths)
    wp_names = {n for n, _ in WP_RULES}
    # naming a whole-program rule via --rules (or a family via --only)
    # implies running those analyses even without --check/--whole-program
    # — an analysis the user asked for by name must never silently not run
    wp_only: Optional[set] = None
    if only is not None:
        wp_only = only & set(FAMILIES)
    if wanted is not None:
        from_rules = {
            fam
            for fam in (family_of_rule(n) for n in wanted)
            if fam is not None
        }
        wp_only = from_rules if wp_only is None else (wp_only & from_rules)
    run_wp = (
        args.check
        or args.whole_program
        or (wanted is not None and bool(wanted & wp_names))
        or (only is not None and bool(only & set(FAMILIES)))
    ) and wp_root is not None
    if wp_only is not None and not wp_only:
        run_wp = False
    # a selection that excludes EVERY analyzer is a usage error, not a
    # green gate: --check must never exit 0 having checked nothing
    # (e.g. --only=kernel --rules=host-sync, or --only=rules
    # --rules=layering)
    file_rules_vacuous = not run_file_rules or (
        wanted is not None and not rules
    )
    if (args.rules or args.only) and file_rules_vacuous and not run_wp:
        print(
            "bdlint: the --only/--rules selection excludes every analyzer "
            "(nothing would run); drop one flag or align them",
            file=sys.stderr,
        )
        return 2
    if run_wp:
        from banyandb_tpu_torch.lint.whole_program import run_whole_program

        wp_findings, wp_stats = run_whole_program(
            wp_root,
            only=wp_only,
            fast=args.fast,
        )
        if wanted is not None:
            wp_findings = [f for f in wp_findings if f.rule in wanted]
            wp_stats["wp_findings"] = len(wp_findings)
        findings = sorted(findings + wp_findings)
        summary["findings"] += len(wp_findings)
        summary["suppressed"] += wp_stats["wp_suppressed"]
        summary.update(wp_stats)

    if args.format == "json":
        print(render_json(findings, summary))
    else:
        print(render_text(findings, summary))
    return 1 if (findings and args.check) else 0


if __name__ == "__main__":
    sys.exit(main())
