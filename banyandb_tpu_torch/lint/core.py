"""bdlint engine, the port's copy: findings, suppressions, the ratchet
mechanics and the renderers (banyandb_tpu/lint/core.py).

The port carries the analysis families it has: the whole-program plan
audit (``lint/whole_program/plan_audit.py``) and the kernel audit
(``lint/kernel``).  The per-file rule families of the reference
(``rules_jax``, ``rules_fabric``) are not ported yet, so ``all_rules()``
is empty; a rule, when one lands, is an object with

- ``name``     the greppable id used in ``# bdlint: disable=<name>``
- ``summary``  one line for ``--list-rules``
- ``scope``    tuple of package-relative path prefixes it applies to
               (``""`` = the whole package)
- ``check(ctx) -> Iterable[Finding]``

Scopes are matched against the file's path relative to the
``banyandb_tpu_torch`` package root.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

_SUPPRESS_RE = re.compile(
    r"#\s*bdlint:\s*(disable|disable-file)=([A-Za-z0-9_,\- ]+)"
)
_GENERATED_DIRS = {"pb", "__pycache__"}


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""

    path: str  # as given to the linter (display path)
    line: int  # 1-based
    col: int  # 0-based
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class FileContext:
    """Parsed source + shared per-file analyses handed to every rule."""

    def __init__(self, source: str, path: str, rel: str):
        self.source = source
        self.path = path
        self.rel = rel  # package-relative, "/"-separated (scope matching)
        self.tree = ast.parse(source)
        self.lines = source.splitlines()
        self._parents: Optional[dict] = None

    @property
    def parents(self) -> dict:
        """child ast node -> parent node map (built on first use)."""
        if self._parents is None:
            p: dict = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    p[child] = node
            self._parents = p
        return self._parents

    def finding(self, node: ast.AST, rule: str, message: str) -> Finding:
        return Finding(
            path=self.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            rule=rule,
            message=message,
        )


def dotted_name(node: ast.AST) -> str:
    """``jax.lax.psum`` for nested Attribute/Name chains, else ""."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def parse_suppressions(lines: list[str]) -> tuple[dict[int, frozenset], frozenset]:
    """-> ({1-based line: suppressed rule names}, file-wide suppressions).

    A suppression on a comment-only line applies to the next code line, so
    long reasons don't have to fight the line-length limit.
    """
    per_line: dict[int, set] = {}
    file_wide: set = set()
    pending: set = set()
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        stripped = text.strip()
        names: set = set()
        if m:
            # the "-- reason" text must go before splitting on commas,
            # or a reason like "-- not a leak, host-sync" would widen
            # the suppression to the named rule
            spec = m.group(2).split("--", 1)[0]
            names = {n.strip() for n in spec.split(",") if n.strip()}
            if m.group(1) == "disable-file":
                file_wide |= names
                names = set()
        if stripped.startswith("#") or not stripped:
            # comment-only or blank line: keep deferring to the next
            # code line (a reflow that inserts a blank line must not
            # silently detach an audited suppression)
            pending |= names
            continue
        here = names | pending
        pending = set()
        if here:
            per_line[i] = per_line.get(i, set()) | here
    return (
        {k: frozenset(v) for k, v in per_line.items()},
        frozenset(file_wide),
    )


# -- ratchet-baseline mechanics ----------------------------------------------
# Shared by every baselined analyzer (layering, wp-shared-state, the
# kernel budget table): a baselined violation that still exists is
# tolerated, a new violation fails, and a baselined entry whose
# violation disappeared fails as STALE — so the checked-in list only
# ever shrinks/tightens, never silently rots.


def stale_entry_finding(
    key: str,
    *,
    rule: str,
    path: str,
    what: str = "the violation",
    line: int = 1,
) -> Finding:
    """The stale half of the ratchet, one message shape for every
    baselined analyzer (tests grep for "stale baseline")."""
    return Finding(
        path=path,
        line=line,
        col=0,
        rule=rule,
        message=(
            f"stale baseline entry `{key}`: {what} no longer exists — "
            "delete it so the ratchet only tightens"
        ),
    )


def apply_ratchet(
    violations: list[tuple[str, Finding]],
    baseline: frozenset,
    *,
    rule: str,
    baseline_path: str,
    what: str = "the violation",
) -> list[Finding]:
    """Set-membership ratchet over ``(key, finding)`` live violations:
    baselined keys are tolerated, unknown keys pass through as findings,
    and baseline entries with no live violation fail as stale."""
    findings = [f for key, f in violations if key not in baseline]
    seen = {key for key, _ in violations if key in baseline}
    for key in sorted(baseline - seen):
        findings.append(
            stale_entry_finding(
                key, rule=rule, path=baseline_path, what=what
            )
        )
    return findings


def ratchet_value(
    key: str,
    column: str,
    measured: float,
    budget: float,
    *,
    rule: str,
    path: str,
    line: int = 1,
    budget_path: str = "",
    regression_hint: str = "",
) -> list[Finding]:
    """Numeric-budget ratchet: measured above budget is a regression,
    measured below budget is a stale (too-loose) entry that must be
    tightened, equal is clean.  The kernel budget table's contract."""
    if measured == budget:
        return []
    if measured > budget:
        msg = (
            f"[{key}] {column} regression: measured {measured:g} exceeds "
            f"the budgeted {budget:g}"
        )
        if regression_hint:
            msg += f"; {regression_hint}"
        return [Finding(path=path, line=line, col=0, rule=rule, message=msg)]
    return [
        Finding(
            path=budget_path or path,
            line=1 if budget_path else line,
            col=0,
            rule=rule,
            message=(
                f"[{key}] stale budget entry: {column} measured "
                f"{measured:g} is below the budgeted {budget:g} — tighten "
                "the entry so the ratchet keeps the improvement"
            ),
        )
    ]


_PACKAGE = "banyandb_tpu_torch"


def _package_rel(path: Path) -> Optional[str]:
    """Path inside the banyandb_tpu_torch package -> package-relative
    posix path; None for files outside the package (bdlint is
    project-native and has nothing to say about them)."""
    parts = list(path.parts)
    if _PACKAGE not in parts:
        return None
    idx = len(parts) - 1 - parts[::-1].index(_PACKAGE)
    rel = parts[idx + 1 :]
    if any(d in _GENERATED_DIRS for d in rel[:-1]):
        return None  # generated code (api/pb) is out of audit scope
    return "/".join(rel)


def all_rules() -> list:
    """The per-file rules of the port: none yet (the reference's
    ``rules_jax``/``rules_fabric`` families are still to be ported)."""
    return []


ALL_RULES = all_rules


def lint_source(
    source: str,
    rel: str = "",
    path: str = "<memory>",
    rules: Optional[list] = None,
) -> tuple[list[Finding], int]:
    """Lint one source string as if it lived at package-relative `rel`.

    -> (findings, suppressed_count).  The test suite's entry point.
    """
    ctx = FileContext(source, path=path, rel=rel)
    per_line, file_wide = parse_suppressions(ctx.lines)
    findings: list[Finding] = []
    suppressed = 0
    for rule in rules if rules is not None else all_rules():
        if rule.scope and not any(rel.startswith(s) for s in rule.scope):
            continue
        for f in rule.check(ctx):
            sup = per_line.get(f.line, frozenset()) | file_wide
            if f.rule in sup or "all" in sup:
                suppressed += 1
            else:
                findings.append(f)
    findings.sort()
    return findings, suppressed


def lint_file(
    path: Path, rules: Optional[list] = None
) -> tuple[list[Finding], int, bool]:
    """-> (findings, suppressed, was_linted)."""
    rel = _package_rel(path)
    if rel is None:
        return [], 0, False
    source = path.read_text(encoding="utf-8")
    try:
        findings, suppressed = lint_source(
            source, rel=rel, path=str(path), rules=rules
        )
    except SyntaxError as e:
        return (
            [
                Finding(
                    path=str(path),
                    line=e.lineno or 1,
                    col=e.offset or 0,
                    rule="parse-error",
                    message=f"file does not parse: {e.msg}",
                )
            ],
            0,
            True,
        )
    return findings, suppressed, True


def lint_paths(
    paths: Iterable[str], rules: Optional[list] = None
) -> tuple[list[Finding], dict]:
    """Walk files/dirs -> (sorted findings, summary stats dict)."""
    files: list[Path] = []
    for p in paths:
        pth = Path(p)
        if pth.is_dir():
            files.extend(sorted(pth.rglob("*.py")))
        elif pth.suffix == ".py":
            files.append(pth)
    findings: list[Finding] = []
    suppressed = 0
    linted = 0
    for f in files:
        got, sup, used = lint_file(f, rules=rules)
        findings.extend(got)
        suppressed += sup
        linted += int(used)
    findings.sort()
    return findings, {
        "files": linted,
        "findings": len(findings),
        "suppressed": suppressed,
    }


def render_text(findings: list[Finding], summary: dict) -> str:
    out = [f.render() for f in findings]
    tail = (
        "bdlint: {files} files, {findings} findings, "
        "{suppressed} suppressed".format(**summary)
    )
    if "wp_functions" in summary:
        tail += (
            "; whole-program: {wp_findings} findings, "
            "{wp_suppressed} suppressed over {wp_functions} "
            "functions".format(**summary)
        )
    out.append(tail)
    return "\n".join(out)


_SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def _rule_catalog() -> list[tuple[str, str]]:
    """(id, summary) for every rule bdlint can emit, stable order:
    per-file rules, whole-program analyses, then the parse sentinel."""
    cat = [(r.name, r.summary) for r in all_rules()]
    from banyandb_tpu_torch.lint.whole_program import WP_RULES

    cat += list(WP_RULES)
    cat.append(("parse-error", "file does not parse"))
    return cat


def render_json(findings: list[Finding], summary: dict) -> str:
    """Real SARIF 2.1.0 (editors and code-scanning UIs ingest it):
    tool.driver rule metadata, results[].locations, run-level summary
    under properties.  Deterministic: sorted findings, sorted keys."""
    catalog = _rule_catalog()
    rule_index = {name: i for i, (name, _) in enumerate(catalog)}
    results = []
    for f in findings:
        results.append(
            {
                "ruleId": f.rule,
                "ruleIndex": rule_index.get(f.rule, -1),
                "level": "error",
                "message": {"text": f.message},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.path},
                            "region": {
                                "startLine": f.line,
                                # bdlint columns are 0-based; SARIF's are 1-based
                                "startColumn": f.col + 1,
                            },
                        }
                    }
                ],
            }
        )
    doc = {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        # informationUri omitted: SARIF §3.19.2 requires an
                        # absolute URI and this repo has no canonical URL;
                        # docs/linting.md is the human entry point
                        "name": "bdlint",
                        "rules": [
                            {
                                "id": name,
                                "shortDescription": {"text": text},
                            }
                            for name, text in catalog
                        ],
                    }
                },
                "results": results,
                "properties": summary,
            }
        ],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
