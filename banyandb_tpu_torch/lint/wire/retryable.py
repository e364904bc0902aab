"""wire-retry: retryable rejections must reach a retry/spool/shed path.

The TransportError contract (cluster/rpc.py) says shed / deadline /
stale-epoch rejecting nodes are healthy: the sender must retry, spool,
degrade or re-route — never swallow the error or treat the node as
dead.  This analyzer walks every ``except TransportError`` handler in
the package and requires its body to reach a recovery verb:

- a call whose dotted name contains one of RETRY_SUBSTRINGS (``spool``,
  ``retry``, ``mark``, ``reload``, ``failover``, ...), possibly one hop
  down through a helper defined in the program, or
- a ``continue`` (per-node loops that record the failure and move on),

or the handler qual must carry a RETRY_EXEMPT reason (terminal
surfaces: a CLI that prints the error, a diagnostics collector that
reports "unreachable").  A bare ``raise``/``pass`` handler on a fabric
path is a finding — that is a retryable rejection dying on the floor.
"""

from __future__ import annotations

import ast
from typing import Optional

from banyandb_tpu_torch.lint.core import Finding, dotted_name
from banyandb_tpu_torch.lint.whole_program.callgraph import Program, _walk_own

from banyandb_tpu_torch.lint.wire import wire_config as _cfg

RULE = "wire-retry"


def _handler_matches(htype: ast.AST, error_classes: tuple[str, ...]) -> bool:
    """True when an except clause catches one of the error classes,
    including tuple clauses and dotted references."""
    if htype is None:
        return False
    if isinstance(htype, ast.Tuple):
        return any(_handler_matches(e, error_classes) for e in htype.elts)
    name = dotted_name(htype) or ""
    short = name.split(".")[-1]
    return short in error_classes


def _body_recovers(
    program: Program,
    info,
    body: list[ast.stmt],
    substrings: tuple[str, ...],
    depth: int = 1,
) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Continue):
                return True
            if not isinstance(node, ast.Call):
                continue
            name = (dotted_name(node.func) or "").lower()
            if any(s in name for s in substrings):
                return True
            if depth > 0:
                # one hop through helpers defined in the program
                for site in info.calls:
                    if site.node is node and site.callee:
                        callee = program.functions.get(site.callee)
                        if callee is not None and _body_recovers(
                            program,
                            callee,
                            callee.node.body,
                            substrings,
                            depth - 1,
                        ):
                            return True
    return False


def analyze_retryable(
    program: Program,
    *,
    error_classes: Optional[tuple[str, ...]] = None,
    substrings: Optional[tuple[str, ...]] = None,
    exempt: Optional[dict[str, str]] = None,
    baseline_path: str = "<wire-config>",
) -> list[Finding]:
    error_classes = (
        _cfg.ERROR_CLASSES if error_classes is None else error_classes
    )
    substrings = _cfg.RETRY_SUBSTRINGS if substrings is None else substrings
    exempt = _cfg.RETRY_EXEMPT if exempt is None else exempt
    findings: list[Finding] = []
    seen_quals: set[str] = set()
    for qual, info in sorted(program.functions.items()):
        for node in _walk_own(info.node):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if not _handler_matches(handler.type, error_classes):
                    continue
                seen_quals.add(qual)
                if qual in exempt:
                    continue
                if _body_recovers(
                    program, info, handler.body, substrings
                ):
                    continue
                findings.append(
                    Finding(
                        path=info.path,
                        line=handler.lineno,
                        col=handler.col_offset,
                        rule=RULE,
                        message=(
                            f"{qual.split(':', 1)[1]} catches "
                            f"{error_classes[0]} but reaches no "
                            f"retry/spool/shed path "
                            f"(RETRY_SUBSTRINGS) — a retryable rejection "
                            f"dies here; recover, re-route, or add a "
                            f"reasoned RETRY_EXEMPT entry"
                        ),
                    )
                )
    for qual in sorted(set(exempt) - seen_quals):
        mod = qual.split(":", 1)[0]
        if not any(i.module == mod for i in program.functions.values()):
            continue  # module absent from this package (seeded pkgs)
        findings.append(
            Finding(
                path=baseline_path,
                line=1,
                col=0,
                rule=RULE,
                message=(
                    f"stale RETRY_EXEMPT entry {qual!r}: the function no "
                    f"longer catches {error_classes[0]} — delete the entry"
                ),
            )
        )
    return findings
