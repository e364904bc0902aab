"""wire-kind: the wire-kind taxonomy audit.

The fabric's four kinds (``deadline``/``error``/``shed``/``stale_epoch``,
cluster/rpc.py TransportError) are load-bearing: the liaison's retry,
spool and eviction decisions all switch on them.  This analyzer pins
the taxonomy three ways:

1. **Vocabulary** — every kind literal the package raises, classifies
   or compares (``TransportError(..., kind=...)``, classifier returns,
   ``e.kind == ...`` switches) must be a DECLARED_KINDS member.  A typo
   (``"staleepoch"``) or an undeclared new kind fails immediately.
2. **Per-transport consistency** — each transport module's kind set
   must equal its TRANSPORT_KINDS entry, both directions: a transport
   that stops carrying a declared kind (or grows an undeclared one)
   fails, so the retryable set stays expressible on every wire.
3. **Classifier exhaustiveness** — each CLASSIFIER_SWITCHES qual must
   mention every kind its entry declares.  Adding a kind to
   DECLARED_KINDS without teaching ``_error_kind`` and the liaison
   delivery/scatter switches fails the gate — the "new kind added
   without full classification" ISSUE case.

Kind-literal collection is deliberately narrow to dodge the package's
many non-wire ``kind`` attributes (plan-node kinds, fault kinds, CLI
kinds): switch sites key off the ``getattr(e, "kind", ...)`` idiom —
the one every wire consumer uses, because the duck-typed TransportError
surface guarantees nothing — never bare ``X.kind`` attribute access;
raise sites are the error classes' own constructor arguments.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from banyandb_tpu_torch.lint.core import Finding
from banyandb_tpu_torch.lint.whole_program.callgraph import Program, _walk_own

from banyandb_tpu_torch.lint.wire import wire_config as _cfg

RULE = "wire-kind"


@dataclass(frozen=True)
class KindSite:
    kind: str
    qual: str
    module: str
    path: str
    line: int
    col: int
    role: str  # "raise" | "classify" | "switch"


def _is_kind_source(expr: ast.AST) -> bool:
    """True for expressions that denote a wire kind:
    ``getattr(X, "kind", ...)`` — bare ``X.kind`` is NOT accepted (the
    package is full of non-wire ``kind`` attributes; the wire idiom is
    always the getattr-with-default form)."""
    return (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Name)
        and expr.func.id == "getattr"
        and len(expr.args) >= 2
        and isinstance(expr.args[1], ast.Constant)
        and expr.args[1].value == "kind"
    )


def _last_name(expr: ast.AST) -> str:
    while isinstance(expr, ast.Attribute):
        return expr.attr
    return expr.id if isinstance(expr, ast.Name) else ""


def collect_kind_sites(
    program: Program,
    *,
    error_classes: tuple[str, ...],
    classifier_names: tuple[str, ...] = ("_error_kind",),
) -> list[KindSite]:
    sites: list[KindSite] = []
    for info in program.functions.values():
        fn_short = info.qual.split(":", 1)[1].split(".")[-1]
        is_classifier = fn_short in classifier_names
        # wire-kind locals in this function: names assigned from .kind
        kind_vars: set[str] = set()
        for node in _walk_own(info.node):
            if isinstance(node, ast.Assign) and _is_kind_source(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        kind_vars.add(t.id)

        def emit(node: ast.AST, kind: str, role: str) -> None:
            sites.append(
                KindSite(
                    kind=kind,
                    qual=info.qual,
                    module=info.module,
                    path=info.path,
                    line=node.lineno,
                    col=node.col_offset,
                    role=role,
                )
            )

        for node in _walk_own(info.node):
            # TransportError(msg, "kind") / TransportError(msg, kind="kind")
            # / TransportError(msg, kind=X.get("kind", "default"))
            if isinstance(node, ast.Call) and _last_name(node.func) in (
                error_classes
            ):
                if len(node.args) >= 2 and isinstance(
                    node.args[1], ast.Constant
                ):
                    emit(node, node.args[1].value, "raise")
                for kw in node.keywords:
                    if kw.arg != "kind":
                        continue
                    if isinstance(kw.value, ast.Constant):
                        emit(node, kw.value.value, "raise")
                    elif (
                        isinstance(kw.value, ast.Call)
                        and isinstance(kw.value.func, ast.Attribute)
                        and kw.value.func.attr == "get"
                        and len(kw.value.args) >= 2
                        and isinstance(kw.value.args[1], ast.Constant)
                    ):
                        emit(node, kw.value.args[1].value, "raise")
            # classifier returns
            elif (
                is_classifier
                and isinstance(node, ast.Return)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                emit(node, node.value.value, "classify")
            # getattr(e, "kind", "default")'s default is itself a kind
            elif (
                isinstance(node, ast.Call)
                and _is_kind_source(node)
                and len(node.args) >= 3
                and isinstance(node.args[2], ast.Constant)
            ):
                emit(node, node.args[2].value, "switch")
            # switches: <kindvar|.kind> == "x" / in ("x", "y")
            elif isinstance(node, ast.Compare):
                left = node.left
                lefty = _is_kind_source(left) or (
                    isinstance(left, ast.Name) and left.id in kind_vars
                )
                if not lefty:
                    continue
                for comp in node.comparators:
                    if isinstance(comp, ast.Constant) and isinstance(
                        comp.value, str
                    ):
                        emit(comp, comp.value, "switch")
                    elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                        for el in comp.elts:
                            if isinstance(el, ast.Constant) and isinstance(
                                el.value, str
                            ):
                                emit(el, el.value, "switch")
    return sites


def analyze_kinds(
    program: Program,
    *,
    declared: Optional[tuple[str, ...]] = None,
    retryable: Optional[frozenset] = None,
    error_classes: Optional[tuple[str, ...]] = None,
    transport_kinds: Optional[dict[str, frozenset]] = None,
    classifier_switches: Optional[dict[str, frozenset]] = None,
    baseline_path: str = "<wire-config>",
) -> list[Finding]:
    declared = _cfg.DECLARED_KINDS if declared is None else declared
    retryable = _cfg.RETRYABLE_KINDS if retryable is None else retryable
    error_classes = (
        _cfg.ERROR_CLASSES if error_classes is None else error_classes
    )
    transport_kinds = (
        _cfg.TRANSPORT_KINDS if transport_kinds is None else transport_kinds
    )
    classifier_switches = (
        _cfg.CLASSIFIER_SWITCHES
        if classifier_switches is None
        else classifier_switches
    )
    sites = collect_kind_sites(program, error_classes=error_classes)
    findings: list[Finding] = []
    declared_set = set(declared)

    # 1. vocabulary
    for s in sites:
        if s.kind not in declared_set:
            findings.append(
                Finding(
                    path=s.path,
                    line=s.line,
                    col=s.col,
                    rule=RULE,
                    message=(
                        f"wire kind {s.kind!r} ({s.role} site in "
                        f"{s.qual.split(':', 1)[1]}) is not in "
                        f"DECLARED_KINDS {sorted(declared_set)}; declare it "
                        f"(and teach every CLASSIFIER_SWITCHES site) or fix "
                        f"the literal"
                    ),
                )
            )

    # the retryable set must be declared
    for k in sorted(set(retryable) - declared_set):
        findings.append(
            Finding(
                path=baseline_path,
                line=1,
                col=0,
                rule=RULE,
                message=(
                    f"RETRYABLE_KINDS contains undeclared kind {k!r}"
                ),
            )
        )

    # 2. per-transport consistency (only transports in this package)
    by_module: dict[str, set[str]] = {}
    mod_anchor: dict[str, tuple[str, int]] = {}
    for s in sites:
        by_module.setdefault(s.module, set()).add(s.kind)
        mod_anchor.setdefault(s.module, (s.path, s.line))
    for mod, expect in sorted(transport_kinds.items()):
        if not any(info.module == mod for info in program.functions.values()):
            continue
        live = by_module.get(mod, set())
        anchor = mod_anchor.get(mod, (baseline_path, 1))
        for k in sorted(expect - live):
            findings.append(
                Finding(
                    path=anchor[0],
                    line=anchor[1],
                    col=0,
                    rule=RULE,
                    message=(
                        f"transport module {mod} no longer carries declared "
                        f"kind {k!r} (TRANSPORT_KINDS) — the retryable "
                        f"contract is not expressible on this wire"
                    ),
                )
            )
        for k in sorted(live - expect):
            findings.append(
                Finding(
                    path=anchor[0],
                    line=anchor[1],
                    col=0,
                    rule=RULE,
                    message=(
                        f"transport module {mod} carries kind {k!r} missing "
                        f"from its TRANSPORT_KINDS entry — update the "
                        f"checked-in table"
                    ),
                )
            )

    # 3. classifier exhaustiveness
    by_qual: dict[str, set[str]] = {}
    qual_anchor: dict[str, tuple[str, int]] = {}
    for s in sites:
        by_qual.setdefault(s.qual, set()).add(s.kind)
        qual_anchor.setdefault(s.qual, (s.path, s.line))
    for qual, expect in sorted(classifier_switches.items()):
        info = program.functions.get(qual)
        if info is None:
            continue
        live = by_qual.get(qual, set())
        for k in sorted(expect - live):
            findings.append(
                Finding(
                    path=info.path,
                    line=info.node.lineno,
                    col=0,
                    rule=RULE,
                    message=(
                        f"classifier switch {qual.split(':', 1)[1]} does not "
                        f"handle declared kind {k!r} — a "
                        f"{'retryable ' if k in retryable else ''}rejection "
                        f"of that kind falls into its default branch"
                    ),
                )
            )
    return findings
