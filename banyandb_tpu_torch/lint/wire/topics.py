"""wire-topic: role/topic exhaustiveness over the bus fabric.

Three passes over the shared parsed package + callgraph:

1. **Topic constant discovery** — every ``Topic`` enum member and every
   module-level ``*TOPIC*`` string constant (including one-hop aliases)
   becomes a dotted-name -> wire-string entry, so call sites and
   registrations resolve without importing the package.
2. **Registration discovery** — per role (wire_config.ROLES), a BFS
   from the registrar function over resolved callees collects every
   ``<bus>.subscribe(topic, handler)`` call: the role's served set,
   with the handler qual when the handler is a resolvable name/method
   (lambdas register the topic but expose no envelope consumer).
3. **Client call-site audit** — every ``X.call(...)`` whose topic
   argument resolves to a known topic constant, in a module with
   declared targets (wire_config.CLIENT_TARGETS): the topic must be
   served by every target role or carry a TOPIC_EXEMPTIONS reason.
   The PR-10 "liaison missing the streamagg surface" bug class is a
   finding here, permanently.

The discovered matrix is additionally diffed against
wire_config.EXPECTED_MATRIX (the golden the smoke prints): a topic
registered but not declared — or declared but no longer registered —
fails, so the checked-in matrix can never drift from the code.
"""

from __future__ import annotations

import ast
from typing import Optional

from banyandb_tpu_torch.lint.core import Finding, dotted_name
from banyandb_tpu_torch.lint.whole_program.callgraph import FuncInfo, Program, _walk_own

from banyandb_tpu_torch.lint.wire import wire_config as _cfg

RULE = "wire-topic"


# -- topic constant discovery -------------------------------------------------


def topic_constants(trees: dict) -> dict[str, str]:
    """dotted constant name -> wire topic string, package-wide.

    Collects ``Topic`` enum members (``mod.Topic.NAME``), module-level
    string constants whose name contains ``TOPIC`` (``mod.NAME``), and
    one-hop aliases of either (``TOPIC_DIAGNOSTICS = DIAG_TOPIC``).
    """
    consts: dict[str, str] = {}
    aliases: dict[str, str] = {}  # dotted -> dotted it refers to
    for mod, (_path, tree) in trees.items():
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == "Topic":
                for stmt in node.body:
                    if (
                        isinstance(stmt, ast.Assign)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)
                    ):
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                consts[f"{mod}.Topic.{t.id}"] = stmt.value.value
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if not (isinstance(t, ast.Name) and "TOPIC" in t.id):
                        continue
                    if isinstance(node.value, ast.Constant) and isinstance(
                        node.value.value, str
                    ):
                        consts[f"{mod}.{t.id}"] = node.value.value
                    else:
                        ref = dotted_name(node.value)
                        if ref:
                            aliases[f"{mod}.{t.id}"] = f"{mod}.{ref}"
    # resolve aliases through imports is the resolver's job; here only
    # same-module references resolve (TOPIC_X = OTHER_TOPIC)
    for name, ref in aliases.items():
        if ref in consts:
            consts[name] = consts[ref]
    return consts


def resolve_topic(
    expr: ast.AST,
    module: str,
    imports: dict[str, str],
    consts: dict[str, str],
) -> Optional[str]:
    """Wire topic string for a call-site/registration expression, or
    None when the expression is not statically a topic constant."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    ids: list[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        ids.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    ids.append(node.id)
    ids.reverse()
    if ids[-1] == "value":  # Topic.X.value
        ids = ids[:-1]
    head = ids[0]
    candidates = [f"{module}." + ".".join(ids)]
    if head in imports:
        candidates.append(".".join([imports[head], *ids[1:]]))
    for cand in candidates:
        if cand in consts:
            return consts[cand]
    return None


# -- registration discovery ---------------------------------------------------


def _resolve_handler(
    expr: ast.AST, info: FuncInfo, program: Program
) -> Optional[str]:
    """Qual of a subscribe() handler argument: ``self._fn`` ->
    "mod:Class._fn"; a bare name -> "mod:fn" when it exists."""
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id in ("self", "cls")
        and info.cls
    ):
        qual = f"{info.module}:{info.cls}.{expr.attr}"
        return qual if qual in program.functions else None
    if isinstance(expr, ast.Name):
        qual = f"{info.module}:{expr.id}"
        return qual if qual in program.functions else None
    return None


def subscriptions(
    program: Program,
    registrars: tuple[str, ...],
    consts: dict[str, str],
    max_depth: int = 3,
) -> dict[str, tuple[Optional[str], str, int]]:
    """topic -> (handler qual or None, path, line) reachable from the
    role's registrar functions (BFS over resolved callees, so helper
    registrars like schema_gossip.register_handlers count)."""
    out: dict[str, tuple[Optional[str], str, int]] = {}
    seen: set[str] = set()
    work: list[tuple[str, int]] = [(q, 0) for q in registrars]
    while work:
        qual, depth = work.pop()
        if qual in seen or qual not in program.functions:
            continue
        seen.add(qual)
        info = program.functions[qual]
        imports = program.tables.get(info.module, {})
        for node in _walk_own(info.node):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "subscribe"
                and len(node.args) >= 2
            ):
                topic = resolve_topic(node.args[0], info.module, imports, consts)
                if topic is not None and topic not in out:
                    handler = _resolve_handler(node.args[1], info, program)
                    out[topic] = (handler, info.path, node.lineno)
        if depth < max_depth:
            for site in info.calls:
                if site.callee:
                    work.append((site.callee, depth + 1))
    return out


def role_topic_matrix(
    program: Program,
    trees: dict,
    roles: Optional[dict[str, tuple[str, ...]]] = None,
) -> dict[str, dict[str, tuple[Optional[str], str, int]]]:
    """role -> {topic -> (handler qual, path, line)} for every role
    whose registrar exists in the program (seeded test packages resolve
    none of the real roles and get an empty matrix)."""
    roles = _cfg.ROLES if roles is None else roles
    consts = topic_constants(trees)
    out: dict[str, dict] = {}
    for role, regs in roles.items():
        if any(q in program.functions for q in regs):
            out[role] = subscriptions(program, regs, consts)
    return out


# -- client call sites --------------------------------------------------------


def client_sites(
    program: Program,
    consts: dict[str, str],
    client_targets: dict[str, tuple[str, ...]],
    known: Optional[set[str]] = None,
) -> list[tuple[str, tuple[str, ...], str, int, str]]:
    """(topic, target roles, path, line, caller qual) for every
    ``X.call(...)`` whose topic argument resolves, in client modules.

    Handles both transport signatures: ``transport.call(addr, topic,
    env)`` (topic in position 1 — taken whenever it resolves, so a
    typo'd or unregistered topic still surfaces) and the worker
    client's ``client.call(topic, env)`` (position 0 — accepted only
    when the resolved string is a ``known`` topic, so address literals
    in position 0 of the other signature never masquerade as topics).
    """
    sites = []
    for info in program.functions.values():
        targets = client_targets.get(info.module)
        if not targets:
            continue
        imports = program.tables.get(info.module, {})
        for node in _walk_own(info.node):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "call"
                and len(node.args) >= 2
            ):
                continue
            topic = resolve_topic(node.args[1], info.module, imports, consts)
            if topic is None:
                topic = resolve_topic(node.args[0], info.module, imports, consts)
                if known is not None and topic not in known:
                    topic = None
            if topic is not None:
                sites.append((topic, targets, info.path, node.lineno, info.qual))
    return sites


# -- the analyzer -------------------------------------------------------------


def analyze_topics(
    program: Program,
    trees: dict,
    *,
    roles: Optional[dict[str, tuple[str, ...]]] = None,
    client_targets: Optional[dict[str, tuple[str, ...]]] = None,
    exemptions: Optional[dict[tuple[str, str], str]] = None,
    expected_matrix: Optional[dict[str, tuple[str, ...]]] = None,
    baseline_path: str = "<wire-config>",
) -> list[Finding]:
    roles = _cfg.ROLES if roles is None else roles
    client_targets = (
        _cfg.CLIENT_TARGETS if client_targets is None else client_targets
    )
    exemptions = _cfg.TOPIC_EXEMPTIONS if exemptions is None else exemptions
    expected_matrix = (
        _cfg.EXPECTED_MATRIX if expected_matrix is None else expected_matrix
    )
    consts = topic_constants(trees)
    matrix = role_topic_matrix(program, trees, roles)
    findings: list[Finding] = []

    # 1. every client-invoked topic served by every target role
    known = set(consts.values())
    for served in matrix.values():
        known.update(served)
    used_exemptions: set[tuple[str, str]] = set()
    flagged: set[tuple[str, str]] = set()
    for topic, targets, path, line, qual in client_sites(
        program, consts, client_targets, known
    ):
        for role in targets:
            if role not in matrix:
                continue  # registrar not in this package (seeded pkgs)
            if topic in matrix[role]:
                continue
            if (role, topic) in exemptions:
                used_exemptions.add((role, topic))
                continue
            if (role, topic) in flagged:
                continue  # one finding per gap, not per call site
            flagged.add((role, topic))
            findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=0,
                    rule=RULE,
                    message=(
                        f"topic `{topic}` is invoked against role "
                        f"`{role}` (from {qual.split(':', 1)[1]}) but the "
                        f"role registers no handler for it; register one "
                        f"in {', '.join(roles[role])} or add a reasoned "
                        f"TOPIC_EXEMPTIONS entry"
                    ),
                )
            )
    # stale exemptions: the gap no longer exists (or the role vanished)
    for (role, topic), _reason in sorted(exemptions.items()):
        if role in matrix and topic in matrix[role]:
            findings.append(
                Finding(
                    path=baseline_path,
                    line=1,
                    col=0,
                    rule=RULE,
                    message=(
                        f"stale TOPIC_EXEMPTIONS entry ({role!r}, "
                        f"{topic!r}): the role now serves the topic — "
                        f"delete the entry (the table only shrinks)"
                    ),
                )
            )

    # 2. golden matrix drift, both directions
    for role, served in sorted(matrix.items()):
        declared = set(expected_matrix.get(role, ()))
        live = set(served)
        for topic in sorted(live - declared):
            _h, path, line = served[topic]
            findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=0,
                    rule=RULE,
                    message=(
                        f"role `{role}` registers topic `{topic}` that "
                        f"EXPECTED_MATRIX does not declare; add it to the "
                        f"checked-in matrix (wire_config.py)"
                    ),
                )
            )
        for topic in sorted(declared - live):
            findings.append(
                Finding(
                    path=baseline_path,
                    line=1,
                    col=0,
                    rule=RULE,
                    message=(
                        f"EXPECTED_MATRIX declares topic `{topic}` on role "
                        f"`{role}` but no registration exists — remove the "
                        f"stale entry or restore the handler"
                    ),
                )
            )
    return findings
