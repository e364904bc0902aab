"""wire-envelope: producer/consumer field matching per envelope plane.

For each plane in wire_config.ENVELOPE_GROUPS (write / scatter / sync):

- **Produced fields** — every string key stored inside a producer
  function: dict literals, ``dict(env, field=...)`` keyword rebuilds,
  and ``env["field"] = ...`` subscript stores.
- **Consumed fields** — every read of the handler's envelope parameter
  in a consumer function: ``env["field"]`` hard reads, ``env.get(...)``
  soft reads; when the envelope is passed whole to a helper in the same
  program, the helper's reads of that parameter count too (one hop).

Two finding classes, both manually ratcheted through the checked-in
accepted tables (entries carry reasons and the tables only shrink):

1. **write-only** — a field every producer stamps but no consumer ever
   reads: dead wire weight, or worse, a consumer that silently ignores
   a fence ("epoch stamped but never checked").
2. **silent-default** — a consumer reads a *produced* field through
   ``env.get(field, default)``: if a producer path forgets the stamp,
   the consumer silently proceeds with the default instead of failing —
   the "epoch fence missing on the streaming ship path" class.
"""

from __future__ import annotations

import ast
from typing import Optional

from banyandb_tpu_torch.lint.core import Finding
from banyandb_tpu_torch.lint.whole_program.callgraph import Program, _walk_own

from banyandb_tpu_torch.lint.wire import wire_config as _cfg

RULE = "wire-envelope"


def _produced_fields(program: Program, quals: tuple[str, ...]) -> dict[str, tuple[str, int]]:
    """field -> (path, line) of one producing site."""
    fields: dict[str, tuple[str, int]] = {}
    for qual in quals:
        info = program.functions.get(qual)
        if info is None:
            continue
        for node in _walk_own(info.node):
            if isinstance(node, ast.Dict):
                for key in node.keys:
                    if isinstance(key, ast.Constant) and isinstance(
                        key.value, str
                    ):
                        fields.setdefault(
                            key.value, (info.path, key.lineno)
                        )
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "dict"
            ):
                for kw in node.keywords:
                    if kw.arg is not None:
                        fields.setdefault(
                            kw.arg, (info.path, node.lineno)
                        )
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)
                        and isinstance(t.slice.value, str)
                    ):
                        fields.setdefault(
                            t.slice.value, (info.path, t.lineno)
                        )
    return fields


def _is_param_ref(expr: ast.AST, param: str) -> bool:
    """True when ``expr`` denotes the envelope parameter: the bare name
    or the ``(env or {})`` guard idiom optional-envelope helpers use."""
    if isinstance(expr, ast.Name):
        return expr.id == param
    if isinstance(expr, ast.BoolOp) and isinstance(expr.op, ast.Or):
        return bool(expr.values) and _is_param_ref(expr.values[0], param)
    return False


def _env_param(node: ast.AST) -> Optional[str]:
    """Name of the envelope parameter: the first argument after self."""
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    args = [a.arg for a in node.args.args]
    if args and args[0] in ("self", "cls"):
        args = args[1:]
    return args[0] if args else None


def _reads_of(
    program: Program, qual: str, param: str, depth: int
) -> list[tuple[str, bool, str, int]]:
    """(field, has_silent_default, path, line) reads of ``param`` inside
    ``qual``, following the envelope one hop when passed whole."""
    info = program.functions.get(qual)
    if info is None:
        return []
    reads: list[tuple[str, bool, str, int]] = []
    for node in _walk_own(info.node):
        if (
            isinstance(node, ast.Subscript)
            and _is_param_ref(node.value, param)
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str)
            and isinstance(node.ctx, ast.Load)
        ):
            reads.append(
                (node.slice.value, False, info.path, node.lineno)
            )
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and _is_param_ref(node.func.value, param)
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            reads.append(
                (
                    node.args[0].value,
                    len(node.args) >= 2,
                    info.path,
                    node.lineno,
                )
            )
        elif depth > 0 and isinstance(node, ast.Call):
            # env passed whole to a resolvable helper: follow one hop
            for idx, arg in enumerate(node.args):
                if not (isinstance(arg, ast.Name) and arg.id == param):
                    continue
                for site in info.calls:
                    if site.node is not node or not site.callee:
                        continue
                    callee = program.functions.get(site.callee)
                    if callee is None:
                        continue
                    cargs = [a.arg for a in callee.node.args.args]
                    if cargs and cargs[0] in ("self", "cls"):
                        cargs = cargs[1:]
                    if idx < len(cargs):
                        reads.extend(
                            _reads_of(
                                program,
                                site.callee,
                                cargs[idx],
                                depth - 1,
                            )
                        )
    return reads


def analyze_envelopes(
    program: Program,
    *,
    groups: Optional[dict[str, dict]] = None,
    baseline_path: str = "<wire-config>",
) -> list[Finding]:
    groups = _cfg.ENVELOPE_GROUPS if groups is None else groups
    findings: list[Finding] = []
    for plane, spec in sorted(groups.items()):
        produced = _produced_fields(program, spec["producers"])
        if not produced and not any(
            q in program.functions for q in spec["consumers"]
        ):
            continue  # plane absent from this package (seeded pkgs)
        consumed: set[str] = set()
        soft_reads: list[tuple[str, str, int]] = []
        for qual in spec["consumers"]:
            info = program.functions.get(qual)
            if info is None:
                continue
            param = _env_param(info.node)
            if param is None:
                continue
            for field, silent, path, line in _reads_of(
                program, qual, param, depth=1
            ):
                consumed.add(field)
                if silent:
                    soft_reads.append((field, path, line))

        accepted_wo: dict[str, str] = spec.get("accepted_write_only", {})
        accepted_sd: dict[str, str] = spec.get("accepted_silent_default", {})

        # 1. write-only fields
        for field in sorted(set(produced) - consumed):
            if field in accepted_wo:
                continue
            path, line = produced[field]
            findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=0,
                    rule=RULE,
                    message=(
                        f"envelope field `{field}` on the {plane} plane is "
                        f"produced but never read by any consumer "
                        f"({', '.join(q.split(':', 1)[1] for q in spec['consumers'])}); "
                        f"dead wire weight or an unchecked fence — consume "
                        f"it or add a reasoned accepted_write_only entry"
                    ),
                )
            )
        for field in sorted(set(accepted_wo) & consumed):
            findings.append(
                Finding(
                    path=baseline_path,
                    line=1,
                    col=0,
                    rule=RULE,
                    message=(
                        f"stale accepted_write_only entry `{field}` on the "
                        f"{plane} plane: a consumer now reads it — delete "
                        f"the entry (the table only shrinks)"
                    ),
                )
            )

        # 2. silent-default reads of produced fields
        flagged: set[str] = set()
        for field, path, line in sorted(soft_reads):
            if field not in produced or field in accepted_sd:
                continue
            if field in flagged:
                continue
            flagged.add(field)
            findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=0,
                    rule=RULE,
                    message=(
                        f"envelope field `{field}` on the {plane} plane is "
                        f"read with a silent default (.get) although every "
                        f"producer stamps it — a producer path that forgets "
                        f"the stamp proceeds silently; hard-read it or add "
                        f"a reasoned accepted_silent_default entry"
                    ),
                )
            )
        live_sd = {f for f, _p, _l in soft_reads if f in produced}
        for field in sorted(set(accepted_sd) - live_sd):
            findings.append(
                Finding(
                    path=baseline_path,
                    line=1,
                    col=0,
                    rule=RULE,
                    message=(
                        f"stale accepted_silent_default entry `{field}` on "
                        f"the {plane} plane: no soft read remains — delete "
                        f"the entry (the table only shrinks)"
                    ),
                )
            )
    return findings
