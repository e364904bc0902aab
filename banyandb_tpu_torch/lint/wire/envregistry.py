"""wire-envflag: one parser, one registry, one doc for BYDB_* flags.

Config knobs are wire contract too — an operator sets them on one node
and expects the documented behavior on every role.  Three checks:

1. **Single parser** — every ``BYDB_*`` environment read must go
   through utils/envflag (``env_flag``/``env_int``/``env_float``/
   ``env_str``).  Raw ``os.environ[...]``/``os.getenv(...)`` reads
   outside that module re-grow the hand-rolled truthiness tables the
   module exists to kill.
2. **Registry** — every flag name passed to an ``env_*`` helper must
   appear in ``envflag.FLAGS`` (the checked-in table), and every FLAGS
   entry must still have a live read (stale entries fail: the table
   tracks the code, not history).
3. **Docs** — every FLAGS name must appear in docs/flags.md and every
   ``BYDB_*`` token in that doc must be a registered flag, so the
   operator page can never cite a knob that does not exist.  (Skipped
   when the doc is absent — seeded test packages.)
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from banyandb_tpu_torch.lint.core import Finding, dotted_name

from banyandb_tpu_torch.lint.wire import wire_config as _cfg

RULE = "wire-envflag"


def _literal_env_name(node: ast.Call, prefix: str) -> Optional[str]:
    if node.args and isinstance(node.args[0], ast.Constant):
        v = node.args[0].value
        if isinstance(v, str) and v.startswith(prefix):
            return v
    return None


def analyze_envflags(
    trees: dict,
    repo_root: Optional[Path],
    *,
    envflag_module: Optional[str] = None,
    envflag_funcs: Optional[tuple[str, ...]] = None,
    prefix: Optional[str] = None,
    flags_doc: Optional[str] = None,
) -> list[Finding]:
    envflag_module = (
        _cfg.ENVFLAG_MODULE if envflag_module is None else envflag_module
    )
    envflag_funcs = (
        _cfg.ENVFLAG_FUNCS if envflag_funcs is None else envflag_funcs
    )
    prefix = _cfg.ENV_PREFIX if prefix is None else prefix
    flags_doc = _cfg.FLAGS_DOC if flags_doc is None else flags_doc
    findings: list[Finding] = []

    used: dict[str, tuple[str, int]] = {}  # flag -> one (path, line)
    for mod, (path, tree) in sorted(trees.items()):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            short = name.split(".")[-1]
            # raw reads: os.environ[...] handled below; .get/getenv here
            if mod != envflag_module and (
                name.endswith("os.environ.get")
                or name in ("os.getenv", "getenv")
                or (short == "get" and name.endswith("environ.get"))
            ):
                flag = _literal_env_name(node, prefix)
                if flag is not None:
                    findings.append(
                        Finding(
                            path=path,
                            line=node.lineno,
                            col=node.col_offset,
                            rule=RULE,
                            message=(
                                f"raw environment read of {flag} — every "
                                f"{prefix}* flag goes through "
                                f"{envflag_module} (env_flag/env_int/"
                                f"env_float/env_str) and its FLAGS table"
                            ),
                        )
                    )
            elif short in envflag_funcs:
                flag = _literal_env_name(node, prefix)
                if flag is not None:
                    used.setdefault(flag, (path, node.lineno))
        # raw subscript reads: os.environ["BYDB_X"]
        if mod == envflag_module:
            continue
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Subscript)
                and (dotted_name(node.value) or "").endswith("os.environ")
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)
                and node.slice.value.startswith(prefix)
            ):
                findings.append(
                    Finding(
                        path=path,
                        line=node.lineno,
                        col=node.col_offset,
                        rule=RULE,
                        message=(
                            f"raw environment read of {node.slice.value} — "
                            f"every {prefix}* flag goes through "
                            f"{envflag_module} and its FLAGS table"
                        ),
                    )
                )

    # the registry itself
    if envflag_module not in trees:
        return findings
    reg_path, reg_tree = trees[envflag_module]
    flags: dict[str, int] = {}
    for node in reg_tree.body:
        targets = (
            node.targets
            if isinstance(node, ast.Assign)
            else [node.target]
            if isinstance(node, ast.AnnAssign)
            else []
        )
        value = getattr(node, "value", None)
        if not any(
            isinstance(t, ast.Name) and t.id == "FLAGS" for t in targets
        ):
            continue
        if isinstance(value, ast.Dict):
            for key in value.keys:
                if isinstance(key, ast.Constant) and isinstance(
                    key.value, str
                ):
                    flags[key.value] = key.lineno
    if not flags:
        findings.append(
            Finding(
                path=reg_path,
                line=1,
                col=0,
                rule=RULE,
                message=(
                    f"{envflag_module} defines no FLAGS dict literal — the "
                    f"{prefix}* registry the audit and docs key off"
                ),
            )
        )
        return findings

    for flag, (path, line) in sorted(used.items()):
        if flag not in flags:
            findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=0,
                    rule=RULE,
                    message=(
                        f"flag {flag} is read but missing from "
                        f"envflag.FLAGS — register it (one line: name -> "
                        f"what it tunes)"
                    ),
                )
            )
    for flag in sorted(set(flags) - set(used)):
        findings.append(
            Finding(
                path=reg_path,
                line=flags[flag],
                col=0,
                rule=RULE,
                message=(
                    f"stale FLAGS entry {flag}: no env_* read remains — "
                    f"delete the entry (the table tracks the code)"
                ),
            )
        )

    # docs cross-reference (skipped when the doc is absent)
    if repo_root is None:
        return findings
    doc_path = Path(repo_root) / flags_doc
    if not doc_path.exists():
        return findings
    text = doc_path.read_text()
    doc_flags = set(re.findall(rf"{re.escape(prefix)}\w+", text))
    for flag in sorted(set(flags) - doc_flags):
        findings.append(
            Finding(
                path=reg_path,
                line=flags[flag],
                col=0,
                rule=RULE,
                message=(
                    f"flag {flag} is registered but undocumented — add it "
                    f"to {flags_doc}"
                ),
            )
        )
    for flag in sorted(doc_flags - set(flags)):
        findings.append(
            Finding(
                path=str(doc_path),
                line=1,
                col=0,
                rule=RULE,
                message=(
                    f"{flags_doc} cites {flag} but no such flag is "
                    f"registered in envflag.FLAGS — fix the doc or "
                    f"register the flag"
                ),
            )
        )
    return findings
