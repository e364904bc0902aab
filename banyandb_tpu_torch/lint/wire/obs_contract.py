"""wire-obs: the instrument contract between code and the dashboard doc.

docs/observability.md is the operator's contract: every metric it cites
must exist, and every instrument must use ONE label set — a counter
bumped with ``{"node": ...}`` here and ``{"peer": ...}`` there is two
series the dashboard cannot join.  Three checks over every
``counter_add`` / ``gauge_set`` / ``observe`` / ``histogram`` call with
a literal (or f-string-prefixed) instrument name:

1. the name must appear in wire_config.OBS_CONTRACT (exact, or under a
   ``prefix*`` pattern entry for f-string families like ``rpc_*_ms``);
2. when the contract pins a label-key set, every call site's literal
   label dict must use exactly those keys;
3. stale contract entries (no live call site) fail, and — when the doc
   exists — every contract name must be mentioned in
   docs/observability.md and every ``banyandb_*`` token the doc cites
   must normalize (strip scope prefix, ``_total``/``_bucket``/
   ``_count``/``_sum`` suffixes) to a contracted instrument.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from banyandb_tpu_torch.lint.core import Finding

from banyandb_tpu_torch.lint.wire import wire_config as _cfg

RULE = "wire-obs"

_METER_FUNCS = {
    # method -> index of the labels argument (after name)
    "counter_add": 2,
    "gauge_set": 2,
    "observe": 2,
    "histogram": 1,
}


def _instr_name(expr: ast.AST) -> Optional[str]:
    """Literal instrument name, or ``prefix*`` for f-string families."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.JoinedStr) and expr.values:
        head = expr.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value + "*"
        return "*"
    return None


def _label_keys(expr: Optional[ast.AST]) -> Optional[frozenset]:
    """Keys of a literal labels dict; None when not statically known."""
    if expr is None:
        return frozenset()
    if isinstance(expr, ast.Constant) and expr.value is None:
        return frozenset()
    if isinstance(expr, ast.Dict):
        keys = []
        for k in expr.keys:
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                return None  # **spread / computed key
            keys.append(k.value)
        return frozenset(keys)
    return None


def instrument_sites(
    trees: dict,
) -> list[tuple[str, Optional[frozenset], str, int]]:
    """(name-or-pattern, label keys or None, path, line) per call."""
    sites = []
    for _mod, (path, tree) in sorted(trees.items()):
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METER_FUNCS
            ):
                continue
            if not node.args:
                continue
            name = _instr_name(node.args[0])
            if name is None or name == "*":
                continue
            idx = _METER_FUNCS[node.func.attr]
            labels_expr: Optional[ast.AST] = None
            if len(node.args) > idx:
                labels_expr = node.args[idx]
            else:
                for kw in node.keywords:
                    if kw.arg == "labels":
                        labels_expr = kw.value
            sites.append((name, _label_keys(labels_expr), path, node.lineno))
    return sites


def _contract_entry(
    name: str, contract: dict
) -> Optional[tuple[str, Optional[frozenset]]]:
    """The contract entry covering ``name``: exact first, then the
    longest ``prefix*`` pattern."""
    if name in contract:
        return name, contract[name]
    best = None
    for key, labels in contract.items():
        if key.endswith("*") and name.startswith(key[:-1]):
            if best is None or len(key) > len(best[0]):
                best = (key, labels)
    return best


def analyze_obs(
    trees: dict,
    repo_root: Optional[Path],
    *,
    contract: Optional[dict] = None,
    obs_doc: Optional[str] = None,
    scope: str = "banyandb",
) -> list[Finding]:
    contract = _cfg.OBS_CONTRACT if contract is None else contract
    obs_doc = _cfg.OBS_DOC if obs_doc is None else obs_doc
    findings: list[Finding] = []
    sites = instrument_sites(trees)
    hit_entries: set[str] = set()
    flagged_names: set[str] = set()
    for name, labels, path, line in sites:
        entry = _contract_entry(name, contract)
        if entry is None:
            if name in flagged_names:
                continue
            flagged_names.add(name)
            findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=0,
                    rule=RULE,
                    message=(
                        f"instrument `{name}` is not in OBS_CONTRACT — "
                        f"declare it (name -> label keys) and cite it in "
                        f"{obs_doc}"
                    ),
                )
            )
            continue
        key, want_labels = entry
        hit_entries.add(key)
        if want_labels is None or labels is None:
            continue  # pattern entry / dynamic labels: no label check
        if labels != want_labels:
            findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=0,
                    rule=RULE,
                    message=(
                        f"instrument `{name}` used with label keys "
                        f"{sorted(labels)} but OBS_CONTRACT pins "
                        f"{sorted(want_labels)} — one instrument, one "
                        f"label set"
                    ),
                )
            )
    for key in sorted(set(contract) - hit_entries):
        findings.append(
            Finding(
                path="<wire-config>",
                line=1,
                col=0,
                rule=RULE,
                message=(
                    f"stale OBS_CONTRACT entry `{key}`: no live call site "
                    f"— delete the entry (the contract tracks the code)"
                ),
            )
        )

    # docs cross-reference (skipped when the doc is absent)
    if repo_root is None or not contract:
        return findings
    doc_path = Path(repo_root) / obs_doc
    if not doc_path.exists():
        return findings
    text = doc_path.read_text()
    for key in sorted(contract):
        bare = key.rstrip("*")
        if bare and bare not in text:
            findings.append(
                Finding(
                    path=str(doc_path),
                    line=1,
                    col=0,
                    rule=RULE,
                    message=(
                        f"contracted instrument `{bare}` is not mentioned "
                        f"in {obs_doc} — document it"
                    ),
                )
            )
    pfx = scope + "_"
    for token in sorted(set(re.findall(rf"{re.escape(pfx)}\w+", text))):
        bare = token[len(pfx):]
        if bare.startswith("tpu"):
            # "banyandb_tpu_torch..." is the package name, not a metric: the
            # scope prefix collides with it by construction
            continue
        for suffix in ("_total", "_bucket", "_count", "_sum"):
            if bare.endswith(suffix):
                bare = bare[: -len(suffix)]
                break
        if _contract_entry(bare, contract) is None:
            findings.append(
                Finding(
                    path=str(doc_path),
                    line=1,
                    col=0,
                    rule=RULE,
                    message=(
                        f"{obs_doc} cites `{token}` but no contracted "
                        f"instrument matches `{bare}` — fix the doc or "
                        f"declare the instrument"
                    ),
                )
            )
    return findings
