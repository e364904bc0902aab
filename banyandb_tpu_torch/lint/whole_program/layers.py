"""Import-graph layering analyzer.

Scans every module in the package for *module-level* imports (function-
local and ``if TYPE_CHECKING:`` imports are the documented lazy-boundary
escape hatch and do not create layer edges), maps both endpoints through
the checked-in layer config, and reports every edge the policy forbids:

- **upward**: importing a strictly higher layer;
- **skip-layer**: importing a lower layer the importer's ``may_import``
  set does not include (the config states, per layer, exactly which
  lower layers it may reach);
- **unknown module**: a module the config cannot place — the map must
  stay total, so growth forces a policy decision.

Pre-existing violations ride a **ratcheted baseline**
(layer_config.BASELINE): a baselined edge that still exists is tolerated
(and counted), a new edge fails, and a baselined edge that no longer
exists fails too ("stale baseline entry") so the list only ever shrinks.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

from banyandb_tpu_torch.lint.core import Finding, apply_ratchet

RULE = "layering"


@dataclass(frozen=True)
class LayerConfig:
    """The checked-in layer policy.

    - ``layers``: bottom-up layer names (index = height).
    - ``may_import``: layer -> lower layers it may import (same layer is
      always allowed; anything else is upward or skip-layer).
    - ``layer_of``: package-relative dotted module prefix -> layer,
      longest prefix wins ("" may map the package root).  A module no
      prefix covers is an unknown-module failure.
    """

    layers: tuple[str, ...]
    may_import: dict[str, tuple[str, ...]]
    layer_of: dict[str, str]

    def module_layer(self, rel_mod: str) -> Optional[str]:
        """Layer of a package-relative dotted module, longest prefix
        first.  The "" entry maps ONLY the package-root module itself —
        it is not a catch-all, so an unmapped module stays unknown (and
        fails the gate)."""
        if rel_mod == "":
            return self.layer_of.get("")
        probe = rel_mod
        while probe:
            layer = self.layer_of.get(probe)
            if layer is not None:
                return layer
            probe = probe.rpartition(".")[0]
        return None

    def allowed(self, src_layer: str, dst_layer: str) -> bool:
        if src_layer == dst_layer:
            return True
        return dst_layer in self.may_import.get(src_layer, ())


@dataclass(frozen=True)
class ImportEdge:
    src: str  # full dotted module
    dst: str  # full dotted module
    path: str
    line: int
    col: int


def iter_py_modules(pkg_root: Path, pkgname: str) -> Iterable[tuple[str, Path]]:
    """(full dotted module name, file path) for every .py in the package."""
    for p in sorted(pkg_root.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(pkg_root).with_suffix("")
        parts = list(rel.parts)
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join([pkgname, *parts]).rstrip("."), p


def parse_package(
    pkg_root: Path, pkgname: str
) -> dict[str, tuple[Path, "ast.Module"]]:
    """module -> (path, parsed tree) for the whole package, skipping
    files that do not parse (the per-file linter reports those).  Parsed
    ONCE here and shared by every whole-program analyzer."""
    trees: dict[str, tuple[Path, ast.Module]] = {}
    for mod, path in iter_py_modules(pkg_root, pkgname):
        try:
            trees[mod] = (path, ast.parse(path.read_text(encoding="utf-8")))
        except SyntaxError:
            continue
    return trees


def resolve_relative_base(mod: str, node: ast.ImportFrom, is_pkg: bool) -> str:
    """Dotted base module an ImportFrom refers to, resolving relative
    levels against the importing module.  Shared by the layering scan
    and the call-graph import tables so both resolve identically."""
    if node.level == 0:
        return node.module or ""
    anchor = mod.split(".")
    up = node.level - (1 if is_pkg else 0)
    anchor = anchor[: len(anchor) - up] if up else anchor
    return ".".join(anchor + ([node.module] if node.module else []))


def _is_type_checking_test(test: ast.AST) -> bool:
    return (
        isinstance(test, ast.Name)
        and test.id == "TYPE_CHECKING"
        or isinstance(test, ast.Attribute)
        and test.attr == "TYPE_CHECKING"
    )


def _module_level_imports(tree: ast.Module):
    """Yield Import/ImportFrom nodes executed at module import time.

    Descends into module-level ``if``/``try`` (conditional imports run at
    import time) but not into functions, classes with methods only
    executing later... class bodies DO execute at import time, so they
    are included; ``if TYPE_CHECKING:`` arms are excluded.
    """
    stack: list[ast.AST] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, ast.If):
            if not _is_type_checking_test(node.test):
                stack.extend(node.body)
            stack.extend(node.orelse)
        elif isinstance(node, (ast.Try, ast.ClassDef, ast.With)):
            for field in ("body", "handlers", "orelse", "finalbody", "items"):
                for child in getattr(node, field, []):
                    if isinstance(child, ast.ExceptHandler):
                        stack.extend(child.body)
                    elif isinstance(child, ast.AST):
                        stack.append(child)


def scan_import_edges(
    pkg_root: Path,
    pkgname: str,
    trees: Optional[dict] = None,
) -> tuple[list[ImportEdge], set[str]]:
    """-> (package-internal module-level import edges, all module names).
    Pass pre-parsed ``trees`` (parse_package) to avoid re-reading."""
    if trees is None:
        trees = parse_package(pkg_root, pkgname)
    names = set(trees)
    edges: list[ImportEdge] = []

    def resolve_from(mod: str, node: ast.ImportFrom, is_pkg: bool) -> list[str]:
        base = resolve_relative_base(mod, node, is_pkg)
        if not (base == pkgname or base.startswith(pkgname + ".")):
            return []
        out = []
        for alias in node.names:
            sub = f"{base}.{alias.name}"
            out.append(sub if sub in names else base)
        return out

    for mod, (path, tree) in trees.items():
        is_pkg = path.name == "__init__.py"
        for node in _module_level_imports(tree):
            targets: list[str] = []
            if isinstance(node, ast.Import):
                targets = [
                    a.name
                    for a in node.names
                    if a.name == pkgname or a.name.startswith(pkgname + ".")
                ]
            else:
                targets = resolve_from(mod, node, is_pkg)
            for t in targets:
                if t != mod:
                    edges.append(
                        ImportEdge(mod, t, str(path), node.lineno, node.col_offset)
                    )
    return edges, names


def _rel(mod: str, pkgname: str) -> str:
    return mod[len(pkgname) + 1 :] if mod != pkgname else ""


def analyze_layers(
    pkg_root: Path,
    pkgname: str,
    config: LayerConfig,
    baseline: frozenset = frozenset(),
    trees: Optional[dict] = None,
) -> list[Finding]:
    """Report forbidden import edges, unknown modules and stale baseline
    entries.  Baselined live violations are tolerated (the ratchet)."""
    if trees is None:
        trees = parse_package(pkg_root, pkgname)
    edges, names = scan_import_edges(pkg_root, pkgname, trees)
    module_paths = {mod: path for mod, (path, _tree) in trees.items()}
    findings: list[Finding] = []
    violations: list[tuple[str, Finding]] = []
    height = {layer: i for i, layer in enumerate(config.layers)}

    for mod in sorted(names):
        if config.module_layer(_rel(mod, pkgname)) is None:
            findings.append(
                Finding(
                    path=str(module_paths[mod]),
                    line=1,
                    col=0,
                    rule=RULE,
                    message=(
                        f"module `{mod}` maps to no layer; add it to "
                        "lint/whole_program/layer_config.py (the map is total)"
                    ),
                )
            )

    for e in edges:
        src_layer = config.module_layer(_rel(e.src, pkgname))
        dst_layer = config.module_layer(_rel(e.dst, pkgname))
        if src_layer is None or dst_layer is None:
            continue  # unknown modules already reported above
        if config.allowed(src_layer, dst_layer):
            continue
        kind = (
            "upward"
            if height[dst_layer] > height[src_layer]
            else "skip-layer"
        )
        violations.append(
            (
                f"{e.src} -> {e.dst}",
                Finding(
                    path=e.path,
                    line=e.line,
                    col=e.col,
                    rule=RULE,
                    message=(
                        f"{kind} import: `{e.src}` ({src_layer}) must not "
                        f"import `{e.dst}` ({dst_layer}); invert the "
                        "dependency, move the shared piece down a layer, or "
                        "use a function-local lazy import at the boundary"
                    ),
                ),
            )
        )

    findings += apply_ratchet(
        violations,
        baseline,
        rule=RULE,
        baseline_path=str(
            pkg_root / "lint" / "whole_program" / "layer_config.py"
        ),
    )
    return findings
