"""Module-resolution call graph + interprocedural fact propagation.

Builds one symbol table over the whole package AST (functions, methods,
nested kernel builders, import aliases), resolves call sites to
fully-qualified functions, and propagates two facts to a fixed point:

- ``sync``:  the function (transitively) performs a device->host sync
  (``measure_exec.device_get`` / ``torch.cuda.synchronize`` /
  ``<stream>.synchronize()``);
- ``block``: the function (transitively) blocks the thread (transport
  RPC, ``time.sleep``, ``urlopen``, ``socket.create_connection``,
  ``subprocess`` waits).

Two analyses consume the facts:

- ``analyze_sync_in_kernel``: a call *inside a device region* (a
  ``kernel``/``step``/``jitted`` function, or the function a builder
  such as ``_kernel_body`` returns) whose callee transitively syncs or
  blocks is flagged — across files, which the per-file host-sync rule
  cannot see.  In eager PyTorch such a call stalls the per-chunk
  pipeline that ``device_get`` batches at the result boundary.  Direct
  (depth-0) calls to the sync APIs stay the per-file rule's business;
  this analysis only reports what an intra-file reading would miss.
- ``analyze_lock_blocking``: the cross-file half of lock-across-rpc — a
  call made while holding a lock whose callee transitively blocks.

Resolution is module-level and deliberately conservative: a call that
cannot be resolved to a package function creates no edge (no facts, no
false chains).  ``self.m()`` resolves through the enclosing class and
its in-package bases; aliased module and symbol imports (including
function-local lazy imports) resolve through one merged per-module
import table.

Lock identity is *declaration-based*: ``self._lock`` in class ``C`` of
module ``m`` is ``m.C._lock`` — one id per declaration site, not per
instance (see lockorder.py for the deadlock-graph consequences).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional

from banyandb_tpu_torch.lint.core import Finding, dotted_name
from banyandb_tpu_torch.lint.rules_fabric import _attr_chain_ids, _is_transport_call
from banyandb_tpu_torch.lint.rules_torch import (
    is_builder_name,
    is_device_region_name,
)
from banyandb_tpu_torch.lint.whole_program.layers import (
    parse_package,
    resolve_relative_base,
)

# the port's sync APIs, matched on the call's last name segment: the
# batched result boundary ``measure_exec.device_get`` (its counterpart of
# jax.device_get) and the stream waits ``torch.cuda.synchronize`` /
# ``<stream>.synchronize()``
_SYNC_NAMES = {"device_get", "synchronize"}


def _is_sync_api(node: ast.Call) -> bool:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr in _SYNC_NAMES
    return isinstance(node.func, ast.Name) and node.func.id in _SYNC_NAMES


_BLOCK_APIS = {
    "time.sleep",
    "_time.sleep",
    "urllib.request.urlopen",
    "request.urlopen",
    "urlopen",
    "socket.create_connection",
    "create_connection",
    "subprocess.run",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.call",
}


@dataclass
class CallSite:
    node: ast.Call
    callee: Optional[str]  # resolved qualname ("mod:Class.fn") or None
    line: int
    col: int


@dataclass(frozen=True)
class Registration:
    """A function handed to a concurrency primitive: the thread-root
    discovery surface for the shared-state analyzer.

    kinds: ``thread`` (threading.Thread target), ``timer``
    (threading.Timer function), ``executor`` (pool.submit fn),
    ``subscriber`` (bus.subscribe handler), ``http`` (a
    ThreadingHTTPServer handler-class ``do_*`` method — each request runs
    it on its own thread)."""

    kind: str
    target: str  # resolved qualname of the function that will run
    name: str  # thread name= constant when present, else ""
    line: int
    col: int


@dataclass
class LockRegion:
    lock_id: str
    node: ast.AST  # the With node
    calls: list[CallSite] = field(default_factory=list)
    inner_locks: list[tuple[str, ast.AST]] = field(default_factory=list)


@dataclass
class FuncInfo:
    qual: str  # "module:fn", "module:Class.fn", "module:fn.inner"
    module: str
    path: str
    node: ast.AST
    cls: Optional[str]
    calls: list[CallSite] = field(default_factory=list)
    lock_regions: list[LockRegion] = field(default_factory=list)
    registrations: list[Registration] = field(default_factory=list)
    direct_sync: Optional[str] = None
    direct_block: Optional[str] = None
    traced: bool = False
    # propagated facts: (base api, witness chain of quals) or None
    sync: Optional[tuple[str, tuple[str, ...]]] = None
    block: Optional[tuple[str, tuple[str, ...]]] = None


def _walk_own(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested defs (each
    nested def is its own FuncInfo)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def lock_identity(
    expr: ast.AST,
    module: str,
    cls: Optional[str],
    imports: Optional[dict[str, str]] = None,
) -> Optional[str]:
    """Declaration-based lock id for a with-context expression, or None
    when the expression is not lock-shaped (last segment contains
    'lock').  An imported head resolves through the module's import
    table, so ``other.GLOBAL_LOCK`` names the same declaration from
    every module that touches it."""
    if isinstance(expr, ast.Call):  # with self._lock_for(x): style
        expr = expr.func
    ids = _attr_chain_ids(expr)
    if not ids or "lock" not in ids[-1].lower():
        return None
    if ids[0] in ("self", "cls"):
        owner = f"{module}.{cls}" if cls else module
        return ".".join([owner, *ids[1:]])
    if imports and ids[0] in imports:
        return ".".join([imports[ids[0]], *ids[1:]])
    return f"{module}." + ".".join(ids)


class Program:
    """The whole-package call graph with propagated facts."""

    def __init__(self) -> None:
        self.functions: dict[str, FuncInfo] = {}
        self.modules: set[str] = set()
        # lock declarations assigned threading.RLock() — reentrant, so a
        # self re-acquisition is not a self-deadlock
        self.reentrant_locks: set[str] = set()
        # every Lock()/RLock() declaration: (abs file path, lineno of the
        # constructor call) -> declaration-based lock id.  The runtime
        # sanitizer (banyandb_tpu_torch/sanitize/lockwatch.py) maps locks it
        # instruments back to static identities through this table.
        self.lock_sites: dict[tuple[str, int], str] = {}
        # module -> {class name -> {method name -> qual}}
        self._classes: dict[str, dict[str, dict[str, str]]] = {}
        self._bases: dict[tuple[str, str], list[str]] = {}
        # merged per-module import tables (kept for late resolution needs)
        self.tables: dict[str, dict[str, str]] = {}
        # one-hop attribute types: (mod, cls, attr) -> (mod2, cls2) for
        # `self.attr = SomePackageClass(...)` — lets `self.liaison.probe()`
        # resolve to the Liaison method
        self.attr_types: dict[tuple[str, str, str], tuple[str, str]] = {}
        # ctor dotted name per attribute declaration: (mod, cls, attr) ->
        # "threading.Event" etc.; the shared-state analyzer classifies
        # thread-safe primitives from this
        self.attr_ctor: dict[tuple[str, str, str], str] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def build(
        cls, pkg_root: Path, pkgname: str, trees: Optional[dict] = None
    ) -> "Program":
        """Pass pre-parsed ``trees`` (layers.parse_package) to share one
        parse of the package across analyzers."""
        self = cls()
        if trees is None:
            trees = parse_package(pkg_root, pkgname)
        self.modules = set(trees)
        for mod, (path, tree) in trees.items():
            self._collect_defs(mod, str(path), tree)
        tables = {
            mod: self._import_table(mod, tree, path.name == "__init__.py")
            for mod, (path, tree) in trees.items()
        }
        self.tables = tables
        for mod, (_path, tree) in trees.items():
            self._collect_attr_types(mod, tree, tables[mod])
        for mod, (_path, tree) in trees.items():
            self._resolve_module(mod, tree, tables[mod])
        self._mark_traced(trees, tables)
        self._propagate()
        return self

    def _collect_defs(self, mod: str, path: str, tree: ast.Module) -> None:
        classes: dict[str, dict[str, str]] = {}

        def visit(node: ast.AST, prefix: str, cls_name: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{mod}:{prefix}{child.name}"
                    self.functions[qual] = FuncInfo(
                        qual=qual, module=mod, path=path, node=child, cls=cls_name
                    )
                    if cls_name and not prefix.replace(cls_name + ".", "", 1):
                        classes.setdefault(cls_name, {})[child.name] = qual
                    visit(child, f"{prefix}{child.name}.", cls_name)
                elif isinstance(child, ast.ClassDef):
                    bases = [dotted_name(b) for b in child.bases]
                    self._bases[(mod, child.name)] = [b for b in bases if b]
                    classes.setdefault(child.name, {})
                    visit(child, f"{child.name}.", child.name)

        visit(tree, "", None)
        self._classes[mod] = classes

        # lock declarations: self.X = threading.Lock()/RLock() inside
        # class C -> "mod.C.X"; NAME = threading.Lock() -> "mod.NAME".
        # RLock declarations are additionally reentrant (not a
        # self-deadlock); every declaration records its constructor-call
        # source site for the runtime sanitizer's identity mapping.
        def scan_locks(node: ast.AST, cls_name: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    scan_locks(child, child.name)
                    continue
                if isinstance(child, ast.Assign) and isinstance(
                    child.value, ast.Call
                ):
                    ctor = dotted_name(child.value.func)
                    if ctor in (
                        "threading.Lock",
                        "Lock",
                        "threading.RLock",
                        "RLock",
                    ):
                        for t in child.targets:
                            lid = lock_identity(t, mod, cls_name)
                            if lid:
                                if ctor.endswith("RLock"):
                                    self.reentrant_locks.add(lid)
                                self.lock_sites[
                                    (path, child.value.lineno)
                                ] = lid
                scan_locks(child, cls_name)

        scan_locks(tree, None)

    def _import_table(
        self, mod: str, tree: ast.Module, is_pkg: bool
    ) -> dict[str, str]:
        """Merged alias -> dotted-target table (module-level AND
        function-local imports: lazy boundaries still carry facts)."""
        table: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    table[(a.asname or a.name).split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
                    if a.asname:
                        table[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom):
                base = resolve_relative_base(mod, node, is_pkg)
                for a in node.names:
                    table[a.asname or a.name] = f"{base}.{a.name}"
        return table

    def _find_class(
        self, mod: str, imports: dict[str, str], dotted: str
    ) -> Optional[tuple[str, str]]:
        """Resolve a dotted constructor name to an in-package class ref
        (module, class) — local class, imported symbol, or imported
        module attribute."""
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        if not rest and head in self._classes.get(mod, {}):
            return (mod, head)
        if head in imports:
            dotted = imports[head] + (("." + rest) if rest else "")
        elif rest:
            return None
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            m = ".".join(parts[:cut])
            if m in self.modules:
                r = ".".join(parts[cut:])
                if r and "." not in r and r in self._classes.get(m, {}):
                    return (m, r)
                return None
        return None

    def _collect_attr_types(
        self, mod: str, tree: ast.Module, imports: dict[str, str]
    ) -> None:
        """One-hop attribute typing: `self.attr = Ctor(...)` anywhere in a
        class records the ctor (for primitive classification) and, when
        Ctor is an in-package class, the attribute's type — enabling
        `self.attr.method()` call resolution."""

        def scan(node: ast.AST, cls_name: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    scan(child, child.name)
                    continue
                if (
                    cls_name
                    and isinstance(child, (ast.Assign, ast.AnnAssign))
                    and isinstance(child.value, ast.Call)
                ):
                    ctor = dotted_name(child.value.func)
                    targets = (
                        child.targets
                        if isinstance(child, ast.Assign)
                        else [child.target]
                    )
                    if ctor:
                        for t in targets:
                            ids = _attr_chain_ids(t)
                            if len(ids) == 2 and ids[0] in ("self", "cls"):
                                key = (mod, cls_name, ids[1])
                                self.attr_ctor.setdefault(key, ctor)
                                ref = self._find_class(mod, imports, ctor)
                                if ref is not None:
                                    self.attr_types.setdefault(key, ref)
                scan(child, cls_name)

        scan(tree, None)

    # -- public class-table accessors (shared_state root discovery) --------

    def iter_classes(self):
        """-> (module, class name, {method name -> qual}) triples."""
        for mod, classes in self._classes.items():
            for cls_name, methods in classes.items():
                yield mod, cls_name, methods

    def class_bases(self, mod: str, cls_name: str) -> list[str]:
        """Dotted base names through the in-package inheritance chain
        (the class's own bases plus in-package ancestors' bases)."""
        out: list[str] = []
        seen = set()
        queue = [(mod, cls_name)]
        while queue:
            m, c = queue.pop(0)
            if (m, c) in seen:
                continue
            seen.add((m, c))
            for b in self._bases.get((m, c), []):
                out.append(b)
                if b in self._classes.get(m, {}):
                    queue.append((m, b))
        return out

    def _find_function(self, dotted: str) -> Optional[str]:
        """Fully-dotted path -> qualname, trying module prefixes longest
        first ("pkg.a.b.C.f" -> "pkg.a.b:C.f")."""
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            if mod in self.modules:
                rest = ".".join(parts[cut:])
                if not rest:
                    return None
                qual = f"{mod}:{rest}"
                if qual in self.functions:
                    return qual
                # class instantiation -> __init__
                init = f"{mod}:{rest}.__init__"
                if init in self.functions:
                    return init
                return None
        return None

    def _method_on(self, mod: str, cls_name: str, name: str) -> Optional[str]:
        """Method lookup through the in-package MRO (single inheritance
        chains only — enough for this codebase)."""
        seen = set()
        queue = [(mod, cls_name)]
        while queue:
            m, c = queue.pop(0)
            if (m, c) in seen:
                continue
            seen.add((m, c))
            qual = self._classes.get(m, {}).get(c, {}).get(name)
            if qual:
                return qual
            for b in self._bases.get((m, c), []):
                # base may be local ("Base") or imported — local only here
                if b in self._classes.get(m, {}):
                    queue.append((m, b))
        return None

    def _attr_type_on(
        self, mod: str, cls_name: str, attr: str
    ) -> Optional[tuple[str, str]]:
        """Attribute type lookup through the in-package MRO (declared in
        the class or any in-package ancestor)."""
        seen = set()
        queue = [(mod, cls_name)]
        while queue:
            m, c = queue.pop(0)
            if (m, c) in seen:
                continue
            seen.add((m, c))
            ref = self.attr_types.get((m, c, attr))
            if ref is not None:
                return ref
            for b in self._bases.get((m, c), []):
                if b in self._classes.get(m, {}):
                    queue.append((m, b))
        return None

    def attr_ctor_on(
        self, mod: str, cls_name: str, attr: str
    ) -> Optional[str]:
        """Constructor dotted name an attribute is assigned from, looked
        up through the in-package MRO ("threading.Event", ...)."""
        seen = set()
        queue = [(mod, cls_name)]
        while queue:
            m, c = queue.pop(0)
            if (m, c) in seen:
                continue
            seen.add((m, c))
            ctor = self.attr_ctor.get((m, c, attr))
            if ctor is not None:
                return ctor
            for b in self._bases.get((m, c), []):
                if b in self._classes.get(m, {}):
                    queue.append((m, b))
        return None

    def _resolve_ref(
        self,
        mod: str,
        imports: dict[str, str],
        enclosing: list[str],
        cls_name: Optional[str],
        local_types: dict[str, tuple[str, str]],
        d: str,
    ) -> Optional[str]:
        """Resolve a dotted function reference (call target or a function
        handed to Thread/submit/subscribe) to a qualname, or None."""
        if not d:
            return None
        head, _, rest = d.partition(".")
        if head in ("self", "cls") and cls_name:
            if rest and "." not in rest:
                return self._method_on(mod, cls_name, rest)
            if rest and rest.count(".") == 1:
                # one typed hop: self.liaison.probe -> Liaison.probe
                attr, _, meth = rest.partition(".")
                ref = self._attr_type_on(mod, cls_name, attr)
                if ref is not None:
                    return self._method_on(ref[0], ref[1], meth)
            return None
        if head in local_types and rest and "." not in rest:
            # typed local: srv = StandaloneServer(...); srv.start()
            return self._method_on(*local_types[head], rest)
        if head in imports:
            return self._find_function(
                imports[head] + (("." + rest) if rest else "")
            )
        if not rest:
            # bare name: enclosing nested scopes innermost-first, then
            # module-level function, then local class __init__
            for prefix in reversed(enclosing):
                qual = f"{mod}:{prefix}{head}"
                if qual in self.functions:
                    return qual
            if f"{mod}:{head}" in self.functions:
                return f"{mod}:{head}"
            if head in self._classes.get(mod, {}):
                return self._classes[mod].get(head, {}).get("__init__")
        return None

    def _resolve_call(
        self,
        mod: str,
        imports: dict[str, str],
        enclosing: list[str],
        cls_name: Optional[str],
        node: ast.Call,
        local_types: Optional[dict[str, tuple[str, str]]] = None,
    ) -> Optional[str]:
        return self._resolve_ref(
            mod,
            imports,
            enclosing,
            cls_name,
            local_types or {},
            dotted_name(node.func),
        )

    def _registrations_of(
        self,
        mod: str,
        imports: dict[str, str],
        enclosing: list[str],
        cls_name: Optional[str],
        local_types: dict[str, tuple[str, str]],
        node: ast.Call,
        fn_node: Optional[ast.AST] = None,
    ) -> list[Registration]:
        """Concurrency registrations made by this call, resolved to the
        function(s) that will run on another thread."""

        def resolve(expr: ast.AST) -> Optional[str]:
            return self._resolve_ref(
                mod, imports, enclosing, cls_name, local_types,
                dotted_name(expr),
            )

        def reg(kind: str, expr: ast.AST, name: str = "") -> list[Registration]:
            target = resolve(expr)
            if target is None and isinstance(expr, ast.Name) and fn_node:
                # the loops.py idiom: `for target, name in ((self._a,
                # "a"), (self._b, "b")): Thread(target=target)` — chase
                # the for-loop's literal iterable for every resolvable
                # function reference bound to this name
                return [
                    Registration(
                        kind=kind, target=t, name=n,
                        line=node.lineno, col=node.col_offset,
                    )
                    for t, n in self._loop_bound_targets(
                        fn_node, expr.id, resolve
                    )
                ]
            if target is None:
                return []
            return [
                Registration(
                    kind=kind,
                    target=target,
                    name=name,
                    line=node.lineno,
                    col=node.col_offset,
                )
            ]

        d = dotted_name(node.func)
        if d:
            # normalize the head through the import table, so
            # `import threading as _threading` still matches
            head, _, rest = d.partition(".")
            if head in imports:
                d = imports[head] + (("." + rest) if rest else "")
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        if d in ("threading.Thread", "Thread") and "target" in kw:
            name = ""
            if isinstance(kw.get("name"), ast.Constant):
                name = str(kw["name"].value)
            return reg("thread", kw["target"], name)
        if d in ("threading.Timer", "Timer"):
            fn = kw.get("function") or (
                node.args[1] if len(node.args) > 1 else None
            )
            return reg("timer", fn) if fn is not None else []
        if isinstance(node.func, ast.Attribute):
            if node.func.attr == "submit" and node.args:
                return reg("executor", node.args[0])
            if node.func.attr == "subscribe" and len(node.args) >= 2:
                return reg("subscriber", node.args[1])
        if d.endswith("ThreadingHTTPServer") and len(node.args) >= 2:
            # each request runs the handler class's do_* method on its
            # own thread: every one is a root
            ref = None
            hd = dotted_name(node.args[1])
            if hd and "." not in hd:
                if hd in self._classes.get(mod, {}):
                    ref = (mod, hd)
                else:
                    ref = self._find_class(mod, imports, hd)
            if ref is None:
                return []
            out = []
            for meth, qual in sorted(self._classes[ref[0]][ref[1]].items()):
                if meth.startswith("do_"):
                    out.append(
                        Registration(
                            kind="http",
                            target=qual,
                            name="",
                            line=node.lineno,
                            col=node.col_offset,
                        )
                    )
            return out
        return []

    @staticmethod
    def _loop_bound_targets(fn_node: ast.AST, var: str, resolve):
        """(target qual, thread name) pairs for a name bound by a for
        loop over a LITERAL tuple/list of (callable, name, ...) tuples —
        the table-driven thread-spawn idiom."""
        out = []
        for forn in ast.walk(fn_node):
            if not isinstance(forn, ast.For):
                continue
            tgt = forn.target
            idx = None
            if isinstance(tgt, ast.Name) and tgt.id == var:
                idx = -1  # bare `for target in (...)`
            elif isinstance(tgt, ast.Tuple):
                for i, el in enumerate(tgt.elts):
                    if isinstance(el, ast.Name) and el.id == var:
                        idx = i
            if idx is None or not isinstance(forn.iter, (ast.Tuple, ast.List)):
                continue
            for row in forn.iter.elts:
                expr = row
                name = ""
                if isinstance(row, (ast.Tuple, ast.List)) and idx >= 0:
                    if idx >= len(row.elts):
                        continue
                    expr = row.elts[idx]
                    consts = [
                        e.value
                        for e in row.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    ]
                    name = consts[0] if consts else ""
                q = resolve(expr)
                if q is not None:
                    out.append((q, name))
        return out

    def _resolve_module(
        self, mod: str, tree: ast.Module, imports: dict[str, str]
    ) -> None:
        def visit_fn(fn_node: ast.AST, qual: str, enclosing: list[str]) -> None:
            info = self.functions[qual]
            # typed locals first: `srv = StandaloneServer(...)` lets the
            # later `srv.start()` resolve (single-assignment idiom only —
            # a rebound name keeps its first type, conservatively)
            local_types: dict[str, tuple[str, str]] = {}
            for node in _walk_own(fn_node):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    ref = self._find_class(
                        mod, imports, dotted_name(node.value.func)
                    )
                    if ref is not None:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                local_types.setdefault(t.id, ref)
            for node in _walk_own(fn_node):
                if isinstance(node, ast.Call):
                    callee = self._resolve_call(
                        mod, imports, enclosing, info.cls, node, local_types
                    )
                    site = CallSite(
                        node=node,
                        callee=callee,
                        line=node.lineno,
                        col=node.col_offset,
                    )
                    info.calls.append(site)
                    info.registrations.extend(
                        self._registrations_of(
                            mod,
                            imports,
                            enclosing,
                            info.cls,
                            local_types,
                            node,
                            fn_node,
                        )
                    )
                    d = dotted_name(node.func)
                    if _is_sync_api(node):
                        info.direct_sync = d or node.func.attr
                    if d in _BLOCK_APIS or _is_transport_call(node):
                        info.direct_block = d or "transport.call"
            # lock regions: with-items whose context is lock-shaped
            for node in _walk_own(fn_node):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                for item in node.items:
                    lock_id = lock_identity(
                        item.context_expr, mod, info.cls, imports
                    )
                    if lock_id is None:
                        continue
                    region = LockRegion(lock_id=lock_id, node=node)
                    for inner in _walk_own(node):
                        if isinstance(inner, ast.Call):
                            region.calls.append(
                                CallSite(
                                    node=inner,
                                    callee=self._resolve_call(
                                        mod,
                                        imports,
                                        enclosing,
                                        info.cls,
                                        inner,
                                        local_types,
                                    ),
                                    line=inner.lineno,
                                    col=inner.col_offset,
                                )
                            )
                        elif isinstance(inner, (ast.With, ast.AsyncWith)):
                            for it in inner.items:
                                lid = lock_identity(
                                    it.context_expr, mod, info.cls, imports
                                )
                                if lid is not None:
                                    region.inner_locks.append((lid, inner))
                    info.lock_regions.append(region)

        def descend(node: ast.AST, prefix: str, enclosing: list[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{mod}:{prefix}{child.name}"
                    if qual in self.functions:
                        # a function's own prefix is in scope for its own
                        # body: `outer` calling its nested `h` resolves to
                        # "mod:outer.h", not the non-existent "mod:h"
                        inner = enclosing + [f"{prefix}{child.name}."]
                        visit_fn(child, qual, inner)
                        descend(child, f"{prefix}{child.name}.", inner)
                elif isinstance(child, ast.ClassDef):
                    descend(child, f"{child.name}.", enclosing)

        descend(tree, "", [])

    def _mark_traced(self, trees: dict, tables: dict) -> None:
        """Device regions: ``kernel``/``step``/``jitted`` functions (the
        executors' naming convention for what runs on device tensors)
        plus the nested def a builder returns (``_kernel_body``'s body,
        whatever its name)."""
        for qual, info in self.functions.items():
            name = qual.rsplit(".", 1)[-1].split(":")[-1]
            if is_device_region_name(name):
                info.traced = True
            if not is_builder_name(name):
                continue
            returned = {
                n.value.id
                for n in _walk_own(info.node)
                if isinstance(n, ast.Return) and isinstance(n.value, ast.Name)
            }
            for r in returned:
                inner = self.functions.get(f"{qual}.{r}")
                if inner is not None:
                    inner.traced = True

    # -- fact propagation --------------------------------------------------

    def _propagate(self) -> None:
        callers: dict[str, list[str]] = {}
        for qual, info in self.functions.items():
            for site in info.calls:
                if site.callee:
                    callers.setdefault(site.callee, []).append(qual)
            if info.direct_sync:
                info.sync = (info.direct_sync, ())
            if info.direct_block:
                info.block = (info.direct_block, ())
        work = [q for q, i in self.functions.items() if i.sync or i.block]
        while work:
            q = work.pop()
            info = self.functions[q]
            for caller in callers.get(q, ()):  # propagate up one edge
                ci = self.functions[caller]
                changed = False
                if info.sync and ci.sync is None:
                    ci.sync = (info.sync[0], (q, *info.sync[1]))
                    changed = True
                if info.block and ci.block is None:
                    ci.block = (info.block[0], (q, *info.block[1]))
                    changed = True
                if changed:
                    work.append(caller)

    def lock_acquires(self) -> dict[str, set[str]]:
        """qual -> set of lock ids the function may (transitively)
        acquire.  Fixed point over the call graph."""
        acq: dict[str, set[str]] = {
            q: {r.lock_id for r in i.lock_regions}
            for q, i in self.functions.items()
        }
        changed = True
        while changed:
            changed = False
            for q, info in self.functions.items():
                for site in info.calls:
                    if site.callee and site.callee in acq:
                        extra = acq[site.callee] - acq[q]
                        if extra:
                            acq[q] |= extra
                            changed = True
        return acq


def _chain(start: str, fact: tuple[str, tuple[str, ...]]) -> str:
    api, path = fact
    hops = " -> ".join(
        q.split(":", 1)[1] + f" ({q.split(':', 1)[0].split('.')[-1]})"
        for q in path
    )
    return f"{start} -> {hops} -> {api}" if hops else f"{start} -> {api}"


def analyze_sync_in_kernel(program: Program) -> list[Finding]:
    """Calls inside device regions whose callee transitively syncs or
    blocks.  Depth-0 (direct API) calls are the per-file rule's job —
    only the cross-function reach is reported here."""
    findings: list[Finding] = []
    for info in program.functions.values():
        if not info.traced:
            continue
        for site in info.calls:
            if not site.callee or _is_sync_api(site.node):
                continue
            callee = program.functions.get(site.callee)
            if callee is None:
                continue
            short = site.callee.split(":", 1)[1]
            if callee.sync:
                findings.append(
                    Finding(
                        path=info.path,
                        line=site.line,
                        col=site.col,
                        rule="wp-sync-in-kernel",
                        message=(
                            f"device region `{info.qual.split(':', 1)[1]}` "
                            f"calls `{short}` which transitively performs "
                            f"a host sync: {_chain(short, callee.sync)}; "
                            "it stalls the per-chunk pipeline, so syncs "
                            "belong at the result boundary (device_get)"
                        ),
                    )
                )
            elif callee.block:
                findings.append(
                    Finding(
                        path=info.path,
                        line=site.line,
                        col=site.col,
                        rule="wp-sync-in-kernel",
                        message=(
                            f"device region `{info.qual.split(':', 1)[1]}` "
                            f"calls `{short}` which transitively blocks: "
                            f"{_chain(short, callee.block)}; a device "
                            "region must stay pure device work"
                        ),
                    )
                )
    return findings


def analyze_lock_blocking(program: Program) -> list[Finding]:
    """The interprocedural extension of lock-across-rpc: a call made
    while holding a lock whose callee (transitively) blocks.  Direct
    blocking calls in the region are the per-file rule's findings and
    are not duplicated here."""
    findings: list[Finding] = []
    for info in program.functions.values():
        for region in info.lock_regions:
            for site in region.calls:
                if not site.callee:
                    continue
                callee = program.functions.get(site.callee)
                if callee is None or not callee.block:
                    continue
                if callee.qual == info.qual:
                    continue
                short = site.callee.split(":", 1)[1]
                findings.append(
                    Finding(
                        path=info.path,
                        line=site.line,
                        col=site.col,
                        rule="wp-lock-blocking",
                        message=(
                            f"`{short}` transitively blocks "
                            f"({_chain(short, callee.block)}) while "
                            f"`{region.lock_id}` is held; snapshot under "
                            "the lock, call outside it"
                        ),
                    )
                )
    return findings
