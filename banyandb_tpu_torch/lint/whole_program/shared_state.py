"""wp-shared-state: whole-program cross-thread attribute race analysis.

The reference gates every merge on ``go test -race``; this is the static
half of the Python analog (the runtime half is ``banyandb_tpu_torch/sanitize``).
Four passes over the callgraph.Program:

1. **Root discovery** — every function that can run on a thread of its
   own: ``threading.Thread(target=...)`` / ``threading.Timer`` targets,
   ``pool.submit`` callables, ``bus.subscribe`` handlers (the gRPC bus
   server dispatches every topic handler on executor threads),
   ``ThreadingHTTPServer`` handler-class ``do_*`` methods, and — by the
   documented class-name convention — public methods of ``*Services`` /
   ``*Servicer`` classes (the wire-plane gRPC surface, which the server
   binds through generic handler tables the resolver cannot follow).
2. **Access collection** — per-class attribute reads/writes with
   *declaration-based* identity (``module.Class.attr``, the same scheme
   lockorder.py uses for locks).  Writes include direct rebinding,
   ``self.x[k] = v`` container stores, augmented assignment, ``del`` and
   known mutator calls (``self.x.append(...)``).  ``__init__`` bodies are
   exempt (Thread.start() publishes constructor writes with a
   happens-before edge), as are attributes declared as thread-safe
   primitives (Event/Condition/Semaphore/Queue/local) and the locks
   themselves.
3. **Must-hold lockset propagation** — per root, the set of locks
   *always* held when control reaches each function: intersection over
   call paths, seeded by lexical ``with <lock>:`` scoping at every call
   site (RLocks guard exactly like Locks; reentrancy only matters to the
   self-deadlock rule).
4. **Race report** — an attribute written from >= 2 distinct roots whose
   write-site guard sets share no common lock is one finding, anchored
   at the first write, with a witness chain per root.  Pre-existing
   accepted states ride a ratcheted ``BASELINE`` (same contract as
   layering: a fixed entry must be deleted, a new race fails).

Resolution is conservative (unresolvable calls create no reachability),
so a clean report means "no race among the facts the resolver can see" —
the runtime sanitizer covers the dynamic remainder.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterable, Optional

from banyandb_tpu_torch.lint.core import Finding, apply_ratchet
from banyandb_tpu_torch.lint.whole_program.callgraph import (
    FuncInfo,
    Program,
    lock_identity,
)

RULE = "wp-shared-state"

# The ratchet.  Keys are attribute identities ("module.Class.attr").
# Empty by policy: new cross-thread state must ship guarded (or carry a
# reasoned per-line suppression at the write site).  A stale entry —
# one whose race no longer exists — fails the gate so the set only
# shrinks.
BASELINE: frozenset[str] = frozenset()

# Constructors whose instances are internally synchronized: attribute
# reads/mutations through them are not data races.
_SYNC_CTORS = {
    "threading.Event",
    "Event",
    "threading.Condition",
    "Condition",
    "threading.Semaphore",
    "Semaphore",
    "threading.BoundedSemaphore",
    "BoundedSemaphore",
    "threading.Barrier",
    "Barrier",
    "threading.local",
    "local",
    "queue.Queue",
    "Queue",
    "queue.SimpleQueue",
    "SimpleQueue",
    "queue.LifoQueue",
    "LifoQueue",
    "queue.PriorityQueue",
    "PriorityQueue",
    # deque.append/popleft are documented GIL-atomic: the single-producer
    # queue idioms built on it (schema watcher events) are not races
    "collections.deque",
    "deque",
}

# Mutating container methods: `self.x.append(v)` writes x's value even
# though the attribute binding itself is only read.
_MUTATORS = {
    "append",
    "appendleft",
    "add",
    "clear",
    "discard",
    "extend",
    "insert",
    "pop",
    "popitem",
    "popleft",
    "remove",
    "setdefault",
    "update",
}

_SERVICER_SUFFIXES = ("Services", "Servicer")
_HTTP_HANDLER_BASES = ("BaseHTTPRequestHandler",)

# Worker-entry functions: each runs as the MAIN thread of a spawned
# subprocess (``python -m banyandb_tpu_torch.cluster.workers``).  The static
# Thread/Timer/subscribe discovery cannot see across an exec boundary,
# so process entries are declared here — everything one reaches is a
# concurrent root population exactly like a Thread target (the worker's
# serve loop then spawns its own writer/executor threads, which the
# ordinary registration discovery picks up inside the entry's closure).
_PROCESS_ENTRY_QUALS = (
    "banyandb_tpu_torch.cluster.workers:worker_main",
    "banyandb_tpu_torch.cluster.workers:_WorkerServer.serve",
)


@dataclass(frozen=True)
class Root:
    qual: str
    kind: str  # thread|timer|executor|subscriber|http|grpc
    label: str


@dataclass(frozen=True)
class Access:
    attr: str  # "module.Class.attr" declaration-based identity
    qual: str  # function containing the access
    path: str
    line: int
    col: int
    write: bool
    locks: frozenset  # lexically-held lock ids at the access site


def discover_roots(program: Program) -> list[Root]:
    """Every thread entry point the resolver can see, one Root per
    distinct target function (first registration's label wins)."""
    roots: dict[str, Root] = {}

    def put(qual: str, kind: str, label: str) -> None:
        roots.setdefault(qual, Root(qual=qual, kind=kind, label=label))

    for info in program.functions.values():
        for r in info.registrations:
            short = r.target.split(":", 1)[1]
            label = f'{r.kind} "{r.name}"' if r.name else f"{r.kind} {short}"
            put(r.target, r.kind, label)
    for qual in _PROCESS_ENTRY_QUALS:
        if qual in program.functions:
            short = qual.split(":", 1)[1]
            put(qual, "process", f"process {short}")
    for mod, cls_name, methods in program.iter_classes():
        if cls_name.endswith(_SERVICER_SUFFIXES):
            for meth, qual in sorted(methods.items()):
                if not meth.startswith("_"):
                    put(qual, "grpc", f"grpc {cls_name}.{meth}")
        elif any(
            b.split(".")[-1] in _HTTP_HANDLER_BASES
            for b in program.class_bases(mod, cls_name)
        ):
            for meth, qual in sorted(methods.items()):
                if meth.startswith("do_"):
                    put(qual, "http", f"http {cls_name}.{meth}")
    return sorted(roots.values(), key=lambda r: r.qual)


def _is_self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in ("self", "cls")
    ):
        return node.attr
    return None


def collect_accesses(program: Program) -> list[Access]:
    """Per-class attribute accesses with lexical lock context, whole
    package.  ``__init__`` bodies, lock attributes and synchronized
    primitives are exempt (see module docstring)."""
    out: list[Access] = []
    for info in program.functions.values():
        if info.cls is None:
            continue
        if info.qual.split(":", 1)[1].split(".")[-1] == "__init__":
            continue
        imports = program.tables.get(info.module, {})
        _scan_function(program, info, imports, out)
    return out


def _scan_function(
    program: Program,
    info: FuncInfo,
    imports: dict,
    out: list[Access],
) -> None:
    mod, cls = info.module, info.cls

    def exempt(attr: str) -> bool:
        if "lock" in attr.lower():
            return True  # the guards themselves
        ctor = program.attr_ctor_on(mod, cls, attr)
        return ctor in _SYNC_CTORS

    def emit(node: ast.AST, attr: str, write: bool, locks: frozenset) -> None:
        if exempt(attr):
            return
        out.append(
            Access(
                attr=f"{mod}.{cls}.{attr}",
                qual=info.qual,
                path=info.path,
                line=node.lineno,
                col=node.col_offset,
                write=write,
                locks=locks,
            )
        )

    def visit(node: ast.AST, locks: frozenset, parent: Optional[ast.AST]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return  # nested defs are their own FuncInfo
        attr = _is_self_attr(node)
        if attr is not None:
            ctx = getattr(node, "ctx", None)
            if isinstance(ctx, (ast.Store, ast.Del)):
                emit(node, attr, True, locks)
            else:
                write = False
                if isinstance(parent, ast.Subscript) and isinstance(
                    getattr(parent, "ctx", None), (ast.Store, ast.Del)
                ):
                    # self.x[k] = v / del self.x[k]; an AugAssign target
                    # subscript also carries Store ctx, so += is covered
                    write = True
                elif (
                    isinstance(parent, ast.Attribute)
                    and parent.attr in _MUTATORS
                    and isinstance(
                        getattr(parent, "parent_call", None), ast.Call
                    )
                ):
                    write = True  # self.x.append(v)
                emit(node, attr, write, locks)
        inner = locks
        if isinstance(node, (ast.With, ast.AsyncWith)):
            ids = set()
            for item in node.items:
                lid = lock_identity(item.context_expr, mod, cls, imports)
                if lid is not None:
                    ids.add(lid)
            inner = locks | frozenset(ids)
        for child in ast.iter_child_nodes(node):
            # annotate the parent shape the mutator classifier needs
            if isinstance(node, ast.Call) and child is node.func:
                child.parent_call = node  # type: ignore[attr-defined]
            visit(child, inner, node)

    for child in ast.iter_child_nodes(info.node):
        visit(child, frozenset(), info.node)


def _lexical_call_locks(info: FuncInfo) -> dict[int, frozenset]:
    """id(call ast node) -> lock ids lexically held around that call."""
    held: dict[int, set] = {}
    for region in info.lock_regions:
        for site in region.calls:
            held.setdefault(id(site.node), set()).add(region.lock_id)
    return {k: frozenset(v) for k, v in held.items()}


def must_hold(
    program: Program, root_qual: str
) -> tuple[dict[str, frozenset], dict[str, Optional[tuple[str, int]]]]:
    """-> (entry locksets, witness parents) for everything reachable from
    ``root_qual``.  entry[q] is the intersection over all discovered call
    paths of the locks held when q is entered; parents[q] names the
    first-discovered caller for witness chains."""
    entry: dict[str, frozenset] = {root_qual: frozenset()}
    parents: dict[str, Optional[tuple[str, int]]] = {root_qual: None}
    work = [root_qual]
    while work:
        q = work.pop()
        info = program.functions.get(q)
        if info is None:
            continue
        if q.split(".")[-1] == "__init__" and q != root_qual:
            # construction is pre-publication: whatever a constructor
            # (and its helpers) writes becomes visible to other threads
            # only through the publishing store that follows, so call
            # edges out of __init__ carry no shared-state reachability
            continue
        base = entry[q]
        lex = _lexical_call_locks(info)
        for site in info.calls:
            callee = site.callee
            if not callee or callee not in program.functions:
                continue
            cand = base | lex.get(id(site.node), frozenset())
            cur = entry.get(callee)
            if cur is None:
                entry[callee] = cand
                parents[callee] = (q, site.line)
                work.append(callee)
            else:
                inter = cur & cand
                if inter != cur:
                    entry[callee] = inter
                    work.append(callee)
    return entry, parents


def _witness(
    parents: dict[str, Optional[tuple[str, int]]], qual: str
) -> str:
    """root -> ... -> qual as short function names."""
    chain = []
    cur: Optional[str] = qual
    seen = set()
    while cur is not None and cur not in seen:
        seen.add(cur)
        chain.append(cur.split(":", 1)[1])
        nxt = parents.get(cur)
        cur = nxt[0] if nxt else None
    return " -> ".join(reversed(chain))


def analyze_shared_state(
    program: Program,
    baseline: frozenset = BASELINE,
    baseline_path: str = "<shared-state-baseline>",
    roots: Optional[list[Root]] = None,
) -> list[Finding]:
    if roots is None:
        roots = discover_roots(program)
    accesses = collect_accesses(program)
    by_fn: dict[str, list[Access]] = {}
    for a in accesses:
        by_fn.setdefault(a.qual, []).append(a)

    # attr -> {root qual -> (witness, [guard sets of write accesses],
    #          first write access)}
    writes: dict[str, dict[str, tuple[str, list, Access]]] = {}
    labels = {r.qual: r.label for r in roots}
    for root in roots:
        entry, parents = must_hold(program, root.qual)
        for qual, held in entry.items():
            for a in by_fn.get(qual, ()):
                if not a.write:
                    continue
                guards = held | a.locks
                rec = writes.setdefault(a.attr, {})
                if root.qual in rec:
                    w, gs, first = rec[root.qual]
                    gs.append(guards)
                    if (a.path, a.line) < (first.path, first.line):
                        rec[root.qual] = (w, gs, a)
                else:
                    rec[root.qual] = (_witness(parents, qual), [guards], a)

    violations: list[tuple[str, Finding]] = []
    for attr in sorted(writes):
        rec = writes[attr]
        if len(rec) < 2:
            continue
        common: Optional[frozenset] = None
        for _w, guard_sets, _a in rec.values():
            for g in guard_sets:
                common = g if common is None else (common & g)
        if common:
            continue
        anchor = min(
            (a for _w, _g, a in rec.values()), key=lambda a: (a.path, a.line)
        )
        chains = "; ".join(
            f"[{labels[rq]}] {w}"
            for rq, (w, _g, _a) in sorted(rec.items())[:3]
        )
        more = len(rec) - min(len(rec), 3)
        violations.append(
            (
                attr,
                Finding(
                    path=anchor.path,
                    line=anchor.line,
                    col=anchor.col,
                    rule=RULE,
                    message=(
                        f"`{attr}` is written from {len(rec)} thread roots "
                        f"with no common lock guard: {chains}"
                        + (f" (+{more} more roots)" if more else "")
                        + "; guard the writes with one shared lock, or "
                        "document the invariant and suppress at the write"
                    ),
                ),
            )
        )
    return apply_ratchet(
        violations,
        baseline,
        rule=RULE,
        baseline_path=baseline_path,
        what="the shared-state race",
    )


def iter_root_labels(program: Program) -> Iterable[str]:
    """Debug/docs helper: the discovered root population."""
    for r in discover_roots(program):
        yield f"{r.kind:10s} {r.qual}"
