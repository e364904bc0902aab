"""Instrumented locks: runtime half of the bdsan lock-order contract
(the port's copy of banyandb_tpu/sanitize/lockwatch.py, over the port's
call graph, lock declarations and reviewed extra edges).

``install()`` replaces ``threading.Lock``/``threading.RLock`` with
factories that wrap locks *created from package code* in a
:class:`TracedLock`.  Each traced lock carries the same
declaration-based identity the static analyzers use
(``module.Class.attr``, mapped through ``Program.lock_sites`` by the
constructor call's source location); locks created outside the package
(stdlib internals, grpc, tests) come back untouched.

Every acquisition records *lock-order witness edges*: acquiring B while
holding A appends the edge ``A -> B`` (first witness only, with thread
name and source site).  The set of runtime-observed edges is compared
against the **declared graph** — the static acquires-while-holding graph
(``lockorder.build_lock_graph``) plus the checked-in
``DECLARED_EXTRA_EDGES`` below for nestings the conservative resolver
cannot see.  A runtime edge between two declaration-mapped locks that is
absent from the declared graph is an ordering the tree never audited:
the stress tests fail on it, and a ``LockWatch`` constructed with an
explicit ``declared`` set reports it as a violation immediately.

Semantics notes:

- Reentrant re-acquisition of the *same declaration* never records an
  edge (two instances of one class share an identity, exactly like the
  static graph — cross-instance ordering is the static self-edge rule's
  business).
- ``Condition`` built on a traced RLock bypasses instrumentation inside
  ``wait()`` (``_release_save``/``_acquire_restore`` delegate to the
  real lock), symmetrically: the held-set stays consistent.
"""

from __future__ import annotations

import os.path
import sys
import threading
from dataclasses import dataclass, field
from typing import Optional

# Real constructors, captured at import time so the watch's own
# bookkeeping lock and the "not package code" fast path never recurse
# into the traced factories.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

# Runtime-observed lock nestings that are REAL and SAFE but invisible to
# the static resolver (calls through untyped variables, e.g.
# ``seg.shards[i].ingest(...)``).  Every entry is a reviewed declaration:
# adding one is an architecture decision, like a layering baseline edit,
# and tests/test_torch_sanitize.py proves the union graph stays acyclic.
# Format: (held id, acquired id).  The first six are the reference's,
# re-keyed; the rest were witnessed by the sanitized server run of
# chip_smoke.py (phase 19: ingest, queries, a concurrent writer, the
# self-trace sink and the lifecycle flusher) and hold in the reference's
# code too.  The static graph's own port-only edges (WriteQueue._pass_lock
# over the queue's state, fault and meter locks; hopper_kernels._lib_lock
# over the build cache's counters) need no entry here; _scan_lock
# (hopper_kernels) takes no other lock and nests under none the run saw.
_NOTIFY = "banyandb_tpu_torch.api.schema.SchemaRegistry._notify_lock"
_REG = "banyandb_tpu_torch.api.schema.SchemaRegistry._lock"
_SELF_TRACE = "banyandb_tpu_torch.obs.selftrace.SelfTraceSink._schema_lock"
_SIDX = "banyandb_tpu_torch.index.sidx.SidxStore"
DECLARED_EXTRA_EDGES: frozenset[tuple[str, str]] = frozenset(
    {
        # engine._tsdb getter reads group opts from the registry while
        # holding the engine map lock (one-way: the registry never calls
        # back into engines)
        (
            "banyandb_tpu_torch.models.measure.MeasureEngine._tsdb_lock",
            "banyandb_tpu_torch.api.schema.SchemaRegistry._lock",
        ),
        # the schema-event drainer holds _notify_lock while delivering
        # watcher callbacks, which read the registry (get_group under
        # _lock), mirror into the property plane (PropertyEngine +
        # InvertedIndex locks) and fan out to watch streams (WatchHub).
        # One-way: mutators queue events under _lock and drain OUTSIDE
        # it, and no watcher target ever re-enters the drainer.
        (_NOTIFY, "banyandb_tpu_torch.api.schema.SchemaRegistry._lock"),
        (_NOTIFY, "banyandb_tpu_torch.cluster.schema_plane.WatchHub._lock"),
        (_NOTIFY, "banyandb_tpu_torch.index.inverted.InvertedIndex._lock"),
        (_NOTIFY, "banyandb_tpu_torch.models.property.PropertyEngine._lock"),
        # shard.ingest serializes the memtable swap, then appends under
        # the memtable's own lock (flush takes them in the same order)
        (
            "banyandb_tpu_torch.storage.tsdb.Shard._lock",
            "banyandb_tpu_torch.storage.memtable.MemTable._lock",
        ),
        # the same swap-then-append for the trace and stream shards'
        # payload memtables
        (
            "banyandb_tpu_torch.storage.tsdb.Shard._lock",
            "banyandb_tpu_torch.storage.memtable.PayloadMemtable._lock",
        ),
        # the trace engine's _tsdb getter reads group opts exactly as the
        # measure engine's does (one-way, as above)
        ("banyandb_tpu_torch.models.trace.TraceEngine._tsdb_lock", _REG),
        # the self-trace sink creates `_monitoring` and its trace once,
        # under its schema lock, through the registry (an untyped local
        # the resolver cannot follow): the registry lock, then the
        # drainer and its watcher targets.  One-way: no registry watcher
        # calls into the sink.
        (_SELF_TRACE, _REG),
        (_SELF_TRACE, _NOTIFY),
        (_SELF_TRACE, "banyandb_tpu_torch.cluster.schema_plane.WatchHub._lock"),
        (_SELF_TRACE, "banyandb_tpu_torch.index.inverted.InvertedIndex._lock"),
        (_SELF_TRACE, "banyandb_tpu_torch.models.property.PropertyEngine._lock"),
        # sidx flush and merge are serialized by their own locks, taken
        # with explicit acquire() (a staged flush holds the flush lock
        # until commit), and read or publish the store's state under
        # _lock inside them; _lock never waits for either
        (f"{_SIDX}._flush_lock", f"{_SIDX}._lock"),
        (f"{_SIDX}._merge_lock", f"{_SIDX}._lock"),
    }
)


@dataclass
class EdgeWitness:
    held: str
    acquired: str
    thread: str
    site: str  # "file:line" of the acquiring frame


@dataclass
class LockWatch:
    """Edge recorder + (optional) immediate validator.

    declared=None records only; a set of (held, acquired) ids validates
    every new mapped edge on the spot (seeded tests use this)."""

    declared: Optional[frozenset] = None
    reentrant: frozenset = frozenset()
    _mu: object = field(default_factory=_REAL_LOCK)
    _tls: threading.local = field(default_factory=threading.local)

    def __post_init__(self):
        self.edges: dict[tuple[str, str], EdgeWitness] = {}
        self.violations: list[EdgeWitness] = []

    # -- per-thread held stack ------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquire(self, lock_id: str) -> None:
        st = self._stack()
        fresh = [
            (h, lock_id)
            for h in dict.fromkeys(st)
            if h != lock_id and (h, lock_id) not in self.edges
        ]
        st.append(lock_id)
        if not fresh:
            return
        site = _caller_site()
        tname = threading.current_thread().name
        with self._mu:
            for e in fresh:
                if e in self.edges:
                    continue
                w = EdgeWitness(e[0], e[1], tname, site)
                self.edges[e] = w
                if (
                    self.declared is not None
                    and is_declared_id(e[0])
                    and is_declared_id(e[1])
                    and e not in self.declared
                ):
                    self.violations.append(w)

    def note_release(self, lock_id: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == lock_id:
                del st[i]
                return

    # -- snapshots -------------------------------------------------------
    def snapshot_edges(self) -> dict[tuple[str, str], EdgeWitness]:
        with self._mu:
            return dict(self.edges)

    def snapshot_violations(self) -> list[EdgeWitness]:
        with self._mu:
            return list(self.violations)


class TracedLock:
    """Lock/RLock proxy feeding a LockWatch.  Unknown attributes
    delegate to the real lock (Condition integration)."""

    def __init__(self, real, lock_id: str, watch: LockWatch):
        self._real = real
        self.lock_id = lock_id
        self._watch = watch

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._watch.note_acquire(self.lock_id)
        return ok

    def release(self):
        self._real.release()
        self._watch.note_release(self.lock_id)

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __repr__(self):
        return f"<TracedLock {self.lock_id} of {self._real!r}>"


# -- static model + global installation ---------------------------------


@dataclass(frozen=True)
class StaticLockModel:
    decl_sites: dict  # (abs path, lineno) -> lock id
    declared: frozenset  # (held, acquired) edges, extras included
    reentrant: frozenset


_model: Optional[StaticLockModel] = None
_watch: Optional[LockWatch] = None
_installed = False
_pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_static() -> StaticLockModel:
    """Build (once) the static lock model from the package AST — the
    declaration-site map and the declared acquires-while-holding graph."""
    global _model
    if _model is None:
        from pathlib import Path

        import banyandb_tpu_torch
        from banyandb_tpu_torch.lint.whole_program.callgraph import Program
        from banyandb_tpu_torch.lint.whole_program.lockorder import build_lock_graph

        pkg = Path(banyandb_tpu_torch.__file__).parent
        program = Program.build(pkg, "banyandb_tpu_torch")
        edges = frozenset(
            (e.held, e.acquired) for e in build_lock_graph(program)
        )
        _model = StaticLockModel(
            decl_sites={
                (os.path.abspath(p), ln): lid
                for (p, ln), lid in program.lock_sites.items()
            },
            declared=edges | DECLARED_EXTRA_EDGES,
            reentrant=frozenset(program.reentrant_locks),
        )
    return _model


def is_declared_id(lock_id: str) -> bool:
    """Ids mapped to a static declaration are dotted; fallback ids for
    unmapped package locks carry a ':'."""
    return ":" not in lock_id


def watch() -> LockWatch:
    global _watch
    if _watch is None:
        _watch = LockWatch()
    return _watch


def _caller_site() -> str:
    """First frame outside this module — where the acquisition happened."""
    f = sys._getframe(1)
    here = os.path.abspath(__file__)
    while f is not None and os.path.abspath(f.f_code.co_filename) == here:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def _creation_site() -> Optional[tuple[str, int]]:
    """(abs path, lineno) of the Lock() construction when it happens in
    package code (sanitize/ itself excluded), else None."""
    f = sys._getframe(2)  # factory -> caller
    if f is None:
        return None
    path = os.path.abspath(f.f_code.co_filename)
    if not path.startswith(_pkg_dir + os.sep):
        return None
    if os.sep + "sanitize" + os.sep in path:
        return None
    return (path, f.f_lineno)


def _identify(site: tuple[str, int]) -> str:
    m = load_static()
    lid = m.decl_sites.get(site)
    if lid is not None:
        return lid
    rel = os.path.relpath(site[0], os.path.dirname(_pkg_dir))
    return f"{rel}:{site[1]}"


def _lock_factory():
    real = _REAL_LOCK()
    site = _creation_site()
    if site is None:
        return real
    return TracedLock(real, _identify(site), watch())


def _rlock_factory():
    real = _REAL_RLOCK()
    site = _creation_site()
    if site is None:
        return real
    return TracedLock(real, _identify(site), watch())


def install() -> None:
    """Patch threading.Lock/RLock with tracing factories (idempotent).
    Loads the static model eagerly so every subsequently created package
    lock maps to its declaration id."""
    global _installed
    if _installed:
        return
    load_static()
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _installed = True


def installed() -> bool:
    return _installed


def undeclared_edges(
    edges=None,
) -> list[EdgeWitness]:
    """Runtime-observed edges between declaration-mapped locks that the
    declared graph does not contain — the stress tests' consistency
    assertion.  Pass an explicit edge dict (e.g. the delta observed
    during a stress window) or default to everything seen so far."""
    m = load_static()
    src = edges if edges is not None else watch().snapshot_edges()
    out = []
    for (a, b), w in sorted(src.items()):
        if a == b or not (is_declared_id(a) and is_declared_id(b)):
            continue
        if (a, b) not in m.declared:
            out.append(w)
    return out
