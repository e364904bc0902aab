"""gleak-style thread / file-descriptor leak tracking.

The reference's integration suites wrap every test in gleak's
goroutine-leak assertion; this is the Python analog for the two resource
kinds that actually leak here: threads and fds.

- Threads: snapshot the alive Thread objects, run, then require the set
  to return to baseline (minus allowlisted daemons) within a grace
  window — most stop() paths signal first and join with a timeout, so a
  freshly stopped thread needs a beat to exit.
- Fds: /proc/self/fd snapshots (Linux-only; degrade to empty sets
  elsewhere).  A gc.collect() runs before the final comparison so
  dropped-but-uncollected sockets/files don't read as leaks.

The allowlist names *process-wide singletons by design* — things a test
cannot and should not tear down.  Everything else that lingers is a bug:
fix the owner's stop()/close() instead of widening this list.
"""

from __future__ import annotations

import gc
import os
import re
import threading
import time
from dataclasses import dataclass

# Process-lifetime daemons, matched against Thread.name:
# - pytest-timeout/faulthandler helpers have no Python-visible threads;
# - grpc's default executor threads appear when channels use the global
#   pool (process-wide, reused, never joined by design); the list is
#   the JAX package's, so both packages' trackers allow the same names.
DEFAULT_THREAD_ALLOWLIST: tuple[str, ...] = (
    r"^grpc-default-executor",
    r"^asyncio_\d+$",
    r"^pydevd\.",
)

# fd targets that belong to process-wide singletons created lazily on
# first use (grpc's global event engine allocates one epoll + eventfd
# pair per process and keeps them for the process lifetime) — a scoped
# tracker cannot account for them.  Real file/socket leaks have concrete
# paths and never match.
DEFAULT_FD_TARGET_ALLOWLIST: tuple[str, ...] = (
    r"^anon_inode:\[event",
)


def thread_snapshot() -> frozenset:
    """Baseline snapshot of live threads.  Snapshots the Thread OBJECTS
    (compared by identity), not bare idents — CPython recycles thread
    identifiers, so an ident-keyed baseline would silently miss a leaked
    thread that inherited a dead baseline thread's id."""
    return frozenset(threading.enumerate())


def leaked_threads(
    before: frozenset,
    allowlist: tuple = DEFAULT_THREAD_ALLOWLIST,
    grace_s: float = 2.0,
) -> list:
    """Alive threads that were not in ``before`` and match no allowlist
    pattern, after waiting up to ``grace_s`` for them to finish."""
    pats = [re.compile(p) for p in allowlist]
    deadline = time.monotonic() + grace_s
    while True:
        leaked = [
            t
            for t in threading.enumerate()
            if t.is_alive()
            and t not in before
            and not any(p.search(t.name or "") for p in pats)
        ]
        if not leaked or time.monotonic() >= deadline:
            return leaked
        time.sleep(0.05)


def process_snapshot() -> frozenset:
    """Baseline snapshot of registered child processes (the worker
    pool's subprocesses report spawn/reap through utils.procreg)."""
    from banyandb_tpu_torch.utils import procreg

    return procreg.snapshot()


def leaked_processes(before: frozenset, grace_s: float = 2.0) -> list:
    """(pid, label) for child processes spawned during the scope that
    are still registered — a worker the owner neither stopped nor
    reaped.  The grace window covers a stop() racing the check."""
    from banyandb_tpu_torch.utils import procreg

    deadline = time.monotonic() + grace_s
    while True:
        leaked = procreg.live(exclude=before)
        if not leaked or time.monotonic() >= deadline:
            return leaked
        time.sleep(0.05)


def open_fds() -> set:
    """Open descriptor numbers (Linux /proc; empty set elsewhere)."""
    try:
        return {int(n) for n in os.listdir("/proc/self/fd")}
    except (OSError, ValueError):
        return set()


def fd_target(fd: int) -> str:
    try:
        return os.readlink(f"/proc/self/fd/{fd}")
    except OSError:
        return "<gone>"


def leaked_fds(
    before: set,
    grace_s: float = 1.0,
    target_allowlist: tuple = DEFAULT_FD_TARGET_ALLOWLIST,
) -> list:
    """(fd, target) pairs open now but not at snapshot time.  Collects
    garbage first so unreferenced handles don't count; retries inside the
    grace window because close() on another thread may still be racing."""
    pats = [re.compile(p) for p in target_allowlist]
    deadline = time.monotonic() + grace_s
    while True:
        gc.collect()
        extra = sorted(open_fds() - before)
        # /proc/self/fd listing includes the listing's own dirfd: a lone
        # phantom entry whose target is the fd directory itself is noise
        pairs = [
            (fd, fd_target(fd))
            for fd in extra
        ]
        pairs = [
            p
            for p in pairs
            if p[1] != "<gone>" and not any(r.search(p[1]) for r in pats)
        ]
        if not pairs or time.monotonic() >= deadline:
            return pairs
        time.sleep(0.05)


@dataclass
class LeakReport:
    threads: list
    fds: list
    procs: list = None  # type: ignore[assignment]

    def clean(self) -> bool:
        return not self.threads and not self.fds and not self.procs

    def render(self) -> str:
        lines = []
        for t in self.threads:
            lines.append(f"leaked thread: {t.name} (ident={t.ident})")
        for fd, target in self.fds:
            lines.append(f"leaked fd: {fd} -> {target}")
        for pid, label in self.procs or ():
            lines.append(f"leaked process: {label} (pid={pid})")
        return "\n".join(lines) or "clean"


class LeakTracker:
    """Scoped tracker: snapshot() ... check() -> LeakReport."""

    def __init__(
        self,
        *,
        thread_allowlist: tuple = DEFAULT_THREAD_ALLOWLIST,
        track_fds: bool = True,
    ):
        self.thread_allowlist = tuple(thread_allowlist)
        self.track_fds = track_fds
        self._threads: set = set()
        self._fds: set = set()
        self._procs: frozenset = frozenset()

    def snapshot(self) -> "LeakTracker":
        self._threads = thread_snapshot()
        self._fds = open_fds() if self.track_fds else set()
        self._procs = process_snapshot()
        return self

    def check(self, grace_s: float = 2.0) -> LeakReport:
        threads = leaked_threads(
            self._threads, self.thread_allowlist, grace_s=grace_s
        )
        fds = (
            leaked_fds(self._fds, grace_s=min(grace_s, 1.0))
            if self.track_fds
            else []
        )
        procs = leaked_processes(self._procs, grace_s=min(grace_s, 2.0))
        return LeakReport(threads=threads, fds=fds, procs=procs)
