"""Child-process registry for leak tracking (bdsan process hygiene).

Owners of child processes (the shard-worker pool, cluster/workers.py)
register every spawn and unregister on reap; the sanitize LeakTracker
(sanitize/leaks.py) reads the registry to assert that no test leaves a
worker process running or unreaped — the process analog of the
gleak-style thread-parity check.

A registered pid counts as leaked whether or not the process still
runs: an exited-but-unregistered child is a reap the owner forgot
(close() was never called), which is exactly what the check exists to
catch.

Lives in utils (L0) so fabric-layer owners can report downward while
the L6 sanitizer reads without an upward import edge.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
_PROCS: dict[int, str] = {}  # pid -> label


def register(pid: int, label: str) -> None:
    with _LOCK:
        _PROCS[pid] = label


def unregister(pid: int) -> None:
    with _LOCK:
        _PROCS.pop(pid, None)


def snapshot() -> frozenset:
    """Registered pids right now (leak-check baseline)."""
    with _LOCK:
        return frozenset(_PROCS)


def live(exclude: frozenset = frozenset()) -> list:
    """(pid, label) for registered processes outside ``exclude`` —
    still running OR still registered (spawned but never reaped — a
    zombie the owner forgot to close())."""
    with _LOCK:
        return [
            (pid, label) for pid, label in _PROCS.items() if pid not in exclude
        ]
