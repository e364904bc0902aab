"""bdsan runtime sanitizers: lock-order witnesses + leak tracking +
crash diagnostics (the port's copy of banyandb_tpu/sanitize).  The
dynamic half of the race/leak hunting layer; the static half is bdlint's
``wp-shared-state`` / ``lock-order`` whole-program analyses.

Gate: ``BYDB_SANITIZE=1``.  ``install()`` is idempotent and does three
things:

1. patches ``threading.Lock``/``RLock`` so locks created by the port's
   package code record acquisition-order witness edges mapped to their
   static declaration identities (lockwatch.py, over the port's own call
   graph and lock-order model);
2. enables ``faulthandler`` so a wedged process dumps every thread's
   stack on SIGABRT/SIGSEGV and on the watchdog
   (``arm_watchdog``/``disarm_watchdog``);
3. exposes the leak-tracking primitives (leaks.py: threads, fds and the
   child processes of ``utils.procreg``) the stress tests build on.

Call ``install()`` before the threaded classes are constructed (before
the server is imported), so every lock they make is traced.  Everything
here is import-light until install() runs: the static lock model (an
AST pass over the package) loads once, lazily.
"""

from __future__ import annotations

from banyandb_tpu_torch.utils.envflag import env_flag


def enabled() -> bool:
    return env_flag("BYDB_SANITIZE", default=False)


_installed = False


def install() -> bool:
    """Install the runtime sanitizers (idempotent).  Returns True when
    active after the call."""
    global _installed
    if _installed:
        return True
    import faulthandler

    from banyandb_tpu_torch.sanitize import lockwatch

    lockwatch.install()
    faulthandler.enable()
    _installed = True
    return True


def installed() -> bool:
    return _installed


def arm_watchdog(timeout_s: float) -> None:
    """Dump every thread's traceback if the process is still inside the
    current unit of work after ``timeout_s`` (non-fatal; the dump goes to
    stderr and work continues).  Re-arming replaces the previous timer."""
    import faulthandler

    faulthandler.dump_traceback_later(timeout_s, exit=False)


def disarm_watchdog() -> None:
    import faulthandler

    faulthandler.cancel_dump_traceback_later()
