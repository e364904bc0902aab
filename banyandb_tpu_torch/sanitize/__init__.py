"""bdsan runtime sanitizers: lock-order witnesses + leak tracking +
crash diagnostics.  The dynamic half of the race/leak hunting layer
(docs/sanitizers.md); the static half is bdlint's ``wp-shared-state`` /
``lock-order`` whole-program analyses.

Gate: ``BYDB_SANITIZE=1``.  In the JAX package ``install()`` patches
``threading.Lock``/``RLock`` with lock-order witnesses mapped to their
static declaration identities (``sanitize/lockwatch.py``), which needs
the whole-program lint's call graph and lock-order model.  Those come to
this package with ROADMAP.md Queue 1 item 9; until then ``install()``
raises ``NotImplementedError``.  The leak-tracking primitives
(``leaks.py``: threads, fds and the child processes of
``utils.procreg``) and the watchdog work here as there.
"""

from __future__ import annotations

from banyandb_tpu_torch.utils.envflag import env_flag


def enabled() -> bool:
    return env_flag("BYDB_SANITIZE", default=False)


_installed = False


def install() -> bool:
    """Install the runtime sanitizers: the lock-order witnesses need
    ``sanitize.lockwatch`` and the whole-program lint, which are not
    ported yet (ROADMAP.md Queue 1 item 9)."""
    raise NotImplementedError(
        "sanitize.install() needs sanitize.lockwatch and "
        "lint.whole_program.{callgraph, lockorder}, which are not ported "
        "to banyandb_tpu_torch yet (ROADMAP.md Queue 1 item 9); the leak "
        "tracking in sanitize.leaks works without it"
    )


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
