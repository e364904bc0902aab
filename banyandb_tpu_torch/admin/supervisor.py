"""Panic supervisor: crash capture + clean cancellation.

Analog of the reference's panic supervisor
(upstream pkg/cmdsetup/supervisor.go: recovered panics write
diagnostics and cancel the run group instead of half-dying).  The
Python twins of "recovered panic" are (a) an uncaught exception on ANY
thread (threading.excepthook) and (b) an uncaught exception on the main
thread (sys.excepthook).  Both paths write a crash artifact via the
diagnostics collector and trigger the run group's stop so teardown is
orderly rather than a stuck half-alive process.
"""

from __future__ import annotations

import logging
import sys
import threading
from pathlib import Path
from typing import Callable, Optional

log = logging.getLogger("banyandb.supervisor")


class Supervisor:
    def __init__(
        self,
        root: str | Path,
        on_crash: Optional[Callable[[], None]] = None,
    ):
        """on_crash: e.g. group.trigger_stop — called once per process
        after the first captured crash."""
        self.root = Path(root)
        self.on_crash = on_crash
        self.crashes = 0
        self._lock = threading.Lock()
        self._prev_threading_hook = None
        self._prev_sys_hook = None

    def _capture(self, reason: str, exc: BaseException) -> None:
        from banyandb_tpu_torch.admin.diagnostics import DiagnosticsCollector

        with self._lock:
            self.crashes += 1
            first = self.crashes == 1
        try:
            artifact = DiagnosticsCollector(self.root).write_crash_artifact(
                f"{reason}: {type(exc).__name__}: {exc}"
            )
            log.error("crash captured -> %s", artifact)
        except Exception:  # noqa: BLE001 - capture must not crash the hook
            log.exception("crash artifact write failed")
        if first and self.on_crash is not None:
            try:
                self.on_crash()
            except Exception:  # noqa: BLE001
                log.exception("on_crash callback failed")

    def install(self) -> "Supervisor":
        self._prev_threading_hook = threading.excepthook
        self._prev_sys_hook = sys.excepthook

        def thread_hook(args):
            if args.exc_type is SystemExit:
                return
            self._capture(
                f"thread {getattr(args.thread, 'name', '?')}", args.exc_value
            )
            self._prev_threading_hook(args)

        def main_hook(exc_type, exc, tb):
            if exc_type is not SystemExit:
                self._capture("main thread", exc)
            self._prev_sys_hook(exc_type, exc, tb)

        threading.excepthook = thread_hook
        sys.excepthook = main_hook
        return self

    def uninstall(self) -> None:
        if self._prev_threading_hook is not None:
            threading.excepthook = self._prev_threading_hook
        if self._prev_sys_hook is not None:
            sys.excepthook = self._prev_sys_hook
